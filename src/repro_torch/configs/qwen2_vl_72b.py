"""Qwen2-VL-72B LM backbone [arXiv:2409.12191; hf].

M-RoPE (multimodal rotary: temporal/height/width sections), dynamic-resolution
vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings; this config covers the 80-layer transformer backbone.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2-vl-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152064,
    attention=AttentionConfig(
        n_heads=64, n_kv_heads=8, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0, mrope=True, mrope_sections=(16, 24, 24),
    ),
    frontend="embed",
    notes="VLM backbone; patch embeds precomputed by stub frontend; M-RoPE.",
))
