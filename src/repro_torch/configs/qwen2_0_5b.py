"""Qwen2-0.5B [arXiv:2407.10671; hf]. Dense GQA kv=2, QKV bias, tied embeds.

q heads 14 zero-padded to 16 for 16-way TP (DESIGN §4).
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    attention=AttentionConfig(n_heads=14, n_kv_heads=2, head_dim=64,
                              qkv_bias=True, rope_theta=1_000_000.0),
    tie_embeddings=True,
))
