"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-*; hf]. 128 experts, top-8, GQA kv=4.

Qwen3 uses an explicit head_dim=128 (q width 64*128=8192 != d_model) — kept.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, MoEConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    d_ff=1536,
    vocab_size=151936,
    attention=AttentionConfig(n_heads=64, n_kv_heads=4, head_dim=128,
                              rope_theta=1_000_000.0),
    moe=MoEConfig(n_experts=128, top_k=8, expert_ff=1536),
))
