"""Zamba2-7B [arXiv:2411.15242; unverified]. Hybrid: Mamba2 backbone + a
shared-weight attention(+MLP) block applied every 6th layer.

81 blocks total = 68 Mamba2 + 13 applications of the single shared attn block.
Per-invocation LoRA on the shared block is simplified away (DESIGN §8).
Eligible for long_500k (hybrid, sub-quadratic backbone).
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, SSMConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=112,
                              rope_theta=10_000.0),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    attn_every=6,
    sub_quadratic=True,
))
