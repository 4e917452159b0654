"""Qwen2.5-14B [hf:Qwen/Qwen2.5-*; hf]. Dense GQA kv=8, QKV bias.

q heads 40 zero-padded to 48 for 16-way TP (DESIGN §4).
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    d_ff=13824,
    vocab_size=152064,
    attention=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                              qkv_bias=True, rope_theta=1_000_000.0),
))
