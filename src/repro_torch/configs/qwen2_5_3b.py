"""Qwen2.5-3B [hf:Qwen/Qwen2.5-*; hf]. Dense GQA kv=2, QKV bias."""
from repro_torch.common.config import ArchConfig, AttentionConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    d_ff=11008,
    vocab_size=151936,
    attention=AttentionConfig(n_heads=16, n_kv_heads=2, head_dim=128,
                              qkv_bias=True, rope_theta=1_000_000.0),
))
