"""InternLM2-1.8B [arXiv:2403.17297; hf]. Dense, GQA kv=8."""
from repro_torch.common.config import ArchConfig, AttentionConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92544,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0),
))
