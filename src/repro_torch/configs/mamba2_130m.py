"""Mamba2-130M [arXiv:2405.21060; unverified]. SSD (state-space duality).

Attention-free: 24 Mamba2 blocks, d_state=128, expand=2 (d_inner=1536,
24 SSD heads of dim 64). vocab 50280 padded to 50304 (mult of 128) for TP.
Eligible for long_500k (sub-quadratic).
"""
from repro_torch.common.config import ArchConfig, SSMConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True,
    sub_quadratic=True,
))
