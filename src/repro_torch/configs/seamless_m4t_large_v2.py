"""SeamlessM4T-large-v2 backbone [arXiv:2308.11596; hf]. Encoder-decoder.

24-layer speech encoder + 24-layer text decoder (d_model 1024, MHA 16 heads,
d_ff 8192). The speech frontend (conformer feature extractor) is a STUB:
``input_specs`` provides precomputed frame embeddings [B, T, d_model].
vocab 256206 padded to 256256 for TP. Full attention -> long_500k skipped.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab_size=256206,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=64,
                              rope_theta=10_000.0),
    frontend="embed",
))
