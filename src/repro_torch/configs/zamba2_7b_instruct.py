"""Zamba2-7B-Instruct as published (Zyphra; the layer equations of
`transformers`' `models/zamba2/modeling_zamba2.py`, the sizes of
https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json).

81 Mamba2 layers: d 3584, 112 SSD heads of 64, state 64, B and C in 2
groups of 56 heads, a depthwise conv of 4 with a bias over (x, B, C),
dt = softplus(dt + dt_bias) clamped below at `time_step_min`, and a gated
RMSNorm taken per group. The 13 layers of `hybrid_layer_ids` first run
one of two shared blocks, A and B in turn, over concat(h, the embedding)
at 7168: RMSNorm, attention of 32 heads of 224 (rope θ 10000 over all
224 dims, scores scaled by (224/2)^-0.5, no bias), RMSNorm at 3584, a
gelu-gated MLP of 14336 whose gate/up projection carries a rank-128
adapter of its own at each application; no residual inside the block.
Each hybrid layer's own 3584 x 3584 `linear` maps the block's output,
which is added to the Mamba layer's input under that layer's residual.
RMSNorm eps 1e-5; the head is tied to the embedding; vocabulary 32000.

Departures from `modeling_zamba2.py`, none a change of the function:

  * the SSD runs in chunks of 128 (the file's `chunk_size` is 256):
    chunking is exact, and kernel F takes chunks of at most 128;
  * the scores' scale is applied by multiplying q by sqrt(2) before
    kernel E, which scales by 224^-0.5;
  * `time_step_min` clamps dt as the file's plain-torch path does (its
    CUDA path does not clamp);
  * train only: `prefill` and decode raise for this layout.
"""
from repro_torch.common.config import (ArchConfig, AttentionConfig, SSMConfig,
                                       register_arch)

#: `layers_block_type` of the published config: "hybrid" at these ids
HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = register_arch(ArchConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=224,
                              rope_theta=10_000.0),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128,
                  n_groups=2, dt_min=0.001),
    tie_embeddings=True,
    norm_eps=1e-5,
    hybrid_layers=HYBRID_LAYER_IDS,
    n_mem_blocks=2,
    adapter_rank=128,
    sub_quadratic=True,
))
