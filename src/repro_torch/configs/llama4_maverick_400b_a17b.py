"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-*; unverified].

MoE: 128 routed experts, top-1, plus one always-on shared expert (llama4
style). Early-fusion multimodality is a frontend concern; the backbone here is
token-driven. q heads 40 are zero-padded to 48 for 16-way TP (see DESIGN §4).
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, MoEConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attention=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    moe=MoEConfig(n_experts=128, top_k=1, expert_ff=8192, shared_expert_ff=8192),
    notes="bf16 optimizer moments used at train_4k to fit 16GB/chip (DESIGN §8).",
))
