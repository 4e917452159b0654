"""Operations and bytes of the model cells, from shapes alone.

A matrix product of an [m, k] and a [k, n] operand is 2*m*k*n
operations. Norms, biases, rotations, activations and the softmax's
exponentials are left out, so every count is a floor.
"""
from __future__ import annotations


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token meets in the layers' products."""
    D, F, L = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["num_hidden_layers"])
    Hq, Hkv, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    return L * (D * (Hq + 2 * Hkv) * Dh + Hq * Dh * D + 3 * D * F)


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attention_pairs_flops(cfg: dict, pairs: int) -> int:
    """q.k and p.v over `pairs` (query, key) pairs in every layer."""
    return (4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * pairs)


def forward_flops(cfg: dict, tokens: int, pairs: int,
                  head_tokens: int) -> int:
    """A forward pass over `tokens` rows that attend over `pairs`
    (query, key) pairs in all, `head_tokens` of them through the head."""
    return (2 * layer_matmul_params(cfg) * tokens
            + 2 * head_params(cfg) * head_tokens
            + attention_pairs_flops(cfg, pairs))


def train_step_flops(cfg: dict, seqs: int, seq_len: int) -> int:
    """A training step over `seqs` causal sequences of `seq_len`: forward
    and backward, three times the forward, with no credit for the
    recomputed forward of rematerialization."""
    T = seqs * seq_len
    pairs = seqs * seq_len * (seq_len + 1) // 2
    return 3 * forward_flops(cfg, T, pairs, T)


def flash_flops(bh: int, s: int, d: int) -> int:
    """Kernel E's causal forward over [bh, s, d]: the S(S+1)/2 unmasked
    (query, key) pairs of each row, two products of d each."""
    return 4 * bh * d * (s * (s + 1) // 2)

