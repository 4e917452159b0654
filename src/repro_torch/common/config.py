"""Config system: architecture + shape configs, registry, reduced smoke configs.

Every assigned architecture lives in ``repro_torch/configs/<id>.py`` as an
:class:`ArchConfig` registered under its public id. Shape cells (seq_len x
global_batch x kind) are shared across the LM family per the assignment.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope: bool = False            # qwen2-vl multimodal rotary (3 sections t/h/w)
    mrope_sections: tuple = (16, 24, 24)  # per-head-dim/2 split across t/h/w

    def padded_heads(self, ways: int) -> int:
        """q heads padded so TP over `ways` divides evenly (zero-pad safe)."""
        return _round_up(self.n_heads, ways) if self.n_heads % ways else self.n_heads


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    shared_expert_ff: int = 0      # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128               # SSD chunk length
    # port-only fields, kept out of the repr (held equal to the JAX
    # package's configs'): B/C groups, each read by n_heads / n_groups
    # heads; softplus(dt) clamped below at dt_min (0: not)
    n_groups: int = field(default=1, repr=False)
    dt_min: float = field(default=0.0, repr=False)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # hybrid (zamba2): every `attn_every`-th block is the shared-weight attn block
    attn_every: int = 0
    # hybrid as published (Zamba2, `models/hybrid._published_*`; port-only,
    # kept out of the repr as above): the layers that first run a shared
    # block (empty: `attn_every`), the shared blocks taken in turn, and
    # the LoRA rank on the MLP's gate/up, one adapter an application
    hybrid_layers: tuple = field(default=(), repr=False)
    n_mem_blocks: int = field(default=1, repr=False)
    adapter_rank: int = field(default=0, repr=False)
    # encdec (seamless): n_layers applies to each of encoder and decoder
    n_encoder_layers: int = 0
    # 'token' (ids -> embedding) or 'embed' (frontend stub provides embeddings)
    frontend: str = "token"
    sub_quadratic: bool = False    # eligible for long_500k decode
    notes: str = ""

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 128)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def n_attn_applications(self) -> int:
        """How many attention blocks run in one forward pass."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            if self.hybrid_layers:
                return len(self.hybrid_layers)
            return self.n_layers // self.attn_every
        if self.family == "encdec":
            return self.n_encoder_layers + 2 * self.n_layers  # self+cross in dec
        return self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (logical, unpadded heads)."""
        d = self.d_model
        n = 0
        n += self.padded_vocab * d                       # embed
        if not self.tie_embeddings and self.frontend == "token":
            n += self.padded_vocab * d                   # lm head
        att = self.attention

        def attn_params() -> int:
            if att is None:
                return 0
            qk = d * att.n_heads * att.head_dim
            kv = d * att.n_kv_heads * att.head_dim
            bias = (att.n_heads + 2 * att.n_kv_heads) * att.head_dim if att.qkv_bias else 0
            return qk * 2 + kv * 2 + bias  # wq, wo, wk, wv

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gated (wi, wg, wo)

        def ssm_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj: x, z, B, C, dt ; out_proj ; conv over (x,B,C)
            conv_ch = di + 2 * s.d_state
            return (d * (2 * di + 2 * s.d_state + nh)) + di * d + conv_ch * s.d_conv + 2 * nh

        if self.family == "dense":
            n += self.n_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
        elif self.family == "moe":
            m = self.moe
            per = attn_params() + 2 * d + d * m.n_experts  # router
            per += m.n_experts * 3 * d * m.expert_ff
            if m.shared_expert_ff:
                per += 3 * d * m.shared_expert_ff
            n += self.n_layers * per
        elif self.family == "ssm":
            n += self.n_layers * (ssm_params() + d)
        elif self.family == "hybrid" and self.hybrid_layers:
            s = self.ssm
            di, gn, nh = s.d_inner(d), s.n_groups * s.d_state, s.n_heads(d)
            conv = di + 2 * gn
            mamba = (d + d * (di + conv + nh) + conv * (s.d_conv + 1)
                     + 3 * nh + di + di * d)
            dh, h2 = att.head_dim * att.n_heads, 2 * d
            shared = h2 + 3 * h2 * dh + dh * d + d + 3 * d * self.d_ff
            apps = len(self.hybrid_layers)
            n += self.n_layers * mamba + self.n_mem_blocks * shared
            n += apps * (self.adapter_rank * (d + 2 * self.d_ff) + d * d)
        elif self.family == "hybrid":
            n_attn = self.n_layers // self.attn_every
            n_mamba = self.n_layers - n_attn
            n += n_mamba * (ssm_params() + d)
            n += attn_params() + mlp_params(self.d_ff) + 2 * d  # one shared block
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff) + 3 * d)
            n += enc + dec
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        all_experts = self.n_layers * m.n_experts * 3 * self.d_model * m.expert_ff
        active = self.n_layers * m.top_k * 3 * self.d_model * m.expert_ff
        return full - all_experts + active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        att = self.attention
        if att is not None:
            ratio = max(1, att.n_heads // max(1, att.n_kv_heads))
            n_heads = 4
            head_dim = 16
            q = (head_dim // 2) * 3 // 8
            att = replace(
                att,
                n_heads=n_heads,
                n_kv_heads=max(1, n_heads // min(ratio, n_heads)),
                head_dim=head_dim,
                mrope_sections=(head_dim // 2 - 2 * q, q, q),
            )
        moe = self.moe
        if moe is not None:
            moe = replace(moe, n_experts=4, top_k=min(2, moe.top_k), expert_ff=64,
                          shared_expert_ff=64 if moe.shared_expert_ff else 0)
        ssm = self.ssm
        if ssm is not None:
            ssm = replace(ssm, d_state=16, head_dim=16, chunk=16)
        if self.hybrid_layers:
            # the published layout at 8 layers: blocks A, B, A after two,
            # four and seven Mamba layers; heads twice as wide over the
            # concatenated input
            return replace(
                self, n_layers=8, hybrid_layers=(2, 4, 7), d_model=64,
                d_ff=128, vocab_size=256, adapter_rank=8, ssm=ssm,
                attention=replace(att, head_dim=2 * 64 // att.n_heads))
        return replace(
            self,
            n_layers=max(2, self.attn_every) * 2 if self.family == "hybrid" else 2,
            n_encoder_layers=2 if self.family == "encdec" else 0,
            d_model=64,
            d_ff=128,
            vocab_size=256,
            attention=att,
            moe=moe,
            ssm=ssm,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_SETS: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(arch: ArchConfig) -> list[ShapeConfig]:
    """Shape cells for an arch, with brief-mandated skips applied."""
    out = [SHAPE_SETS["train_4k"], SHAPE_SETS["prefill_32k"], SHAPE_SETS["decode_32k"]]
    if arch.sub_quadratic:
        out.append(SHAPE_SETS["long_500k"])
    return out


# ---------------------------------------------------------------- registry
_REGISTRY: dict[str, ArchConfig] = {}

ARCH_IDS = [
    "qwen2-vl-72b",
    "llama4-maverick-400b-a17b",
    "qwen3-moe-235b-a22b",
    "internlm2-1.8b",
    "qwen2.5-14b",
    "qwen2.5-3b",
    "qwen2-0.5b",
    "mamba2-130m",
    "zamba2-7b",
    "seamless-m4t-large-v2",
]

#: archs registered beside the assigned ones, with no counterpart in the
#: JAX package: `list_archs`, which the parity and dry-run suites walk
#: against that package, leaves them out
EXTRA_ARCH_IDS = [
    "zamba2-7b-instruct",
]

_MODULE_FOR = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
               for a in ARCH_IDS + EXTRA_ARCH_IDS}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        if name not in _MODULE_FOR:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_FOR)}")
        importlib.import_module(_MODULE_FOR[name])
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return list(ARCH_IDS)
