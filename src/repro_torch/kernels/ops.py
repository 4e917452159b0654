"""Public entry points of the float kernels, with the names of
`repro/kernels/ops.py`.

Each call runs where its tensors lie: on CUDA tensors it launches the
hand-written kernel of its module (`csrc/*.cu`) or raises; on CPU tensors
it runs that module's plain PyTorch version. `flash_attention_trainable`
launches the flash kernel forward, which on float32 also writes each
row's log-sum-exp; its backward is the hand-written backward kernels
(`flash_attention.flash_attention_backward`), where the reference's
custom VJP differentiates its oracle (it has no kernel backward); on
bfloat16 CUDA tensors, which no training path gives it, the backward
still recomputes through the oracle `ref.flash_attention` under autograd.
The models' card route `flash_attention_ragged_trainable` (E at any
lengths) shares that backward; `mamba2_ssd_with_state_trainable` (F with
its final state) differentiates `ref.mamba2_ssd_with_state`.
`paged_attention_serial` is the unfused baseline — dequantize the whole
cache to bf16, then attend — plain PyTorch, as it is plain jnp in the
reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import trace
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kv_quant as _kq
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import ref as R
from repro_torch.kernels import refresh_paged_attention as _rpa


flash_attention = _fa.flash_attention
kv_quant = _kq.kv_quant
refresh_paged_attention = _rpa.refresh_paged_attention
mamba2_ssd = _ssd.mamba2_ssd


# ------------------------------------------------------------------- flash
#: backward calls that recomputed through the oracle (bfloat16 on the card)
RECOMPUTES = 0


class _FlashTrainable(torch.autograd.Function):
    """Kernel E forward and E's one backward, shared by
    `flash_attention_trainable` (the TPU kernel's contract,
    `_fa.flash_attention`) and the models' card route
    (`models.layers.chunked_attention`, any lengths,
    `_fa.flash_attention_ragged`). The forward saves q, k, v, the output
    and each row's log-sum-exp (`_fa.flash_attention_with_lse`); the
    backward is `_fa.flash_attention_backward`: the backward kernels on
    float32 CUDA tensors, their plain version on CPU tensors. bfloat16
    CUDA tensors save q, k, v alone and recompute the oracle's gradient
    under autograd (`RECOMPUTES`). Every backward runs inside the span
    `attn.backward` (CUDA events on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, ragged):
        ctx.causal = causal
        if q.device.type == "cuda" and q.dtype == torch.bfloat16:
            ctx.save_for_backward(q, k, v)
            fwd = _fa.flash_attention_ragged if ragged else _fa.flash_attention
            return fwd(q, k, v, causal=causal)
        out, lse = _fa.flash_attention_with_lse(q, k, v, causal=causal,
                                                ragged=ragged)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        global RECOMPUTES
        saved = ctx.saved_tensors       # unpacked once (checkpointing)
        with trace.span("attn.backward", g.device):
            if len(saved) == 3:
                RECOMPUTES += 1
                q, k, v = (t.detach().requires_grad_() for t in saved)
                with torch.enable_grad():
                    out = R.flash_attention(q, k, v, causal=ctx.causal)
                    grads = torch.autograd.grad(out, (q, k, v), g)
            else:
                q, k, v, out, lse = saved
                grads = _fa.flash_attention_backward(
                    q, k, v, out.contiguous(), lse, g.contiguous(),
                    causal=ctx.causal)
        return (*grads, None, None)


def flash_attention_trainable(q, k, v, causal=True):
    return _FlashTrainable.apply(q, k, v, causal, False)


def flash_attention_ragged_trainable(q, k, v, causal=True):
    """`flash_attention_trainable` at any lengths (`flash_attention_ragged`
    forward): the models' attention on the card."""
    return _FlashTrainable.apply(q, k, v, causal, True)


# --------------------------------------------------------------------- ssd
class _SsdTrainable(torch.autograd.Function):
    """Kernel F forward with its final state (`mamba2_ssd_with_state`),
    the plain version's gradient backward: autograd of
    `ref.mamba2_ssd_with_state` (the chunked SSD with a zero residual,
    B and C in one group or in G) recomputed from the saved inputs. A
    final state that nothing reads comes back with no gradient. Every
    backward runs inside the span `ssd.backward` (CUDA events on the
    card) and counts one `mamba2_ssd.BWD_CALLS`."""

    @staticmethod
    def forward(ctx, x, dt, A, B_in, C_in, chunk):
        ctx.save_for_backward(x, dt, A, B_in, C_in)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _ssd.mamba2_ssd_with_state(x, dt, A, B_in, C_in, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        _ssd.BWD_CALLS += 1
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        dev = ins[0].device
        with trace.span("ssd.backward", dev), torch.enable_grad():
            outs = R.mamba2_ssd_with_state(*ins, chunk=ctx.chunk)
            pairs = [(o, g) for o, g in zip(outs, (gy, gstate))
                     if g is not None]
            if not pairs:
                return (None,) * 6
            grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        return (*grads, None)


def mamba2_ssd_with_state_trainable(x, dt, A, B_in, C_in, *, chunk=128):
    """`mamba2_ssd_with_state` with a gradient: kernel F forward, the
    plain version's gradient backward (the models' SSD on the card)."""
    return _SsdTrainable.apply(x, dt, A, B_in, C_in, chunk)


# ------------------------------------------------------- paged attn (SARP)
def paged_attention_serial(q, k_pages, v_pages, k_scale, v_scale,
                           page_table, seq_lens, *, page_size: int):
    """REF_ab-analogue baseline: stop-the-world dequant of ALL pages to a
    bf16 buffer (extra device-memory round trip), then attend. ~5x the
    KV-side traffic of the fused kernel (1B read vs 1B+2B+2B)."""
    kd = (k_pages.float() * k_scale[:, None, :, None]).to(torch.bfloat16)
    vd = (v_pages.float() * v_scale[:, None, :, None]).to(torch.bfloat16)
    return _serial_attend(q, kd, vd, page_table, seq_lens, page_size)


def _serial_attend(q, kd, vd, page_table, seq_lens, page_size):
    b, h, d = q.shape
    hkv = kd.shape[2]
    group = h // hkv
    maxp = page_table.shape[1]
    # gather logical view [B, maxp*T, Hkv, D]
    idx = page_table.long().clamp_min(0)
    k_seq = kd[idx].reshape(b, maxp * page_size, hkv, d)
    v_seq = vd[idx].reshape(b, maxp * page_size, hkv, d)
    if group > 1:
        k_seq = k_seq.repeat_interleave(group, dim=2)
        v_seq = v_seq.repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k_seq.float()) / math.sqrt(d)
    mask = (torch.arange(maxp * page_size, dtype=torch.int64,
                         device=q.device)[None, None, :]
            < seq_lens.long()[:, None, None])
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v_seq.float())
    return out.to(q.dtype)
