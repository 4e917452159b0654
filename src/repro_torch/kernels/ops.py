"""Public entry points of the float kernels, with the names of
`repro/kernels/ops.py`.

Each call runs where its tensors lie: on CUDA tensors it launches the
hand-written kernel of its module (`csrc/*.cu`) or raises; on CPU tensors
it runs that module's plain PyTorch version. `flash_attention_trainable`
launches the flash kernel forward; its backward recomputes through the
oracle `ref.flash_attention` under autograd, as the reference's custom
VJP does (the reference has no kernel backward). `paged_attention_serial`
is the unfused baseline — dequantize the whole cache to bf16, then
attend — plain PyTorch, as it is plain jnp in the reference.
"""
from __future__ import annotations

import math

import torch

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
class _FlashTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _fa.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = R.flash_attention(q, k, v, causal=ctx.causal)
            gq, gk, gv = torch.autograd.grad(out, (q, k, v), g)
        return gq, gk, gv, None


def flash_attention_trainable(q, k, v, causal=True):
    return _FlashTrainable.apply(q, k, v, causal)


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
    mask = (torch.arange(maxp * page_size, device=q.device)[None, None, :]
            < seq_lens.long()[:, None, None])
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v_seq.float())
    return out.to(q.dtype)
