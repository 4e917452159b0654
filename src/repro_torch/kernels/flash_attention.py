"""Causal or non-causal attention forward with an online softmax as a CUDA
kernel on the H100's tensor cores (kernel E).

Replaces the TPU kernel `_flash_kernel` of the JAX package
(`repro/kernels/flash_attention.py`): q/k/v `[BH, S, D]` (kv already
GQA-expanded), q and kv blocks of `min(128, S)` rows (a length the block
does not divide raises), causal meaning `qpos >= kpos` counted from 0 also
when `Sq != Skv`, the softmax taken in float32 with masked scores at
-1e30, `out = acc / max(l, 1e-30)`.

Beside the kernel, as beside every kernel of this package:

  * the plain PyTorch version is the oracle `ref.flash_attention`;
  * `flash_attention` is the wrapper around the hand-written kernels
    `flash_attention_bf16_kernel` and `flash_attention_f32_kernel`
    (`csrc/flash_attention.cu`). It takes the plain version only for
    tensors that lie on the CPU (or on `meta`, shapes only); for CUDA
    tensors it launches the kernel of their dtype or raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

`flash_attention_ragged` is the models' route to the same kernel: any
Sq and Skv, as the reference's `chunked_attention` takes them (queries
padded at the end and sliced back; keys at their own length, the rows
past Skv zero-filled and masked inside the kernel).

What bounds it on an H100: operations. A causal prefill at S=4096, D=128
needs S(S+1)/2 (q, k) pairs a head, 4·D floating-point operations each,
against 4·S·D elements of input and output. Both types compute on the
tensor cores, in blocks of two warpgroups per (head, 128-row q block):

  * bf16: `wgmma` with float32 accumulation, S = Q·Kᵀ from shared memory
    and O += P·V with P in registers, over kv tiles of 128 keys. P is
    split into P_hi = bf16(p) and P_lo = bf16(p - P_hi) and multiplied
    twice, because one bf16 rounding of P misses the card's bf16 bar (one
    rounding of the output; `chip_smoke.FLASH_TOL`) on a few elements in
    10^4, while the split meets it. That is 1.5x the function's tensor
    work; the bound counts the function's own.
  * f32: 3xTF32 on `mma.sync` (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each
    part rounded to the nearest TF32 value): single-pass TF32 misses the
    float32 bar (2e-5) by ~40x, and the TF32 `wgmma` cannot read V, which
    is contiguous in D, as its B operand. Its least time is therefore
    three TF32 products at the TF32 peak, below the CUDA cores' float32
    bound.

`tests/test_torch_flash_numerics.py` emulates both arithmetics on the CPU
against the bars.

The gradient (`flash_attention_backward`, float32 only) is a hand-written
kernel too, where the TPU kernel has none (the JAX package differentiates
its oracle): `flash_attention_with_lse` is E's forward that also returns
each query row's log-sum-exp, and the backward kernels
(`csrc/flash_attention_bwd.cu`) recompute P tile by tile from it instead
of building the [BH, Sq, Skv] scores. Beside them, as beside E:

  * the plain version `flash_attention_backward_torch` (with
    `flash_attention_lse_torch`) repeats their arithmetic and tile walks;
  * `BWD_LAUNCHES` counts the backward's launches (a call counts one).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

#: number of kernel launches made by `flash_attention`
LAUNCHES = 0
#: number of backward calls that launched the backward kernels
BWD_LAUNCHES = 0

#: the widest head the bf16 kernel takes, and the TPU kernel's block length
MAX_D, BLOCK = 128, 128
#: the widest head the f32 kernel and the backward kernels take
MAX_D_F32 = 224
#: keys a kv tile of E's f32 kernel (its online log-sum-exp walks these),
#: at D <= MAX_D and past it
F_KT, F_KT_WIDE = 64, 32
#: keys of a dk/dv block and query rows of a dq block of the backward, at
#: D <= MAX_D and past it
BWD_ROWS, BWD_ROWS_WIDE = 128, 64

flash_attention_torch = ref.flash_attention

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def blocks(sq: int, skv: int) -> tuple[int, int]:
    """q and kv block lengths, `min(128, S)`; a length that the block
    does not divide raises, as the TPU kernel asserts."""
    q_blk, kv_blk = min(BLOCK, sq), min(BLOCK, skv)
    if sq % q_blk or skv % kv_blk:
        raise ValueError(f"flash_attention: sequence lengths {sq}, {skv} "
                         f"must be multiples of the blocks {q_blk}, "
                         f"{kv_blk}")
    return q_blk, kv_blk


def operations(bh: int, sq: int, skv: int, d: int, causal: bool, *,
               ragged: bool = False) -> int:
    """Floating-point operations the function needs: for each (q, k) pair
    it does not mask (k ≤ q under causality), 2·D for the score and as
    many for P·V. Work the kernels add is not counted: the masked parts
    of the tiles they compute, the padded query rows, P·V taken twice for
    the split P in bf16, three TF32 products for each float32 one.
    `ragged` counts for `flash_attention_ragged`, which takes any
    lengths; otherwise lengths `blocks` refuses raise."""
    if not ragged:
        blocks(sq, skv)               # raises where the function raises
    pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    return bh * pairs * 4 * d


def backward_operations(bh: int, sq: int, skv: int, d: int,
                        causal: bool) -> int:
    """Floating-point operations the gradient needs, counted as
    `operations` counts the forward: 7 products of 2·D for each unmasked
    (q, k) pair - S and dP in each of the two kernels, then dV, dK and
    dQ. Masked parts of tiles and the three TF32 products of a float32
    one are not counted."""
    return operations(bh, sq, skv, d, causal, ragged=True) * 7 // 2


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [BH, Sq, D]; k, v: [BH, Skv, D]; one dtype (float32 or
    bfloat16), contiguous, on one device. Returns [BH, Sq, D] of q's
    dtype. On the card D is a multiple of 4, at most `MAX_D` in bfloat16
    and `MAX_D_F32` in float32."""
    return _forward("flash_attention", q, k, v, causal, False, False)[0]


def padded_rows(sq: int) -> int:
    """Query rows `flash_attention_ragged` gives the kernel for `sq`
    queries: `sq` itself up to one block, else `sq` rounded up to a
    multiple of `BLOCK`."""
    return sq if sq <= BLOCK else -(-sq // BLOCK) * BLOCK


def flash_attention_ragged(q, k, v, *, causal: bool = True):
    """The same function as `flash_attention` at any lengths: the route of
    the models' attention (`models.layers.chunked_attention`), which the
    reference computes at any length. q is padded at the end with zero
    rows to `padded_rows(Sq)` and the output sliced back: exact, causal
    or not, since no query row reads another. Keys are taken at their
    own length: the kernel's kv tiles zero-fill the rows past Skv and
    mask their scores (`key >= Skv`), so no load reads past Skv, and it
    is launched with a key block of 1, which lifts the launcher's
    divisibility check. `blocks` and `flash_attention` keep the TPU
    kernel's contract. Same dtypes, devices and head widths as
    `flash_attention`; Sq and Skv at least 1."""
    return _forward("flash_attention_ragged", q, k, v, causal, True,
                    False)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             ragged: bool = False):
    """`(out, lse)`: `flash_attention` (`flash_attention_ragged` with
    `ragged`) and each query row's log-sum-exp of its scaled scores,
    `log(sum_k exp(q·k / sqrt(D)))` over the keys it sees, [BH, Sq]: what
    the backward recomputes P from. On the card float32 only (E's f32
    kernel writes it beside the output); on the CPU `out` is the plain
    version's, as `flash_attention`'s, and `lse` is
    `flash_attention_lse_torch`'s."""
    return _forward("flash_attention_with_lse", q, k, v, causal, ragged,
                    True)


def _forward(fn, q, k, v, causal, ragged, with_lse):
    """The three forwards above: `(out, lse or None)`."""
    _check(fn, q, k, v)
    sq, skv = q.shape[1], k.shape[1]
    if ragged:
        if sq < 1 or skv < 1:
            raise ValueError(f"{fn}: sequence lengths {sq}, {skv} must be "
                             f"positive")
        rows = padded_rows(sq)
        q_blk, kv_blk = min(BLOCK, rows), 1
    else:
        rows = sq
        q_blk, kv_blk = blocks(sq, skv)
    qp = q
    if rows != sq:
        qp = torch.nn.functional.pad(q, (0, 0, 0, rows - sq)).contiguous()
    lse = None
    if q.device.type in ("cpu", "meta"):
        out = flash_attention_torch(qp, k, v, causal=causal)
        if with_lse:
            lse = flash_attention_lse_torch(q, k, causal=causal)
    else:
        if with_lse:
            if q.dtype != torch.float32:
                raise TypeError(f"{fn}: the log-sum-exp is written by the "
                                f"float32 kernel; got {q.dtype}")
            lse = torch.empty((q.shape[0], rows), dtype=torch.float32,
                              device=q.device)
        out = _launch(fn, qp, k, v, causal, q_blk, kv_blk, lse)
        if lse is not None and rows != sq:
            lse = lse[:, :sq].contiguous()
    return (out[:, :sq] if rows != sq else out), lse


def flash_attention_lse_torch(q, k, *, causal: bool = True):
    """Each query row's log-sum-exp of its scaled scores, [BH, Sq], as
    E's f32 kernel takes it: a running max m and sum l over key tiles of
    `F_KT` (`F_KT_WIDE` past `MAX_D`), then m + log(l). Computed in
    float32, or in float64 for float64 inputs (the plain versions'
    checks)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    kt = F_KT if d <= MAX_D else F_KT_WIDE
    wt = torch.promote_types(q.dtype, torch.float32)
    qw, kw = q.to(wt), k.to(wt)
    i64 = dict(dtype=torch.int64, device=q.device)
    qpos = torch.arange(sq, **i64)
    m = torch.full((bh, sq), -math.inf, dtype=wt, device=q.device)
    l = torch.zeros((bh, sq), dtype=wt, device=q.device)
    for k0 in range(0, skv, kt):
        z = torch.einsum("bqd,bkd->bqk", qw,
                         kw[:, k0:k0 + kt]) / math.sqrt(d)
        if causal:
            kpos = torch.arange(k0, min(k0 + kt, skv), **i64)
            z = torch.where(qpos[:, None] >= kpos[None, :], z, -math.inf)
        m_new = torch.maximum(m, z.amax(-1))
        safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        l = l * torch.exp(m - safe) + torch.exp(z - safe[..., None]).sum(-1)
        m = m_new
    return m + torch.log(l)


def flash_attention_backward(q, k, v, out, lse, dout, *,
                             causal: bool = True):
    """`(dq, dk, dv)`: the gradient of `flash_attention_ragged` (any
    lengths, E's masking) for the output gradient `dout`, from the
    forward's `out` and `lse` (`flash_attention_with_lse`). q, out, dout
    [BH, Sq, D]; k, v [BH, Skv, D]; lse [BH, Sq]; contiguous, on one
    device. CUDA tensors launch the backward kernels (float32, D at most
    `MAX_D_F32` and a multiple of 4) or raise; CPU tensors (and `meta`)
    run `flash_attention_backward_torch`."""
    global BWD_LAUNCHES
    from repro_torch.kernels import _build
    fn = "flash_attention_backward"
    _check(fn, q, k, v)
    bh, sq, d = q.shape
    skv = k.shape[1]
    for name, x, shape in (("out", out, q.shape), ("dout", dout, q.shape)):
        _build.check_tensor(fn, name, x, dtypes=(q.dtype,), ndim=3,
                            device=q.device)
        if x.shape != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
    _build.check_tensor(fn, "lse", lse, dtypes=(torch.float32, torch.float64),
                        ndim=2, device=q.device)
    if tuple(lse.shape) != (bh, sq):
        raise ValueError(f"{fn}: lse has shape {tuple(lse.shape)}, expected "
                         f"{(bh, sq)}")
    if sq < 1 or skv < 1:
        raise ValueError(f"{fn}: sequence lengths {sq}, {skv} must be "
                         f"positive")
    if q.device.type in ("cpu", "meta"):
        return flash_attention_backward_torch(q, k, v, out, lse, dout,
                                              causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"{fn}: the kernels take float32; got {q.dtype}, "
                        f"lse {lse.dtype}")
    if d > MAX_D_F32 or d % 4:
        raise ValueError(f"{fn}: the kernels take D <= {MAX_D_F32}, a "
                         f"multiple of 4; got D={d}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if bh == 0:
        return dq, dk, dv
    di = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch("flash_attention_bwd_f32_launch", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq,
                      skv, d, int(bool(causal)),
                      torch.cuda.current_stream().cuda_stream)
    BWD_LAUNCHES += 1
    return dq, dk, dv


def flash_attention_backward_torch(q, k, v, out, lse, dout, *,
                                   causal: bool = True):
    """The plain version of `flash_attention_backward`, walking the
    kernels' tiles: Di = rowsum(dout ∘ out); for each block of `BWD_ROWS`
    keys (`BWD_ROWS_WIDE` past `MAX_D`), the query tiles of t rows from
    the diagonal on (t = 64 where the kernels pad D to 64 columns, 32
    where they pad it to 128 or take it wider),
    P = exp(q·kᵀ·scale - lse) masked, dP = dout·vᵀ, dS = P ∘ (dP - Di),
    dv += Pᵀ·dout, dk += dSᵀ·q; for each block of `BWD_ROWS` query rows,
    the key tiles up to the diagonal, dq += dS·k; dk and dq times scale
    at the end. In float32, or float64 for float64 inputs; the gradients
    come back in the inputs' dtype."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    wt = torch.promote_types(q.dtype, torch.float32)
    qw, kw, vw, ow, gw = (x.to(wt) for x in (q, k, v, out, dout))
    lw = lse.to(wt)
    scale = 1.0 / math.sqrt(d)
    i64 = dict(dtype=torch.int64, device=q.device)
    di = (gw * ow).sum(-1)
    rows = BWD_ROWS if d <= MAX_D else BWD_ROWS_WIDE
    t = 64 if d <= 64 else 32

    def tile(q0, q1, k0, k1):
        """P and dS of query rows [q0, q1) against keys [k0, k1)."""
        z = torch.einsum("bqd,bkd->bqk", qw[:, q0:q1], kw[:, k0:k1]) * scale
        p = torch.exp(z - lw[:, q0:q1, None])
        if causal:
            keep = (torch.arange(q0, q1, **i64)[:, None]
                    >= torch.arange(k0, k1, **i64)[None, :])
            p = torch.where(keep, p, 0.0)
        dp = torch.einsum("bqd,bkd->bqk", gw[:, q0:q1], vw[:, k0:k1])
        return p, p * (dp - di[:, q0:q1, None])

    dq, dk, dv = (torch.zeros_like(x) for x in (qw, kw, vw))
    for k0 in range(0, skv, rows):
        k1 = min(k0 + rows, skv)
        for q0 in range((k0 // t) * t if causal else 0, sq, t):
            q1 = min(q0 + t, sq)
            p, ds = tile(q0, q1, k0, k1)
            dv[:, k0:k1] += torch.einsum("bqk,bqd->bkd", p, gw[:, q0:q1])
            dk[:, k0:k1] += torch.einsum("bqk,bqd->bkd", ds, qw[:, q0:q1])
    for q0 in range(0, sq, rows):
        q1 = min(q0 + rows, sq)
        n_keys = min(skv, ((q1 - 1) // t + 1) * t) if causal else skv
        for k0 in range(0, n_keys, t):
            _, ds = tile(q0, q1, k0, min(k0 + t, skv))
            dq[:, q0:q1] += torch.einsum("bqk,bkd->bqd", ds,
                                         kw[:, k0:min(k0 + t, skv)])
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _check(fn, q, k, v):
    from repro_torch.kernels import _build
    _build.check_tensor(fn, "q", q, dtypes=tuple(_DTYPES), ndim=3)
    for name, x in (("k", k), ("v", v)):
        _build.check_tensor(fn, name, x, dtypes=(q.dtype,), ndim=3,
                            device=q.device)
    bh, _, d = q.shape
    skv = k.shape[1]
    if tuple(k.shape) != (bh, skv, d) or tuple(v.shape) != (bh, skv, d):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")


def _launch(fn, q, k, v, causal, q_blk, kv_blk, lse=None):
    """Kernel E of q's dtype on CUDA tensors, or raise; with `lse`
    ([BH, Sq] float32) the f32 kernel also writes the log-sum-exp."""
    global LAUNCHES
    from repro_torch.kernels import _build
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    bh, sq, d = q.shape
    dmax = MAX_D_F32 if q.dtype == torch.float32 else MAX_D
    if d > dmax or d % 4:
        raise ValueError(f"{fn}: the {_DTYPES[q.dtype]} kernel takes D <= "
                         f"{dmax}, a multiple of 4; got D={d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if lse is None:
        name, ptrs = f"flash_attention_{_DTYPES[q.dtype]}_launch", ()
    else:
        name, ptrs = "flash_attention_f32_lse_launch", (lse.data_ptr(),)
    with torch.cuda.device(q.device):
        _build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), *ptrs, bh, sq, k.shape[1], d, q_blk,
                      kv_blk, int(bool(causal)),
                      torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out
