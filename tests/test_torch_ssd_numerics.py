"""The arithmetic of kernel F (`csrc/mamba2_ssd.cu`) emulated in plain torch
on the CPU, held to the card's bar (`chip_smoke.SSD_TOL`, the reference's
atol 5e-4 / rtol 2e-3) against the JAX package's oracle
`repro.kernels.ref.mamba2_ssd` and the port's plain version, at the card's
edge shapes (`chip_smoke.SSD_CASES`), at 64 chunks and under a decay
strong enough that exp(cum) falls below 1e-20 inside a chunk.

The kernel cannot run here; these tests pin its decomposition:

* per (batch, chunk): cum, the within-chunk cumulative sum of dt * A[h];
  C.B^T once for all heads;
* per head: W = C.B^T o exp(cum_i - cum_j) o [j <= i] (the decay taken
  only where j <= i), y = W.(dt x), the chunk's state
  S_c = sum_l (dt_l x_l exp(total - cum_l)) (x) B_l;
* the carried state h_c = h_{c-1} exp(total) + S_c, h_{-1} = 0;
* the carried term taken transposed, (h_{c-1}.C^T)^T, times exp(cum_i),
  added to y;

with every product 3xTF32: both operands split into hi + lo parts, each
rounded to the nearest TF32 value (10 mantissa bits, ties away from
zero, as the kernel's two integer operations round), and
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed, the two small products first.
One more test keeps the reason on record: single-pass TF32 misses the
bar, so the kernel may not take it."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the repo root's device check)

ATOL, RTOL = cs.SSD_TOL


def tf32_rna(x):
    """float32 -> the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def mm_3xtf32(a, b):
    """a @ b (batched) with both operands split into TF32 hi + lo parts,
    the two small products summed first."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def emulate_ssd(x, dt, A, B, C, chunk, mm=mm_3xtf32):
    """Kernel F's arithmetic on float32 CPU tensors: x [b, s, h, p], dt
    [b, s, h], A [h], B/C [b, s, n] -> y [b, s, h, p]; `mm` is every
    product."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    l = min(chunk, s)
    nc = s // l
    xc = x.reshape(b, nc, l, h, p).permute(0, 1, 3, 2, 4)     # [b,nc,h,l,p]
    dtc = dt.reshape(b, nc, l, h).permute(0, 1, 3, 2)          # [b,nc,h,l]
    Bc, Cc = B.reshape(b, nc, l, n), C.reshape(b, nc, l, n)
    cum = torch.cumsum(dtc * A[None, None, :, None], dim=-1)   # [b,nc,h,l]
    total = cum[..., -1:]
    cb = mm(Cc, Bc.transpose(-1, -2))[:, :, None]              # once a chunk
    keep = torch.tril(torch.ones((l, l), dtype=torch.bool))
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.exp(torch.where(keep, diff, torch.zeros(())))
    w = torch.where(keep, cb * decay, torch.zeros(()))
    dtx = xc * dtc[..., None]
    y = mm(w, dtx)                                             # [b,nc,h,l,p]
    dte = torch.exp(total - cum)
    states = mm((dtx * dte[..., None]).transpose(-1, -2),
                Bc[:, :, None])                                # [b,nc,h,p,n]
    ecum, etot = torch.exp(cum), torch.exp(total)[..., None]   # [b,nc,h,1,1]
    hstate = torch.zeros((b, h, p, n))
    for c in range(nc):
        if c:
            yo = mm(hstate, Cc[:, c, None].transpose(-1, -2))
            y[:, c] = torch.addcmul(y[:, c], ecum[:, c, ..., None],
                                    yo.transpose(-1, -2))
        hstate = hstate * etot[:, c] + states[:, c]
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p)


def _inputs(b, s, h, p, n, seed, strong=False):
    """The reference test's draws (`tests/test_kernels.py`); `strong`
    draws dt and |A| so that dt * |A| is about 3 a step."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, p)
    if strong:
        dt = rs.uniform(0.5, 1.5, (b, s, h))
        A = -rs.uniform(2.0, 4.0, h)
    else:
        dt = np.abs(rs.randn(b, s, h)) * 0.1 + 0.01
        A = -np.abs(rs.randn(h)) - 0.1
    arrs = [a.astype(np.float32)
            for a in (x, dt, A, rs.randn(b, s, n), rs.randn(b, s, n))]
    return arrs, [torch.from_numpy(a) for a in arrs]


def _held(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("case", cs.SSD_CASES)
def test_emulated_kernel_holds_the_bar_at_the_edge_shapes(case):
    b, s, h, p, n, chunk = case
    arrs, ts = _inputs(b, s, h, p, n, seed=s + p + n)
    got = emulate_ssd(*ts, chunk)
    _held(got, jref.mamba2_ssd(*map(jnp.asarray, arrs), chunk=chunk),
          f"against repro.kernels.ref at {case}")
    _held(got, tref.mamba2_ssd(*ts, chunk=chunk),
          f"against the port's plain version at {case}")


def test_emulated_kernel_carries_the_state_over_64_chunks():
    """S = 1024 in chunks of 16: the state crosses 63 look-back steps."""
    arrs, ts = _inputs(1, 1024, 2, 16, 32, seed=3)
    _held(emulate_ssd(*ts, 16),
          jref.mamba2_ssd(*map(jnp.asarray, arrs), chunk=16), "64 chunks")


@pytest.mark.parametrize("chunk", [16, 32])
def test_emulated_kernel_under_strong_decay(chunk):
    """dt * |A| about 3 a step: exp(cum) falls below 1e-20 inside a chunk,
    and above the diagonal cum_i - cum_j would overflow exp; the kernel
    takes the decay only where j <= i, so nothing is NaN."""
    b, s, h, p, n = 2, 64, 2, 8, 16
    arrs, ts = _inputs(b, s, h, p, n, seed=11, strong=True)
    x, dt, A = ts[:3]
    cum = torch.cumsum((dt * A).reshape(b, s // chunk, chunk, h), dim=2)
    assert float(torch.exp(cum).min()) < 1e-20
    got = emulate_ssd(*ts, chunk)
    assert torch.isfinite(got).all()
    _held(got, jref.mamba2_ssd(*map(jnp.asarray, arrs), chunk=chunk),
          f"strong decay, chunk {chunk}")


def test_single_pass_tf32_misses_the_bar():
    """Why every product is three TF32 products: one, with each operand
    rounded to TF32 once, lies further than SSD_TOL from the oracle at
    mamba2-130m's chunk, head and state widths."""
    b, s, h, p, n, chunk = 1, 256, 2, 64, 128, 128
    arrs, ts = _inputs(b, s, h, p, n, seed=s + p + n)
    want = np.asarray(jref.mamba2_ssd(*map(jnp.asarray, arrs), chunk=chunk))
    got = emulate_ssd(*ts, chunk, mm=mm_1xtf32).numpy()
    assert not np.allclose(got, want, atol=ATOL, rtol=RTOL)
