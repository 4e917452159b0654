"""Kernel D (int8 KV-page quantization) on the CPU: the port's
`ops.kv_quant` against the JAX package's (the oracle
`repro.kernels.ref.kv_quant`, and `repro.kernels.ops.kv_quant`, Pallas in
interpret mode) on pages with non-finite slices and at every model width
of the repo;
the kernel's arithmetic (`csrc/kv_quant.cu`: a max over the bit patterns
of |x|, a floor that keeps a NaN, a true division, rounding half to even,
0 for a NaN quotient) emulated in numpy against the oracle; and the
wrapper's pick of an instantiation (`kv_quant.plan`) with the kernel's
walk over a slice, emulated, visiting every vector once.

The bars against the oracle: exact. Scales equal bit for bit (NaN where
NaN; a NaN's payload is not compared), int8 equal wherever `x / scale` is
finite. Where it is not - every value under a NaN scale, +-inf under an
inf one - the int8 value is undefined in the reference (a NaN cast to
int8), so it is not compared; the kernel stores 0 there.

Against the Pallas kernel in interpret mode: NaN and inf scales where the
oracle has them, and finite scales within one rounding. Compiled by XLA
for the CPU, the kernel divides by the constant 127 through its
reciprocal, one rounding off the true division in some slices (the 1e-8
floor is one of them), so its int8 values are equal where the two scales
are and within 1 where they are not."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import kv_quant as tkq
from repro_torch.kernels import ops as tops

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the card check's edge shapes)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of `dtype`, and
    the values both hold, in float32."""
    tp = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        _TDT[dtype])
    return jnp.asarray(a, _JDT[dtype]), tp, tp.float().numpy()


def _nonfinite_pages(shape, seed):
    """Random pages with +inf and -inf in slice (0, 0), a NaN in the last
    slice and an all-zero slice (1, 0)."""
    a = np.random.RandomState(seed).randn(*shape) * 3
    a[0, 0, 0, 0], a[0, -1, 0, -1] = np.inf, -np.inf
    a[-1, -1, -1, 0] = np.nan
    a[1, :, 0, :] = 0.0
    return a


def _assert_matches(q8, sc, jq8, jsc, x):
    """Scales equal bit for bit with NaN where NaN; int8 equal where
    `x / scale` is finite."""
    q8, sc = np.asarray(q8), np.asarray(sc)
    jq8, jsc = np.asarray(jq8), np.asarray(jsc, np.float32)
    nan = np.isnan(jsc)
    np.testing.assert_array_equal(np.isnan(sc), nan)
    np.testing.assert_array_equal(sc[~nan].view(np.int32),
                                  jsc[~nan].view(np.int32))
    with np.errstate(invalid="ignore"):
        fin = np.isfinite(x / jsc[:, None, :, None])
    np.testing.assert_array_equal(q8[fin], jq8[fin])
    return fin


def _assert_near_interpret(q8, sc, jq8, jsc, x):
    """Against the Pallas kernel in interpret mode (see the module
    docstring): non-finite scales where it has them, finite ones within
    one rounding, int8 equal where the scales are equal, within 1 where
    they are not."""
    q8, sc = np.asarray(q8), np.asarray(sc)
    jq8, jsc = np.asarray(jq8), np.asarray(jsc, np.float32)
    fs = np.isfinite(jsc)
    np.testing.assert_array_equal(np.isnan(sc), np.isnan(jsc))
    np.testing.assert_array_equal(sc[np.isinf(jsc)], jsc[np.isinf(jsc)])
    assert (np.abs(sc[fs] - jsc[fs]) <= np.spacing(jsc[fs])).all()
    with np.errstate(invalid="ignore"):
        fin = np.isfinite(x / jsc[:, None, :, None])
    same = np.broadcast_to((sc == jsc)[:, None, :, None], x.shape)
    np.testing.assert_array_equal(q8[fin & same], jq8[fin & same])
    diff = np.abs(q8.astype(np.int32) - jq8.astype(np.int32))
    assert (diff[fin] <= 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_nonfinite_scales_equal_the_reference(dtype):
    """A NaN in a slice gives the slice a NaN scale and an inf an inf
    scale, in the port as in the reference (the first CUDA design's
    `fmaxf` gave a finite scale for a NaN slice)."""
    jp, tp, x = _both(_nonfinite_pages((3, 8, 2, 16), seed=3), dtype)
    q8, sc = tops.kv_quant(tp)
    assert np.isinf(sc[0, 0].item()) and np.isnan(sc[2, 1].item())
    assert np.isfinite(sc.numpy()[[0, 1, 1, 2], [1, 0, 1, 0]]).all()
    fin = _assert_matches(q8.numpy(), sc.numpy(), *jref.kv_quant(jp), x)
    assert not fin[2, :, 1].any() and fin[0, 1:-1, 0].all()
    _assert_near_interpret(q8.numpy(), sc.numpy(),
                           *jops.kv_quant(jp, interpret=True), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_kv_quant_model_widths_equal_the_reference(d, dtype):
    """Head dims 64, 112 and 128 (every attention config of the repo) at
    the paged cache's 64-token page: equal value for value."""
    a = np.random.RandomState(d).randn(2, 64, 2, d) * 4
    a[1, 5, 0, :3] = [63.5, -63.5, 2.5]        # ties if the scale were 1
    jp, tp, x = _both(a, dtype)
    q8, sc = tops.kv_quant(tp)
    jq8, jsc = jref.kv_quant(jp)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy().view(np.int32),
                                  np.asarray(jsc).view(np.int32))
    _assert_near_interpret(q8.numpy(), sc.numpy(),
                           *jops.kv_quant(jp, interpret=True), x)


def _emulate_kernel(x):
    """`csrc/kv_quant.cu`'s arithmetic on float32 pages [P, T, H, D]: the
    absmax as the max of |x|'s bits as unsigned integers, the floor
    `a < 1e-8 ? 1e-8 : a` (keeps a NaN), a true division, rounding half
    to even, 0 for a NaN quotient, the clip to +-127."""
    bits = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
    amax = bits.max(axis=(1, 3)).view(np.float32)
    with np.errstate(invalid="ignore"):
        floor = np.where(amax < np.float32(1e-8), np.float32(1e-8), amax)
        sc = (floor / np.float32(127.0)).astype(np.float32)
        v = x / sc[:, None, :, None]
        q = np.where(np.isnan(v), 0, np.clip(np.rint(v), -127, 127))
    return q.astype(np.int8), sc


@pytest.mark.parametrize("kind", ["nonfinite", "boundaries"])
def test_kernel_arithmetic_emulated_equals_the_reference(kind):
    if kind == "nonfinite":
        a = _nonfinite_pages((3, 16, 2, 8), seed=4)
    else:
        a = np.random.RandomState(5).randn(3, 16, 2, 8) * 5
        a[1, 3, 1, :4] = [63.5, -63.5, 0.5, -1.5]    # ties at scale 1
        a[1, :, 1, 4:], a[1, 0, 1, 4] = 0.0, 127.0
        a[2, :, 0] = 0.0                               # the 1e-8 floor
    x = np.ascontiguousarray(a, np.float32)
    q8, sc = _emulate_kernel(x)
    jq8, jsc = jref.kv_quant(jnp.asarray(x))
    fin = _assert_matches(q8, sc, jq8, jsc, x)
    assert not q8[~fin].any()
    if kind == "nonfinite":
        # what the first design did: fmaxf drops a NaN, so the NaN slice
        # got a finite scale
        assert np.isfinite(np.fmax.reduce(np.abs(x[2, :, 1]), axis=None))
        assert np.isnan(sc[2, 1])


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", cs.KV_QUANT_SHAPES)
def test_plan_and_the_kernel_walk_cover_the_slice(shape, itemsize):
    """The instantiation `plan` picks (a vector that divides the row's
    bytes, a block of 128 or 256 threads, the fewest vectors a thread
    that cover the slice) and the kernel's walk over a slice (`walk_at`
    and `step`: tiles of NT x NV vectors, a thread's vectors NT apart,
    rows and columns advanced by fixed steps) visit every vector of the
    slice exactly once, at the position a division would give."""
    _, t, _, d = shape
    vb, nv, nt = tkq.plan(t, d, itemsize)
    assert (d * itemsize) % vb == 0 and vb in (16, 8, 4, 2)
    assert 2 * vb > 16 or (d * itemsize) % (2 * vb)    # the widest
    ev = vb // itemsize
    dv, n_vec = d // ev, t * d // ev
    assert nt == (256 if n_vec > 128 * tkq.MAX_VECTORS else 128)
    assert nv == tkq.MAX_VECTORS or nv * nt >= n_vec
    assert nv == 1 or (nv // 2) * nt < n_vec           # the fewest
    tile = nt * nv
    rstep, cstep = nt // dv, nt - (nt // dv) * dv
    seen = []
    for tl in range(-(-n_vec // tile)):
        for tid in range(nt):
            v = tl * tile + tid
            r, c = divmod(v, dv)
            for _ in range(nv):
                if r < t:
                    assert (r, c) == divmod(v, dv)
                    seen.append(r * dv + c)
                r, c, v = r + rstep, c + cstep, v + nt
                if c >= dv:
                    r, c = r + 1, c - dv
    assert sorted(seen) == list(range(n_vec))


@pytest.mark.parametrize("dtype,t,d,want", [
    ("float32", 64, 128, (16, 8, 256)), ("bfloat16", 64, 128, (16, 8, 128)),
    ("float32", 64, 112, (16, 8, 256)), ("bfloat16", 64, 112, (16, 8, 128)),
    ("float32", 64, 64, (16, 8, 128)), ("bfloat16", 64, 64, (16, 4, 128)),
    ("float32", 128, 256, (16, 8, 256)), ("bfloat16", 128, 256, (16, 8, 256)),
    ("bfloat16", 5, 12, (8, 1, 128)), ("float32", 3, 6, (8, 1, 128)),
    ("bfloat16", 3, 6, (4, 1, 128)), ("float32", 4, 5, (4, 1, 128)),
    ("bfloat16", 4, 5, (2, 1, 128))])
def test_plan_picks(dtype, t, d, want):
    """8 vectors of 16 bytes a thread at every model width (64, 112, 128)
    in both dtypes, but bf16 at 64, whose slice 128 threads cover with 4;
    a slice past 256 x 8 vectors in tiles of that; narrower vectors only
    for rows that 16 bytes do not divide."""
    assert tkq.plan(t, d, _ITEMSIZE[dtype]) == want
