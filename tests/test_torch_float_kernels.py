"""The port's float-kernel entry point (`repro_torch.kernels.ops`) against
the JAX package's (`repro.kernels.ops`, Pallas in interpret mode, and the
oracles `repro.kernels.ref`) on the CPU, where every port wrapper runs
its plain PyTorch version. The same numpy inputs, made from a seed, go
through both; the bars are the reference's own (`tests/test_kernels.py`):
flash 2e-5 in f32 and 2e-2 in bf16; kv_quant scales rtol 1e-4, int8
within ±1 and the `|x - q·s| <= 0.51·s` round trip; paged attention atol
5e-5 / rtol 1e-4; SSD atol 5e-4 / rtol 2e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kv_quant as tkq
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import refresh_paged_attention as trpa
from repro_torch.models import layers as tlayers

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of `dtype`."""
    return (jnp.asarray(a, _JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                _TDT[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------- kv_quant
@pytest.mark.parametrize("p,t,h,d", [(4, 8, 2, 16), (2, 16, 4, 32),
                                     (1, 64, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant(p, t, h, d, dtype):
    rs = np.random.RandomState(1)
    a = rs.randn(p, t, h, d) * 3
    a[0, :, 0, :] = 0.0                               # an all-zero head
    jp, tp = _both(a, dtype)
    q8, sc = tops.kv_quant(tp)
    assert q8.dtype == torch.int8 and sc.dtype == torch.float32
    for jq8, jsc in (jops.kv_quant(jp), jref.kv_quant(jp)):
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-4)
        assert np.abs(q8.numpy().astype(np.int32)
                      - np.asarray(jq8, np.int32)).max() <= 1
    np.testing.assert_allclose(sc.numpy()[0, 0], 1e-8 / 127.0, rtol=1e-6)
    assert not q8[0, :, 0, :].any()
    deq = q8.numpy().astype(np.float32) * sc.numpy()[:, None, :, None]
    bound = sc.numpy()[:, None, :, None] * 0.51 + 1e-6
    assert (np.abs(deq - _np(tp)) <= bound).all()


def test_kv_quant_equals_the_reference_exactly():
    """True division and half-to-even rounding: not only within ±1, the
    port's quantization equals the reference's value for value."""
    rs = np.random.RandomState(2)
    a = rs.randn(3, 16, 2, 32) * 5
    a[1, 3, 1, :4] = [63.5, -63.5, 0.5, -1.5]        # ties at scale 1
    a[1, :, 1, 4:] = 0.0
    a[1, 0, 1, 4] = 127.0
    for dtype in ("float32", "bfloat16"):
        jp, tp = _both(a, dtype)
        q8, sc = tops.kv_quant(tp)
        jq8, jsc = jops.kv_quant(jp)
        np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


# ------------------------------------------------------------ paged (SARP)
def _paged_inputs(b, h, hkv, d, t, maxp, seed, lens=None, pad=False,
                  qdtype="float32"):
    rs = np.random.RandomState(seed)
    p_total = maxp * b + 2
    kp = rs.randn(p_total, t, hkv, d).astype(np.float32)
    vp = rs.randn(p_total, t, hkv, d).astype(np.float32)
    table = rs.permutation(p_total)[:b * maxp].reshape(b, maxp)
    if lens is None:
        lens = rs.randint(1, maxp * t + 1, b)
    lens = np.asarray(lens)
    if pad:                               # entries past the valid pages
        for bi, n in enumerate(lens):
            table[bi, (n + t - 1) // t:] = -1
    q = rs.randn(b, h, d)
    j = dict(q=_both(q, qdtype)[0], kp=jnp.asarray(kp), vp=jnp.asarray(vp),
             table=jnp.asarray(table, jnp.int32),
             lens=jnp.asarray(lens, jnp.int32))
    tt = dict(q=_both(q, qdtype)[1], kp=torch.from_numpy(kp),
              vp=torch.from_numpy(vp),
              table=torch.from_numpy(table.astype(np.int32)),
              lens=torch.from_numpy(lens.astype(np.int32)))
    return j, tt


def _quantized(j, tt):
    """Quantize both sides' pages with their own kv_quant (the reference
    test quantizes with `ref.kv_quant`); the int8 pages are equal."""
    jk8, jks = jref.kv_quant(j["kp"])
    jv8, jvs = jref.kv_quant(j["vp"])
    tk8, tks = tops.kv_quant(tt["kp"])
    tv8, tvs = tops.kv_quant(tt["vp"])
    return (jk8, jv8, jks, jvs), (tk8, tv8, tks, tvs)


@pytest.mark.parametrize("b,h,hkv,d,t,maxp", [
    (2, 4, 2, 16, 8, 3), (1, 8, 8, 32, 16, 2), (3, 6, 2, 64, 8, 4),
    (2, 10, 2, 16, 8, 3), (2, 32, 2, 16, 8, 3)])
def test_refresh_paged_attention(b, h, hkv, d, t, maxp):
    j, tt = _paged_inputs(b, h, hkv, d, t, maxp, seed=b * 100 + h)
    jq, tq = _quantized(j, tt)
    out = tops.refresh_paged_attention(tt["q"], *tq, tt["table"],
                                       tt["lens"], page_size=t)
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, h, d)
    for want in (jops.refresh_paged_attention(j["q"], *jq, j["table"],
                                              j["lens"], page_size=t),
                 jref.paged_decode_attention(j["q"], *jq, j["table"],
                                             j["lens"], page_size=t)):
        np.testing.assert_allclose(_np(out), _np(want), atol=5e-5,
                                   rtol=1e-4)
    np.testing.assert_allclose(
        _np(out), _np(tref.paged_decode_attention(
            tt["q"], *tq, tt["table"], tt["lens"], page_size=t)),
        atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_refresh_paged_attention_zero_length_and_padding(qdtype):
    """A sequence of length 0 gets zeros, as the TPU kernel gives (its
    page loop never runs: acc / max(l, 1e-30)); -1 entries past a
    sequence's pages are never read. Held against the JAX `ops` entry,
    not the loop oracle."""
    b, h, hkv, d, t, maxp = 4, 10, 2, 16, 8, 4
    j, tt = _paged_inputs(b, h, hkv, d, t, maxp, seed=7,
                          lens=[0, 9, 32, 1], pad=True, qdtype=qdtype)
    assert (tt["table"] == -1).any()
    jq, tq = _quantized(j, tt)
    out = tops.refresh_paged_attention(tt["q"], *tq, tt["table"],
                                       tt["lens"], page_size=t)
    want = jops.refresh_paged_attention(j["q"], *jq, j["table"],
                                        j["lens"], page_size=t)
    assert out.dtype == _TDT[qdtype]
    tol = 5e-5 if qdtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol * 2)
    assert not out[0].any() and out[1:].abs().sum() > 0


def test_serial_baseline_matches():
    b, h, hkv, d, t, maxp = 2, 4, 2, 16, 8, 3
    rs = np.random.RandomState(3)
    kp, vp = rs.randn(2, 8, t, hkv, d)
    jk, tk = _both(kp)
    jv, tv = _both(vp)
    jk8, jks = jref.kv_quant(jk)
    jv8, jvs = jref.kv_quant(jv)
    tk8, tks = tops.kv_quant(tk)
    tv8, tvs = tops.kv_quant(tv)
    table = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    lens = np.asarray([17, 24], np.int32)
    jq, tq = _both(rs.randn(b, h, d))
    serial = tops.paged_attention_serial(
        tq, tk8, tv8, tks, tvs, torch.from_numpy(table),
        torch.from_numpy(lens), page_size=t)
    want = jops.paged_attention_serial(
        jq, jk8, jv8, jks, jvs, jnp.asarray(table), jnp.asarray(lens),
        page_size=t)
    np.testing.assert_allclose(_np(serial), _np(want), atol=5e-5, rtol=1e-4)
    fused = tops.refresh_paged_attention(
        tq, tk8, tv8, tks, tvs, torch.from_numpy(table),
        torch.from_numpy(lens), page_size=t)
    np.testing.assert_allclose(_np(fused), _np(serial), atol=2e-2,
                               rtol=2e-2)


def test_kv_quant_then_paged_attention_slice():
    """The chained slice: f32 pages -> `ops.kv_quant` -> int8 cache ->
    `ops.refresh_paged_attention`, through both packages."""
    b, h, hkv, d, t, maxp = 3, 10, 2, 32, 16, 3
    j, tt = _paged_inputs(b, h, hkv, d, t, maxp, seed=11, lens=[48, 17, 1])
    jk8, jks = jops.kv_quant(j["kp"])
    jv8, jvs = jops.kv_quant(j["vp"])
    tk8, tks = tops.kv_quant(tt["kp"])
    tv8, tvs = tops.kv_quant(tt["vp"])
    np.testing.assert_array_equal(tk8.numpy(), np.asarray(jk8))
    out = tops.refresh_paged_attention(tt["q"], tk8, tv8, tks, tvs,
                                       tt["table"], tt["lens"], page_size=t)
    want = jops.refresh_paged_attention(j["q"], jk8, jv8, jks, jvs,
                                        j["table"], j["lens"], page_size=t)
    np.testing.assert_allclose(_np(out), _np(want), atol=5e-5, rtol=1e-4)


# ------------------------------------------------------------------- flash
@pytest.mark.parametrize("bh,s,d", [(2, 64, 16), (1, 128, 32), (3, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(bh, s, d, dtype, causal):
    rs = np.random.RandomState(s + d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rs.randn(bh, s, d), dtype)
                                    for _ in range(3))
    out = tops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == _TDT[dtype]
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (jops.flash_attention(jq, jk, jv, causal=causal),
                 jref.flash_attention(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)


def test_flash_attention_rejects_a_length_the_block_does_not_divide():
    x = torch.zeros(1, 192, 16)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tops.flash_attention(x, x, x)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_trainable_grads(causal):
    rs = np.random.RandomState(5)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rs.randn(2, 64, 16))
                                    for _ in range(3))

    def f_jax(q, k, v):
        return (jops.flash_attention_trainable(q, k, v, causal) ** 2).sum()

    gj = jax.grad(f_jax, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    before = tfa.LAUNCHES
    (tops.flash_attention_trainable(*ts, causal) ** 2).sum().backward()
    assert tfa.LAUNCHES == before          # CPU tensors: no kernel launch
    for a, b in zip(ts, gj):
        np.testing.assert_allclose(_np(a.grad), _np(b), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------- ssd
def _ssd_inputs(b, s, h, p, n, seed):
    rs = np.random.RandomState(seed)
    arrs = (rs.randn(b, s, h, p), np.abs(rs.randn(b, s, h)) * 0.1 + 0.01,
            -np.abs(rs.randn(h)) - 0.1, rs.randn(b, s, n), rs.randn(b, s, n))
    pairs = [_both(a) for a in arrs]
    return [x for x, _ in pairs], [y for _, y in pairs]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 8, 16, 16), (1, 128, 2, 16, 32, 32), (2, 32, 1, 64, 8, 8)])
def test_mamba2_ssd(b, s, h, p, n, chunk):
    j, t = _ssd_inputs(b, s, h, p, n, seed=s + p)
    y = tops.mamba2_ssd(*t, chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, h, p)
    for want in (jops.mamba2_ssd(*j, chunk=chunk),
                 jref.mamba2_ssd(*j, chunk=chunk)):
        np.testing.assert_allclose(_np(y), _np(want), atol=5e-4, rtol=2e-3)


def test_ssd_chunked_both_outputs():
    """`ssd_chunked` with a D residual and an initial state: y and the
    final state [B,H,P,N] equal `repro.models.layers.ssd_chunked`."""
    b, s, h, p, n = 2, 48, 3, 8, 16
    j, t = _ssd_inputs(b, s, h, p, n, seed=9)
    rs = np.random.RandomState(10)
    (jd, td), (jh, th) = _both(rs.randn(h)), _both(rs.randn(b, h, p, n))
    jy, jst = jlayers.ssd_chunked(*j, jd, 16, init_state=jh)
    ty, tst = tlayers.ssd_chunked(*t, td, 16, init_state=th)
    assert tuple(tst.shape) == (b, h, p, n)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(_np(tst), _np(jst), atol=5e-4, rtol=2e-3)
    _, tst0 = tlayers.ssd_chunked(*t, td, 16)
    _, jst0 = jlayers.ssd_chunked(*j, jd, 16)
    np.testing.assert_allclose(_np(tst0), _np(jst0), atol=5e-4, rtol=2e-3)


def test_ssd_matches_naive_recurrence():
    """The port's chunked oracle equals the O(S) recurrence."""
    b, s, h, p, n = 1, 32, 2, 4, 8
    _, (x, dt, A, Bi, Ci) = _ssd_inputs(b, s, h, p, n, seed=12)
    yr = tref.mamba2_ssd(x, dt, A, Bi, Ci, chunk=8).numpy()
    x, dt, A, Bi, Ci = (a.double().numpy() for a in (x, dt, A, Bi, Ci))
    state = np.zeros((b, h, p, n))
    ys = []
    for i in range(s):
        da = np.exp(dt[:, i] * A[None])
        state = state * da[:, :, None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, i], Bi[:, i], x[:, i])
        ys.append(np.einsum("bn,bhpn->bhp", Ci[:, i], state))
    np.testing.assert_allclose(yr, np.stack(ys, 1), atol=1e-4, rtol=1e-3)


# ------------------------------------------------------- operation counts
@pytest.mark.parametrize("sq,skv,causal", [(256, 256, True), (64, 64, True),
                                           (128, 256, True),
                                           (256, 128, False)])
def test_flash_operations_count_the_unmasked_pairs(sq, skv, causal):
    """The bound counts what the function needs: 4·D operations for each
    (q, k) pair the reference's mask keeps, nothing for masked pairs."""
    keep = (np.arange(sq)[:, None] >= np.arange(skv)[None, :]
            if causal else np.ones((sq, skv), bool))
    assert tfa.operations(3, sq, skv, 32, causal) == 3 * int(
        keep.sum()) * 4 * 32


@pytest.mark.parametrize("s,chunk", [(256, 128), (64, 16), (32, 64)])
def test_ssd_operations_count_the_lower_triangle(s, chunk):
    """Per chunk: C·Bᵀ and the weighted dt·x over the pairs j ≤ i only,
    then C·hᵀ and the state update, L·P·N multiply-adds each."""
    b, h, p, n = 2, 3, 8, 16
    l = min(chunk, s)
    pairs = int(np.tril(np.ones((l, l), bool)).sum())
    macs = (s // l) * (pairs * (n + p) + 2 * l * p * n)
    assert tssd.operations(b, s, h, p, n, chunk) == 2 * b * h * macs


# ----------------------------------------------------------------- wrappers
def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """Nothing falls back: a device that is neither the CPU nor CUDA, a
    wrong dtype or a non-contiguous tensor raises."""
    meta = torch.empty(2, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tkq.kv_quant(meta)
    with pytest.raises(TypeError, match="dtype"):
        tkq.kv_quant(torch.zeros(2, 8, 2, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(*[torch.zeros(1, 16, 64).transpose(1, 2)] * 3)
    x = torch.zeros(1, 64, 2, 4, device="meta")
    dt = torch.zeros(1, 64, 2, device="meta")
    bc = torch.zeros(1, 64, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tssd.mamba2_ssd(x, dt, torch.zeros(2, device="meta"), bc, bc,
                        chunk=16)
    j, tt = _paged_inputs(1, 4, 2, 16, 8, 2, seed=0)
    _, tq = _quantized(j, tt)
    with pytest.raises(TypeError, match="page_table"):
        trpa.refresh_paged_attention(tt["q"], *tq, tt["table"].long(),
                                     tt["lens"], page_size=8)
    with pytest.raises(ValueError, match="shapes do not fit"):
        trpa.refresh_paged_attention(tt["q"], *tq, tt["table"],
                                     tt["lens"], page_size=16)
