"""The arithmetic of kernel E (`csrc/flash_attention.cu`) emulated in plain
torch on the CPU, held to the card's bars (`chip_smoke.FLASH_TOL`) against
the port's plain version and the JAX package's oracle, at the card's edge
shapes (`chip_smoke.FLASH_CASES`).

The kernel cannot run here; these tests pin the design's numerics:

* bf16: scores from bf16 q, k with float32 sums; the probabilities P of a
  64- or 128-key tile split into P_hi = bf16(p) and P_lo = bf16(p - P_hi),
  both multiplied by V (`wgmma` with float32 accumulation), so P keeps
  ~16 bits; the output rounded to bf16 once.
* f32: every product as 3xTF32, a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with
  each part rounded to the nearest TF32 value (10 mantissa bits, ties away
  from zero, as cvt.rna.tf32.f32).

Both run the kernel's online softmax tile by tile: masked scores -1e30,
exp2 of (s - m) · log2(e)/sqrt(D), out = acc / max(l, 1e-30). Three more
tests keep the reasons on record: one bf16 rounding of P misses the bf16
bar, single-pass TF32 misses the float32 bar, and with q, k and v all
scaled by 8 the float32 plain version itself lies further than that bar
from the exact result (why the wide-range case scales q only)."""
import math
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

#: keys a kv tile, as in the kernel's BF_KT and F_KT
BF16_KT, F32_KT = 128, 64
NEG = -1e30


def _inputs(bh, sq, skv, d, q_scale, seed=0):
    rs = np.random.RandomState(seed + 7 * sq + d)
    q = rs.randn(bh, sq, d).astype(np.float32) * q_scale
    return q, rs.randn(bh, skv, d).astype(np.float32), \
        rs.randn(bh, skv, d).astype(np.float32)


def tf32_rna(x):
    """float32 -> the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """a @ b with both operands split into TF32 hi + lo parts, the two
    small products summed first."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def _online(s, v, causal, kt, pv):
    """The kernel's online softmax over tiles of `kt` keys: `s` raw scores
    [BH, Sq, Skv] (float32), `pv(p, v_tile)` the P·V product."""
    bh, sq, skv = s.shape
    d = v.shape[-1]
    c = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        s = torch.where(keep[None], s, torch.tensor(NEG))
    m = torch.full((bh, sq, 1), NEG)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, skv, kt):
        st = s[:, :, k0:k0 + kt]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2((st - m_new) * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + pv(p, v[:, k0:k0 + kt])
        m = m_new
    return acc / l.clamp_min(1e-30)


def emulate_bf16(q, k, v, causal):
    """Kernel E's bf16 arithmetic: q, k, v bf16 tensors -> bf16 output."""
    s = q.float() @ k.float().transpose(1, 2)

    def pv(p, vt):
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        return hi @ vt.float() + lo @ vt.float()
    return _online(s, v, causal, BF16_KT, pv).to(torch.bfloat16)


def emulate_f32(q, k, v, causal, mm=mm_3xtf32):
    """Kernel E's f32 arithmetic (3xTF32 by default) on float32 tensors,
    over its kv tiles (32 keys for heads wider than 128)."""
    kt = F32_KT if q.shape[-1] <= 128 else F32_KT // 2
    return _online(mm(q, k.transpose(1, 2)), v, causal, kt, mm)


def _held(got, want, dtype, what):
    """`got` within FLASH_TOL[dtype] of `want` (a torch tensor of the
    plain version, or the JAX oracle's array)."""
    atol, rtol = cs.FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [c for c in cs.FLASH_CASES if c[3] <= 128])
def test_bf16_split_p_meets_the_card_bar(case, causal):
    q, k, v = _inputs(*case)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = emulate_bf16(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _held(got, tref.flash_attention(tq, tk, tv, causal=causal).float(),
          "bfloat16", "vs the port's plain version")
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    _held(got, jref.flash_attention(jq, jk, jv, causal=causal), "bfloat16",
          "vs the JAX oracle")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", cs.FLASH_CASES)
def test_f32_3xtf32_meets_the_card_bar(case, causal):
    q, k, v = _inputs(*case)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = emulate_f32(tq, tk, tv, causal)
    _held(got, tref.flash_attention(tq, tk, tv, causal=causal), "float32",
          "vs the port's plain version")
    _held(got, jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal),
          "float32", "vs the JAX oracle")


def test_single_bf16_p_misses_the_bf16_bar():
    """Why P is split: rounded once to bf16, as FlashAttention and SDPA
    round it, P puts a few elements in 10^4 past the card's bf16 bar (one
    rounding of the output) at the causal edge shapes; the split puts
    none there."""
    atol, rtol = cs.FLASH_TOL["bfloat16"]

    def once(q, k, v, causal):
        s = q.float() @ k.float().transpose(1, 2)
        return _online(s, v, causal, BF16_KT,
                       lambda p, vt: p.to(torch.bfloat16).float()
                       @ vt.float()).to(torch.bfloat16)
    past = {once: 0, emulate_bf16: 0}
    for case in cs.FLASH_CASES:
        if case[1] < 128:
            continue
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in _inputs(*case))
        want = tref.flash_attention(tq, tk, tv, causal=True).float()
        for fn in past:
            got = fn(tq, tk, tv, True).float()
            past[fn] += int(((got - want).abs()
                             > atol + rtol * want.abs()).sum())
    assert past[once] > 0 and past[emulate_bf16] == 0


def test_single_pass_tf32_misses_the_f32_bar():
    """Why 3xTF32: one TF32 product keeps 10 mantissa bits, and the output
    then lies ~10-100x the float32 bar away from the plain version."""
    tq, tk, tv = (torch.from_numpy(x) for x in _inputs(2, 128, 128, 128, 1))
    want = tref.flash_attention(tq, tk, tv, causal=True)
    atol, rtol = cs.FLASH_TOL["float32"]
    bar = atol + rtol * want.abs()
    one = (emulate_f32(tq, tk, tv, True, mm=mm_1xtf32) - want).abs()
    three = (emulate_f32(tq, tk, tv, True) - want).abs()
    assert float((one / bar).max()) > 10
    assert float((one > bar).float().mean()) > 0.2
    assert float((three / bar).max()) < 1


def test_scaling_k_and_v_too_puts_the_f32_plain_version_past_its_bar():
    """With q, k and v all x8 the scores widen 64x and the float32 plain
    version lies further than FLASH_TOL from the exact (float64) result,
    so no float32 kernel summing in another order could be held to it;
    the wide-range case of FLASH_CASES scales q alone (8x wider scores),
    where the plain version stays inside the bar."""
    atol, rtol = cs.FLASH_TOL["float32"]
    q, k, v = _inputs(1, 256, 256, 64, 1)

    def distance(scales):
        xs = [torch.from_numpy(x * f) for x, f in zip((q, k, v), scales)]
        plain = tref.flash_attention(*xs, causal=False).double()
        xq, xk, xv = (x.double() for x in xs)
        exact = torch.softmax(xq @ xk.transpose(1, 2) / 8.0, -1) @ xv
        return float(((plain - exact).abs()
                      / (atol + rtol * exact.abs())).max())
    assert distance((8, 8, 8)) > 1
    assert distance((8, 1, 1)) < 1


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      1 + 2 ** -12, -(1 + 2 ** -11), 3.0e-3],
                     dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -9, 1.0,
                         -(1 + 2 ** -10)], dtype=torch.float32)
    assert torch.equal(got[:5], want)
    assert int(got[5:].view(torch.int32)[0]) & 0x1fff == 0
    hi, lo = _split(x)
    assert torch.equal(hi[:5] + lo[:5], x[:5])
