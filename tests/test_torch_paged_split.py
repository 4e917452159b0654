"""The arithmetic of kernel C (`csrc/refresh_paged_attention.cu`) emulated in
plain torch on the CPU, held to the card's bars (`chip_smoke.PAGED_TOL`:
the reference's atol 5e-5 / rtol 1e-4 with q in float32, one rounding of
the output with q in bfloat16) against the JAX package's oracle
`repro.kernels.ref.paged_decode_attention` and, at the small shapes, its
Pallas kernel in interpret mode (`repro.kernels.ops`).

The kernel cannot run here; these tests pin its split and merge:

* a sequence's first n_valid = min(ceil(seq_len / T), MAXP) table entries
  (clamped at 0) are cut into splits of `split` pages; a split at or past
  n_valid does nothing;
* a split walks its pages in items of at most 64 rows, stopping at
  seq_len, and keeps an online softmax per query head: s = k_scale (q.k)
  with q scaled by 1/sqrt(D), the item's max, alpha = exp(m - m_new),
  p = exp(s - m_new), acc = acc alpha + (p v_scale).V, l = l alpha + sum p;
* the merge takes M = max m over the splits and
  out = sum acc e^(m - M) / max(sum l e^(m - M), 1e-30): zeros when no
  page is valid.

Cases: `chip_smoke.PAGED_CASES` (a zero length, groups 1, 5 and 16, six
splits with a ragged last page, pages of 128 rows), with splits of 1, 2
and `SPLIT_PAGES` pages, so that splits end where the sequence ends
mid-page and splits past a sequence's pages have nothing to read."""
import math
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import refresh_paged_attention as trpa

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the repo root's device check)

ROWS = 64          # rows of an item, as the kernel's PA_ROWS
NEG = -1e30


def emulate_paged(q, k8, v8, ks, vs, table, lens, page_size, split):
    """Kernel C's arithmetic on CPU tensors; returns [B, H, D] of q's
    dtype."""
    b, h, d = q.shape
    hkv = k8.shape[2]
    group, maxp = h // hkv, table.shape[1]
    nsplit = max(1, -(-maxp // split))
    qs = q.float() * torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.zeros((b, h, d))
    for bi in range(b):
        n = int(lens[bi])
        n_valid = min(-(-n // page_size), maxp) if n > 0 else 0
        parts = []
        for si in range(nsplit):
            pg0 = si * split
            if pg0 >= n_valid:
                continue
            m = torch.full((h,), NEG)
            l = torch.zeros(h)
            acc = torch.zeros((h, d))
            for pi in range(pg0, min(pg0 + split, n_valid)):
                phys = max(int(table[bi, pi]), 0)
                for r0 in range(0, page_size, ROWS):
                    pos0 = pi * page_size + r0
                    if pos0 >= n:
                        break
                    rows = min(ROWS, page_size - r0, n - pos0)
                    for g in range(hkv):
                        hs = slice(g * group, (g + 1) * group)
                        k = k8[phys, r0:r0 + rows, g].float()
                        v = v8[phys, r0:r0 + rows, g].float()
                        s = ks[phys, g] * (qs[bi, hs] @ k.T)
                        m_new = torch.maximum(m[hs], s.amax(-1))
                        alpha = torch.exp(m[hs] - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l[hs] = l[hs] * alpha + p.sum(-1)
                        acc[hs] = acc[hs] * alpha[:, None] + (
                            p * vs[phys, g]) @ v
                        m[hs] = m_new
            parts.append((m, l, acc))
        if not parts:
            continue
        mx = torch.stack([pm for pm, _, _ in parts]).amax(0)
        lt = sum(pl * torch.exp(pm - mx) for pm, pl, _ in parts)
        ot = sum(pa * torch.exp(pm - mx)[:, None] for pm, _, pa in parts)
        out[bi] = ot / lt.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _case(b, h, hkv, d, t, maxp, lens, seed):
    """Random pages quantized by the port's oracle (int8 and scales then
    given to both packages), a table with -1 past each sequence's pages,
    q: numpy arrays and CPU tensors."""
    rs = np.random.RandomState(seed)
    n_pages = b * maxp + 2
    k8, ks = tref.kv_quant(torch.from_numpy(
        rs.randn(n_pages, t, hkv, d).astype(np.float32)))
    v8, vs = tref.kv_quant(torch.from_numpy(
        rs.randn(n_pages, t, hkv, d).astype(np.float32)))
    table = rs.permutation(n_pages)[:b * maxp].reshape(b, maxp)
    for bi, n in enumerate(lens):
        table[bi, (n + t - 1) // t:] = -1
    q = rs.randn(b, h, d).astype(np.float32)
    ts = (torch.from_numpy(q), k8, v8, ks, vs,
          torch.from_numpy(table.astype(np.int32)),
          torch.tensor(lens, dtype=torch.int32))
    return [x.numpy() for x in ts], ts


@pytest.mark.parametrize("split", [1, 2, trpa.SPLIT_PAGES])
@pytest.mark.parametrize("case", cs.PAGED_CASES)
def test_emulated_split_and_merge_hold_the_bar(case, split):
    b, h, hkv, d, t, maxp, lens = case
    arrs, ts = _case(b, h, hkv, d, t, maxp, lens, seed=b * 10 + h)
    j = [jnp.asarray(a) for a in arrs]
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        q = ts[0].to(dtype)
        got = emulate_paged(q, *ts[1:], t, split)
        atol, rtol = cs.PAGED_TOL[cs.dtype_name(dtype)]
        wants = [jref.paged_decode_attention(j[0].astype(jdt), *j[1:],
                                             page_size=t)]
        if maxp <= 4:                      # the Pallas kernel, interpreted
            wants.append(jops.refresh_paged_attention(
                j[0].astype(jdt), *j[1:], page_size=t))
        for want in wants:
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want, np.float32),
                atol=atol, rtol=rtol, err_msg=f"{case} split {split} {dtype}")
        for bi, n in enumerate(lens):
            if n == 0:
                assert not got[bi].any()


def test_splits_past_the_sequence_and_a_zero_length():
    """MAXP of 12 pages, splits of 2: the first sequence's 5 valid pages
    end mid-page in its third split and its last three splits have no
    valid page; the second sequence has length 0 and gets zeros."""
    b, h, hkv, d, t, maxp, lens = 2, 10, 2, 16, 8, 12, (37, 0)
    arrs, ts = _case(b, h, hkv, d, t, maxp, lens, seed=4)
    got = emulate_paged(*ts, t, 2)
    want = jops.refresh_paged_attention(*map(jnp.asarray, arrs),
                                        page_size=t)
    atol, rtol = cs.PAGED_TOL["float32"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)
    assert not got[1].any() and got[0].abs().sum() > 0
