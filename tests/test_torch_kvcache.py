"""The port's paged int8 KV cache (`repro_torch.kvcache`) against the JAX
package's (`repro.kvcache`) on the CPU, where `quantize_page` runs kernel
D's plain version.

Bars: `quantize_page` is held value for value (scales bit for bit, int8
equal), on float32 and bfloat16 pages; the cache's bookkeeping (page
table, lengths, page states, staging map, free lists, stats) is held
equal after the same seeded sequence of operations, and `gather_seq`
equal in float32 (staged values go through the same cast, compressed
ones through the same int8 values and scales). The reference's own cache
tests are repeated on the port at their bars.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fallback; see _hypothesis_shim
    from _hypothesis_shim import given, settings, strategies as st

from repro.kvcache import PagedKVCache as JCache
from repro.kvcache import PagedKVConfig as JConfig
from repro.kvcache.paged import dequantize_page as jdequant
from repro.kvcache.paged import page_quant_error as jerror
from repro.kvcache.paged import quantize_page as jquant
from repro_torch.kvcache import PagedKVCache, PagedKVConfig, quantize_page
from repro_torch.kvcache.paged import dequantize_page, page_quant_error

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GEOM = dict(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4, n_pages=16,
            n_staging=8, n_groups=4, max_seqs=4, max_pages_per_seq=8)


def _configs(dtype):
    return (JConfig(**GEOM, dtype=_JDT[dtype]),
            PagedKVConfig(**GEOM, dtype=_TDT[dtype]))


def _pages(shape, dtype, seed):
    """Random pages (numpy float32) with an all-zero head and values on
    the rounding boundaries, rounded to `dtype`."""
    rs = np.random.RandomState(seed)
    a = (rs.randn(*shape) * 3).astype(np.float32)
    a[..., 0, :] = 0.0                                   # an all-zero head
    a.reshape(-1)[:4] = [63.5, -63.5, 0.5, 127.0]
    return np.array(jnp.asarray(a, _JDT[dtype]).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 4, 2, 8), (4, 2, 8), (3, 2, 16, 1, 12)])
def test_quantize_page_equals_reference(dtype, shape):
    a = _pages(shape, dtype, seed=len(shape))
    q8, sc = quantize_page(torch.from_numpy(a).to(_TDT[dtype]))
    jq8, jsc = jquant(jnp.asarray(a, _JDT[dtype]))
    assert q8.dtype == torch.int8 and sc.dtype == torch.float32
    assert tuple(q8.shape) == shape and tuple(sc.shape) == jsc.shape
    np.testing.assert_array_equal(sc.numpy().view(np.int32),
                                  np.asarray(jsc).view(np.int32))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(
        dequantize_page(q8, sc, torch.float32).numpy(),
        np.asarray(jdequant(jq8, jsc, jnp.float32)))
    assert float(page_quant_error(torch.from_numpy(a))) == float(
        jerror(jnp.asarray(a)))


def test_quantize_page_divides_by_a_tensor():
    """The scale is the true float32 division amax / 127, as the
    reference's; a product by the rounded reciprocal 1/127 (what CUDA
    torch makes of a division by the scalar 127.0) is one rounding off in
    these slices, which the plain version must not be."""
    amax = np.float32(1.0) + np.arange(4096, dtype=np.float32) * np.float32(
        1e-3)
    true = amax / np.float32(127.0)
    recip = amax * (np.float32(1.0) / np.float32(127.0))
    off = amax[true != recip][:8]
    assert off.size == 8
    page = np.zeros((off.size, 2, 1, 4), np.float32)
    page[:, 0, 0, 0] = off
    _, sc = quantize_page(torch.from_numpy(page))
    np.testing.assert_array_equal(sc.numpy()[:, 0], off / np.float32(127.0))
    np.testing.assert_array_equal(
        sc.numpy(), np.asarray(jquant(jnp.asarray(page))[1]))


def _same_books(c, jc, what=""):
    np.testing.assert_array_equal(c.page_table, jc.page_table, what)
    np.testing.assert_array_equal(c.seq_len, jc.seq_len, what)
    np.testing.assert_array_equal(c.active, jc.active, what)
    np.testing.assert_array_equal(c.page_state, jc.page_state, what)
    np.testing.assert_array_equal(c.staging_slot, jc.staging_slot, what)
    assert c.free_pages == jc.free_pages, what
    assert c.free_staging == jc.free_staging, what
    assert c.stats == jc.stats, what
    assert c.compressible_pages() == jc.compressible_pages(), what
    assert c.group_ready() == jc.group_ready(), what
    assert c.staging_pressure() == jc.staging_pressure(), what
    assert c.page_pressure() == jc.page_pressure(), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operations_match_reference(dtype, seed):
    """One seeded sequence of new_seq / append / compress_page /
    compress_group / release_seq on both caches: identical bookkeeping
    after every operation, equal gathers at the end and along the way."""
    jcfg, tcfg = _configs(dtype)
    jc, c = JCache(jcfg), PagedKVCache(tcfg, device="cpu")
    rs = np.random.RandomState(seed)
    sids = []
    shape = (GEOM["n_layers"], GEOM["n_kv_heads"], GEOM["head_dim"])
    for i in range(70):
        kind = rs.choice(["new", "append", "append", "append", "page",
                          "group", "release", "gather"])
        if kind == "new" and len(sids) < GEOM["max_seqs"]:
            s = c.new_seq()
            assert s == jc.new_seq()
            sids.append(s)
        elif kind == "append" and sids:
            sid = sids[rs.randint(len(sids))]
            k, v = ((rs.randn(*shape) * 2).astype(np.float32)
                    for _ in range(2))
            ok = c.append(sid, torch.from_numpy(k), torch.from_numpy(v))
            assert ok == jc.append(sid, jnp.asarray(k), jnp.asarray(v))
        elif kind == "page" and c.compressible_pages():
            pages = c.compressible_pages()
            p = pages[rs.randint(len(pages))]
            forced = bool(rs.randint(2))
            c.compress_page(p, forced=forced)
            jc.compress_page(p, forced=forced)
        elif kind == "group":
            g = rs.randint(GEOM["n_groups"])
            assert c.compress_group(g) == jc.compress_group(g)
        elif kind == "release" and sids:
            sid = sids.pop(rs.randint(len(sids)))
            c.release_seq(sid)
            jc.release_seq(sid)
        elif kind == "gather" and sids:
            _same_gather(c, jc, sids[rs.randint(len(sids))])
        _same_books(c, jc, f"after step {i} ({kind})")
    assert c.stats["appends"] > 10 and c.stats["compressions"] > 0
    for sid in sids:
        _same_gather(c, jc, sid)


def _same_gather(c, jc, sid):
    assert c.pages_of(sid) == jc.pages_of(sid)
    for layer in range(GEOM["n_layers"]):
        k, v = c.gather_seq(sid, layer, torch.float32)
        jk, jv = jc.gather_seq(sid, layer, jnp.float32)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_gather_in_bfloat16_matches_reference():
    jcfg, tcfg = _configs("bfloat16")
    jc, c = JCache(jcfg), PagedKVCache(tcfg, device="cpu")
    rs = np.random.RandomState(7)
    sid = c.new_seq()
    jc.new_seq()
    for _ in range(10):
        k = rs.randn(2, 2, 8).astype(np.float32)
        c.append(sid, torch.from_numpy(k), torch.from_numpy(-k))
        jc.append(sid, jnp.asarray(k), jnp.asarray(-k))
    c.compress_group(c.group_of(c.pages_of(sid)[0]))
    jc.compress_group(jc.group_of(jc.pages_of(sid)[0]))
    k, v = c.gather_seq(sid, 1)
    jk, jv = jc.gather_seq(sid, 1)
    assert k.dtype == torch.bfloat16
    np.testing.assert_array_equal(k.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


def test_cache_lives_on_the_requested_device():
    c = PagedKVCache(PagedKVConfig(**GEOM), device="cpu")
    for name in ("k_pages", "v_pages", "k_scale", "v_scale", "k_staging",
                 "v_staging"):
        assert getattr(c, name).device.type == "cpu"
    assert c.k_staging.dtype == torch.bfloat16
    assert PagedKVConfig(1, 1, 4).dtype == torch.bfloat16


# ------------------------------------ the reference's cache tests, on the port

CFG = PagedKVConfig(**GEOM, dtype=torch.float32)
RS = np.random.RandomState(0)


def _tok(i):
    return torch.from_numpy(
        (RS.randn(CFG.n_layers, CFG.n_kv_heads, CFG.head_dim) * 0.5)
        .astype(np.float32))


def test_append_gather_roundtrip_staged():
    c = PagedKVCache(CFG, device="cpu")
    sid = c.new_seq()
    toks = [_tok(i) for i in range(6)]
    for t in toks:
        assert c.append(sid, t, t * 2)
    k, v = c.gather_seq(sid, layer=1, dtype=torch.float32)
    assert tuple(k.shape) == (6, 2, 8)
    expect = torch.stack([t[1] for t in toks])
    torch.testing.assert_close(k, expect, atol=1e-6, rtol=0)
    torch.testing.assert_close(v, expect * 2, atol=1e-6, rtol=0)


def test_compress_then_gather_within_int8_tolerance():
    c = PagedKVCache(CFG, device="cpu")
    sid = c.new_seq()
    toks = [_tok(i) for i in range(8)]  # 2 full pages
    for t in toks:
        c.append(sid, t, t)
    pages = c.compressible_pages()
    assert len(pages) == 2
    for p in pages:
        c.compress_page(p)
    k, _ = c.gather_seq(sid, layer=0, dtype=torch.float32)
    expect = torch.stack([t[0] for t in toks])
    scale = float(expect.abs().max()) / 127
    torch.testing.assert_close(k, expect, atol=2 * scale, rtol=0)
    assert c.stats["compressions"] == 2


def test_staging_slots_recycled_and_release_frees_everything():
    c = PagedKVCache(CFG, device="cpu")
    sid = c.new_seq()
    free0 = len(c.free_staging)
    for i in range(CFG.page_size * 2 + 2):   # 2 full pages + 1 partial
        c.append(sid, _tok(i), _tok(i))
    assert len(c.free_staging) == free0 - 3
    for p in c.compressible_pages():
        c.compress_page(p)
    assert len(c.free_staging) == free0 - 1  # only the partial page staged
    c.release_seq(sid)
    assert len(c.free_pages) == CFG.n_pages
    assert len(c.free_staging) == CFG.n_staging
    assert (c.page_state == -1).all()


@settings(max_examples=30, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 2), st.integers(0, 30)),
                    min_size=1, max_size=60))
def test_invariants_under_random_ops(ops):
    """No double-free / aliasing under arbitrary append/compress/release."""
    c = PagedKVCache(CFG, device="cpu")
    sids = []
    tok = _tok(0)
    for kind, arg in ops:
        if kind == 0 and len(sids) < CFG.max_seqs - 1:
            sids.append(c.new_seq())
        elif kind == 1 and sids:
            if not c.append(sids[arg % len(sids)], tok, tok):
                for p in c.compressible_pages():
                    c.compress_page(p, forced=True)
        elif kind == 2 and sids:
            c.release_seq(sids.pop(arg % len(sids)))
        used = [p for p in range(CFG.n_pages) if c.page_state[p] >= 0]
        assert len(set(c.free_pages)) == len(c.free_pages)
        assert set(used).isdisjoint(c.free_pages)
        staged = [p for p in used if c.page_state[p] == 1]
        slots = [int(c.staging_slot[p]) for p in staged]
        assert len(set(slots)) == len(slots)          # no slot aliasing
        assert set(slots).isdisjoint(c.free_staging)
        for sid in sids:
            for p in c.pages_of(sid):
                assert c.page_state[p] >= 0


def test_quant_error_bound():
    page = torch.from_numpy((RS.randn(2, 4, 2, 8) * 5).astype(np.float32))
    q, s = quantize_page(page)
    assert float(page_quant_error(page)) <= float(s.max()) * 0.51 + 1e-6
