"""Greedy token streams of the port's `EngineCore` (`repro_torch.serving`)
against the JAX package's `EngineCore` on the CPU, on the reference
lifecycle tests' model and prompts (`tests/test_serving_lifecycle.py`):
reduced qwen2-0.5b in float32 with the reference's `init(PRNGKey(0))`
weights carried across by `params_from_numpy`, the two 32-token prompts
without compression, and mixed prompts with compressions firing.

Bars (stated here): the logits of every decode call, recorded on both
sides, are held at `LOGITS` atol 1e-5 / rtol 1e-5 (float32 logits of
O(0.1) to O(1), measured differences below 1e-6). The streams are held
identical; that demand is sound only where no greedy pick is a near tie,
so the test asserts that every reference pick's top-2 margin exceeds the
bar, rather than loosening the bar where one is not.

The reference engine runs eagerly in JAX and compiles each op for each
new shape, so this file takes most of a minute on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced
from repro.kvcache import PagedKVConfig as JKVConfig
from repro.models import transformer as JT
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import EngineCore as JEngineCore
from repro.serving import paged_decode as jpd
from repro_torch.common.config import get_arch
from repro_torch.kvcache import PagedKVConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.dims import make_dims
from repro_torch.serving import EngineConfig, EngineCore
from repro_torch.serving import paged_decode as tpd

LOGITS = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def model():
    """(reference params, port params, port cfg, port dims)."""
    jcfg, jdims = reduced("qwen2-0.5b")
    jparams = JT.init(jax.random.PRNGKey(0), jcfg, jdims)
    cfg = get_arch("qwen2-0.5b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    return (jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu"), cfg, dims)


def _kv_kw(cfg, dims, **over):
    base = dict(n_layers=cfg.n_layers, n_kv_heads=dims.n_kv,
                head_dim=cfg.attention.head_dim, page_size=4, n_pages=64,
                n_staging=16, n_groups=4, max_seqs=8)
    base.update(over)
    return base


def _recording(fn, log):
    """`fn` (a decode forward) with each call's logits appended to `log`
    as a float32 numpy array."""
    def wrapped(*args):
        out = fn(*args)
        log.append(np.asarray(out[0], np.float32) if not isinstance(
            out[0], torch.Tensor) else out[0].float().numpy())
        return out
    return wrapped


def _run_both(model, prompts, max_new, dtype, kv_over, **ecfg):
    """The same prompts through the reference's EngineCore and the
    port's; returns (ref handles, port handles, ref engine, port engine,
    ref logits per decode call, port logits per decode call)."""
    jparams, params, cfg, dims = model
    jcfg, jdims = reduced("qwen2-0.5b")
    jl, tl = [], []
    kv = _kv_kw(cfg, dims, **kv_over)
    jeng = JEngineCore(jparams, jcfg, jdims,
                       JKVConfig(**kv, dtype={"float32": jnp.float32,
                                              "bfloat16": jnp.bfloat16}[dtype]),
                       JEngineConfig(**ecfg),
                       decode_fn=_recording(jpd.paged_decode_forward, jl))
    eng = EngineCore(params, cfg, dims,
                     PagedKVConfig(**kv, dtype=getattr(torch, dtype)),
                     EngineConfig(**ecfg),
                     decode_fn=_recording(tpd.paged_decode_forward, tl))
    jh = [jeng.submit(p, max_new, rid=i) for i, p in enumerate(prompts)]
    th = [eng.submit(p, max_new, rid=i) for i, p in enumerate(prompts)]
    jeng.run_until_done(max_rounds=200)
    eng.run_until_done(max_rounds=200)
    return jh, th, jeng, eng, jl, tl


def _hold_streams(jh, th, jl, tl):
    """No reference pick is a near tie (its top-2 margin exceeds the bar
    at the top logit), logits within `LOGITS` call by call, and the
    streams identical."""
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        v = np.isfinite(b)
        np.testing.assert_allclose(a[v], b[v], err_msg=f"decode call {i}",
                                   **LOGITS)
        top2 = np.sort(b, axis=-1)[:, -2:]
        bar = LOGITS["atol"] + LOGITS["rtol"] * np.abs(top2[:, 1])
        assert ((top2[:, 1] - top2[:, 0]) > 2 * bar).all(), (
            f"decode call {i}: a greedy pick within the bar of a tie")
    for j, t in zip(jh, th):
        assert t.state.value == j.state.value
        assert t.tokens == j.tokens, t.rid


def _lifecycle_prompts(vocab):
    return [[1 + i] + [(7 * j + 3 * i) % (vocab - 1) + 1 for j in range(31)]
            for i in range(2)]


def test_greedy_streams_equal_reference_without_compression(model):
    """The reference lifecycle test's batch (two 32-token prompts, `ideal`,
    staging large enough, red-line off): the port's EngineCore streams the
    reference EngineCore's tokens."""
    cfg = model[2]
    jh, th, jeng, eng, jl, tl = _run_both(
        model, _lifecycle_prompts(cfg.vocab_size), 3, "float32",
        dict(n_staging=24), policy="ideal", prefill_chunk=8,
        force_threshold=2.0)
    _hold_streams(jh, th, jl, tl)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert all(len(h.tokens) == 3 for h in th)
    assert eng.cache.stats == jeng.cache.stats
    assert eng.cache.stats["compressions"] == 0
    for k in ("rounds", "tokens", "prefill_calls", "decode_calls"):
        assert eng.stats[k] == jeng.stats[k], k


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_greedy_streams_equal_reference_with_compressions(model, dtype):
    """Mixed prompt lengths under `darp` with a staging pool small enough
    that scheduled and forced compressions fire (kernel D's plain version
    here): the same tokens, cache stats and maintenance events."""
    cfg = model[2]
    prompts = [[1 + i] + [(5 * j + i) % (cfg.vocab_size - 1) + 1
                          for j in range(n - 1)]
               for i, n in enumerate((5, 14, 9))]
    jh, th, jeng, eng, jl, tl = _run_both(
        model, prompts, 6, dtype, dict(n_staging=6), policy="darp",
        prefill_chunk=4)
    _hold_streams(jh, th, jl, tl)
    assert eng.cache.stats == jeng.cache.stats
    assert eng.cache.stats["compressions"] > 0
    assert eng.stats["maintenance_events"] == jeng.stats["maintenance_events"]
    assert eng.stats["stall_rounds"] == jeng.stats["stall_rounds"]
