"""The port's serving path (`repro_torch.serving`: `paged_decode`, the
request-lifecycle `EngineCore`, the co-simulation, and the
`DarpScheduler` copy) against the JAX package's on the CPU, and the
reference lifecycle tests (`tests/test_serving_lifecycle.py`) repeated on
the port. `tests/test_torch_serving_streams.py` holds the two engines'
greedy streams against each other.

The model is the reference lifecycle tests': reduced qwen2-0.5b in
float32, the reference's `init(PRNGKey(0))` weights carried across by
`params_from_numpy`.

Bars (stated here): the paged forwards' K/V and logits at `LOGITS` atol
1e-5 / rtol 1e-5 (float32 values of O(0.1) to O(1), measured differences
below 1e-6); greedy streams, co-sim summaries and scheduler picks are
compared exactly.
"""
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced
from repro.core.refresh import list_serving_scenarios
from repro.core.scheduler import DarpScheduler as JDarp
from repro.core.scheduler import SchedulerPolicy as JPolicy
from repro.kvcache import PagedKVConfig as JKVConfig
from repro.models import transformer as JT
from repro.serving import paged_decode as jpd
from repro.serving.cosim import CoSimConfig as JCoSimConfig
from repro.serving.cosim import run_cosim as jrun_cosim
from repro_torch.common.config import get_arch
from repro_torch.core.policy import MaintenanceLedger
from repro_torch.core.scheduler import DarpScheduler, SchedulerPolicy
from repro_torch.kvcache import PagedKVCache, PagedKVConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.dims import make_dims
from repro_torch.serving import (CoSimConfig, CoSimTimeout, EngineConfig,
                                 EngineCore, QueueFull, Request,
                                 RequestState, ServeConfig, ServingEngine,
                                 bit_identical_replay, run_cosim)
from repro_torch.serving import paged_decode as tpd
from repro_torch.serving.paged_decode import FORWARD_CALLS

LOGITS = dict(atol=1e-5, rtol=1e-5)
#: the committed reference artifact of `bench_serving_cosim` (200
#: requests of serving_bursty, seed 0, four policies best to worst)
COSIM_ARTIFACT = (pathlib.Path(__file__).resolve().parents[1] / "results"
                  / "bench" / "serving_cosim.json")


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


def _engine(model, kv_over=None, **ecfg):
    _, params, cfg, dims = model
    kv = _kv_kw(cfg, dims, dtype=torch.float32, **(kv_over or {}))
    return EngineCore(params, cfg, dims, PagedKVConfig(**kv),
                      EngineConfig(**ecfg))


def _lifecycle_prompts(vocab):
    """The reference lifecycle test's two 32-token prompts."""
    return [[1 + i] + [(7 * j + 3 * i) % (vocab - 1) + 1 for j in range(31)]
            for i in range(2)]


def _legacy_greedy(model, kv_cfg, prompts, max_new):
    """The pre-EngineCore loop on the port: token-at-a-time prefill
    through the decode path, then batched greedy decode."""
    _, params, cfg, dims = model
    cache = PagedKVCache(kv_cfg, device="cpu")
    reqs = []
    for prompt in prompts:
        sid = cache.new_seq()
        for tok in prompt[:-1]:
            _, k, v = tpd.paged_decode_forward(params, cfg, dims, cache,
                                               [sid], torch.tensor([tok]))
            assert cache.append(sid, k[:, 0], v[:, 0])
        reqs.append({"sid": sid, "next": prompt[-1], "out": []})
    while any(len(r["out"]) < max_new for r in reqs):
        act = [r for r in reqs if len(r["out"]) < max_new]
        logits, k, v = tpd.paged_decode_forward(
            params, cfg, dims, cache, [r["sid"] for r in act],
            torch.tensor([r["next"] for r in act]))
        nxt = torch.argmax(logits, -1).numpy()
        for bi, r in enumerate(act):
            assert cache.append(r["sid"], k[:, bi], v[:, bi])
            r["out"].append(int(nxt[bi]))
            r["next"] = int(nxt[bi])
    return [r["out"] for r in reqs]


def test_chunked_prefill_equals_token_at_a_time_in_fewer_calls(model):
    """As the reference's `test_greedy_equivalence_and_call_reduction`:
    chunked prefill streams the legacy loop's tokens in >= 3x fewer
    forward calls, with streaming callbacks and lifecycle metrics."""
    _, _, cfg, dims = model
    prompts = _lifecycle_prompts(cfg.vocab_size)
    kv = PagedKVConfig(**_kv_kw(cfg, dims, n_staging=24, dtype=torch.float32))
    c0 = sum(FORWARD_CALLS.values())
    ref = _legacy_greedy(model, kv, prompts, 3)
    legacy_calls = sum(FORWARD_CALLS.values()) - c0
    eng = _engine(model, kv_over=dict(n_staging=24), policy="ideal",
                  prefill_chunk=8, force_threshold=2.0)
    streamed = []
    handles = [eng.submit(p, 3, rid=i,
                          on_token=lambda h, t: streamed.append((h.rid, t)))
               for i, p in enumerate(prompts)]
    c0 = sum(FORWARD_CALLS.values())
    eng.run_until_done(max_rounds=100)
    core_calls = sum(FORWARD_CALLS.values()) - c0
    assert [h.tokens for h in handles] == ref
    assert legacy_calls >= 3 * core_calls, (legacy_calls, core_calls)
    for h in handles:
        assert [t for r, t in streamed if r == h.rid] == h.tokens
        m = h.metrics
        assert m.admit_round >= m.submit_round >= 0
        assert m.first_token_round >= m.admit_round
        assert m.finish_round >= m.first_token_round
        assert np.isfinite(h.ttft) and np.isfinite(h.tpot)
        assert m.prefill_chunks == 4                   # ceil(31 / 8)


def test_paged_forwards_match_reference_on_one_cache_state(model):
    """`paged_prefill_forward` and `paged_decode_forward` on the same
    cache state (staged and compressed pages, bf16 staging) in both
    packages: K/V and logits within the bar."""
    jparams, params, cfg, dims = model
    jcfg, jdims = reduced("qwen2-0.5b")
    kv = _kv_kw(cfg, dims)
    from repro.kvcache import PagedKVCache as JCache
    jc = JCache(JKVConfig(**kv))
    c = PagedKVCache(PagedKVConfig(**kv), device="cpu")
    chunks = [[3, 9, 27, 81], [11, 13]]
    sids = [c.new_seq() for _ in chunks]
    assert sids == [jc.new_seq() for _ in chunks]
    for rnd in range(2):
        k, v = tpd.paged_prefill_forward(params, cfg, dims, c, sids, chunks)
        jk, jv = jpd.paged_prefill_forward(jparams, jcfg, jdims, jc, sids,
                                           chunks)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **LOGITS)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **LOGITS)
        for bi, sid in enumerate(sids):
            for t in range(len(chunks[bi])):
                assert c.append(sid, k[:, bi, t], v[:, bi, t])
                assert jc.append(sid, jk[:, bi, t], jv[:, bi, t])
        if rnd == 0:
            for g in range(4):
                assert c.compress_group(g) == jc.compress_group(g)
    assert c.stats["compressions"] > 0
    toks = [4, 8]
    logits, k, v = tpd.paged_decode_forward(params, cfg, dims, c, sids,
                                            torch.tensor(toks))
    jlogits, jk, jv = jpd.paged_decode_forward(
        jparams, jcfg, jdims, jc, sids, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **LOGITS)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **LOGITS)


# ------------------------------------------ the reference's lifecycle tests

def test_empty_prompt_and_zero_max_new_finish_at_submit(model):
    eng = _engine(model)
    h_empty = eng.submit([], max_new=8)
    h_zero = eng.submit([1, 2, 3], max_new=0)
    assert h_empty.state is RequestState.DONE and h_empty.tokens == []
    assert h_zero.state is RequestState.DONE and h_zero.tokens == []
    assert not eng.has_work()
    eng.run_until_done()
    assert eng.stats["rounds"] == 0 and not eng.stats["timed_out"]


def test_queue_full_backpressure(model):
    eng = _engine(model, max_queue=2)
    h1 = eng.submit([1, 2], max_new=1)
    h2 = eng.submit([1, 3], max_new=1)
    assert eng.would_block()
    with pytest.raises(QueueFull):
        eng.submit([1, 4], max_new=1)
    assert eng.stats["rejected"] == 1
    eng.run_until_done(max_rounds=50)
    assert h1.state is RequestState.DONE and h2.state is RequestState.DONE
    assert not eng.would_block()


def test_eviction_under_page_exhaustion(model):
    eng = _engine(model, kv_over=dict(n_pages=4, n_staging=4,
                                      max_pages_per_seq=8),
                  policy="ideal", max_batch=2)
    short = eng.submit([1, 2, 3], max_new=6, rid=0)
    long = eng.submit([1, 2, 4], max_new=30, rid=1)
    eng.run_until_done(max_rounds=200)
    assert not eng.stats["timed_out"]
    assert short.state is RequestState.DONE and len(short.tokens) == 6
    assert long.state is RequestState.EVICTED and len(long.tokens) < 30
    assert eng.stats["evictions"] == 1
    assert len(eng.cache.free_pages) == eng.cache.cfg.n_pages
    assert len(eng.cache.free_staging) == eng.cache.cfg.n_staging


def test_timed_out_recorded_not_masked(model):
    eng = _engine(model, policy="ideal")
    h = eng.submit([1, 2, 3], max_new=30)
    with pytest.warns(RuntimeWarning, match="max_rounds"):
        eng.run_until_done(max_rounds=2)
    assert eng.stats["timed_out"] and not h.done
    eng.run_until_done(max_rounds=200)
    assert not eng.stats["timed_out"] and h.state is RequestState.DONE


def test_registry_hot_path_has_no_darpscheduler(model):
    import repro_torch.serving.engine as E
    imports = [l for l in inspect.getsource(E).splitlines()
               if l.lstrip().startswith(("from ", "import "))]
    assert not any("scheduler" in l or "DarpScheduler" in l for l in imports)
    eng = _engine(model, policy="darp")
    assert eng.policy.name == "darp"
    assert isinstance(eng.ledger, MaintenanceLedger)
    eng2 = _engine(model, policy=SchedulerPolicy.ALL_BANK)
    assert eng2.policy.name == "all_bank"


def test_maintenance_counts_stall_once_per_round(model):
    eng = _engine(model, kv_over=dict(n_pages=64, n_staging=3),
                  policy="ideal", force_threshold=0.5, max_batch=1)
    h = eng.submit([1, 2, 3, 4, 5, 6], max_new=10)
    eng.run_until_done(max_rounds=100)
    assert h.state is RequestState.DONE
    assert eng.stats["stall_rounds"] <= eng.stats["rounds"]
    assert h.metrics.stall_rounds == eng.stats["stall_rounds"]


def test_legacy_shim_runs_unchanged(model):
    _, params, cfg, dims = model
    with pytest.warns(DeprecationWarning):
        eng = ServingEngine(params, cfg, dims,
                            PagedKVConfig(**_kv_kw(cfg, dims,
                                                   dtype=torch.float32)),
                            ServeConfig(max_batch=2, policy="darp",
                                        refresh_interval=3.0))
    reqs = [Request(prompt=[1 + i, 2, 3], max_new=4, rid=i)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_rounds=200)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    for key in ("rounds", "tokens", "stall_rounds", "maintenance_events"):
        assert key in eng.stats
    assert eng.stats["tokens"] == 12
    assert eng.cache.stats["appends"] > 0
    empty = Request(prompt=[], max_new=4, rid=99)
    eng.submit(empty)
    assert empty.done and empty.out == []


def test_engine_device_follows_the_params_else_the_card(model):
    eng = _engine(model)
    assert eng.device.type == "cpu" and eng.cache.device.type == "cpu"
    kv = PagedKVConfig(n_layers=1, n_kv_heads=1, head_dim=4)
    stub = EngineCore(None, None, None, kv, device="cpu")
    assert stub.cache.k_pages.device.type == "cpu"
    assert (inspect.signature(CoSimConfig).parameters["device"].default
            == "cuda")


# ------------------------------------------------------------------ co-sim

@pytest.mark.parametrize("scenario", sorted(list_serving_scenarios()))
def test_cosim_summary_bit_identical_to_reference(scenario):
    kw = dict(scenario=scenario, policy="darp", n_requests=40, seed=0)
    got = run_cosim(CoSimConfig(device="cpu", **kw)).summary()
    want = jrun_cosim(JCoSimConfig(**kw)).summary()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_cosim_reproduces_the_reference_artifact_and_its_ordering():
    """`bench_serving_cosim`'s 200-request serving_bursty run under the
    four policies, field for field against the reference's committed
    artifact, with its dsarp <= darp <= ref_pb <= all_bank ordering of
    TTFT p99, TPOT p99 and the DRAM stall."""
    with open(COSIM_ARTIFACT) as f:
        art = json.load(f)
    pols = art["policies"]
    assert pols == ["dsarp", "darp", "ref_pb", "all_bank"]
    out = {p: run_cosim(CoSimConfig(policy=p, n_requests=art["n_requests"],
                                    scenario=art["scenario"],
                                    seed=art["seed"], device="cpu")).summary()
           for p in pols}
    for p in pols:
        assert json.dumps(out[p], sort_keys=True) == json.dumps(
            art[p], sort_keys=True), p
    for key in (lambda s: s["ttft_ticks"]["p99"],
                lambda s: s["tpot_ticks"]["p99"],
                lambda s: s["dram_stall_ticks"]):
        vals = [key(out[p]) for p in pols]
        assert all(a <= b for a, b in zip(vals, vals[1:])), vals
    assert art["ttft_p99_ordered"] and art["stall_ordered"]


def test_cosim_replay_is_bit_identical_and_timeout_raises():
    assert bit_identical_replay(CoSimConfig(
        scenario="serving_bursty", policy="darp", n_requests=24, seed=1,
        device="cpu"))
    with pytest.raises(CoSimTimeout):
        run_cosim(CoSimConfig(scenario="serving_bursty", n_requests=30,
                              seed=0, max_rounds=3, device="cpu"))


# --------------------------------------------------------- DarpScheduler

@pytest.mark.parametrize("policy", list(SchedulerPolicy) + ["hira",
                                                            "elastic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_darp_scheduler_equals_reference(policy, seed):
    """The copy picks what the reference picks, call for call, under
    random demand, write windows, ready and idle masks; lags, overdue
    banks and snapshot ages agree, and the budget invariant holds."""
    name = policy.value if isinstance(policy, SchedulerPolicy) else policy
    jpol = JPolicy(name) if isinstance(policy, SchedulerPolicy) else name
    rs = np.random.RandomState(seed)
    n, budget = int(rs.randint(2, 9)), int(rs.randint(1, 6))
    a = DarpScheduler(n, interval=3.0, budget=budget, policy=policy)
    b = JDarp(n, interval=3.0, budget=budget, policy=jpol)
    for t in range(120):
        now = float(t) * 0.75
        kw = dict(demand=rs.randint(0, 3, n).tolist(),
                  write_window=bool(rs.rand() < 0.4),
                  max_issues=int(rs.randint(1, n + 1)))
        if rs.rand() < 0.5:
            kw["ready"] = (rs.rand(n) < 0.8).tolist()
            kw["idle"] = (rs.rand(n) < 0.6).tolist()
        assert a.select(now, **kw) == b.select(now, **kw), t
        a.check_invariant(now)
        assert [a.lag(i, now) for i in range(n)] == [
            b.lag(i, now) for i in range(n)]
        assert a.overdue(now) == b.overdue(now)
        assert [a.snapshot_age(i, now) for i in range(n)] == [
            b.snapshot_age(i, now) for i in range(n)]
