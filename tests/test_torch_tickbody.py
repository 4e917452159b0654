"""Port parity, tick body: `select_batch_torch`, `arbiter_scores_torch`
and `torchbody.closed_body` of `repro_torch` against the JAX package's
numpy/jnp definitions, and `sweep(..., backend="torch", device="cpu")`
against the reference backends. Tolerance: none (exact equality)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.policy import list_policies
from repro.core.sweep import SweepSpec as RefSpec, sweep as ref_sweep
from repro.core.sweep import engine as ref_engine
from repro.core.sweep import jaxbody
from repro.core.sweep.arbiter import arbiter_scores
from repro.core.sweep.policies import (KIND_AB, KIND_DARP, KIND_ELASTIC,
                                       KIND_HIRA, KIND_IDEAL, KIND_RDARP,
                                       KIND_RR, select_batch)

from repro_torch.core.sweep import SweepSpec, sweep, torchbody
from repro_torch.core.sweep.policies import select_batch_torch
from repro_torch.kernels import sweep_arbiter as tarb

from _torch_parity import assert_cells_equal, spec_kwargs

POLICIES = tuple(list_policies())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ tie-breaks
def test_torch_argmax_returns_first_maximum():
    """The tie-break contract of every pick: lowest index wins."""
    x = torch.tensor([[3, 7, 7, 1, 7], [0, 0, 0, 0, 0], [-1, -1, 5, 5, -1]],
                     dtype=torch.int32)
    assert torch.argmax(x, dim=1).tolist() == [1, 0, 2]
    assert torch.argmax((x == 7).to(torch.int32), dim=1).tolist()[0] == 1
    big = torch.zeros((64, 4096), dtype=torch.int32)
    big[:, 1000:] = 9
    assert (torch.argmax(big, dim=1) == 1000).all()


# ---------------------------------------------------------- select_batch
def _select_planes(rs, G, B, kinds):
    """Random decision planes with planted ties: lags drawn from a tiny
    range so several banks share the maximum, budget edges hit, and
    whole rows are not ready / not idle."""
    kind = rs.choice(kinds, G).astype(np.int32)
    budget = np.full(G, 8, np.int32)
    lag = rs.randint(-9, 10, (G, B)).astype(np.int32)
    lag[rs.rand(G) < 0.15] = 2                       # all-tied rows
    ready = rs.rand(G, B) < 0.8
    ready[rs.rand(G) < 0.05] = False
    idle = rs.rand(G, B) < 0.7
    demand = (rs.randint(0, 4, (G, B)) * (rs.rand(G, B) < 0.5)
              ).astype(np.int32)
    demand[rs.rand(G) < 0.2] = 0                     # quiet cells
    return dict(kind=kind, lag=lag, ready=ready, idle=idle, demand=demand,
                write_window=rs.rand(G) < 0.4, budget=budget,
                wrp=rs.rand(G) < 0.5,
                urgent_at=rs.randint(1, 7, G).astype(np.int32),
                rr=rs.randint(0, 50, G).astype(np.int32))


@pytest.mark.parametrize("kinds", [
    (KIND_RR,), (KIND_DARP,), (KIND_RDARP,), (KIND_ELASTIC,), (KIND_HIRA,),
    (KIND_IDEAL, KIND_AB, KIND_RR, KIND_DARP, KIND_RDARP, KIND_ELASTIC,
     KIND_HIRA)], ids=["rr", "darp", "rdarp", "elastic", "hira", "mixed"])
@pytest.mark.parametrize("B,nb", [(8, 8), (32, 8)])
def test_select_batch_torch_equals_numpy(kinds, B, nb):
    rs = np.random.RandomState(7 + B + len(kinds))
    p = _select_planes(rs, 600, B, kinds)
    picks, rr = select_batch(np, nb=nb, **p)
    tp, trr = select_batch_torch(nb=nb, **{k: _t(v) for k, v in p.items()})
    assert tp.dtype == torch.bool and trr.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), picks)
    np.testing.assert_array_equal(trr.numpy(), rr)
    if kinds != (KIND_IDEAL,):
        assert picks.any()


# -------------------------------------------------------- arbiter scores
def _score_planes(rs, G, B, with_occ):
    """Random arbitration planes: ages planted equal (ties), whole rows
    ineligible (draining rank, busy banks), `t` past every arrival."""
    t = 5000
    p = dict(
        has_req=rs.rand(G, B) < 0.7,
        head_row=rs.randint(0, 4, (G, B)).astype(np.int32),
        head_arrive=(t - rs.randint(0, 3, (G, B)) * 100).astype(np.int32),
        head_is_write=rs.rand(G, B) < 0.4,
        bank_free=rs.randint(t - 50, t + 50, (G, B)).astype(np.int32),
        head_ref_until=rs.randint(t - 80, t + 20, (G, B)).astype(np.int32),
        bank_mid_ref=rs.rand(G, B) < 0.3,
        open_row=rs.randint(-1, 4, (G, B)).astype(np.int32),
        drain=rs.rand(G) < 0.5,
        rank_drain=np.repeat(rs.rand(G, B // 4) < 0.2, 4, axis=1))
    p["rank_drain"][rs.rand(G) < 0.1] = True          # ineligible rows
    p["head_arrive"][rs.rand(G) < 0.05] = -(1 << 20) - 7   # age saturates
    if with_occ:
        p["occ"] = rs.randint(0, 12, (G, B)).astype(np.int32)
    return t, p


@pytest.mark.parametrize("with_occ", [True, False], ids=["closed", "open"])
@pytest.mark.parametrize("G,B", [(257, 8), (64, 32)])
def test_arbiter_scores_torch_equals_numpy(G, B, with_occ):
    t, p = _score_planes(np.random.RandomState(G + B), G, B, with_occ)
    want = arbiter_scores(np, t, **p)
    got = tarb.arbiter_scores_torch(t, **{k: _t(v) for k, v in p.items()})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).all(axis=1).any() and (want >= 0).any()
    # the wrapper on CPU tensors takes the plain version (int32 planes)
    wrapped = tarb.sweep_arbiter(
        t, **{k: _t(v).to(torch.int32) for k, v in p.items()})
    np.testing.assert_array_equal(wrapped.numpy(), want)
    via_adapter = tarb.arbiter_for("cuda")(
        t, **{k: _t(v) for k, v in p.items()})
    np.testing.assert_array_equal(via_adapter.numpy(), want)


@pytest.mark.parametrize("fault", ["dtype", "shape", "stride", "drain"])
def test_arbiter_wrapper_rejects_bad_planes(fault):
    t, p = _score_planes(np.random.RandomState(1), 16, 8, True)
    p = {k: _t(v).to(torch.int32) for k, v in p.items()}
    if fault == "dtype":
        p["has_req"] = p["has_req"].to(torch.bool)
    elif fault == "shape":
        p["occ"] = p["occ"][:, :4].contiguous()
    elif fault == "stride":
        p["bank_free"] = p["bank_free"].t().contiguous().t()
    else:
        p["drain"] = p["drain"][:8]
    with pytest.raises((TypeError, ValueError)):
        tarb.sweep_arbiter(t, **p)
    assert tarb.LAUNCHES == 0           # no launch on the CPU, ever


def test_unknown_arbiter_raises():
    with pytest.raises(ValueError):
        tarb.arbiter_for("pallas")


# ------------------------------------------------- tick-by-tick parity
def _np_state(s):
    return {k: np.asarray(v) for k, v in s.items()}


def _compare_planes(ref_state, port_state, ctx):
    got = torchbody.state_to_numpy(port_state)
    assert set(got) == set(ref_state) and len(got) == 38
    for k, v in ref_state.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{ctx} plane {k}")


@pytest.mark.parametrize("grid_name,start,ticks", [
    ("flat", 0, 120), ("flat", 1270, 90), ("multirank", 1285, 70),
    ("subarray4", 1280, 60)])
def test_closed_body_tick_by_tick(grid_name, start, ticks):
    """Run the reference body to `start`, then for each of the next
    `ticks` ticks load the reference state into the port, advance both
    one tick and compare all 38 planes (the window past tick ~1300
    covers all-bank refresh accrual, rank drain and staggered starts)."""
    kw = dict(policies=POLICIES, densities=(32,), reqs=2000, seed=5,
              mode="closed")
    if grid_name == "flat":
        kw.update(scenarios=("closed_mixed", "closed_write_heavy"))
    elif grid_name == "multirank":
        # eight cores drain 2000 requests before the first tREFI: go longer
        kw.update(scenarios=("closed_multirank",), n_ranks=2, n_channels=2,
                  reqs=6000)
    else:
        kw.update(scenarios=("closed_subarray_storm",), n_subarrays=4)
    rgrid = ref_engine._Grid(RefSpec(**kw))
    rcfg = jaxbody.closed_cfg(rgrid)
    rcst = jaxbody.closed_consts(rgrid)
    scores = lambda t, **p: arbiter_scores(jax.numpy, t, **p)
    step = jax.jit(functools.partial(jaxbody.closed_body, rcfg, rcst,
                                     scores))
    s = jaxbody.closed_state0(rcfg, rcst)
    for _ in range(start):
        s = step(s)

    from repro_torch.core.sweep.engine import _Grid
    grid = _Grid(SweepSpec(**kw))
    cfg = torchbody.closed_cfg(grid)
    assert (cfg.B, cfg.S, cfg.C, cfg.N, cfg.K, cfg.LQ, cfg.has_stag,
            cfg.has_hra) == (rcfg.B, rcfg.S, rcfg.C, rcfg.N, rcfg.K,
                             rcfg.LQ, rcfg.has_stag, rcfg.has_hra)
    cst = torchbody.consts_from_numpy(_np_state(rcst))
    own = torchbody.closed_consts(grid)
    for k, v in cst.items():             # the port's consts match too
        if k == "horizon":
            assert own[k] == v
        else:
            assert torch.equal(own[k], v), k
    if start == 0:
        _compare_planes(_np_state(s), torchbody.closed_state0(cfg, cst),
                        "state0")
    free_run = torchbody.state_from_numpy(_np_state(s))
    for i in range(ticks):
        loaded = torchbody.state_from_numpy(_np_state(s))
        assert bool(jaxbody.closed_cond(rcst, s)) \
            == torchbody.closed_cond(cst, loaded)
        s = step(s)
        ref_np = _np_state(s)
        _compare_planes(ref_np, torchbody.closed_body(
            cfg, cst, tarb.arbiter_scores_torch, loaded),
            f"{grid_name} t={start + i} (loaded)")
        free_run = torchbody.closed_body(cfg, cst,
                                         tarb.arbiter_scores_torch, free_run)
    _compare_planes(ref_np, free_run, f"{grid_name} free run")
    if start:
        assert ref_np["refab"].sum() > 0 and ref_np["refpb"].sum() > 0


# --------------------------------------------------- the torch backend
def test_torch_backend_equals_reference_jax_and_batched():
    kw = spec_kwargs("kernels", None)
    port = sweep(SweepSpec(**kw), "torch", device="cpu")
    assert_cells_equal(ref_sweep(RefSpec(**kw), "jax"), port, "jax")
    assert_cells_equal(ref_sweep(RefSpec(**kw), "batched"), port, "batched")


@pytest.mark.parametrize("grid", ["conformance", "multirank", "subarray1",
                                  "subarray4"])
@pytest.mark.parametrize("arbiter", ["torch", "cuda"])
def test_torch_backend_equals_reference_batched(grid, arbiter):
    """`arbiter="cuda"` on CPU tensors exercises the kernel wrapper's
    checks and casts; the wrapper then takes the plain version."""
    kw = spec_kwargs(grid, POLICIES)
    port = sweep(SweepSpec(**kw), "torch", arbiter=arbiter, device="cpu")
    assert_cells_equal(ref_sweep(RefSpec(**kw), "batched"), port, grid)


def test_torch_backend_guards():
    from repro_torch.core.policy import PolicyBase
    from repro_torch.core.policy import registry

    class Custom(PolicyBase):
        name = "torch_test_custom"

        def select(self, view):
            return []

    registry.register_policy("torch_test_custom", Custom, override=True)
    try:
        spec = SweepSpec(policies=("torch_test_custom",),
                         scenarios=("closed_mixed",), densities=(8,),
                         reqs=32, mode="closed")
        with pytest.raises(ValueError, match="batched"):
            sweep(spec, "torch", device="cpu")
    finally:
        registry._REGISTRY.pop("torch_test_custom")
    with pytest.raises(ValueError, match="n_shards"):
        sweep(SweepSpec(**spec_kwargs("kernels", None)), "torch",
              n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="unknown sweep backend"):
        sweep(SweepSpec(**spec_kwargs("kernels", None)), "jax")
