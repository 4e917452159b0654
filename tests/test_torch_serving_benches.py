"""The port's serving benches (`benchmarks_torch/bench_framework.py`:
`bench_serving`, `bench_serving_lifecycle`, `bench_serving_cosim`) and
their `benchmarks_torch/run.py` entries, on the CPU at `run.py --fast`'s
arguments, against the reference's committed artifacts
(`results/bench/serving_{policies,lifecycle,cosim}.json`) through
`chip_smoke.check_serving_artifacts`: every scheduling field equal.

The reference draws its weights with JAX, the port with torch: the
tokens generated differ, the scheduling does not (the engine makes
`max_new` tokens a request and schedules on rounds and page occupancy).
What is not compared is the wall clock (`wall_s`, `tok_per_s`, the
`*_ms` percentiles), which no two runs share. The co-sim's summaries are
tick-space and compared whole."""
import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the repo root's device check)
from benchmarks_torch import bench_framework as BF  # noqa: E402
from benchmarks_torch import fig_refresh as FR  # noqa: E402


@pytest.fixture(scope="module")
def fast():
    """The three payloads at `run.py --fast`'s arguments, on the CPU."""
    return {
        "serving_policies": BF.bench_serving(
            n_requests=4, max_new=12, policies=FR.SERVING_POLICIES,
            device="cpu"),
        "serving_lifecycle": BF.bench_serving_lifecycle(
            n_requests=4, max_new=8, device="cpu"),
        "serving_cosim": BF.bench_serving_cosim(
            n_requests=200, scenario="serving_bursty",
            policies=("darp", "all_bank"), device="cpu")}


def test_serving_benches_reproduce_the_reference_scheduling(fast):
    cs.check_serving_artifacts(fast)


@pytest.mark.parametrize("entry", ["serving_policies", "serving_lifecycle",
                                   "serving_cosim"])
def test_each_payload_has_the_reference_keys(fast, entry):
    """Each payload carries the reference artifact's keys, at every
    level the artifact has (the co-sim's fast run has two of its four
    policies)."""
    want = cs.load_artifact(entry)
    got = fast[entry]
    keys = set(want) if entry != "serving_cosim" else (
        set(want) - {"dsarp", "ref_pb"})
    assert set(got) == keys
    for k, v in got.items():
        if isinstance(v, dict) and isinstance(want.get(k), dict):
            assert set(v) == set(want[k]), (entry, k)


def test_lifecycle_raises_on_a_timeout():
    with pytest.raises(RuntimeError, match="did not drain"):
        BF.bench_serving_lifecycle(n_requests=2, max_new=4, max_rounds=2,
                                   policies=("darp",), device="cpu")


def test_run_py_writes_the_serving_entries(tmp_path, monkeypatch):
    """`run.py --fast --device cpu` runs the three serving entries and
    writes their payloads, each equal in scheduling to the reference's,
    and the training bench (`darp_ckpt`, here a stand-in that returns the
    reference's artifact: its own test, with the real trainer, is
    `tests/test_torch_checkpoint.py`) at `--fast`'s 20 steps on the
    CPU."""
    spec = importlib.util.spec_from_file_location(
        "bench_run_torch_cpu", ROOT / "benchmarks_torch" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert "serving_lifecycle" in run.__doc__ and "darp_ckpt" in run.__doc__
    calls = {}
    for name in ("bench_serving", "bench_serving_lifecycle",
                 "bench_serving_cosim"):
        real = getattr(BF, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = kw
            return _real(*a, **kw)
        monkeypatch.setattr(run.BF, name, spy)

    def ckpt_stub(**kw):
        calls["bench_darp_ckpt"] = kw
        return cs.load_artifact("darp_ckpt")
    monkeypatch.setattr(run.BF, "bench_darp_ckpt", ckpt_stub)
    for name in ("fig_grids", "fig1", "fig2", "fig3", "sweep_grid",
                 "closed_loop", "sweep_multirank", "sweep_subarray",
                 "command_trace"):
        monkeypatch.setattr(run.FR, name, _figure_stub(name))
    assert run.main(["--fast", "--device", "cpu", "--out",
                     str(tmp_path)]) == 0
    assert all(kw["device"] == "cpu" for kw in calls.values()), calls
    got = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert {"serving_policies", "serving_lifecycle", "serving_cosim",
            "sarp_decode_bytes", "device"} <= set(got)
    assert calls["bench_darp_ckpt"] == {"steps": 20, "device": "cpu"}
    assert got["darp_ckpt"] == cs.load_artifact("darp_ckpt")
    cs.check_serving_artifacts(got)


def _figure_stub(name):
    """A stand-in for a figure script (those have their own tests in
    `tests/test_torch_figures.py`) with the keys `run.py` prints."""
    def stub(*a, **kw):
        if name == "fig_grids":
            return []
        if name == "fig1":
            return {32: {"ref_pb": 0.0, "ref_ab": 0.0}}
        if name == "fig2":
            return {"ref_pb": {"p99_read_ns": 0}, "sarp_pb": {
                "p99_read_ns": 0, "serves_during_sibling_refresh": 0}}
        if name == "fig3":
            return {32: {"dsarp": {"improvement_vs_refab": 0.0,
                                   "energy_vs_refab": 0.0}}}
        if name in ("sweep_multirank", "sweep_subarray"):
            key, n, pol = (("per_rank_count", 2, ("dsarp", "ref_ab"))
                           if name == "sweep_multirank" else
                           ("per_subarray_count", 8, ("sarp_pb", "ref_pb")))
            return {"bit_identical": True, key: {n: {
                "weighted_speedup_vs_ideal": {p: {32: 0.0} for p in pol}}}}
        return {"speedup_vs_dramsim_loop": 0, "speedup_vs_scalar_tick": 0,
                "speedup_vs_dramsim_ticks": 0, "bit_identical": True,
                "overhead_pct": 0, "violations": 0}
    return stub
