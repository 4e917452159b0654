"""The port's figure, bench, example and tool scripts against the JAX
package's: `benchmarks_torch/fig_refresh.py` and `bench_framework.py`
against `benchmarks/` and the committed `results/bench/*.json` (made by
the reference's `benchmarks/run.py --fast`), `examples/dram_sweep_torch.py`
against `examples/dram_sweep.py`, `tools/check_commands_torch.py` against
`tools/check_commands.py`.

Tolerance everywhere: none. The figures' floats are means over the same
`CellResult` values in the same order, so they are equal bit for bit;
JSON is compared as loaded JSON (its keys are strings). Timings are not
compared. The port's megakernel backend runs here through its plain
PyTorch version (`device="cpu"`); the card's run is in
`tests/test_torch_gpu.py` and `chip_smoke.py`."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import fig_refresh as RFR  # noqa: E402
from benchmarks_torch import bench_framework as BF  # noqa: E402
from benchmarks_torch import fig_refresh as FR  # noqa: E402

ARTIFACTS = ROOT / "results" / "bench"


def _artifact(name):
    return json.loads((ARTIFACTS / f"{name}.json").read_text())


def _as_json(obj):
    return json.loads(json.dumps(obj, default=str))


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fig1_fig3_batched_equal_the_committed_artifacts():
    """`run.py --fast`'s load (reqs=800) on the host engine: every float
    of Figures 1 and 3 equals the reference's committed artifacts."""
    runs = FR.fig_grids(reqs=800, backend="batched")
    assert _as_json(FR.fig1(runs=runs)) == _artifact("fig1_refresh_loss")
    assert _as_json(FR.fig3(runs=runs)) == _artifact("fig3_dsarp")


def test_fig1_fig3_on_the_megakernel_path_equal_the_reference():
    """`backend="mega"` through its plain version, both the shared grids
    (`runs=`) and fig1's own sweep, against the reference's functions on
    its default backend at the same load."""
    reqs = 120
    ref_runs = RFR.fig_grids(reqs=reqs)
    runs = FR.fig_grids(reqs=reqs, backend="mega", device="cpu")
    assert all(r.backend == "mega" for r in runs)
    assert FR.fig3(runs=runs) == RFR.fig3(runs=ref_runs)
    want = RFR.fig1(runs=ref_runs)
    assert FR.fig1(runs=runs) == want
    assert FR.fig1(reqs=reqs, backend="mega", device="cpu") == want


def test_fig2_equals_the_artifact_and_the_reference():
    got = FR.fig2()
    assert _as_json(got) == _artifact("fig2_sarp_timeline")
    assert got == RFR.fig2()


@pytest.mark.parametrize("name,fn,key", [
    ("sweep_multirank", "sweep_multirank", "per_rank_count"),
    ("sweep_subarray", "sweep_subarray", "per_subarray_count")])
def test_hierarchy_sweeps_equal_the_artifacts(name, fn, key):
    got = _as_json(getattr(FR, fn)(fast=True))
    want = _artifact(name)
    assert got["grid"] == want["grid"]
    assert got["bit_identical"] is True
    assert list(got[key]) == list(want[key])
    for n in want[key]:
        assert (got[key][n]["weighted_speedup_vs_ideal"]
                == want[key][n]["weighted_speedup_vs_ideal"]), n


def test_closed_loop_is_bit_identical_on_the_artifact_grid():
    got = FR.closed_loop(fast=True)
    want = _artifact("sweep_closed_loop")
    assert got["grid"] == want["grid"]
    assert got["bit_identical"] is True


def test_command_trace_equals_the_artifact():
    got = _as_json(FR.command_trace(fast=True))
    want = _artifact("command_trace")
    for k in ("workload", "commands", "counts", "violations",
              "bit_identical", "disabled_emits_trace"):
        assert got[k] == want[k], k
    assert got["violations"] == 0 and got["bit_identical"] is True


def test_sarp_bytes_equals_the_artifact():
    assert _as_json(BF.bench_sarp_bytes()) == _artifact("sarp_decode_bytes")


def _demand_fields(d):
    return {f.name: (getattr(d, f.name).tolist()
                     if isinstance(getattr(d, f.name), np.ndarray)
                     else getattr(d, f.name))
            for f in dataclasses.fields(d) if f.name != "workload"}


def test_mega_ladder_spec_gives_the_reference_cells_in_order():
    got, want = FR.mega_ladder_spec(24), RFR.mega_ladder_spec(24)
    assert (got.policies, got.densities, got.reqs, got.seed, got.mode) == (
        want.policies, want.densities, want.reqs, want.seed, want.mode)
    assert len(got.scenarios) == len(want.scenarios) == 24
    for a, b in zip(got.scenarios, want.scenarios):
        assert _demand_fields(a) == _demand_fields(b), b.name
        assert dataclasses.asdict(a.workload) == dataclasses.asdict(
            b.workload), b.name
    assert ([(p, s.name, d) for p, s, d in got.cells()]
            == [(p, s.name, d) for p, s, d in want.cells()])


def test_check_commands_tool_matches_the_reference_tool():
    port = _load_script("tools/check_commands_torch.py",
                        "check_commands_torch")
    ref = _load_script("tools/check_commands.py", "check_commands_ref")
    lines = []
    for main in (port.main, ref.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([]) == 0
        lines.append(buf.getvalue().strip().splitlines()[-1])
    # the closing line, seconds apart: "N traces, M commands, 0 problem(s)"
    assert [ln.rsplit(",", 1)[0] for ln in lines] == [
        "check_commands: 56 traces, 6633 commands, 0 problem(s)"] * 2
    assert all(ln.endswith("(ok)") for ln in lines)


def test_example_prints_the_reference_example_lines():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join((str(ROOT / "src"), str(ROOT))))
    outs = [subprocess.run([sys.executable, str(ROOT / script), *extra],
                           cwd=str(ROOT), env=env, capture_output=True,
                           text=True, timeout=600, check=True).stdout
            for script, extra in (
                ("examples/dram_sweep_torch.py", ["--fast", "--device",
                                                  "cpu"]),
                ("examples/dram_sweep.py", ["--fast"]))]
    assert "== Figure 3" in outs[1]
    assert outs[0] == outs[1]
