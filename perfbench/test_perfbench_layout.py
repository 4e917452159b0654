"""The benchmark's files hold together, and import what they may.

Every cell of `BENCHMARK.json` has its workload file, configuration file
and runner; every per-layer metric its reader; names and units keep to
the benchmark's rules; nothing under `perfbench/` imports JAX, the JAX
package (`repro`) or the repository's other benchmark folders, and the
reference imports nothing of the program (`repro_torch`)."""
import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: Path) -> set:
    """Top-level names of every module the file imports (relative
    imports resolve inside `perfbench`)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("perfbench" if node.level else
                    node.module.split(".")[0])
    return out


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]] + PER_LAYER)
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file_loads(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    f = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert f["name"] == cell and f["config"] == w["config"]
    assert f["chips"] == w["chips"] == 1
    assert f["why"] == w["why"] and len(w["why"]) <= 200
    assert (HERE / "runners" / f"{f['runner']}.py").is_file()
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert json.loads((ROOT / cfg["file"]).read_text())["name"] == cfg["name"]
    e2e = [m for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell]) and m["name"] != "setup_s"]
    assert e2e, "a cell reports an end-to-end metric besides setup_s"
    reported = {m["name"] for m in e2e}
    mine = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])]
    assert mine and all(m["moves"] in reported for m in mine)


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    assert mod.read({"kernels": [], "busy": [], "window": (0.0, 1.0),
                     "spans": [], "counters": {}, "config": {},
                     "workload": {}}) in (None, 100.0)
    assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}
    # the harness reads a metric in the cells it lists, and in no other
    assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_configs_are_used_and_own_their_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and len(c["source"]) <= 200


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_no_repro_no_other_benchmarks(path):
    bad = imported_tops(path) & {"jax", "jaxlib", "flax", "repro",
                                 "benchmarks", "benchmarks_torch"}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported_tops(path), path


def test_import_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.kernels\nfrom reprox import y\n")
    assert imported_tops(f) == {"repro_torch", "reprox"}
    f.write_text("from repro.core import x\n")
    assert "repro" in imported_tops(f)
