"""The second half of `test_torch_dryrun_pods.py` (its docstring states
(a) to (e)): (a) on (pod=2, data=16, model=16), and (d) `run_cell`
through the CLI on the reduced qwen2-0.5b and a reduced MoE (16
experts, which the model ways divide) at small shapes, on both pod
meshes: `ok` records of 256 / 512 devices whose per-device product
FLOPs x devices are at least the one-card record's, with collectives
over InfiniBand and the collective term at its rate; the CLI's three
flags choose the meshes. Every fake world runs in a process of its own.

Tolerance: none (shapes, bytes and counts are integers; the ratios are
held to the same expressions).
"""
import pytest

from repro_torch.common.config import applicable_shapes, get_arch, list_archs
from repro_torch.parallel import op_analysis as OA

import _torch_dist_workers as W
from _torch_pod_shapes import both_sides, hold_cell

MESH = "pod2x16x16"
MESHES = ["pod16x16", "pod2x16x16"]
DEVICES = {"pod16x16": 256, "pod2x16x16": 512}
CELLS = [(arch, shape.name) for arch in list_archs()
         for shape in applicable_shapes(get_arch(arch))]


# ------------------------------------------------------------------ (a)

@pytest.fixture(scope="module")
def shapes():
    return both_sides(MESH, CELLS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_local_shapes_equal_the_reference_shard_shapes(shapes, arch, shape):
    hold_cell(MESH, *shapes, arch, shape)


# ------------------------------------------------------------------ (d)

ARCHS = ["qwen2-0.5b", "qwen3-moe-235b-a22b"]
FLAGS = {"": ["h100x1", "pod16x16", "pod2x16x16"],
         "--one-card-only": ["h100x1"], "--single-pod-only": ["pod16x16"],
         "--multi-pod-only": ["pod2x16x16"]}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dryrun_pods")
    runs = [(["--arch", arch, "--shape", shape], str(base / "all"))
            for arch in ARCHS for shape in W.TINY_SHAPES]
    runs += [(["--arch", ARCHS[0], "--shape", "tiny_decode"]
              + ([flag] if flag else []), str(base / f"flag{i}"))
             for i, flag in enumerate(FLAGS)]
    out = W.run_alone(W.dryrun_cli_worker, runs=runs, timeout=300)
    return out[:-len(FLAGS)][-1]["records"], out[-len(FLAGS):]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", list(W.TINY_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pod_record_counts_at_least_the_one_card_work(cli_runs, arch, shape,
                                                      mesh):
    recs, _ = cli_runs
    one = recs[f"{arch}__{shape}__h100x1.json"]
    rec = recs[f"{arch}__{shape}__{mesh}.json"]
    assert one["ok"] and rec["ok"], rec.get("traceback")
    assert rec["devices"] == DEVICES[mesh] and one["devices"] == 1
    ops = rec["ops"]
    assert (ops["dot_flops_per_dev"] * rec["devices"]
            >= one["ops"]["dot_flops_per_dev"])
    assert one["ops"]["collective_counts"] == {}
    assert sum(ops["collective_counts"].values()) > 0
    if shape == "tiny_train":
        assert ops["collective_counts"].get("all-gather", 0) > 0
        assert ops["collective_counts"].get("all-reduce", 0) > 0
    assert ops["wire_bytes_per_dev"] == pytest.approx(
        sum(ops["collective_wire_bytes"].values()), rel=1e-12)
    assert set(ops["link_wire_bytes"]) == {"ib"}     # every group spans nodes
    roof = rec["roofline"]
    assert roof["collective_s"] == sum(
        w / OA.LINK_BW[link] for link, w in ops["link_wire_bytes"].items())
    mem = rec["memory"]
    assert mem["argument_gb"] <= one["memory"]["argument_gb"]
    assert (mem["argument_gb"] * rec["devices"]
            >= one["memory"]["argument_gb"])
    assert rec["fits_one_card"] == (mem["argument_gb"] + mem["output_gb"]
                                    <= 80)
    assert rec["useful_flop_ratio"] == pytest.approx(
        rec["model_flops_global"] / rec["devices"] / ops["flops_per_dev"],
        rel=1e-12)


@pytest.mark.parametrize("flag", list(FLAGS), ids=lambda f: f or "none")
def test_cli_flags_choose_the_meshes(cli_runs, flag):
    _, by_flag = cli_runs
    run = by_flag[list(FLAGS).index(flag)]
    assert run["rc"] == 0
    assert sorted(run["records"]) == sorted(
        f"{ARCHS[0]}__tiny_decode__{m}.json" for m in FLAGS[flag])
    assert all(r["ok"] for r in run["records"].values())
