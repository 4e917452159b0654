"""The port's dry run on the reference's production meshes
(`repro_torch.launch.{mesh,dryrun}`, `repro_torch.parallel.op_analysis`)
against the reference's (`repro.launch.dryrun`, `repro.launch.specs`,
`repro.parallel.hlo_analysis`). Every fake world runs in a process of
its own (`_torch_dist_workers.run_alone`, `_torch_pod_shapes.py`). This
file holds (a) on (data=16, model=16), (b), (c) and (e);
`test_torch_dryrun_pods_multi.py` holds (a) on (pod=2, data=16,
model=16) and (d), so that `--dist loadfile` runs the halves on two
workers.

  * (a) All 32 cells (ten archs at their applicable shapes): every state
    and batch (or decode token) leaf's local shape on rank 0 equals the
    reference's `NamedSharding.shard_shape` (XLA's padded shard where a
    dimension does not divide), leaf for leaf in JAX's flatten order;
    the step's per-device argument bytes equal their total, and so does
    the committed record's `argument_gb` (`results/dryrun_torch/`);
  * (b) `op_analysis._wire_bytes` equals the reference's
    `hlo_analysis._wire_bytes` for every collective at group sizes 1, 2,
    16 and 512;
  * (c) one redistribution on the fake (16, 16) world counts what was
    worked by hand: Shard(0) -> Replicate over 'model' one all-gather of
    result x 15/16, Partial -> Replicate one all-reduce of 2 x result x
    15/16, Shard(0) -> Shard(1) one all-to-all of result x 15/16, each
    over InfiniBand ('model' is 16 consecutive ranks: two nodes of 8),
    the collective term the wire bytes at `IB_BW`; a plain call none;
  * (d) `run_cell` (through the CLI) on the reduced qwen2-0.5b and a
    reduced MoE (16 experts, which the model ways divide) at small
    shapes, on both pod meshes: `ok` records of 256 / 512 devices whose
    per-device product FLOPs x devices are at least the one-card
    record's, with collectives; the CLI's three flags choose the meshes;
  * (e) `fake_world` refuses to replace a real group and leaves none
    behind.

Tolerance: none (shapes, bytes and counts are integers; the collective
term is a division of them, held to the same expression).
"""
import pytest

from repro.parallel.hlo_analysis import _wire_bytes as ref_wire_bytes

from repro_torch.common.config import applicable_shapes, get_arch, list_archs
from repro_torch.parallel import op_analysis as OA

import _torch_dist_workers as W
from _torch_pod_shapes import both_sides, hold_cell

MESH = "pod16x16"
CELLS = [(arch, shape.name) for arch in list_archs()
         for shape in applicable_shapes(get_arch(arch))]


# ------------------------------------------------------------------ (a)

@pytest.fixture(scope="module")
def shapes():
    return both_sides(MESH, CELLS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_local_shapes_equal_the_reference_shard_shapes(shapes, arch, shape):
    hold_cell(MESH, *shapes, arch, shape)


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("g", [1, 2, 16, 512])
@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_wire_bytes_equal_the_reference(op, g):
    for result_b, operand_b in ((4096.0, 256.0), (12345.0, 67890.0),
                                (0.0, 8.0)):
        assert (OA._wire_bytes(op, result_b, operand_b, g)
                == ref_wire_bytes(op, result_b, operand_b, g))


# ------------------------------------------------------------------ (c)

@pytest.fixture(scope="module")
def redistributed():
    return W.run_alone(W.redistribute_worker)


@pytest.mark.parametrize("case,kind,wire", [
    ("gather", "all-gather", 64 * 32 * 4 * 15 / 16),
    ("reduce", "all-reduce", 2 * 64 * 32 * 4 * 15 / 16),
    ("all_to_all", "all-to-all", 4 * 32 * 4 * 15 / 16)])
def test_one_redistribution_counts_its_collective_by_hand(redistributed,
                                                          case, kind, wire):
    got = redistributed[case]
    assert got["counts"] == {kind: 1}
    assert got["wire"] == {kind: wire} and got["wire_bytes"] == wire
    assert got["links"] == {kind: ["ib"]}
    assert got["link_wire"] == {"ib": wire}
    assert got["roofline"]["collective_s"] == wire / OA.IB_BW
    assert got["flops"] == 0.0 and got["n_ops"] == 1


def test_a_plain_call_counts_no_collective(redistributed):
    got = redistributed["plain"]
    assert got["counts"] == {} and got["wire_bytes"] == 0.0
    assert got["links"] == {} and got["roofline"]["collective_s"] == 0.0


def test_link_rates_are_the_data_sheets():
    assert OA.LINK_BW == {"nvlink": 450e9, "ib": 50e9}
    assert OA.CARDS_PER_NODE == 8


# ------------------------------------------------------------------ (e)

def test_fake_world_refuses_a_real_group_and_leaves_none():
    out = W.run_alone(W.fake_world_worker)
    assert "already initialized" in out["refused"]
    assert "replaced" not in out
    assert out["kept"] == (True, "gloo", 1)
    assert out["inside"] == ("fake", 512, 0)
    assert out["after_exit"] is False and out["after_error"] is False
