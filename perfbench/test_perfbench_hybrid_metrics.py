"""The hybrid training cell's per-layer readers on synthetic traces and
recorder contents, against values worked out by hand: the whole step's
share of the float32 peak, kernel F's and E's backward kernels' shares of
their rooflines, and the shares of the SSD backward and shared-block
spans; each reads None where its kernels, spans or counters are absent
(the parent program has neither the spans nor the counter)."""
import json
from pathlib import Path

import pytest

from perfbench.counts import hybrid_flops
from perfbench.counts.model_flops import flash_flops
from perfbench.counts.peaks import FP32_FLOPS, TF32_TC_FLOPS
from perfbench.test_perfbench_trace_metrics import reader, spans
from repro_torch.common import trace

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "configs" / "zamba2-7b-instruct.json")
                    .read_text())
WORKLOAD = json.loads((HERE / "workloads" / "zamba2-7b-instruct.train_4k"
                       ".json").read_text())


def data(kernels=(), window=(0.0, 10.0), counters=None):
    c = {"steps": 2, "rows": 2, "seq": 4096}
    c.update(counters or {})
    return {"kernels": list(kernels), "busy": [], "window": window,
            "spans": [], "counters": c, "config": CONFIG,
            "workload": WORKLOAD}


def test_ssd_operations_count_c_bt_once_a_group():
    one = hybrid_flops.ssd_operations(1, 4096, 112, 64, 64, 128, 1)
    two = hybrid_flops.ssd_operations(1, 4096, 112, 64, 64, 128, 2)
    pairs = 128 * 129 // 2
    assert two - one == 2 * 32 * pairs * 64
    from repro_torch.kernels import mamba2_ssd
    assert two == mamba2_ssd.operations(1, 4096, 112, 64, 64, 128, 2)


def test_forward_flops_of_the_cut_model():
    """~7.1 GFLOP a token: 24 Mamba mixers, 4 shared-block applications
    over the concatenated input, the tied head."""
    fl = hybrid_flops.forward_flops(CONFIG["model"], 4096, 128)
    assert 7.0e9 < fl / 4096 < 7.2e9
    assert hybrid_flops.train_step_flops(CONFIG["model"], 2, 4096, 128) == \
        6 * fl


def test_mfu_train_hybrid():
    fl = 2 * hybrid_flops.train_step_flops(CONFIG["model"], 2, 4096, 128)
    assert reader("mfu.train_hybrid")(data()) == pytest.approx(
        100 * fl / (10.0 * FP32_FLOPS))
    assert reader("mfu.train_hybrid")(data(counters={"steps": 0})) is None


def test_f_roofline_counts_each_launch_as_one_layers_scan():
    ks = [("void mamba2_ssd_kernel(float const*)", 1.0, 1.001),
          ("void mamba2_ssd_kernel(float const*)", 2.0, 2.003),
          ("flash_attention_f32_kernel", 3.0, 4.0)]
    one = hybrid_flops.ssd_operations(1, 4096, 112, 64, 64, 128, 2)
    assert reader("f_roofline.train")(data(ks)) == pytest.approx(
        100 * 2 * 3 * one / TF32_TC_FLOPS / 0.004)
    assert reader("f_roofline.train")(data(ks[2:])) is None


def test_e_bwd_roofline_counts_a_call_a_dq_launch():
    ks = [("flash_bwd_di_f32_kernel", 0.0, 0.001),
          ("void flash_bwd_dkdv_f32_kernel<28>(float const*)", 0.001, 0.021),
          ("void flash_bwd_dq_f32_kernel<28>(float const*)", 0.021, 0.031),
          ("flash_bwd_di_f32_kernel", 1.0, 1.001),
          ("void flash_bwd_dkdv_f32_kernel<28>(float const*)", 1.001, 1.021),
          ("void flash_bwd_dq_f32_kernel<28>(float const*)", 1.021, 1.031),
          ("flash_attention_f32_kernel", 2.0, 2.5)]
    one = 7 * flash_flops(32, 4096, 224) // 2
    assert reader("e_bwd_roofline.train_hybrid")(data(ks)) == \
        pytest.approx(100 * 2 * 3 * one / TF32_TC_FLOPS / 0.062)
    assert reader("e_bwd_roofline.train_hybrid")(data(ks[-1:])) is None


def test_ssd_backward_share_needs_every_call_timed(monkeypatch):
    rows = [("train.step", 1.0, 9.0), ("ssd.backward", 2.0, 2.1),
            ("ssd.backward", 3.0, 3.1), ("ssd.backward", 12.0, 12.1)]
    spans(monkeypatch, rows, {1: (2.0, 2.5), 2: (3.0, 3.25),
                              3: (12.0, 12.5)})
    read = reader("ssd_backward_share.train")
    two = {"program": {"ssd_bwd_calls": 2}}
    assert read(data(counters=two)) == pytest.approx(7.5)
    assert read(data(counters={"program": {"ssd_bwd_calls": 3}})) is None
    assert read(data(counters={"program": {"ssd_bwd_calls": None}})) is None
    monkeypatch.setattr(trace, "_records", [])
    assert read(data(counters=two)) is None


def test_shared_block_share_reads_device_seconds(monkeypatch):
    rows = [("train.step", 1.0, 9.0), ("hybrid.shared", 2.0, 2.1),
            ("train.forward", 2.0, 3.0), ("hybrid.shared", 9.5, 10.5)]
    spans(monkeypatch, rows, {1: (2.0, 3.0), 3: (9.5, 11.5)})
    read = reader("shared_block_share.train")
    # the second span is clipped to the window on the host, but its
    # device seconds are its events'
    assert read(data()) == pytest.approx(30.0)
    spans(monkeypatch, [("train.step", 1.0, 9.0)])
    assert read(data()) is None


@pytest.mark.parametrize("name", ["ssd_backward_share.train",
                                  "shared_block_share.train"])
def test_none_on_a_program_without_the_recorder(name, monkeypatch):
    import sys

    import repro_torch.common
    monkeypatch.setitem(sys.modules, "repro_torch.common.trace", None)
    monkeypatch.delattr(repro_torch.common, "trace")
    assert reader(name)(data(counters={"program": {"ssd_bwd_calls": 0}})) \
        is None
