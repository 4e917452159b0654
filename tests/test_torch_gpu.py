"""Card-only tests of the port's CUDA kernels (marker `gpu`): each sweep
kernel against its plain PyTorch version and the numpy `batched`
backend, exact; kv_quant against its plain version exactly, on finite
pages and on pages with a NaN slice and an inf slice; each other float
kernel (paged attention, flash attention, Mamba2 SSD) against its plain
version at the reference's bars, with TF32 off. They import nothing of JAX, so they run on a machine that has only the
port's dependencies:

    PYTHONPATH=src:tests python -m pytest -q -m gpu --noconftest \
        tests/test_torch_gpu.py

Without a card every test here skips (decided inside the test, never at
import)."""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.policy import list_policies
from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.kernels import sweep_arbiter as tarb
from repro_torch.kernels import sweep_megakernel as mega

from _torch_parity import ONE_PER_KIND, assert_cells_equal, spec_kwargs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the repo root's device check)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (see the module "
                    "docstring for the command to run on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["conformance", "multirank", "subarray4"])
def test_cuda_megakernel_equals_plain_version(grid):
    _need_card()
    spec = SweepSpec(**spec_kwargs(grid, tuple(list_policies())))
    before = mega.LAUNCHES
    on_card = sweep(spec, "mega")
    assert mega.LAUNCHES > before
    assert_cells_equal(sweep(spec, "mega", device="cpu"), on_card, grid)
    assert_cells_equal(sweep(spec, "batched"), on_card, grid)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["open_conformance", "open_multirank",
                                  "open_subarray4"])
def test_cuda_open_megakernel_equals_plain_version(grid):
    _need_card()
    spec = SweepSpec(**spec_kwargs(grid, tuple(list_policies())))
    before = mega.OPEN_LAUNCHES
    on_card = sweep(spec)                         # the default: mode "open"
    assert mega.OPEN_LAUNCHES > before
    assert_cells_equal(sweep(spec, "mega", device="cpu"), on_card, grid)
    assert_cells_equal(sweep(spec, "batched"), on_card, grid)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["wide_closed", "wide_open"])
def test_cuda_megakernels_take_128_bank_cells(grid):
    """The wide instantiation of both megakernels (more than 64 banks)."""
    _need_card()
    spec = SweepSpec(**spec_kwargs(grid, ONE_PER_KIND))
    before = mega.LAUNCHES + mega.OPEN_LAUNCHES
    on_card = sweep(spec, "mega")
    assert mega.LAUNCHES + mega.OPEN_LAUNCHES == before + 1
    assert_cells_equal(sweep(spec, "mega", device="cpu"), on_card, grid)
    assert_cells_equal(sweep(spec, "batched"), on_card, grid)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["ties_closed", "ties_open",
                                  "banks40_closed", "banks40_open"])
def test_cuda_megakernels_keep_the_serial_orders(grid):
    """The group-of-lanes kernels on `chip_smoke.lane_order_specs`:
    tie-heavy policies at 2 ranks x 2 channels, and 40-bank cells whose
    lanes own two banks each; difference 0 against the plain version."""
    _need_card()
    spec = dict(cs.lane_order_specs(SweepSpec, tuple(list_policies())))[grid]
    before = mega.LAUNCHES + mega.OPEN_LAUNCHES
    on_card = sweep(spec, "mega")
    assert mega.LAUNCHES + mega.OPEN_LAUNCHES == before + 1
    assert_cells_equal(sweep(spec, "mega", device="cpu"), on_card, grid)
    assert_cells_equal(sweep(spec, "batched"), on_card, grid)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["kernels", "open_kernels"])
def test_cuda_arbiter_equals_plain_version(grid):
    _need_card()
    spec = SweepSpec(**spec_kwargs(grid, None))
    before = tarb.LAUNCHES
    on_card = sweep(spec, "torch", arbiter="cuda")
    assert tarb.LAUNCHES > before
    assert_cells_equal(sweep(spec, "batched"), on_card, "arbiter=cuda")
    before = tarb.LAUNCHES
    host = sweep(spec, "batched", arbiter="cuda")
    assert tarb.LAUNCHES > before
    assert_cells_equal(on_card, host, "batched, arbiter=cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [2, 4])
def test_cuda_megakernel_shards_over_cards(n_shards):
    _need_card()
    if torch.cuda.device_count() < n_shards:
        pytest.skip(f"needs {n_shards} cards")
    spec = SweepSpec(**spec_kwargs("conformance", tuple(list_policies())))
    before = mega.LAUNCHES
    sharded = sweep(spec, "mega", n_shards=n_shards)
    assert mega.LAUNCHES == before + n_shards
    assert_cells_equal(sweep(spec, "mega"), sharded, f"{n_shards} shards")


# ------------------------------------------------------------ float kernels
# The edge cases, the bars and the input makers are `chip_smoke.py`'s, so
# the device check and these tests hold the kernels to one table.
def _gpu_float_setup():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", cs.KV_QUANT_SHAPES)
def test_cuda_kv_quant_equals_plain_version(dtype, shape, nonfinite):
    from repro_torch.kernels import kv_quant as kq
    pages = cs.kv_quant_input(torch, _gpu_float_setup(), shape, dtype,
                              nonfinite)
    before = kq.LAUNCHES
    q8, sc = kq.kv_quant(pages)
    assert kq.LAUNCHES == before + 1
    cs.check_kv_quant(torch, pages, q8, sc, f"kv_quant {shape}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,d,t,maxp,lens", cs.PAGED_CASES)
def test_cuda_paged_attention_equals_plain_version(dtype, b, h, hkv, d, t,
                                                   maxp, lens):
    from repro_torch.kernels import refresh_paged_attention as rpa
    _gpu_float_setup()
    q, *cache = cs.paged_case(torch, np, b, h, hkv, d, t, maxp, lens,
                              seed=b * 10 + h)
    q = q.to(dtype)
    before = rpa.LAUNCHES
    got = rpa.refresh_paged_attention(q, *cache, page_size=t)
    assert rpa.LAUNCHES == before + 1
    cs.close(torch, got, rpa.paged_attention_torch(q, *cache, page_size=t),
             *cs.PAGED_TOL[cs.dtype_name(dtype)], "paged attention")
    for bi, n in enumerate(lens):
        if n == 0:
            assert not got[bi].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", cs.FLASH_CASES)
def test_cuda_flash_attention_equals_plain_version(dtype, causal, case):
    from repro_torch.kernels import flash_attention as fa
    g = _gpu_float_setup()
    q, k, v = (x.to(dtype) for x in cs.flash_inputs(torch, g, *case))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES == before + 1
    cs.close(torch, got, fa.flash_attention_torch(q, k, v, causal=causal),
             *cs.FLASH_TOL[cs.dtype_name(dtype)], "flash attention")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk", cs.SSD_CASES)
def test_cuda_mamba2_ssd_equals_plain_version(b, s, h, p, n, chunk):
    from repro_torch.kernels import mamba2_ssd as ssd
    args = cs.ssd_inputs(torch, _gpu_float_setup(), b, s, h, p, n)
    before = ssd.LAUNCHES
    got = ssd.mamba2_ssd(*args, chunk=chunk)
    assert ssd.LAUNCHES == before + 1
    cs.close(torch, got, ssd.mamba2_ssd_torch(*args, chunk=chunk),
             *cs.SSD_TOL, "mamba2 ssd")


@pytest.mark.gpu
def test_cuda_bench_run_fast_reproduces_the_reference_artifacts(tmp_path):
    """`benchmarks_torch/run.py --fast` on the card, written to a scratch
    directory: every deterministic field equals the reference's committed
    `results/bench/*.json` (`chip_smoke.check_artifacts`), the figure
    grids and the ladder ran on A1 and the regression guard on A2, and
    `kernel_micro` has the reference's keys beside the kernels'."""
    import importlib.util
    import json
    _need_card()
    spec = importlib.util.spec_from_file_location(
        "bench_run_torch", cs.HERE + "/benchmarks_torch/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    closed, open_ = mega.LAUNCHES, mega.OPEN_LAUNCHES
    assert run.main(["--fast", "--out", str(tmp_path)]) == 0
    assert mega.LAUNCHES > closed and mega.OPEN_LAUNCHES > open_
    got = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    cs.check_artifacts(got)
    assert got["sweep_mega"]["ref_grid_8x8x3"]["fused_beats_batched"]
    assert {"flash_ref_us", "kv_quant_us", "ssd_ref_us", "flash_kernel_us",
            "kv_quant_kernel_us", "ssd_kernel_us"} <= set(got["kernel_micro"])
    assert got["device"]["figure_backend"] == "mega"
