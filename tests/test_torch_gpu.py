"""Card-only tests of the port's CUDA kernels (marker `gpu`): each kernel
against its plain PyTorch version and the numpy `batched` backend, exact.
They import nothing of JAX, so they run on a machine that has only the
port's dependencies:

    PYTHONPATH=src:tests python -m pytest -q -m gpu --noconftest \
        tests/test_torch_gpu.py

Without a card every test here skips (decided inside the test, never at
import)."""
import pytest
import torch

from repro_torch.core.policy import list_policies
from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.kernels import sweep_arbiter as tarb
from repro_torch.kernels import sweep_megakernel as mega

from _torch_parity import assert_cells_equal, spec_kwargs


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
def test_cuda_arbiter_equals_plain_version():
    _need_card()
    spec = SweepSpec(**spec_kwargs("kernels", None))
    before = tarb.LAUNCHES
    on_card = sweep(spec, "torch", arbiter="cuda")
    assert tarb.LAUNCHES > before
    assert_cells_equal(sweep(spec, "batched"), on_card, "arbiter=cuda")


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
