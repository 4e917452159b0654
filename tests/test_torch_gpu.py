"""Card-only tests of the port's CUDA kernels (marker `gpu`): each sweep
kernel against its plain PyTorch version and the numpy `batched`
backend, exact; kv_quant against its plain version exactly, on finite
pages and on pages with a NaN slice and an inf slice; each other float
kernel (paged attention, flash attention, Mamba2 SSD) against its plain
version at the reference's bars, with TF32 off; and the serving path's
two kernel entries: `kvcache.quantize_page` (kernel D) on the engine's
page and `models.layers.chunked_attention` (kernel E, with its padding,
the models' ragged lengths and its refusal of a q_offset); the Mamba
route `models.layers.ssd_chunked` (kernel F with its final state); and
the three newer families' prefill on the card against the CPU. They
import nothing of JAX, so they run on a machine that has only the
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
    """Held at `FLASH_TOL`; a head wider than the bf16 kernel takes is
    refused in bf16, with no launch."""
    from repro_torch.kernels import flash_attention as fa
    g = _gpu_float_setup()
    q, k, v = (x.to(dtype) for x in cs.flash_inputs(torch, g, *case))
    before = fa.LAUNCHES
    if dtype not in cs.flash_dtypes(torch, fa, case[3]):
        with pytest.raises(ValueError):
            cs.flash_entry(fa, case[1], case[2])(q, k, v, causal=causal)
        assert fa.LAUNCHES == before
        return
    got = cs.flash_entry(fa, case[1], case[2])(q, k, v, causal=causal)
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
@pytest.mark.parametrize("b,s,h,p,n,chunk", cs.SSD_CASES)
def test_cuda_mamba2_ssd_final_state_equals_plain_version(b, s, h, p, n,
                                                          chunk):
    """F's second output, the state after the last token that the models'
    prefill hands to decode, written by each (batch, head)'s last chunk."""
    from repro_torch.kernels import mamba2_ssd as ssd
    args = cs.ssd_inputs(torch, _gpu_float_setup(), b, s, h, p, n)
    before = ssd.LAUNCHES
    y, state = ssd.mamba2_ssd_with_state(*args, chunk=chunk)
    assert ssd.LAUNCHES == before + 1
    y_want, state_want = ssd.mamba2_ssd_with_state_torch(*args, chunk=chunk)
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    cs.close(torch, y, y_want, *cs.SSD_TOL, "mamba2 ssd y")
    cs.close(torch, state, state_want, *cs.SSD_TOL, "mamba2 ssd state")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk,groups", cs.SSD_GROUP_CASES)
def test_cuda_mamba2_ssd_groups_equal_plain_version(b, s, h, p, n, chunk,
                                                    groups):
    """F with B and C in groups ([B,S,G,N], a block's heads in one group)
    against its plain version, y and the final state, one launch."""
    from repro_torch.kernels import mamba2_ssd as ssd
    args = cs.ssd_inputs(torch, _gpu_float_setup(), b, s, h, p, n, groups)
    before = ssd.LAUNCHES
    y, state = ssd.mamba2_ssd_with_state(*args, chunk=chunk)
    assert ssd.LAUNCHES == before + 1
    y_want, state_want = ssd.mamba2_ssd_with_state_torch(*args, chunk=chunk)
    cs.close(torch, y, y_want, *cs.SSD_TOL, "grouped ssd y")
    cs.close(torch, state, state_want, *cs.SSD_TOL, "grouped ssd state")


# ------------------------------------------------------------ serving path
@pytest.mark.gpu
def test_cuda_quantize_page_equals_plain_version_at_the_engine_page():
    """`kvcache.quantize_page` on the card is kernel D, exactly equal to
    its plain version (on the card and on the CPU) on the serving
    engine's bf16 staging slice [24, 4, 2, 64]; `compress_page` stores
    what it returns."""
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kvcache import PagedKVCache, PagedKVConfig
    from repro_torch.kvcache import quantize_page
    g = _gpu_float_setup()
    cache = PagedKVCache(PagedKVConfig(n_layers=24, n_kv_heads=2,
                                       head_dim=64, page_size=4,
                                       n_pages=256, n_staging=24,
                                       n_groups=4, max_seqs=8))
    sid = cache.new_seq()
    for _ in range(4):
        tok = torch.randn((24, 2, 64), generator=g, device="cuda") * 3
        assert cache.append(sid, tok, -tok)
    (page,) = cache.compressible_pages()
    slot = int(cache.staging_slot[page])
    staged = cache.k_staging[:, slot].contiguous()
    before = kq.LAUNCHES
    q8, sc = quantize_page(staged)
    assert kq.LAUNCHES == before + 1
    cs.check_kv_quant(torch, staged, q8, sc, "quantize_page, engine page")
    q8_cpu, sc_cpu = quantize_page(staged.cpu())
    assert torch.equal(q8.cpu(), q8_cpu)
    assert torch.equal(sc.cpu().view(torch.int32), sc_cpu.view(torch.int32))
    cache.compress_page(page)
    assert kq.LAUNCHES == before + 3                    # K and V
    assert torch.equal(cache.k_pages[:, page], q8)
    assert torch.equal(cache.k_scale[:, page], sc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal", [(300, True), (512, True),
                                      (64, True), (256, False)])
def test_cuda_chunked_attention_equals_plain_loop(dtype, s, causal):
    """`layers.chunked_attention` on the card is kernel E on [B·Hq, S, D]
    (K/V expanded from 2 kv heads to 14, a causal 300 padded to 384
    rows), held against the plain online-softmax loop on the CPU at
    `FLASH_TOL`."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    g = _gpu_float_setup()
    q = torch.randn((2, s, 14, 64), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((2, s, 2, 64), generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    before = fa.LAUNCHES
    got = L.chunked_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES == before + 1
    want = L.chunked_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    cs.close(torch, got.cpu(), want, *cs.FLASH_TOL[cs.dtype_name(dtype)],
             "chunked attention")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,d,causal", [
    (1, 300, 64, False), (300, 300, 64, False), (1000, 1000, 64, False),
    (1, 1, 64, True), (512, 512, 112, True)])
def test_cuda_chunked_attention_takes_the_models_lengths(dtype, sq, skv, d,
                                                         causal):
    """The encoder-decoder's and the hybrid's calls of
    `layers.chunked_attention` on the card: kernel E at ragged lengths,
    non-causal (cross-attention at its BOS prefill, the encoder over 300
    frames, 1000 x 1000), causal 1 x 1 and head dim 112, held against the
    plain loop on the CPU at `FLASH_TOL`."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    g = _gpu_float_setup()
    q = torch.randn((2, sq, 4, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((2, skv, 4, d), generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    before = fa.LAUNCHES
    got = L.chunked_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES == before + 1
    want = L.chunked_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    cs.close(torch, got.cpu(), want, *cs.FLASH_TOL[cs.dtype_name(dtype)],
             "chunked attention")


@pytest.mark.gpu
@pytest.mark.parametrize("s,init", [(256, False), (200, True)])
def test_cuda_ssd_chunked_route(s, init):
    """`layers.ssd_chunked` on the card is kernel F with its final state,
    `D_res x` added in float32, y in x's dtype: held against the plain
    loop on the CPU at `SSD_TOL`; an `init_state` raises (F starts from
    zero), as does a chunk that does not divide S (200 by 128)."""
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models import layers as L
    g = _gpu_float_setup()
    args = list(cs.ssd_inputs(torch, g, 2, s, 3, 64, 128))
    args[0] = args[0].to(torch.bfloat16)
    d_res = torch.rand((3,), generator=g, device="cuda")
    if init:
        with pytest.raises(ValueError, match="init_state"):
            L.ssd_chunked(*args, d_res, 128,
                          init_state=torch.zeros((2, 3, 64, 128),
                                                 device="cuda"))
        with pytest.raises(ValueError, match="does not divide"):
            L.ssd_chunked(*args, d_res, 128)
        return
    before = ssd.LAUNCHES
    y, state = L.ssd_chunked(*args, d_res, 128)
    assert ssd.LAUNCHES == before + 1 and y.dtype == torch.bfloat16
    y_want, st_want = L.ssd_chunked(*[a.cpu() for a in args], d_res.cpu(),
                                    128)
    cs.close(torch, y.float().cpu(), y_want.float(), 1e-3, 1e-2,
             "ssd_chunked y (one bf16 rounding)")
    cs.close(torch, state.cpu(), st_want, *cs.SSD_TOL,
             "ssd_chunked final state")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_cuda_family_prefill_matches_cpu(arch):
    """Each new family's reduced config: `prefill` on the card (F in
    every Mamba layer, E in every attention) equals the same call on the
    CPU within `chip_smoke.MODEL_REL`, logits and every state leaf."""
    from repro_torch.common.config import get_arch
    from repro_torch.common.treeutil import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    _gpu_float_setup()
    cfg = get_arch(arch).reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    M = get_model(cfg)
    params = M.init(torch.Generator().manual_seed(0), cfg, dims, "cpu")
    rs = np.random.RandomState(0)
    if cfg.family == "encdec":
        batch = {"enc_embeds": torch.from_numpy(
            rs.randn(2, 37, cfg.d_model).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(
            rs.randint(0, cfg.vocab_size, (2, 64)))}
    want = M.prefill(params, batch, cfg, dims)
    before = (ssd.LAUNCHES, fa.LAUNCHES)
    got = M.prefill(tree_map(lambda x: x.cuda(), params),
                    {k: x.cuda() for k, x in batch.items()}, cfg, dims)
    assert ssd.LAUNCHES > before[0] or cfg.family == "encdec"
    assert fa.LAUNCHES > before[1] or cfg.family == "ssm"
    v = cfg.vocab_size
    cs.held(torch, got[0][:, :v], want[0][:, :v], f"{arch} logits")
    cs.hold_trees(torch, got[1], want[1], f"{arch} state")


@pytest.mark.gpu
@pytest.mark.parametrize("causal,q_offset,what", [(True, 8, "q_offset")])
def test_cuda_chunked_attention_raises_where_kernel_e_cannot(causal,
                                                             q_offset, what):
    """A q_offset raises on the card (E counts query positions from 0):
    nothing falls back to the plain loop. Every length is taken
    (`test_cuda_chunked_attention_takes_the_models_lengths`)."""
    from repro_torch.models import layers as L
    _gpu_float_setup()
    q = torch.zeros((1, 300, 2, 16), device="cuda")
    with pytest.raises(ValueError, match=what):
        L.chunked_attention(q, q, q, causal=causal, q_offset=q_offset)


@pytest.mark.gpu
def test_cuda_bench_run_fast_reproduces_the_reference_artifacts(tmp_path):
    """`benchmarks_torch/run.py --fast` on the card, written to a scratch
    directory: every deterministic field equals the reference's committed
    `results/bench/*.json` (`chip_smoke.check_artifacts`, and the serving
    entries' scheduling `chip_smoke.check_serving_artifacts`), the figure
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
    cs.check_serving_artifacts(got)
    assert got["sweep_mega"]["ref_grid_8x8x3"]["fused_beats_batched"]
    assert {"flash_ref_us", "kv_quant_us", "ssd_ref_us", "flash_kernel_us",
            "kv_quant_kernel_us", "ssd_kernel_us"} <= set(got["kernel_micro"])
    assert got["device"]["figure_backend"] == "mega"


# ---------------------------------------------------------------- training
#: per family: a reduced arch, and the gradient leaves that reach the loss
#: only through kernel E (attention q/k/v) or F (the Mamba projections)
TRAIN_ARCHS = {
    "qwen2-0.5b": ("layers/attn/wq", "layers/attn/wk", "layers/attn/wv"),
    "qwen3-moe-235b-a22b": ("layers/attn/wq", "layers/attn/wk"),
    "mamba2-130m": ("layers/wx", "layers/wB", "layers/wC", "layers/wdt"),
    "zamba2-7b": ("groups/wx", "groups/wB", "shared/attn/wq",
                  "shared/attn/wk"),
    "seamless-m4t-large-v2": ("enc_layers/attn/wq", "dec_layers/self/wk",
                              "dec_layers/cross/wv")}


def _train_case(arch, device):
    from repro_torch.common.config import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_state
    cfg = get_arch(arch).reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    state = make_state(torch.Generator().manual_seed(0), cfg, dims,
                       OptConfig(), device="cpu")
    kind = ("encdec" if cfg.family == "encdec"
            else ("embeds" if cfg.frontend == "embed" else "tokens"))
    batch = SyntheticLMData(cfg.vocab_size, batch=2, seq=64, seed=0,
                            embed_dim=cfg.d_model, kind=kind).batch_at(0)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    from repro_torch.common.treeutil import tree_map
    return cfg, dims, tree_map(lambda x: x.to(device), state["params"]), \
        batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_cuda_gradients_flow_through_kernels_e_and_f(arch):
    """Each family's reduced `train_loss` gradient on the card (E and F
    forward, the Functions' backward) equals the same call with no kernel
    (`chip_smoke.plain_train`) and the CPU's, every leaf within
    `MODEL_REL`; the leaves that reach the loss only through E or F get a
    non-zero gradient. Before the Functions, a kernel's output had no
    autograd node and these gradients were zero."""
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops
    from repro_torch.train.step import make_grad_fn
    _gpu_float_setup()
    cfg, dims, params, batch = _train_case(arch, "cuda")
    fn = make_grad_fn(cfg, dims)
    before = (fa.LAUNCHES, ssd.LAUNCHES)
    loss, _, grads = fn(params, batch)
    assert fa.LAUNCHES > before[0] or cfg.family == "ssm"
    assert ssd.LAUNCHES > before[1] or cfg.family in ("dense", "moe",
                                                      "encdec")
    with cs.plain_train(fa, ssd, ops):
        ploss, _, pgrads = fn(params, batch)
    _, _, cparams, cbatch = _train_case(arch, "cpu")
    closs, _, cgrads = fn(cparams, cbatch)
    cs.held(torch, loss, ploss, f"{arch} loss")
    cs.held(torch, loss, closs, f"{arch} loss vs CPU")
    got = dict(zip(flat_paths(grads), tree_leaves(grads)))
    for path, p, c in zip(flat_paths(pgrads), tree_leaves(pgrads),
                          tree_leaves(cgrads)):
        cs.held(torch, got[path], p, f"{arch} gradient {path}")
        cs.held(torch, got[path], c, f"{arch} gradient {path} vs CPU")
    for path in TRAIN_ARCHS[arch]:
        assert float(got[path].abs().max()) > 0, (arch, path)


@pytest.mark.gpu
def test_cuda_kernel_failure_in_a_train_step_raises():
    """A kernel that fails inside a training step raises out of the step;
    nothing swaps in the plain version."""
    from unittest import mock
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.step import make_grad_fn
    _gpu_float_setup()
    cfg, dims, params, batch = _train_case("qwen2-0.5b", "cuda")

    def broken(*a, **kw):
        raise RuntimeError("kernel E failed")
    with mock.patch.object(fa, "_launch", broken):
        with pytest.raises(RuntimeError, match="kernel E failed"):
            make_grad_fn(cfg, dims)(params, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_cuda_checkpoint_round_trip_is_bit_exact(tmp_path, moment_dtype):
    """A CUDA train state after one step (bf16 moments included, factored
    v) written by the engine and restored onto the card bit for bit."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointEngine
    from repro_torch.common.treeutil import tree_leaves
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_state, make_train_step
    _gpu_float_setup()
    cfg, dims, _, batch = _train_case("qwen2-0.5b", "cuda")
    ocfg = OptConfig(moment_dtype=moment_dtype, factored_v=True)
    state = make_state(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dims, ocfg)
    state, _ = make_train_step(cfg, dims, ocfg)(state, batch)
    eng = CheckpointEngine(CheckpointConfig(directory=str(tmp_path),
                                            interval=1, n_banks=3))
    eng.force_snapshot(1, state)
    eng.flush_all_now()
    eng.wait()
    restored, step = eng.restore(state)
    assert step == 1
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and b.device.type == "cuda"
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", cs.FLASH_CASES)
def test_cuda_flash_backward_equals_plain_gradient(causal, case):
    """E's backward kernels from E's forward with its log-sum-exp, at the
    models' route's lengths: held against autograd of the plain attention
    at `chip_smoke.FLASH_GRAD_REL`, the same bits twice, one launch a
    call (`chip_smoke.flash_backward_case`)."""
    from repro_torch.kernels import flash_attention as fa
    g = _gpu_float_setup()
    q, k, v = cs.flash_inputs(torch, g, *case)
    do = torch.randn(q.shape, generator=g, device="cuda")
    cs.flash_backward_case(torch, fa, q, k, v, do, causal,
                           f"flash backward {case}")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", cs.FLASH_CASES)
def test_cuda_flash_forward_with_lse_keeps_the_output(causal, case):
    """The trainable route's forward writes the log-sum-exp beside E's
    output and leaves that output as `flash_attention_ragged`'s, bit for
    bit; the log-sum-exp is the plain version's within float32 rounding."""
    from repro_torch.kernels import flash_attention as fa
    g = _gpu_float_setup()
    q, k, v = cs.flash_inputs(torch, g, *case)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           ragged=True)
    assert torch.equal(out, fa.flash_attention_ragged(q, k, v,
                                                      causal=causal))
    want = fa.flash_attention_lse_torch(q, k, causal=causal)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)
