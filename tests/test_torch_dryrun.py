"""The port's one-card dry run (`repro_torch.launch.{specs,dryrun}`,
`repro_torch.parallel.op_analysis`, `benchmarks_torch/roofline_report.py`)
against the reference's (`repro.launch.specs`, `jax.eval_shape`).

  * every arch and kind: the `meta` state leaves equal the reference's
    `jax.eval_shape` leaves in JAX's flatten order, shape and dtype;
  * param / decode-state specs, batch specs, `model_flops`,
    `opt_config_for`, `accum_for`: exactly equal;
  * `analyze_ops`: the same counts on `meta` as on CPU tensors, and a
    prefill's product FLOPs equal to a count made by hand;
  * `meta` takes the plain route in the models and the kernel wrappers;
    an unknown device still raises.

Tolerance: none (shapes, dtypes and counts are integers).
"""
import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.common.config import get_arch as ref_get_arch
from repro.launch import specs as RSP
from repro.models.dims import make_dims as ref_make_dims

from repro_torch.common.config import (SHAPE_SETS, ShapeConfig,
                                       applicable_shapes, get_arch,
                                       list_archs)
from repro_torch.common.treeutil import tree_leaves
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.models.dims import make_dims
from repro_torch.parallel.op_analysis import analyze_ops
from repro_torch.train import make_train_step

from _torch_train_parity import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


def _ref_model_flops():
    """The reference's `launch.dryrun.model_flops`, taken from its source:
    importing that module sets `XLA_FLAGS` for a 512-device host."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "model_flops")
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["model_flops"]


def _leaf_sig(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_state_leaves_equal_reference_eval_shape(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    dims, rdims = make_dims(cfg, tp=1), ref_make_dims(rcfg, tp=1)
    for kind, shape_name in KINDS.items():
        shape = SHAPE_SETS[shape_name]
        got, specs = SP.state_shapes_and_specs(cfg, dims, kind, shape)
        want, rspecs = RSP.state_shapes_and_specs(rcfg, rdims, kind, shape)
        leaves = tree_leaves(got)
        assert all(x.device.type == "meta" for x in leaves)
        assert ([_leaf_sig(x) for x in leaves]
                == [(tuple(x.shape), str(x.dtype))
                    for x in jax.tree.leaves(want)]), (arch, kind)
        assert specs == rspecs, (arch, kind)
        assert len(SP.spec_leaves(specs)) == len(leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_batches_and_cell_settings_equal_reference(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    dims, rdims = make_dims(cfg, tp=1), ref_make_dims(rcfg, tp=1)
    mod = get_model(cfg)
    from repro.models.api import get_model as ref_get_model
    rmod = ref_get_model(rcfg)
    assert mod.param_specs(cfg, dims) == rmod.param_specs(rcfg, rdims)
    assert (mod.decode_state_specs(cfg, dims)
            == rmod.decode_state_specs(rcfg, rdims))
    assert SP.opt_config_for(cfg).__dict__ == \
        RSP.opt_config_for(rcfg).__dict__
    ref_mf = _ref_model_flops()
    for shape in applicable_shapes(cfg):
        assert SP.accum_for(cfg, shape) == RSP.accum_for(rcfg, shape)
        assert D.model_flops(cfg, shape) == ref_mf(rcfg, shape)
        for labels in (True, False):
            got = SP.batch_specs(cfg, shape, with_labels=labels)
            want = RSP.batch_specs(rcfg, shape, with_labels=labels)
            assert {k: _leaf_sig(v) for k, v in got.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            assert SP.batch_spec_axes(cfg, got) == RSP.batch_spec_axes(
                rcfg, want)


def _reduced_cell(arch, kind, device, b=4, s=32):
    """(fn, args) of a reduced arch's step on `device`: the meta cell's
    builders, with params drawn on the CPU when asked for."""
    cfg = get_arch(arch).reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    shape = ShapeConfig("t", s, b, kind)
    fn, args = D.cell_step(cfg, dims, shape)
    if device == "meta":
        return cfg, dims, fn, args
    if kind == "train":              # the same step, for a state on the CPU
        fn = make_train_step(cfg, dims, SP.opt_config_for(cfg),
                             accum=SP.accum_for(cfg, shape), device="cpu")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)

    def real(x):
        if x.dtype in (torch.int32, torch.int64):
            return torch.as_tensor(rng.integers(0, cfg.vocab_size, x.shape),
                                   dtype=x.dtype)
        return torch.randn(x.shape, generator=gen).to(x.dtype)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return None if tree is None else real(tree)
    return cfg, dims, fn, tuple(build(a) for a in args)


#: a reduced arch of each family, and M-RoPE; the hybrid's train step
#: (4 microbatches, 12 layers) is left out for its time on the CPU
CELLS = [(arch, kind)
         for arch in ("qwen2-0.5b", "mamba2-130m", "zamba2-7b",
                      "seamless-m4t-large-v2", "qwen3-moe-235b-a22b",
                      "qwen2-vl-72b")
         for kind in ("train", "prefill", "decode")
         if (arch, kind) != ("zamba2-7b", "train")]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_analyze_ops_on_meta_equals_the_same_call_on_cpu(arch, kind):
    cfg, _, fn, margs = _reduced_cell(arch, kind, "meta")
    _, _, fn_cpu, cargs = _reduced_cell(arch, kind, "cpu")
    got = analyze_ops(fn, *margs)
    want = analyze_ops(fn_cpu, *cargs)
    for field in ("flops", "dot_flops", "hbm_bytes", "n_instructions",
                  "dot_flops_by_dtype", "argument_bytes", "output_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.dot_flops > 0 and got.wire_bytes == 0
    assert got.collective_counts == {} and got.collective_wire == {}
    roof = got.roofline()
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"]) > 0
    assert roof["collective_s"] == 0.0


def test_prefill_dot_flops_equal_a_count_by_hand():
    b, s = 2, 64
    cfg, dims, fn, args = _reduced_cell("qwen2-0.5b", "prefill", "meta",
                                        b=b, s=s)
    t, d, dh = b * s, cfg.d_model, cfg.attention.head_dim
    nq, nkv = dims.n_q, dims.n_kv
    layer = (2 * t * d * dh * (nq + 2 * nkv)        # q, k, v projections
             + 2 * t * nq * dh * d                  # output projection
             + 2 * 2 * b * nq * s * s * dh          # q·kᵀ, p·v: all blocks
             + 3 * 2 * t * d * cfg.d_ff)            # gated MLP
    want = cfg.n_layers * layer + 2 * b * d * dims.vocab   # last-token head
    got = analyze_ops(fn, *args)
    assert got.dot_flops == want
    assert got.dot_flops_by_dtype == {"float32": float(want)}


def test_meta_takes_the_plain_route_and_unknown_devices_raise():
    q = torch.empty(2, 16, 4, 8, device="meta")
    assert L.chunked_attention(q, q, q, causal=True).shape == q.shape
    x = torch.empty(1, 16, 2, 4, device="meta")
    dt = torch.empty(1, 16, 2, device="meta")
    A = torch.empty(2, device="meta")
    bc = torch.empty(1, 16, 8, device="meta")
    y, h = L.ssd_chunked(x, dt, A, bc, bc, A, 8)
    assert y.shape == x.shape and h.shape == (1, 2, 4, 8)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        L.chunked_attention(other, other, other, causal=True)
    with pytest.raises(ValueError, match="unsupported device"):
        L.ssd_chunked(other, dt, A, bc, bc, A, 8)


def test_kernel_wrappers_take_meta_to_the_plain_version():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import refresh_paged_attention as rpa
    meta = dict(device="meta")
    launches = (fa.LAUNCHES, kq.LAUNCHES, ssd.LAUNCHES, rpa.LAUNCHES)
    q = torch.empty(4, 128, 16, **meta)
    assert fa.flash_attention(q, q, q).shape == q.shape
    assert fa.flash_attention_ragged(q[:, :100].contiguous(), q,
                                     q).shape == (4, 100, 16)
    q8, sc = kq.kv_quant(torch.empty(3, 8, 2, 16, **meta))
    assert q8.dtype == torch.int8 and sc.shape == (3, 2)
    x = torch.empty(2, 64, 3, 8, **meta)
    y, h = ssd.mamba2_ssd_with_state(
        x, torch.empty(2, 64, 3, **meta), torch.empty(3, **meta),
        torch.empty(2, 64, 16, **meta), torch.empty(2, 64, 16, **meta),
        chunk=16)
    assert y.shape == x.shape and h.shape == (2, 3, 8, 16)
    pages = torch.empty(6, 8, 2, 16, dtype=torch.int8, **meta)
    out = rpa.refresh_paged_attention(
        torch.empty(2, 4, 16, **meta), pages, pages,
        torch.empty(6, 2, **meta), torch.empty(6, 2, **meta),
        torch.empty(2, 3, dtype=torch.int32, **meta),
        torch.empty(2, dtype=torch.int32, **meta), page_size=8)
    assert out.shape == (2, 4, 16)
    assert (fa.LAUNCHES, kq.LAUNCHES, ssd.LAUNCHES,
            rpa.LAUNCHES) == launches


def test_dryrun_cli_writes_an_ok_record_and_the_report_reads_it(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--one-card-only",
         "--out", str(tmp_path)],
        cwd=str(ROOT), env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "dryrun done: 1 ok, 0 failed" in out.stdout
    rec = json.loads(
        (tmp_path / "mamba2-130m__decode_32k__h100x1.json").read_text())
    assert rec["ok"] and rec["devices"] == 1 and rec["mesh"] == "h100x1"
    assert rec["memory"]["temp_gb"] is None
    assert rec["fits_one_card"] == (rec["memory"]["argument_gb"]
                                    + rec["memory"]["output_gb"] <= 80)
    for key in ("ops", "roofline", "model_flops_global",
                "useful_flop_ratio", "roofline_fraction"):
        assert key in rec
    sys.path.insert(0, str(ROOT / "benchmarks_torch"))
    try:
        import roofline_report
    finally:
        sys.path.remove(str(ROOT / "benchmarks_torch"))
    text = roofline_report.report(roofline_report.load(str(tmp_path)))
    assert "| mamba2-130m | decode_32k |" in text and "1/1 cells ok" in text
