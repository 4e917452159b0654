"""The port stands alone: `repro_torch`, `chip_smoke.py` and the port's
scripts (`benchmarks_torch/*.py`, `examples/dram_sweep_torch.py`,
`examples/serve_refresh_torch.py`, `examples/quickstart_torch.py`,
`tools/check_commands_torch.py`, `tools/check_contract_torch.py`) import
neither `jax` nor anything of the JAX package `repro`."""
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT_FILES = sorted((SRC / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "benchmarks_torch").glob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "dram_sweep_torch.py",
    ROOT / "examples" / "serve_refresh_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "tools" / "check_commands_torch.py",
    ROOT / "tools" / "check_contract_torch.py"]

#: an import statement that names jax or the JAX package (not
#: `repro_torch`), at any indentation
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))",
    re.MULTILINE)


def _port_modules():
    import repro_torch
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def test_port_has_the_expected_modules():
    mods = set(_port_modules())
    for m in ("repro_torch.core.policy.registry",
              "repro_torch.core.refresh.sim",
              "repro_torch.core.commands.replay",
              "repro_torch.core.sweep.engine",
              "repro_torch.core.sweep.torchbody",
              "repro_torch.kernels.sweep_arbiter",
              "repro_torch.kernels.sweep_megakernel",
              "repro_torch.kernels._build",
              "repro_torch.kernels.ref",
              "repro_torch.kernels.ops",
              "repro_torch.kernels.kv_quant",
              "repro_torch.kernels.refresh_paged_attention",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.mamba2_ssd",
              "repro_torch.models.layers",
              "repro_torch.common", "repro_torch.common.config",
              "repro_torch.common.treeutil", "repro_torch.configs",
              "repro_torch.configs.qwen2_0_5b",
              "repro_torch.core.scheduler.darp", "repro_torch.kvcache",
              "repro_torch.kvcache.paged", "repro_torch.serving",
              "repro_torch.serving.engine", "repro_torch.serving.cosim",
              "repro_torch.serving.paged_decode", "repro_torch.launch.serve",
              "repro_torch.models.dims", "repro_torch.models.blocks",
              "repro_torch.models.loss", "repro_torch.models.transformer",
              "repro_torch.models.api", "repro_torch.models.convert",
              "repro_torch.models.mamba", "repro_torch.models.hybrid",
              "repro_torch.models.encdec", "repro_torch.optim",
              "repro_torch.optim.adamw", "repro_torch.train",
              "repro_torch.train.step", "repro_torch.train.trainer",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.checkpoint", "repro_torch.checkpoint.engine",
              "repro_torch.launch.train", "repro_torch.analysis",
              "repro_torch.analysis.passes.cuda_lint",
              "repro_torch.parallel.op_analysis",
              "repro_torch.launch.specs", "repro_torch.launch.dryrun",
              "repro_torch.parallel.sharding", "repro_torch.parallel.local_ops",
              "repro_torch.launch.mesh"):
        assert m in mods, m


@pytest.mark.parametrize("module", ["repro_torch.parallel",
                                    "repro_torch.parallel.sharding",
                                    "repro_torch.parallel.local_ops",
                                    "repro_torch.launch.mesh"])
def test_multi_card_modules_pull_in_neither_jax_nor_repro(module):
    """The multi-card slice imports `torch.distributed` only: importing
    it in a fresh interpreter loads no JAX and builds no process group."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'jaxlib' or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


def test_importing_every_port_module_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'jaxlib' or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


#: the port's figure, bench, example and tool scripts
SCRIPTS = ("benchmarks_torch/fig_refresh.py",
           "benchmarks_torch/bench_framework.py", "benchmarks_torch/run.py",
           "benchmarks_torch/train_layout.py",
           "benchmarks_torch/train_profile.py",
           "benchmarks_torch/roofline_report.py",
           "examples/dram_sweep_torch.py", "examples/serve_refresh_torch.py",
           "examples/quickstart_torch.py",
           "tools/check_commands_torch.py", "tools/check_contract_torch.py")


def test_importing_the_port_scripts_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib.util, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
        f"for i, path in enumerate({list(SCRIPTS)!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', "
        "path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'jaxlib' or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env={"PATH": ""}, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_names_neither_jax_nor_repro_in_an_import(path):
    assert path.is_file(), path
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, (path, hits)


def test_kernel_sources_spell_no_shared_constant_as_a_literal():
    """Score bits and column tables reach the CUDA sources only through
    the generated header (`kernels/_build.py`); the sweep kernels'
    sources include it, and no source spells a shared constant."""
    from repro_torch.core.sweep import fields
    from repro_torch.kernels import _build
    header = _build._fields_header()
    for name in fields.__all__:
        assert f"#define {name} {getattr(fields, name)}\n" in header, name
    for cu in sorted((SRC / "repro_torch/kernels/csrc").glob("*.cu*")):
        text = cu.read_text()
        if cu.name.startswith("sweep_"):
            assert '#include "sweep_fields.h"' in text, cu
        assert not re.search(r"#define\s+(W_|MP_|MS_|AGE_|OCC_|KIND_)", text)
        for lit in (str(fields.AGE_CAP), str(fields.W_WRITE), "1 << 2"):
            assert lit not in text, (cu, lit)
