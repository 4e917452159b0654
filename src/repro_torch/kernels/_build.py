"""Build and load the package's CUDA kernels.

`load()` compiles `csrc/*.cu` with `nvcc` for `sm_90a` into one shared
library with a plain C interface and opens it with `ctypes`. It runs at
first use, never at import: the CPU tests import every module on machines
that have no compiler. There is no fallback — a missing `nvcc` or a failed
compile raises `RuntimeError` carrying the compiler's output.

The build is keyed by a hash of the sources, the generated constants
header and the flags, so an unchanged tree reuses `build/` and any edit
rebuilds. Each source is compiled to an object by its own `nvcc` process,
all started together, and one link step joins them.

Constants the sweep kernels share with the Python side (`core/sweep/fields.py`
score bits and `MP_*`/`MS_*` column tables, `KIND_*` policy kinds, the
histogram width, the never-arrives sentinel and the widest cell the
megakernels take) are written into
`sweep_fields.h` from the Python definitions at build time; the `.cu`
sources never spell them as literals.

The build directory is `build/repro_torch` under the repository root;
nothing else outside the package is written.

`check_tensor` and `launch` are what every kernel wrapper calls: the
first before it hands a tensor's pointer to C, the second to call the C
launch function and raise on the CUDA error it returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
#: facts of the build that `load()` performed or reused in this process:
#: ``path``, ``seconds`` (0.0 when an existing library was reused),
#: ``reused``, ``log`` (nvcc/ptxas output: registers, spills per kernel)
info: dict = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _fields_header() -> str:
    """`sweep_fields.h`: every shared constant as a `#define`, generated
    from the Python single sources of truth."""
    from repro_torch.core.sweep import fields, policies
    from repro_torch.core.sweep.engine import MAX_LAT_TICKS, _PAD_ARRIVE
    from repro_torch.kernels.sweep_megakernel import MAX_BANKS, MAX_CORES
    lines = ["// generated by repro_torch/kernels/_build.py - do not edit",
             "#pragma once"]
    for name in fields.__all__:
        lines.append(f"#define {name} {int(getattr(fields, name))}")
    for name in sorted(n for n in vars(policies) if n.startswith("KIND_")):
        lines.append(f"#define {name} {int(getattr(policies, name))}")
    lines.append(f"#define POLICY_NEG ({int(policies._NEG)})")
    lines.append(f"#define POLICY_KD {int(policies._KD)}")
    lines.append(f"#define MAX_LAT_TICKS {int(MAX_LAT_TICKS)}")
    lines.append(f"#define PAD_ARRIVE {int(_PAD_ARRIVE)}")
    lines.append(f"#define SWEEP_MAX_BANKS {int(MAX_BANKS)}")
    lines.append(f"#define SWEEP_MAX_CORES {int(MAX_CORES)}")
    return "\n".join(lines) + "\n"


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "repro_torch kernels need the CUDA compiler: no nvcc on PATH, "
        "under $CUDA_HOME/bin or under /usr/local/cuda/bin")


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all, return their joined
    output; raise with that output if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    bad = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n  " + "\n  ".join(
            " ".join(c) for c in bad) + "\n" + log)
    return log


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_arbiter_launch.argtypes = [p] * 12 + [i] * 3 + [p]
    lib.sweep_arbiter_launch.restype = i
    lib.sweep_mega_closed_launch.argtypes = [p] * 14 + [i] * 15 + [p]
    lib.sweep_mega_closed_launch.restype = i
    lib.sweep_mega_closed_plan.argtypes = [i] * 10 + [p]
    lib.sweep_mega_closed_plan.restype = i
    lib.sweep_mega_open_launch.argtypes = [p] * 11 + [i] * 11 + [p]
    lib.sweep_mega_open_launch.restype = i
    lib.sweep_mega_open_plan.argtypes = [i] * 8 + [p]
    lib.sweep_mega_open_plan.restype = i
    lib.sweep_error_string.argtypes = [i]
    lib.sweep_error_string.restype = ctypes.c_char_p
    # the float kernels: one entry point per input dtype
    for dt in ("f32", "bf16"):
        getattr(lib, f"kv_quant_{dt}_launch").argtypes = [p] * 3 + [i] * 7 \
            + [p]
        getattr(lib, f"paged_attention_{dt}_launch").argtypes = \
            [p] * 9 + [i] * 7 + [p]
        getattr(lib, f"flash_attention_{dt}_launch").argtypes = \
            [p] * 4 + [i] * 7 + [p]
    lib.flash_attention_f32_lse_launch.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.flash_attention_bwd_f32_launch.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.mamba2_ssd_f32_launch.argtypes = [p] * 9 + [i] * 8 + [p]
    for name in ("kv_quant_f32", "kv_quant_bf16", "paged_attention_f32",
                 "paged_attention_bf16", "flash_attention_f32",
                 "flash_attention_f32_lse", "flash_attention_bwd_f32",
                 "flash_attention_bf16", "mamba2_ssd_f32"):
        getattr(lib, f"{name}_launch").restype = i


def load() -> ctypes.CDLL:
    """The kernels' shared library, built from the sources in the package
    at first use (see the module docstring)."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    fields_h = _fields_header()
    h = hashlib.sha256()
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(fields_h.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    out = build_dir() / tag
    so = out / "librepro_torch_kernels.so"
    t0 = time.perf_counter()
    log, reused = "", so.is_file()
    if not reused:
        nvcc = _find_nvcc()
        out.mkdir(parents=True, exist_ok=True)
        (out / "sweep_fields.h").write_text(fields_h)
        objs = [out / (s.stem + ".o") for s in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(out), "-I", str(CSRC),
                         "-c", str(s), "-o", str(o)]
                        for s, o in zip(sources, objs)])
        tmp = out / f"librepro_torch_kernels.{os.getpid()}.so"
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    info.update(path=str(so), reused=reused, log=log,
                seconds=0.0 if reused else time.perf_counter() - t0)
    _lib = lib
    return lib


def error_string(err: int) -> str:
    """`cudaGetErrorString` for a code returned by a launch function."""
    return load().sweep_error_string(int(err)).decode()


def launch(name: str, *args) -> None:
    """Call the C launch function `name` (pointers and the stream as
    ints) and raise with CUDA's message if it returns an error: a launch
    the device refuses never runs, and a later synchronize does not
    report it."""
    err = getattr(load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({error_string(err)})")


def check_tensor(fn: str, name: str, x, *, dtypes, ndim: int,
                 device=None) -> None:
    """Raise unless `x` is a contiguous tensor of one of `dtypes` with
    `ndim` dimensions (on `device`, when given; on a card, 16-byte
    aligned): what a kernel wrapper checks before it hands pointers to a
    launch function."""
    import torch
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if x.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} has dtype {x.dtype}, expected one "
                        f"of {', '.join(map(str, dtypes))}")
    if x.dim() != ndim:
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                         f"expected {ndim} dimensions")
    if device is not None and x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, expected "
                         f"{device}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must start on a 16-byte boundary "
                         f"(the kernels load 4 elements at a time)")
