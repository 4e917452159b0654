"""Build and bind the kernels (fixture corpus): the generated constants
header and a `_bind` whose ctypes declarations match the C launchers
(CU501, CU504)."""
import ctypes


def _fields_header() -> str:
    from repro_torch.core.sweep import fields, policies
    from repro_torch.core.sweep.engine import MAX_LAT_TICKS
    lines = ["#pragma once"]
    for name in fields.__all__:
        lines.append(f"#define {name} {int(getattr(fields, name))}")
    for name in sorted(n for n in vars(policies) if n.startswith("KIND_")):
        lines.append(f"#define {name} {int(getattr(policies, name))}")
    lines.append(f"#define MAX_LAT_TICKS {int(MAX_LAT_TICKS)}")
    return "\n".join(lines) + "\n"


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_arbiter_launch.argtypes = [p] * 3 + [i] * 2 + [p]
    lib.sweep_arbiter_launch.restype = i
    lib.sweep_error_string.argtypes = [i]
    lib.sweep_reset_launch.argtypes = [p, i, p]
    lib.sweep_reset_launch.restype = i
    lib.sweep_error_string.restype = ctypes.c_char_p
    for dt in ("f32", "bf16"):
        getattr(lib, f"flash_attention_{dt}_launch").argtypes = \
            [p] * 4 + [i] * 3 + [p]
    for name in ("flash_attention_f32", "flash_attention_bf16"):
        getattr(lib, f"{name}_launch").restype = i


def load():
    lib = ctypes.CDLL("librepro_torch_kernels.so")
    _bind(lib)
    return lib


def launch(name, *args):
    err = getattr(load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
