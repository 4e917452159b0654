"""Op-level analysis of one eager PyTorch call: FLOPs, device-memory bytes
and the roofline of one H100 — the dry run's instrument.

The counterpart of the reference's `parallel/hlo_analysis.py`, renamed as
`core/sweep/torchbody.py` is: there is no compiled HLO to parse.
`analyze_ops(fn, *args, **kwargs)` runs ``fn`` under a
`TorchDispatchMode`, which sees every aten op the call dispatches,
autograd's backward included, on any device (`meta` too, where nothing is
computed). Eager PyTorch runs each aten op that is not a view as one
kernel (or a fill or copy), the counterpart of HLO's top-level
instructions, so per op:

  * ``dot_flops``: the products' FLOPs as `torch.utils.flop_counter`
    counts them (2·m·n·k a matrix product), also by the products' dtype;
  * ``flops``: ``dot_flops`` plus one a result element of every other op
    that computes (copies, fills and gathers count none), the reference's
    approximation;
  * ``hbm_bytes``: the bytes of the operands (each tensor's strided span,
    so a broadcast operand counts its distinct elements) plus those of
    the result;
  * ``n_instructions``: the ops counted;
  * ``wire_bytes`` 0, ``collective_counts`` and ``collective_wire`` {}:
    one card has no collectives.

Views, `empty` and aliases move nothing and count nothing. What the
dispatcher never sees is not counted: a kernel launched through ctypes
(the port's CUDA kernels) writes into a tensor the wrapper allocated, so
only that allocation shows; on the card, kernels E and F are invisible.

On `meta` an op's outputs and counts depend only on its arguments'
shapes, strides and dtypes and its other arguments, so they are computed
once a signature: a repeat of an op that returns fresh tensors gets fresh
`meta` tensors of the recorded layout without running the op's Python
meta kernel again. The plain attention's loop over score blocks repeats
the same few ops thousands of times a layer; this is what makes a
32k-token prefill cell take seconds, not minutes.

Peaks (`PEAK_FLOPS`, `HBM_BW`): one H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit): bf16 and fp16 tensor cores 989e12, TF32 495e12,
float32 on the CUDA cores 67e12, HBM 3.35e12 B/s. A product runs at the
peak of its dtype (float32 at TF32's when
`torch.backends.cuda.matmul.allow_tf32` is set while it is counted); every
other FLOP at the float32 rate.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: dense peak FLOP/s of one H100 SXM by the products' dtype
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
#: device-memory bytes a second of one H100 SXM (80 GB HBM3)
HBM_BW = 3.35e12
#: device memory of one H100, bytes (the dry run's `fits_one_card`)
HBM_BYTES = 80e9

_aten = torch.ops.aten
#: ops that allocate or alias without touching memory
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten._unsafe_view.default,
         _aten.detach.default, _aten.alias.default,
         _aten.lift_fresh.default}
#: ops that only move or fill memory: bytes, no FLOPs
_MOVES = {"copy_", "_to_copy", "clone", "cat", "stack", "constant_pad_nd",
          "index", "index_select", "gather", "slice_scatter",
          "select_scatter", "fill_", "zero_", "zeros", "ones", "full",
          "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
          "new_full", "arange", "scalar_tensor", "repeat", "index_put_",
          "index_put", "scatter", "tril", "triu", "embedding",
          "embedding_dense_backward"}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the memory `t` covers: its strided span, at most its
    element count (a broadcast reads each distinct element once)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(span, t.numel()) * t.element_size()


def tree_bytes(obj) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples."""
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _product_dtype(dtype: torch.dtype) -> str:
    name = str(dtype).replace("torch.", "")
    if name == "float32" and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return name if name in PEAK_FLOPS else "float32"


@dataclass
class OpAnalysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_counts: dict = field(default_factory=dict)
    collective_wire: dict = field(default_factory=dict)
    dot_flops: float = 0.0
    n_instructions: int = 0
    dot_flops_by_dtype: dict = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0

    def roofline(self) -> dict:
        """The reference's roofline terms on one H100: seconds of compute
        (each product at its dtype's peak, the rest at float32's), of
        memory and of collectives (0), the dominant one and the bound."""
        ct = sum(f / PEAK_FLOPS[dt] for dt, f in
                 self.dot_flops_by_dtype.items())
        ct += (self.flops - self.dot_flops) / PEAK_FLOPS["float32"]
        mt = self.hbm_bytes / HBM_BW
        lt = 0.0
        dom = max((("compute", ct), ("memory", mt), ("collective", lt)),
                  key=lambda kv: kv[1])
        return {"compute_s": ct, "memory_s": mt, "collective_s": lt,
                "dominant": dom[0], "bound_s": dom[1]}


def _counts(func, args, kwargs, res):
    """(bytes, FLOPs, product FLOPs, product dtype) of one counted op."""
    results = list(_tensors(res))
    nbytes = (sum(_span_bytes(t) for t in _tensors((args, kwargs)))
              + sum(t.numel() * t.element_size() for t in results))
    packet = func.overloadpacket
    if packet in flop_registry:
        f = float(flop_registry[packet](*args, **kwargs, out_val=res))
        return nbytes, f, f, _product_dtype(results[0].dtype)
    if packet.__name__ in _MOVES:
        return nbytes, 0.0, 0.0, None
    return nbytes, float(sum(t.numel() for t in results)), 0.0, None


class _Unkeyed(Exception):
    pass


def _key(obj):
    """A hashable signature of an op's arguments, all tensors on `meta`;
    raises `_Unkeyed` for anything else."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "meta":
            raise _Unkeyed
        return ("T", obj.shape, obj.stride(), obj.storage_offset(),
                obj.dtype)
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_key(o) for o in obj)
    if isinstance(obj, dict):
        return ("D",) + tuple((k, _key(v)) for k, v in sorted(obj.items()))
    if obj is None or isinstance(obj, (bool, int, float, str, torch.dtype,
                                       torch.device, torch.layout,
                                       torch.memory_format)):
        return (type(obj).__name__, obj)
    if isinstance(obj, torch.Generator):
        return ("G",)                 # meta draws nothing
    raise _Unkeyed


def _fresh(func) -> bool:
    """The op returns new tensors and writes none of its arguments."""
    schema = func._schema
    return not any(a.alias_info is not None
                   for a in list(schema.arguments) + list(schema.returns))


def _template(res):
    if isinstance(res, torch.Tensor):
        return ("T", res.shape, res.stride(), res.dtype)
    if isinstance(res, (list, tuple)):
        return (type(res),) + tuple(_template(r) for r in res)
    return ("V", res)


def _rebuild(tpl):
    if tpl[0] == "T":
        return torch.empty_strided(tpl[1], tpl[2], dtype=tpl[3],
                                   device="meta")
    if tpl[0] == "V":
        return tpl[1]
    return tpl[0](_rebuild(t) for t in tpl[1:])


class _Counter(TorchDispatchMode):
    def __init__(self, out: OpAnalysis):
        super().__init__()
        self.out = out
        self.memo: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view or func in _FREE:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except _Unkeyed:
            key = None
        hit = self.memo.get(key) if key is not None else None
        if hit is not None and hit[0] is not None:
            res = _rebuild(hit[0])
        else:
            res = func(*args, **kwargs)
        if hit is not None:
            counts = hit[1]
        else:
            counts = _counts(func, args, kwargs, res)
            if key is not None:
                on_meta = all(t.device.type == "meta" for t in _tensors(res))
                self.memo[key] = (_template(res) if _fresh(func) and on_meta
                                  else None, counts)
        o = self.out
        nbytes, flops, dot, dt = counts
        o.n_instructions += 1
        o.hbm_bytes += nbytes
        o.flops += flops
        if dt is not None:
            o.dot_flops += dot
            o.dot_flops_by_dtype[dt] = o.dot_flops_by_dtype.get(dt, 0.0) + dot
        return res


def analyze_ops(fn, *args, **kwargs) -> OpAnalysis:
    """Run ``fn(*args, **kwargs)`` once, counting every aten op it
    dispatches (module docstring); ``argument_bytes`` and
    ``output_bytes`` are the tensors of its arguments and its result."""
    out = OpAnalysis(argument_bytes=tree_bytes((args, kwargs)))
    with _Counter(out):
        res = fn(*args, **kwargs)
    out.output_bytes = tree_bytes(res)
    return out
