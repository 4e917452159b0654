"""Op-level analysis of one eager PyTorch call: FLOPs, device-memory bytes,
collectives and the roofline of an H100 — the dry run's instrument.

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
  * ``n_instructions``: the ops counted, collectives included;
  * ``collective_counts``, ``collective_wire`` (by the reference's names:
    ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) and ``wire_bytes``: each collective of
    `torch.distributed`'s functional API (`_c10d_functional`, and
    DTensor's `_dtensor.shard_dim_alltoall`) with the wire bytes of the
    reference's ring model (`_wire_bytes`, from the local result's and
    operand's bytes and the group's size); a collective counts no FLOPs
    and no device-memory bytes. ``collective_links`` names, a kind, the
    links its groups cross (``nvlink`` within a node of
    `CARDS_PER_NODE` consecutive ranks, ``ib`` across nodes), and
    ``link_wire`` sums the wire bytes by link. A call on plain tensors
    has none of them.

**A sharded call** (DTensor arguments, a mesh; `launch/mesh.py`) is
counted a device, for rank 0: the mode lets DTensor dispatch each op
(it declines every op whose types hold a DTensor), so what it sees is
the local op on each rank's shard and each collective DTensor runs on
it. DTensor's own bookkeeping runs uncounted (`_DTENSOR_INTERNALS`, by
the Python frames that call it): the ops its sharding propagation runs
at global shapes (on `FakeTensor`s, or on `meta` tensors to trace a
decomposition) once a signature, which, counted, would come and go
with what its caches hold from earlier calls; and the ops that lay out
a mesh.
``argument_bytes`` and ``output_bytes`` count each DTensor's local
shard; rank 0 holds the largest shard of an uneven dimension, the
reference's padded shard.

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
other FLOP at the float32 rate. Links (`LINK_BW`, NVIDIA's data sheets):
NVLink 4 within an HGX node of `CARDS_PER_NODE` = 8 cards, 450e9 B/s a
direction a card (`NVLINK_BW`); across nodes one 400 Gb/s InfiniBand
NIC a card, 50e9 B/s (`IB_BW`). The reference has one rate, its TPU
pod's ICI; here a collective's wire bytes go at the rate of the slowest
link its group crosses.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: dense peak FLOP/s of one H100 SXM by the products' dtype
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
#: device-memory bytes a second of one H100 SXM (80 GB HBM3)
HBM_BW = 3.35e12
#: device memory of one H100, bytes (the dry run's `fits_one_card`)
HBM_BYTES = 80e9
#: bytes a second a direction of one card's links: NVLink 4 within a node,
#: one 400 Gb/s InfiniBand NIC a card across nodes
NVLINK_BW = 450e9
IB_BW = 50e9
LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}
#: cards of one node (HGX H100), consecutive ranks
CARDS_PER_NODE = 8

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
#: `torch.distributed`'s functional collectives by the reference's names,
#: in-place, `_out` and coalesced forms under their base name (DTensor's
#: Shard-to-Shard all-to-all is an op of its own); a send is this
#: device's half of a point-to-point exchange, its receive the other's
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all",
                "isend": "collective-permute",
                "batch_p2p_ops": "collective-permute"}
#: functional-collective ops that move nothing
_COLLECTIVE_FREE = {"wait_tensor", "_wrap_tensor_autograd", "irecv"}
_COLLECTIVE_NS = ("_c10d_functional", "_dtensor")
#: DTensor's modules whose ops are its bookkeeping, not a device's work:
#: sharding propagation, decomposition tracing, mesh layout
_DTENSOR_INTERNALS = ("/distributed/tensor/_sharding_prop.py",
                      "/distributed/tensor/_decompositions.py",
                      "/distributed/device_mesh.py")


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
    """Bytes of every tensor in a tree of dicts, lists and tuples; of a
    DTensor, this rank's shard."""
    return sum(_local(t).numel() * t.element_size() for t in _tensors(obj))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _wire_bytes(op: str, result_b: float, operand_b: float, g: int) -> float:
    """The reference's ring model (`hlo_analysis._wire_bytes`): bytes one
    device sends for collective `op` over a group of `g`."""
    frac = (g - 1) / g if g > 1 else 0.0
    if op == "all-gather":
        return result_b * frac
    if op == "all-reduce":
        return 2.0 * result_b * frac
    if op == "reduce-scatter":
        return operand_b * frac
    if op == "all-to-all":
        return result_b * frac
    return float(result_b)  # collective-permute crosses a link once


def _in_dtensor_internals() -> bool:
    """Whether the op being dispatched was called by DTensor's own
    bookkeeping (`_DTENSOR_INTERNALS`)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_DTENSOR_INTERNALS):
            return True
        f = f.f_back
    return False


def _group(args) -> tuple:
    """(size, link) of the process group a collective names: its name is
    the op's last string argument. ``ib`` when its ranks span more than
    one node of `CARDS_PER_NODE` consecutive ranks, else ``nvlink``."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    ranks = dist.get_process_group_ranks(_resolve_process_group(name))
    nodes = {r // CARDS_PER_NODE for r in ranks}
    return len(ranks), ("ib" if len(nodes) > 1 else "nvlink")


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
    collective_links: dict = field(default_factory=dict)
    link_wire: dict = field(default_factory=dict)

    def roofline(self) -> dict:
        """The reference's roofline terms on an H100: seconds of compute
        (each product at its dtype's peak, the rest at float32's), of
        memory and of collectives (each link's wire bytes at its rate),
        the dominant one and the bound."""
        ct = sum(f / PEAK_FLOPS[dt] for dt, f in
                 self.dot_flops_by_dtype.items())
        ct += (self.flops - self.dot_flops) / PEAK_FLOPS["float32"]
        mt = self.hbm_bytes / HBM_BW
        lt = sum((w / LINK_BW[link] for link, w in self.link_wire.items()),
                 0.0)
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
    """A hashable signature of an op's arguments, all tensors plain and on
    `meta`; raises `_Unkeyed` for anything else (a DTensor's device is
    `meta` too, but its result must stay a DTensor)."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "meta" or isinstance(obj, DTensor):
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
        self.sharded = False          # a DTensor op has been seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.sharded = True
            return NotImplemented   # DTensor runs it: its local ops come back
        if func.is_view or func in _FREE:
            return func(*args, **kwargs)
        if self.sharded and _in_dtensor_internals():
            return func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NS:
            return self._collective(func, args, kwargs)
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

    def _collective(self, func, args, kwargs):
        res = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _COLLECTIVE_FREE:
            return res
        base = name.rstrip("_").removesuffix("_out").removesuffix(
            "_coalesced")
        kind = _COLLECTIVES.get(base)
        if kind is None:
            raise NotImplementedError(f"analyze_ops: collective {func} "
                                      f"is not counted")
        g, link = _group(args)
        result_b = sum(t.numel() * t.element_size() for t in _tensors(res))
        operand_b = sum(t.numel() * t.element_size()
                        for t in _tensors((args, kwargs)))
        wire = _wire_bytes(kind, result_b, operand_b, g)
        o = self.out
        o.n_instructions += 1
        o.wire_bytes += wire
        o.collective_counts[kind] = o.collective_counts.get(kind, 0) + 1
        o.collective_wire[kind] = o.collective_wire.get(kind, 0.0) + wire
        links = o.collective_links.setdefault(kind, [])
        if link not in links:
            links.append(link)
            links.sort()
        o.link_wire[link] = o.link_wire.get(link, 0.0) + wire
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
