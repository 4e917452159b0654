"""dtype pass — int32-closure hazards in the tick engines and kernels.

The sweep backends are bit-identical only because every stacked state
plane stays strictly int32 (tick contract section 3); the classic ways to
silently break that are untyped numpy or torch constructors (float64 /
float32 defaults), Python floats leaking into a state plane inside a tick
loop, host round trips inside the torch tick body (a sync with the card
every tick), and literals that overflow int32.

Rules
  DT201  np./torch. zeros/ones/empty/full without an explicit dtype
  DT202  np.arange / torch.arange without an explicit dtype
  DT203  host sync inside the torch tick body (`torchbody.py`'s `*_body`
         and `*_cond` functions and the functions nested in them): an
         ``np.`` call, ``.item()``, ``.cpu()``, ``.numpy()`` or
         ``.tolist()``
  DT204  int literal >= 2**31 outside a comparison guard
  DT205  float literal or true division assigned into a tick-loop state
         plane
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import (EvalError, base_name, eval_int,
                                    parent_map)
from repro_torch.analysis.core import Finding, RepoContext, register_pass

RULES = (
    ("DT201", "untyped np/torch array constructor"),
    ("DT202", "untyped np/torch arange"),
    ("DT203", "host sync inside the torch tick body"),
    ("DT204", "int literal overflows int32"),
    ("DT205", "float leakage into a state plane"),
)

#: constructors whose default dtype is floating: name -> index of the
#: positional slot that would carry an explicit dtype in numpy (torch
#: takes dtype by keyword only)
_CONSTRUCTORS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2}

#: array modules whose constructors the pass reads, and whether a
#: positional slot can carry the dtype
_MODULES = {"np": True, "torch": False}

#: stacked per-cell/per-bank state planes of the tick loops (engine.py
#: `_run_*` backends and sim.py `run_ticks`); assignments into these must
#: stay integral
STATE_PLANES = frozenset({
    "bank_free", "ref_until", "ref_sub", "open_row", "open_sub", "ctr",
    "ref_until_s", "open_row_s",
    "issued", "n_arrived", "n_served", "wpend", "score", "lat", "done",
    "lat_sum", "last_done", "phase", "rank_phase", "ab_pending",
    "rank_drain", "comp_t", "next_issue", "next_idx", "q_head", "q_tail",
    "out_reads", "remaining", "finish", "h_arr", "h_row", "h_sub", "h_w",
    "next_arrive", "age", "due", "lag", "demand", "occ",
})

#: prefixes of engine functions whose bodies ARE the tick loops
_TICK_FN_PREFIXES = ("_run_", "run_ticks")

#: traced scopes: the torch tick body's step and loop-condition functions
_TRACED_SUFFIXES = ("_body", "_cond")

#: tensor methods that copy to the host and wait for the card
_SYNC_METHODS = frozenset({"item", "cpu", "numpy", "tolist"})

INT32_MAX = 2 ** 31


def _array_call(node: ast.Call, attr: str) -> str | None:
    """"np" or "torch" when ``node`` calls ``np.<attr>`` / ``torch.<attr>``."""
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr == attr
            and isinstance(f.value, ast.Name) and f.value.id in _MODULES):
        return f.value.id
    return None


def _has_dtype(node: ast.Call, pos_slot: int | None) -> bool:
    """An explicit ``dtype=``, a ``**kwargs`` that may carry it (as in
    ``torch.empty(shape, **i32)``), or a filled positional dtype slot."""
    if any(kw.arg in ("dtype", None) for kw in node.keywords):
        return True
    return pos_slot is not None and len(node.args) > pos_slot


def check_constructors(tree: ast.Module, path: str) -> list[Finding]:
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for ctor, slot in _CONSTRUCTORS.items():
            mod = _array_call(node, ctor)
            if mod and not _has_dtype(node, slot if _MODULES[mod] else None):
                out.append(Finding(
                    path, node.lineno, "DT201",
                    f"{mod}.{ctor} without an explicit dtype defaults to "
                    "a float type — state planes must be constructed with "
                    "a stated dtype"))
        mod = _array_call(node, "arange")
        if mod and not _has_dtype(node, 3 if _MODULES[mod] else None):
            out.append(Finding(
                path, node.lineno, "DT202",
                f"{mod}.arange without an explicit dtype is "
                "platform-widthed or inferred — state a dtype so int32 "
                "closure is visible"))
    return out


def _traced_defs(tree: ast.Module) -> list[ast.FunctionDef]:
    """Functions that run once a tick on the device's tensors: every
    ``*_body`` / ``*_cond`` function (the walk of each also covers the
    functions nested in it)."""
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)
            and node.name.endswith(_TRACED_SUFFIXES)]


def check_traced_np(tree: ast.Module, path: str) -> list[Finding]:
    out: list[Finding] = []
    seen: set[int] = set()
    for fn in _traced_defs(tree):
        for node in ast.walk(fn):
            what = None
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "np"):
                what = f"host np.{node.attr}"
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _SYNC_METHODS):
                what = f".{node.func.attr}()"
            if what is None or node.lineno in seen:
                continue
            seen.add(node.lineno)
            out.append(Finding(
                path, node.lineno, "DT203",
                f"{what} inside the tick body '{fn.name}' — a copy to the "
                "host and a wait for the card every tick; keep the op on "
                "the state's tensors"))
    return out


def _try_eval(node: ast.AST):
    try:
        return eval_int(node)
    except EvalError:
        return None


def check_overflow_literals(tree: ast.Module, path: str) -> list[Finding]:
    """Flag maximal constant expressions whose value cannot fit int32.

    Evaluating only *maximal* const subexpressions keeps legitimate
    spellings like ``(1 << 31) - 1`` clean (the whole expression fits even
    though the inner shift alone does not). Literals inside comparisons
    are guards (e.g. ``x >= 2 ** 31`` overflow checks), not plane values.
    """
    out: list[Finding] = []
    parents = parent_map(tree)

    def under_compare(n: ast.AST) -> bool:
        cur = n
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, ast.Compare):
                return True
            if isinstance(cur, ast.stmt):
                return False
        return False

    for node in ast.walk(tree):
        if not isinstance(node, (ast.Constant, ast.BinOp, ast.UnaryOp)):
            continue
        par = parents.get(node)
        if (isinstance(par, (ast.BinOp, ast.UnaryOp))
                and _try_eval(par) is not None):
            continue  # the maximal enclosing const expression reports
        val = _try_eval(node)
        if val is None or -INT32_MAX <= val < INT32_MAX:
            continue
        if under_compare(node):
            continue
        out.append(Finding(
            path, node.lineno, "DT204",
            f"constant expression evaluates to {val}, which does not fit "
            "int32"))
    return out


def _tick_fns(tree: ast.Module) -> list[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)
            and n.name.startswith(_TICK_FN_PREFIXES)]


def _has_float(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, float)):
            return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Div):
            return True
    return False


def check_plane_floats(tree: ast.Module, path: str) -> list[Finding]:
    out: list[Finding] = []
    for fn in _tick_fns(tree):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets, value = [node.target], node.value
            else:
                continue
            if value is None or not _has_float(value):
                continue
            for tgt in targets:
                name = base_name(tgt)
                # only subscript/attribute stores hit a plane in place;
                # a bare Name rebinding is a local scalar
                if (name in STATE_PLANES
                        and not isinstance(tgt, ast.Name)):
                    out.append(Finding(
                        path, node.lineno, "DT205",
                        f"float-valued expression stored into state plane "
                        f"'{name}' inside tick loop '{fn.name}' — planes "
                        "must stay integral (use // and int literals)"))
    return out


def check_module(ctx: RepoContext, rel: str) -> list[Finding]:
    tree = ctx.tree(rel)
    if tree is None:
        return []
    out = check_constructors(tree, rel)
    out += check_traced_np(tree, rel)
    out += check_overflow_literals(tree, rel)
    out += check_plane_floats(tree, rel)
    return out


@register_pass("dtype", rules=RULES)
def run(ctx: RepoContext) -> list[Finding]:
    """Walk the tick engines and kernels for int32-closure hazards."""
    out: list[Finding] = []
    targets = [ctx.ENGINE, ctx.TORCHBODY, ctx.SIM, ctx.ARBITER, ctx.FIELDS,
               ctx.SWEEP_POLICIES]
    targets += ctx.py_files(ctx.KERNELS_DIR)
    seen: set[str] = set()
    for rel in targets:
        if rel in seen:
            continue
        seen.add(rel)
        out.extend(check_module(ctx, rel))
    return out
