"""cuda-lint pass — what the CUDA kernels' build and bindings get wrong late.

The port's kernels are CUDA C++ under `kernels/csrc/`, compiled by
`kernels/_build.py` with `nvcc` into one library with a plain C interface
and called through `ctypes`. Faults there surface only on a card, and
some never do, so the cheap structural ones are checked here, from the
sources as text (C) or AST (Python), without a compiler:

* ABI drift — `_build._bind` spells every launcher's parameter list a
  second time as ctypes ``argtypes``, and ctypes never checks it against
  the C signature: a pointer passed where the C side reads an int, or one
  argument too few, is undefined behaviour on the card. Each bound name
  must be an ``extern "C"`` function of the sources with the same count
  and kinds (pointer for pointer, int for int), a ``restype`` wherever it
  returns ``int``, and every ``*_launch`` entry point must be bound.
  `_bind`'s loops over dtype suffixes and f-string names are unrolled.
* Grid floor division — a ``/`` in a launch grid (the first ``<<<``
  argument, the locals it names, or a ``dim3``) silently drops the tail
  unless it is the ceil idiom ``(n + b - 1) / b`` or the same function
  guards it with ``n % b``.
* No fallback — the port's rule inverts the Pallas interpret fallback:
  a CUDA tensor launches its kernel or raises. A ``try`` around a build,
  a launch or a kernel wrapper whose ``except`` does not re-raise, and a
  device branch that sends anything but ``cpu`` or ``meta`` (shape-only
  tensors) to the plain version, are both a silent fallback.
* Plane-table pinning — the sweep kernels' shared constants reach C
  only through `sweep_fields.h`, which `_build._fields_header()`
  generates from the Python sources of truth: no kernel module rebinds an
  ``MP_*``/``MS_*``/``MEGA_*`` name, no source ``#define``s a generated
  name or spells one of its distinctive values (|v| >= 1024) as a
  literal, and every ``sweep_*`` source includes the header.
* Dropped state plane — a key initialised by ``<mode>_state0`` but
  missing from ``<mode>_body``'s returned dict (`core/sweep/torchbody.py`)
  is a plane the tick loop freezes at its first value (PL505, unchanged).

Rules
  CU501  C launcher ABI and `_bind`'s ctypes declarations disagree
  CU502  grid floor-divided without a ceil idiom or divisibility guard
  CU503  silent fallback from a kernel to the plain version
  CU504  shared constant not pinned to the generated fields header
  CU505  tick-state plane dropped from a body's return dict
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.astutil import (EvalError, attr_chain, call_name,
                                          eval_int, module_int_env)
from repro_torch.analysis.core import Finding, RepoContext, register_pass

RULES = (
    ("CU501", "C launcher ABI and ctypes argtypes/restype disagree"),
    ("CU502", "grid floor-division without ceil or divisibility guard"),
    ("CU503", "silent fallback from a kernel to the plain version"),
    ("CU504", "shared constant not pinned to the generated fields header"),
    ("CU505", "tick-state plane dropped from a body's return dict"),
)

_SWEEP_DIR = "src/repro_torch/core/sweep"
_MODELS_DIR = "src/repro_torch/models"
_ANALYSIS_DIR = "src/repro_torch/analysis"
_HEADER = "sweep_fields.h"

# ------------------------------------------------------------ C sources


def strip_comments(src: str) -> str:
    """``//`` and ``/* */`` comments blanked to spaces, newlines kept, so
    offsets and line numbers are those of the source. String literals
    are left alone (``extern "C"`` is one)."""
    out = list(src)
    i, n = 0, len(src)
    while i < n:
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [c if c == "\n" else " " for c in src[i:j]]
            i = j
        elif src[i] == '"':
            j = i + 1
            while j < n and src[j] != '"':
                j += 2 if src[j] == "\\" else 1
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _c_kind(decl: str) -> str:
    """ABI kind of a C parameter or return type: p(ointer), i(nt),
    l(ong long), f(loat), d(ouble), v(oid), ?(unknown)."""
    if "*" in decl or "[" in decl:
        return "p"
    words = re.findall(r"[A-Za-z_]\w*", decl)
    words = [w for w in words if w not in ("const", "volatile", "signed",
                                           "__restrict__", "restrict")]
    types = set(words)
    if {"long"} <= types and words.count("long") >= 2 or types & {
            "int64_t", "size_t", "ssize_t", "uint64_t", "ptrdiff_t"}:
        return "l"
    if types & {"int", "unsigned", "int32_t", "uint32_t"}:
        return "i"
    if "float" in types:
        return "f"
    if "double" in types:
        return "d"
    if words == ["void"]:
        return "v"
    return "?"


_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+([A-Za-z_][\w\s\*]*?)\s*\b([A-Za-z_]\w*)\s*\(([^)]*)\)'
    r'\s*\{')


def extern_c_functions(ctx: RepoContext) -> dict[str, dict]:
    """name -> {"path", "line", "ret", "params": [kind, ...]} for every
    ``extern "C"`` function defined in the kernel sources."""
    out: dict[str, dict] = {}
    for rel in ctx.files(ctx.CSRC_DIR, "*.cu"):
        text = strip_comments(ctx.text(rel) or "")
        for m in _EXTERN_RE.finditer(text):
            params = [p.strip() for p in m.group(3).split(",")]
            kinds = [] if params in ([""], ["void"]) else [
                _c_kind(p) for p in params]
            out[m.group(2)] = dict(path=rel, line=_line(text, m.start()),
                                   ret=_c_kind(m.group(1)), params=kinds)
    return out


# ---------------------------------------------------------- _bind table

#: ctypes names -> ABI kind
_CTYPES = {
    "c_void_p": "p", "c_char_p": "p", "c_wchar_p": "p",
    "c_int": "i", "c_int32": "i", "c_uint": "i", "c_uint32": "i",
    "c_longlong": "l", "c_int64": "l", "c_ulonglong": "l",
    "c_uint64": "l", "c_size_t": "l", "c_ssize_t": "l",
    "c_float": "f", "c_double": "d",
}


class _Unknown(Exception):
    pass


def _eval_bind(node: ast.AST, env: dict):
    """Value of an expression of `_bind`: a kind string for a ctypes
    type, a list of kinds, a str, or a tuple of strs."""
    if isinstance(node, ast.Constant) and isinstance(node.value,
                                                     (str, int)):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise _Unknown(node.id)
    if isinstance(node, ast.Attribute):
        if node.attr in _CTYPES:
            return _CTYPES[node.attr]
        raise _Unknown(node.attr)
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func) or []
        if chain[-1:] == ["POINTER"]:
            return "p"
        raise _Unknown(ast.dump(node.func))
    if isinstance(node, (ast.List, ast.Tuple)):
        vals = [_eval_bind(e, env) for e in node.elts]
        return vals if isinstance(node, ast.List) else tuple(vals)
    if isinstance(node, ast.BinOp):
        a, b = _eval_bind(node.left, env), _eval_bind(node.right, env)
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Mult):
            return a * b
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            val = _eval_bind(v.value if isinstance(v, ast.FormattedValue)
                             else v, env)
            parts.append(str(val))
        return "".join(parts)
    raise _Unknown(type(node).__name__)


def _bound_name(target: ast.AST, env: dict) -> tuple[str, str] | None:
    """(function name, "argtypes"/"restype") for ``lib.NAME.argtypes`` or
    ``getattr(lib, <name expr>).restype``."""
    if not (isinstance(target, ast.Attribute)
            and target.attr in ("argtypes", "restype")):
        return None
    owner = target.value
    if isinstance(owner, ast.Attribute):
        return owner.attr, target.attr
    if (isinstance(owner, ast.Call) and isinstance(owner.func, ast.Name)
            and owner.func.id == "getattr" and len(owner.args) == 2):
        name = _eval_bind(owner.args[1], env)
        if isinstance(name, str):
            return name, target.attr
    return None


def bind_table(tree: ast.Module) -> tuple[dict, dict, list[int]]:
    """``(argtypes, restypes, unreadable)`` of `_bind`: name -> (value,
    line) for each, and the lines of statements the pass cannot read."""
    argtypes: dict[str, tuple[list, int]] = {}
    restypes: dict[str, tuple[str, int]] = {}
    unreadable: list[int] = []
    fn = next((n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "_bind"), None)
    if fn is None:
        return argtypes, restypes, unreadable

    def walk(stmts, env):
        for st in stmts:
            try:
                if isinstance(st, ast.Assign):
                    tgt = st.targets[0]
                    if isinstance(tgt, ast.Tuple):
                        vals = _eval_bind(st.value, env)
                        for t, v in zip(tgt.elts, vals):
                            env[t.id] = v
                    elif isinstance(tgt, ast.Name):
                        env[tgt.id] = _eval_bind(st.value, env)
                    else:
                        hit = _bound_name(tgt, env)
                        if hit is None:
                            raise _Unknown("target")
                        name, what = hit
                        val = _eval_bind(st.value, env)
                        (argtypes if what == "argtypes"
                         else restypes)[name] = (val, st.lineno)
                elif isinstance(st, ast.For):
                    for v in _eval_bind(st.iter, env):
                        walk(st.body, {**env, st.target.id: v})
                elif isinstance(st, ast.Expr) and isinstance(st.value,
                                                             ast.Constant):
                    pass
                else:
                    raise _Unknown(type(st).__name__)
            except (_Unknown, AttributeError, TypeError):
                unreadable.append(st.lineno)

    walk(fn.body, {})
    return argtypes, restypes, unreadable


def check_abi(ctx: RepoContext) -> list[Finding]:
    """CU501 — `_bind`'s ctypes declarations against the C signatures."""
    out: list[Finding] = []
    tree = ctx.tree(ctx.BUILD)
    if tree is None:
        return out
    funcs = extern_c_functions(ctx)
    argtypes, restypes, unreadable = bind_table(tree)
    for line in unreadable:
        out.append(Finding(ctx.BUILD, line, "CU501",
                           "statement of _bind the ABI check cannot read "
                           "— spell ctypes declarations as lib.NAME.argtypes"
                           " = [...] lists, loops over literal tuples"))
    for name in sorted(set(argtypes) | set(restypes)):
        line = (argtypes.get(name) or restypes[name])[1]
        c = funcs.get(name)
        if c is None:
            out.append(Finding(ctx.BUILD, line, "CU501",
                               f"_bind declares '{name}', which no "
                               "extern \"C\" function of csrc/*.cu "
                               "defines"))
            continue
        where = f"{c['path']}:{c['line']}"
        if name in argtypes:
            got, line = argtypes[name]
            if len(got) != len(c["params"]):
                out.append(Finding(
                    ctx.BUILD, line, "CU501",
                    f"'{name}' takes {len(c['params'])} parameters "
                    f"({where}) but _bind gives {len(got)} argtypes"))
            else:
                bad = [k for k, (a, b) in enumerate(zip(got, c["params"]))
                       if a != b]
                if bad:
                    k = bad[0]
                    out.append(Finding(
                        ctx.BUILD, line, "CU501",
                        f"'{name}' parameter {k} is {c['params'][k]!r} in "
                        f"C ({where}) but {got[k]!r} in _bind (p pointer, "
                        "i int, l long long, f float, d double)"))
        if c["ret"] == "i" and restypes.get(name, ("?",))[0] != "i":
            out.append(Finding(
                ctx.BUILD, (restypes.get(name) or argtypes[name])[1],
                "CU501",
                f"'{name}' returns int ({where}); _bind must set its "
                "restype to ctypes.c_int so the error code is read"))
    for name, c in sorted(funcs.items()):
        if name.endswith("_launch") and name not in argtypes:
            out.append(Finding(
                c["path"], c["line"], "CU501",
                f"launcher '{name}' has no argtypes in _build._bind — "
                "ctypes would pass every pointer as a 32-bit int"))
    return out


# -------------------------------------------------------- grid divisions


def function_bodies(text: str) -> list[tuple[int, int]]:
    """(start, end) offsets of the outermost function bodies of a C++
    source: blocks whose header ends in ``)`` (or ``) const``), outside
    any other function; namespaces, structs and ``extern "C"`` blocks are
    walked into."""
    spans: list[tuple[int, int]] = []
    stack: list[tuple[int, bool]] = []  # (open offset, is function)
    last = 0
    for i, ch in enumerate(text):
        if ch in ";{}":
            if ch == "{":
                header = text[last:i].strip()
                in_fn = any(f for _, f in stack)
                is_fn = (not in_fn and re.search(r"\)\s*(const)?\s*$",
                                                 header) is not None
                         and not re.match(r"(if|for|while|switch)\b",
                                          header))
                stack.append((i, is_fn))
            elif ch == "}" and stack:
                start, is_fn = stack.pop()
                if is_fn:
                    spans.append((start, i + 1))
            last = i + 1
    return spans


def _balanced(text: str, i: int, step: int) -> int:
    """Offset just past the bracket group starting at ``text[i]`` (an
    opening bracket for step 1, a closing one for step -1)."""
    opens, closes = ("([", ")]") if step == 1 else (")]", "([")
    depth = 0
    while 0 <= i < len(text):
        if text[i] in opens:
            depth += 1
        elif text[i] in closes:
            depth -= 1
            if depth == 0:
                return i + step
        i += step
    return i


def _norm(s: str) -> str:
    s = re.sub(r"\s+", "", s)
    while s.startswith("(") and _balanced(s, 0, 1) == len(s):
        s = s[1:-1]
    return s


def _operand_left(expr: str, i: int) -> str:
    j = i - 1
    while j >= 0 and expr[j].isspace():
        j -= 1
    if j >= 0 and expr[j] in ")]":
        k = _balanced(expr, j, -1) + 1
        return expr[k:j + 1]
    k = j
    while k >= 0 and (expr[k].isalnum() or expr[k] in "_."):
        k -= 1
    return expr[k + 1:j + 1]


def _operand_right(expr: str, i: int) -> str:
    j = i + 1
    while j < len(expr) and expr[j].isspace():
        j += 1
    if j < len(expr) and expr[j] == "(":
        return expr[j:_balanced(expr, j, 1)]
    k = j
    while k < len(expr) and (expr[k].isalnum() or expr[k] in "_."):
        k += 1
    return expr[j:k]


def _division_ok(num: str, den: str, body: str) -> bool:
    n, d = _norm(num), _norm(den)
    ceil = re.fullmatch(r"(.+)\+\(?" + re.escape(d) + r"-1\)?", n)
    if ceil:
        return True
    flat = re.sub(r"\s+", "", body)
    return f"{n}%{d}" in flat or f"({n})%{d}" in flat


def _split_args(s: str) -> list[str]:
    out, depth, cur = [], 0, ""
    for ch in s:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def grid_expressions(body: str) -> list[tuple[int, str]]:
    """(offset in ``body``, text) of each launch grid: the first ``<<<``
    argument, the initializer of each local it names, and every
    ``dim3`` built in the body."""
    exprs: list[tuple[int, str]] = []
    for m in re.finditer(r"<<<(.*?)>>>", body, re.S):
        grid = _split_args(m.group(1))[0]
        exprs.append((m.start(1), grid))
        for name in set(re.findall(r"[A-Za-z_]\w*", grid)):
            d = re.search(r"\b" + name + r"\s*(?:=\s*([^;]+);|\(([^;]*)\);)",
                          body[:m.start()])
            if d and re.search(r"\b(int|long|unsigned|dim3|auto|size_t)\b"
                               r"[\w\s\*]*$", body[:d.start()]):
                exprs.append((d.start(), d.group(1) or d.group(2)))
    for m in re.finditer(r"\bdim3\s*(?:[A-Za-z_]\w*\s*)?\(", body):
        start = m.end() - 1
        exprs.append((start, body[start:_balanced(body, start, 1)]))
    return exprs


def check_grids(ctx: RepoContext) -> list[Finding]:
    """CU502 — every ``/`` in a launch grid is a ceil or guarded."""
    out: list[Finding] = []
    for rel in ctx.files(ctx.CSRC_DIR, "*.cu") + ctx.files(ctx.CSRC_DIR,
                                                             "*.cuh"):
        text = strip_comments(ctx.text(rel) or "")
        seen: set[int] = set()
        for s, e in function_bodies(text):
            body = text[s:e]
            for off, expr in grid_expressions(body):
                for m in re.finditer(r"/", expr):
                    num = _operand_left(expr, m.start())
                    den = _operand_right(expr, m.start())
                    line = _line(text, s + off + m.start())
                    if _division_ok(num, den, body) or line in seen:
                        continue
                    seen.add(line)
                    out.append(Finding(
                        rel, line, "CU502",
                        f"grid divides {_norm(num)} by {_norm(den)} with no "
                        f"ceil idiom ((n + b - 1) / b) and no "
                        f"`{_norm(num)} % {_norm(den)}` guard in the "
                        "function — a size the block does not divide drops "
                        "its tail"))
    return out


# ------------------------------------------------------------ fallbacks

#: device types a branch may send to the plain version: the CPU, where
#: the tests run it, and `meta`, which computes shapes only
PLAIN_DEVICES = frozenset({"cpu", "meta"})

_LAUNCH_CALLS = frozenset({"_launch", "launch", "load"})


def kernel_wrappers(ctx: RepoContext) -> set[str]:
    """Names of the functions in kernel modules that launch a kernel:
    those that bump a ``*LAUNCHES`` counter, and those calling one."""
    direct: set[str] = set()
    calls: dict[str, set[str]] = {}
    for rel in ctx.py_files(ctx.KERNELS_DIR):
        tree = ctx.tree(rel)
        if tree is None:
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            names = {call_name(c) for c in ast.walk(fn)
                     if isinstance(c, ast.Call)}
            calls[fn.name] = calls.get(fn.name, set()) | names
            if any(isinstance(n, ast.AugAssign)
                   and isinstance(n.target, ast.Name)
                   and n.target.id.endswith("LAUNCHES")
                   for n in ast.walk(fn)):
                direct.add(fn.name)
    wrappers = set(direct)
    changed = True
    while changed:
        changed = False
        for name, called in calls.items():
            if name not in wrappers and called & wrappers:
                wrappers.add(name)
                changed = True
    return wrappers


def _launches(nodes: list[ast.AST], wrappers: set[str]) -> bool:
    for st in nodes:
        for c in ast.walk(st):
            if not isinstance(c, ast.Call):
                continue
            name = call_name(c) or ""
            if (name in _LAUNCH_CALLS or name in wrappers
                    or name.endswith(("_launch", "_on_card"))):
                return True
    return False


def _raises(nodes: list[ast.AST]) -> bool:
    return bool(nodes) and isinstance(nodes[-1], ast.Raise)


def _terminates(nodes: list[ast.AST]) -> bool:
    return bool(nodes) and isinstance(nodes[-1], (ast.Return, ast.Raise))


class _DevSet:
    """A set of device types, or the complement of one (``neg``)."""

    def __init__(self, names=(), neg=False):
        self.names, self.neg = frozenset(names), neg

    def inter(self, o):
        if not self.neg and not o.neg:
            return _DevSet(self.names & o.names)
        if self.neg and o.neg:
            return _DevSet(self.names | o.names, True)
        pos, neg = (self, o) if not self.neg else (o, self)
        return _DevSet(pos.names - neg.names)

    def minus(self, o):
        return self.inter(_DevSet(o.names, not o.neg))

    def plain_ok(self):
        return not self.neg and self.names <= PLAIN_DEVICES

    def __str__(self):
        names = ", ".join(sorted(self.names)) or "nothing"
        return f"every device but {names}" if self.neg else names


def string_tuples(tree: ast.Module) -> dict[str, list[str]]:
    """Module-level ``NAME = ("a", "b")`` bindings (tuples or lists of
    strings), so a device test may name its set."""
    out: dict[str, list[str]] = {}
    for st in tree.body:
        if (isinstance(st, ast.Assign)
                and isinstance(st.value, (ast.Tuple, ast.List))
                and all(isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                        for e in st.value.elts)):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = [e.value for e in st.value.elts]
    return out


def _device_test(test: ast.AST,
                 named: dict[str, list[str]]) -> _DevSet | None:
    """Device types for which ``test`` holds, when it is a comparison of
    a ``.type`` attribute with string constants (``x.device.type ==
    "cuda"``, ``dev.type not in ("cpu", "meta")``, or a module-level
    tuple of them); else None."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"):
        return None
    rhs, op = test.comparators[0], test.ops[0]
    if isinstance(rhs, ast.Name) and rhs.id in named:
        names = named[rhs.id]
    elif isinstance(rhs, ast.Constant) and isinstance(rhs.value, str):
        names = [rhs.value]
    elif isinstance(rhs, (ast.Tuple, ast.List, ast.Set)) and all(
            isinstance(e, ast.Constant) for e in rhs.elts):
        names = [e.value for e in rhs.elts]
    else:
        return None
    if isinstance(op, (ast.Eq, ast.In)):
        return _DevSet(names)
    if isinstance(op, (ast.NotEq, ast.NotIn)):
        return _DevSet(names, True)
    return None


def check_device_branches(fn: ast.FunctionDef, path: str,
                          wrappers: set[str],
                          named: dict[str, list[str]]) -> list[Finding]:
    """CU503 — follow the device types through ``fn``'s top-level device
    branches; each branch, and the tail of a function that launches in
    one of them, that runs the plain version must be reached only by
    `PLAIN_DEVICES`."""
    out: list[Finding] = []
    reach = _DevSet((), True)
    dispatches = joined = False
    tail: list[ast.AST] = []
    for st in fn.body:
        cond = (_device_test(st.test, named) if isinstance(st, ast.If)
                else None)
        if cond is None:
            tail.append(st)
            continue
        tail = []
        # after an if/else neither of whose routes returns, the code that
        # follows is common to both, not a route of its own
        joined = not (_terminates(st.body) or _terminates(st.orelse))
        for branch, enters in ((st.body, reach.inter(cond)),
                               (st.orelse, reach.minus(cond))):
            if not branch:
                continue
            if _launches(branch, wrappers):
                dispatches = True
            elif not _raises(branch) and not enters.plain_ok():
                out.append(Finding(
                    path, branch[0].lineno, "CU503",
                    f"'{fn.name}' sends {enters} to the plain version — "
                    "a CUDA tensor must launch its kernel or raise; only "
                    f"{sorted(PLAIN_DEVICES)} take the plain route"))
        if _terminates(st.body):
            reach = reach.minus(cond)
        if _terminates(st.orelse):
            reach = reach.inter(cond)
    if (dispatches and tail and not joined
            and not _launches(tail, wrappers)
            and not _raises(tail) and not reach.plain_ok()):
        out.append(Finding(
            path, tail[0].lineno, "CU503",
            f"'{fn.name}' falls through to the plain version for {reach} "
            "— a CUDA tensor must launch its kernel or raise"))
    return out


def check_try_fallbacks(tree: ast.Module, path: str,
                        wrappers: set[str]) -> list[Finding]:
    """CU503 — a ``try`` around a build, launch or wrapper whose handler
    does anything but re-raise."""
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try) or not _launches(node.body,
                                                          wrappers):
            continue
        for h in node.handlers:
            returns = any(isinstance(n, ast.Return) for n in ast.walk(h))
            if returns or not _raises(h.body):
                out.append(Finding(
                    path, h.lineno, "CU503",
                    "except around a kernel build or launch that does not "
                    "re-raise — a failing kernel must not fall back"))
    return out


# ------------------------------------------------------- plane tables

_MEGA_NAME = re.compile(r"^(MEGA_|MP_|MS_)")


def _range_unpacks(tree: ast.Module) -> dict[str, int]:
    """``(A, B, C) = range(3)`` bindings at module level."""
    env: dict[str, int] = {}
    for st in tree.body:
        if (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Tuple)
                and isinstance(st.value, ast.Call)
                and call_name(st.value) == "range"
                and len(st.value.args) == 1):
            try:
                n = eval_int(st.value.args[0])
            except EvalError:
                continue
            for k, t in enumerate(st.targets[0].elts[:n]):
                if isinstance(t, ast.Name):
                    env[t.id] = k
    return env


def _int_env(ctx: RepoContext, rel: str) -> dict[str, int]:
    """Module-level int constants of ``rel``, ``np.int32(x)`` unwrapped."""
    tree = ctx.tree(rel)
    if tree is None:
        return {}
    env = _range_unpacks(tree)
    env.update(module_int_env(tree)[0])
    for st in tree.body:
        if (isinstance(st, ast.Assign) and isinstance(st.value, ast.Call)
                and call_name(st.value) in ("int32", "int64", "int")
                and len(st.value.args) == 1):
            try:
                val = eval_int(st.value.args[0], env)
            except EvalError:
                continue
            for t in st.targets:
                if isinstance(t, ast.Name):
                    env[t.id] = val
    return env


def _module_path(ctx: RepoContext, module: str) -> str:
    return "src/" + module.replace(".", "/") + ".py"


def header_constants(ctx: RepoContext) -> dict[str, int | None]:
    """name -> value (None when not statically known) of every
    ``#define`` that `_build._fields_header()` writes."""
    tree = ctx.tree(ctx.BUILD)
    fn = tree and next((n for n in tree.body
                        if isinstance(n, ast.FunctionDef)
                        and n.name == "_fields_header"), None)
    if fn is None:
        return {}
    # where each name the function imports comes from
    origin: dict[str, tuple[str, str | None]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                sub = f"{node.module}.{a.name}"
                if ctx.exists(_module_path(ctx, sub)):
                    origin[a.asname or a.name] = (sub, None)
                else:
                    origin[a.asname or a.name] = (node.module, a.name)
    envs: dict[str, dict[str, int]] = {}

    def env_of(module: str) -> dict[str, int]:
        if module not in envs:
            envs[module] = _int_env(ctx, _module_path(ctx, module))
        return envs[module]

    def value(expr: ast.AST) -> int | None:
        if isinstance(expr, ast.Call) and expr.args:
            expr = expr.args[0]
        chain = attr_chain(expr) or []
        if len(chain) == 1 and chain[0] in origin:
            mod, attr = origin[chain[0]]
            return env_of(mod).get(attr) if attr else None
        if len(chain) == 2 and chain[0] in origin:
            return env_of(origin[chain[0]][0]).get(chain[1])
        return None

    out: dict[str, int | None] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.JoinedStr) and node.values:
            head = node.values[0]
            if not (isinstance(head, ast.Constant)
                    and str(head.value).startswith("#define ")):
                continue
            name = str(head.value)[len("#define "):].split()
            if name and len(node.values) > 1:
                fv = node.values[1]
                out[name[0]] = value(fv.value) if isinstance(
                    fv, ast.FormattedValue) else None
        # `for name in fields.__all__`: every listed name of that module
        if (isinstance(node, ast.Attribute) and node.attr == "__all__"
                and isinstance(node.value, ast.Name)
                and node.value.id in origin):
            mod = origin[node.value.id][0]
            mtree = ctx.tree(_module_path(ctx, mod))
            env = env_of(mod)
            for st in (mtree.body if mtree else []):
                if (isinstance(st, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == "__all__"
                                for t in st.targets)
                        and isinstance(st.value, (ast.List, ast.Tuple))):
                    for e in st.value.elts:
                        if isinstance(e, ast.Constant):
                            out[e.value] = env.get(e.value)
        # `n.startswith("KIND_")` over `vars(module)`: the prefix's names
        if (isinstance(node, ast.Call) and call_name(node) == "vars"
                and node.args and isinstance(node.args[0], ast.Name)
                and node.args[0].id in origin):
            mod = origin[node.args[0].id][0]
            prefixes = [c.args[0].value for c in ast.walk(fn)
                        if isinstance(c, ast.Call)
                        and call_name(c) == "startswith" and c.args
                        and isinstance(c.args[0], ast.Constant)]
            for k, v in env_of(mod).items():
                if k.startswith(tuple(prefixes)):
                    out[k] = v
    return out


_INT_LIT = re.compile(
    r"(?<![\w.])(?:(\d+)\s*[uUlL]*\s*<<\s*(\d+)|(0[xX][0-9a-fA-F]+|\d+)"
    r"[uUlL]*)(?![\w.])")

#: values smaller than this collide with ordinary literals (block sizes,
#: lane counts) and are not checked
DISTINCT = 1024


def check_plane_tables(ctx: RepoContext) -> list[Finding]:
    """CU504 — Python rebinding, C ``#define``s and literals of the
    generated constants, and the header's includes."""
    out: list[Finding] = []
    for rel in ctx.py_files(ctx.KERNELS_DIR):
        tree = ctx.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for tgt in targets:
                names = (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                         else [tgt])
                for t in names:
                    if isinstance(t, ast.Name) and _MEGA_NAME.match(t.id):
                        out.append(Finding(
                            rel, node.lineno, "CU504",
                            f"'{t.id}' is (re)bound in a kernel module — "
                            "plane-table columns and widths come from "
                            "core.sweep.fields only"))
    consts = header_constants(ctx)
    distinct = {abs(v): k for k, v in consts.items()
                if v is not None and abs(v) >= DISTINCT}
    sources = ctx.files(ctx.CSRC_DIR, "*.cu") + ctx.files(ctx.CSRC_DIR,
                                                            "*.cuh")
    for rel in sources:
        raw = ctx.text(rel) or ""
        text = strip_comments(raw)
        for m in re.finditer(r"^\s*#\s*define\s+([A-Za-z_]\w*)", text, re.M):
            if m.group(1) in consts:
                out.append(Finding(
                    rel, _line(text, m.start(1)), "CU504",
                    f"#define {m.group(1)} in a source — it is generated "
                    f"into {_HEADER} by _build._fields_header()"))
        code = re.sub(r'"(?:[^"\\]|\\.)*"', lambda s: " " * len(s.group()),
                      text)
        for m in _INT_LIT.finditer(code):
            if m.group(1):
                val = int(m.group(1)) << int(m.group(2))
            else:
                val = int(m.group(3), 0)
            if val in distinct:
                out.append(Finding(
                    rel, _line(code, m.start()), "CU504",
                    f"literal {m.group().strip()} spells the value of "
                    f"{distinct[val]} — use the name from {_HEADER}"))
        name = rel.rsplit("/", 1)[-1]
        if name.startswith("sweep_") and not re.search(
                r'#\s*include\s+"' + re.escape(_HEADER) + '"', text):
            out.append(Finding(rel, 1, "CU504",
                               f"sweep source does not include {_HEADER}"))
    return out


# ---------------------------------------------------- state key sets


def _own_returns(fn: ast.FunctionDef) -> list[ast.Return]:
    """Return statements of ``fn`` itself, not of nested functions."""
    out: list[ast.Return] = []
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Return):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _returned_dict_keys(fn: ast.FunctionDef) -> set[str] | None:
    """Union of keyword names over every ``return dict(...)`` of ``fn``;
    None when no return is a ``dict(...)`` keyword call."""
    keys: set[str] | None = None
    for ret in _own_returns(fn):
        v = ret.value
        if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                and v.func.id == "dict" and v.keywords
                and all(kw.arg for kw in v.keywords)):
            keys = (keys or set()) | {kw.arg for kw in v.keywords}
    return keys


def check_state_keysets(tree: ast.Module, path: str) -> list[Finding]:
    """CU505 — every plane initialised by ``<mode>_state0`` appears in
    the dict returned by the paired ``<mode>_body``."""
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out: list[Finding] = []
    for name, s0 in fns.items():
        if not name.endswith("_state0"):
            continue
        body_fn = fns.get(name[: -len("_state0")] + "_body")
        if body_fn is None:
            continue
        s0_keys = _returned_dict_keys(s0)
        body_keys = _returned_dict_keys(body_fn)
        if s0_keys is None or body_keys is None:
            continue
        for key in sorted(s0_keys - body_keys):
            out.append(Finding(
                path, body_fn.lineno, "CU505",
                f"state plane '{key}' is initialised by {name} but "
                f"missing from {body_fn.name}'s returned dict — the tick "
                "loop would carry it frozen at its initial value with no "
                "runtime error"))
    return out


@register_pass("cuda-lint", rules=RULES)
def run(ctx: RepoContext) -> list[Finding]:
    """Lint the CUDA kernels' ctypes ABI, launch grids and generated
    constants, the wrappers' device dispatch for silent fallbacks, and
    the tick-state modules for dropped planes."""
    out = check_abi(ctx)
    out += check_grids(ctx)
    out += check_plane_tables(ctx)
    wrappers = kernel_wrappers(ctx)
    for rel in ctx.py_files(ctx.SRC_PKG):
        if rel.startswith(_ANALYSIS_DIR + "/"):
            continue
        tree = ctx.tree(rel)
        if tree is None:
            continue
        out.extend(check_try_fallbacks(tree, rel, wrappers))
        if rel.startswith((ctx.KERNELS_DIR + "/", _MODELS_DIR + "/")):
            named = string_tuples(tree)
            for fn in ast.walk(tree):
                if isinstance(fn, ast.FunctionDef):
                    out.extend(check_device_branches(fn, rel, wrappers,
                                                     named))
    for rel in ctx.py_files(_SWEEP_DIR):
        text = ctx.text(rel)
        if text and "_state0" in text:
            tree = ctx.tree(rel)
            if tree is not None:
                out.extend(check_state_keysets(tree, rel))
    return out
