"""Small AST helpers shared by the `repro_torch.analysis` passes.

Everything here is stdlib-only (`ast`, `pathlib`) — the analysis suite
must run in CI without numpy/jax installed, in well under a second.
"""
from __future__ import annotations

import ast


class EvalError(Exception):
    """An expression could not be reduced to a Python int statically."""


_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a ** b,
    ast.LShift: lambda a, b: a << b,
    ast.RShift: lambda a, b: a >> b,
    ast.BitOr: lambda a, b: a | b,
    ast.BitAnd: lambda a, b: a & b,
    ast.BitXor: lambda a, b: a ^ b,
}

_UNARYOPS = {
    ast.USub: lambda a: -a,
    ast.UAdd: lambda a: +a,
    ast.Invert: lambda a: ~a,
}


def eval_int(node: ast.AST, env: dict[str, int] | None = None) -> int:
    """Statically evaluate an int-valued constant expression.

    Supports int literals, names bound in ``env``, the arithmetic/bitwise
    binary operators, and unary +/-/~. Raises :class:`EvalError` for
    anything else (floats included — the bit-field layout is integral by
    contract).
    """
    env = env or {}
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or not isinstance(node.value, int):
            raise EvalError(f"non-int constant {node.value!r}")
        return node.value
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise EvalError(f"unbound name {node.id!r}")
    if isinstance(node, ast.BinOp):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise EvalError(f"unsupported operator {type(node.op).__name__}")
        return op(eval_int(node.left, env), eval_int(node.right, env))
    if isinstance(node, ast.UnaryOp):
        op = _UNARYOPS.get(type(node.op))
        if op is None:
            raise EvalError(f"unsupported operator {type(node.op).__name__}")
        return op(eval_int(node.operand, env))
    raise EvalError(f"unsupported node {type(node).__name__}")


def eval_int_str(expr: str, env: dict[str, int] | None = None) -> int:
    """`eval_int` over source text (used for doc-table constants)."""
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError as exc:
        raise EvalError(str(exc)) from exc
    return eval_int(tree.body, env)


def attr_chain(node: ast.AST) -> list[str] | None:
    """``a.b.c`` -> ["a", "b", "c"]; None if the base is not a Name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def base_name(node: ast.AST) -> str | None:
    """Root Name of an attribute/subscript chain (``a.b[0].c`` -> "a")."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def call_name(node: ast.Call) -> str | None:
    """Terminal callee name: ``pl.pallas_call(...)`` -> "pallas_call"."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def names_in(node: ast.AST) -> set[str]:
    """All Name identifiers appearing anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def parent_map(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    """Child -> parent links for every node in ``tree``."""
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def module_int_env(tree: ast.Module) -> tuple[dict[str, int], dict[str, int]]:
    """Evaluate all statically-int module-level assignments, in order.

    Returns ``(env, lines)`` where ``env`` maps name -> value and
    ``lines`` maps name -> line of its (last) binding. Assignments whose
    RHS cannot be reduced are skipped.
    """
    env: dict[str, int] = {}
    lines: dict[str, int] = {}
    for stmt in tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        try:
            val = eval_int(value, env)
        except EvalError:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                env[tgt.id] = val
                lines[tgt.id] = stmt.lineno
    return env, lines
