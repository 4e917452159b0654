"""policy-purity pass — decision logic stays in `repro_torch/core/policy`.

ROADMAP rule: refresh-scheduling decisions live in policy classes behind
the registry; engines consume them through `select()`/traits only. The
two ways that rots are (a) an engine branching on a registry *name*
("if policy == 'darp'") — forking per-policy behavior outside the policy
class — and (b) a policy's `select()` mutating the `MaintenanceView` it
was handed, which the tick contract declares read-only (the engines
share one view instance per tick across the whole grid).

Rules
  PP301  engine/serving code branches on a policy registry name
  PP302  `select()` mutates its MaintenanceView argument
  PP303  policy package imports an engine/backend module
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import base_name
from repro_torch.analysis.core import Finding, RepoContext, register_pass
from repro_torch.analysis.passes.registry_coverage import collect_registrations

RULES = (
    ("PP301", "per-policy branching on registry names outside the "
              "policy package"),
    ("PP302", "MaintenanceView mutated inside select()"),
    ("PP303", "policy package imports engine/backend code"),
)

#: container mutators that count as mutation when invoked on the view
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "add",
    "update", "setdefault", "discard", "sort",
})

#: module prefixes the policy layer must not depend on (the dependency
#: arrow goes engine -> policy, never back)
_FORBIDDEN_IMPORT_PREFIXES = (
    "repro_torch.core.sweep", "repro_torch.core.refresh",
    "repro_torch.kernels", "repro_torch.serving", "repro_torch.analysis",
)


def _string_values(node: ast.expr) -> list[str]:
    """String constants in a compare operand (plain or in a container)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [elt.value for elt in node.elts
                if isinstance(elt, ast.Constant)
                and isinstance(elt.value, str)]
    return []


def check_name_branching(tree: ast.Module, path: str,
                         reg_names: frozenset[str]) -> list[Finding]:
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        hits = [
            s for operand in [node.left, *node.comparators]
            for s in _string_values(operand) if s in reg_names
        ]
        if hits:
            out.append(Finding(
                path, node.lineno, "PP301",
                f"comparison against policy registry name(s) "
                f"{sorted(set(hits))} — per-policy behavior belongs in "
                "the policy class (add a trait or method instead)"))
    return out


def check_select_purity(tree: ast.Module, path: str) -> list[Finding]:
    out: list[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name != "select":
            continue
        params = [a.arg for a in fn.args.args]
        if params and params[0] == "self":
            params = params[1:]
        if not params:
            continue
        view = params[0]  # select(self, view, ...) by contract
        for node in ast.walk(fn):
            tgt_nodes: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                tgt_nodes = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                tgt_nodes = [node.target]
            elif isinstance(node, ast.Delete):
                tgt_nodes = list(node.targets)
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr in _MUTATORS
                        and base_name(f.value) == view):
                    out.append(Finding(
                        path, node.lineno, "PP302",
                        f"select() calls {view}.{f.attr}(...) — the "
                        "MaintenanceView is shared and read-only"))
                continue
            for tgt in tgt_nodes:
                if (isinstance(tgt, (ast.Attribute, ast.Subscript))
                        and base_name(tgt) == view):
                    out.append(Finding(
                        path, node.lineno, "PP302",
                        f"select() writes into its view argument "
                        f"'{view}' — the MaintenanceView is shared and "
                        "read-only"))
    return out


def check_policy_imports(tree: ast.Module, path: str) -> list[Finding]:
    out: list[Finding] = []
    for node in ast.walk(tree):
        mods: list[tuple[str, int]] = []
        if isinstance(node, ast.Import):
            mods = [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods = [(node.module, node.lineno)]
        for mod, line in mods:
            if any(mod == p or mod.startswith(p + ".")
                   for p in _FORBIDDEN_IMPORT_PREFIXES):
                out.append(Finding(
                    path, line, "PP303",
                    f"policy package imports {mod} — the dependency "
                    "arrow is engine -> policy, never back"))
    return out


@register_pass("policy-purity", rules=RULES)
def run(ctx: RepoContext) -> list[Finding]:
    """Flag decision logic forked outside the policy package and
    MaintenanceView mutation inside select()."""
    out: list[Finding] = []
    regs = collect_registrations(ctx)
    reg_names = frozenset(regs)

    policy_files = set(ctx.py_files(ctx.POLICY_PKG))
    analysis_prefix = "src/repro_torch/analysis/"
    for rel in ctx.py_files(ctx.SRC_PKG):
        tree = ctx.tree(rel)
        if tree is None:
            continue
        if rel in policy_files:
            out.extend(check_select_purity(tree, rel))
            out.extend(check_policy_imports(tree, rel))
        elif not rel.startswith(analysis_prefix) and reg_names:
            out.extend(check_name_branching(tree, rel, reg_names))
    return out
