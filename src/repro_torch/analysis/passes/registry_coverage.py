"""registry-coverage pass — every registered policy is actually tested.

Registrations are collected statically from the policy package (decorator
form, direct `register_policy(name, Class)` calls, and lambda factories
wrapping a class constructor) so the pass needs no imports and runs on
fixture corpora. A name that never reaches the conformance / sweep /
multirank matrices, or a policy class the vectorized fast-path table in
`sweep/policies.py` cannot classify, is a CI failure — exactly the
silent gap a new `@register_policy` would otherwise open.

A test file "covers" the registry when it either iterates
`list_policies()` (full dynamic coverage) or names the policy in a
string literal (static matrices like test_multirank's POLICIES tuple).

Rules
  RC401  policy missing from the conformance test matrix
  RC402  policy missing from the multirank test matrix
  RC403  policy missing from the sweep test matrix
  RC404  policy class unknown to the vectorized fast-path table
  RC405  fast-path table entry for a class no registration produces
  RC406  SARP-trait policy missing from the subarray test matrix

RC406 looks at the *trait*, not just the class attribute: a registration
is SARP either because its class (or a base) sets ``sarp = True``, or
because the ``register_policy(name, lambda: Cls(..., sarp=True))``
factory passes the trait as a keyword — both spellings exist in the
built-in catalogue. Such a policy exercises the per-subarray refresh
path, so skipping `tests/test_subarray.py`'s backend-vs-DramSim matrix
would leave its defining behavior untested.

RC407 extends the same contract to the *serving* scenario registry:
every ``register_serving_scenario`` site in the scenario module must
reach the co-sim conformance matrix (`tests/test_serving_cosim.py`),
either by string literal or by iterating ``list_serving_scenarios()``.
A serving arrival trace that never flows through the engine <-> DramSim
replay is exactly as silent a gap as an untested policy.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, RepoContext, register_pass

RULES = (
    ("RC401", "policy missing from conformance matrix"),
    ("RC402", "policy missing from multirank matrix"),
    ("RC403", "policy missing from sweep matrix"),
    ("RC404", "policy class not classifiable by the fast-path table"),
    ("RC405", "fast-path table entry with no registered producer"),
    ("RC406", "SARP-trait policy missing from subarray matrix"),
    ("RC407", "serving scenario missing from co-sim matrix"),
)


class Registration:
    __slots__ = ("name", "cls", "path", "line")

    def __init__(self, name: str, cls: str | None, path: str, line: int):
        self.name, self.cls, self.path, self.line = name, cls, path, line


def _lambda_class(node: ast.Lambda) -> str | None:
    """``lambda **kw: Cls(...)`` -> "Cls" (the class the factory builds)."""
    body = node.body
    if isinstance(body, ast.Call) and isinstance(body.func, ast.Name):
        return body.func.id
    return None


def _is_register_call(node: ast.Call) -> bool:
    f = node.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)
    return name == "register_policy"


def collect_registrations(ctx: RepoContext) -> dict[str, Registration]:
    """name -> Registration for every `register_policy` site in the
    policy package (decorators, direct calls, lambda factories)."""
    regs: dict[str, Registration] = {}

    def record(name_node: ast.expr, cls: str | None, path: str, line: int):
        if (isinstance(name_node, ast.Constant)
                and isinstance(name_node.value, str)):
            n = name_node.value
            regs[n] = Registration(n, cls, path, line)

    for rel in ctx.py_files(ctx.POLICY_PKG):
        tree = ctx.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for dec in node.decorator_list:
                    if (isinstance(dec, ast.Call) and _is_register_call(dec)
                            and dec.args):
                        record(dec.args[0], node.name, rel, dec.lineno)
            elif isinstance(node, ast.Call) and _is_register_call(node):
                if len(node.args) < 2:
                    continue
                factory = node.args[1]
                cls: str | None = None
                if isinstance(factory, ast.Name):
                    cls = factory.id
                elif isinstance(factory, ast.Lambda):
                    cls = _lambda_class(factory)
                record(node.args[0], cls, rel, node.lineno)
    return regs


def collect_trait_classes(ctx: RepoContext, trait: str) -> set[str]:
    """Policy classes that set ``<trait> = True`` as a class attribute
    (directly or via a base class in the policy package)."""
    flagged: set[str] = set()
    bases: dict[str, list[str]] = {}
    for rel in ctx.py_files(ctx.POLICY_PKG):
        tree = ctx.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases[node.name] = [b.id for b in node.bases
                                if isinstance(b, ast.Name)]
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == trait
                                for t in stmt.targets)
                        and isinstance(stmt.value, ast.Constant)
                        and stmt.value.value is True):
                    flagged.add(node.name)
    changed = True
    while changed:
        changed = False
        for cls, bs in bases.items():
            if cls not in flagged and any(b in flagged for b in bs):
                flagged.add(cls)
                changed = True
    return flagged


def collect_sarp_names(ctx: RepoContext,
                       regs: dict[str, Registration]) -> set[str]:
    """Registered names carrying the SARP trait, via either spelling:
    the class (or a base) sets ``sarp = True``, or the registration's
    lambda factory passes ``sarp=True`` as a constructor keyword (which
    `collect_registrations` cannot see — it only keeps the class name)."""
    trait_classes = collect_trait_classes(ctx, "sarp")
    sarp = {n for n, r in regs.items() if r.cls in trait_classes}
    for rel in ctx.py_files(ctx.POLICY_PKG):
        tree = ctx.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and _is_register_call(node)
                    and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and isinstance(node.args[1], ast.Lambda)):
                continue
            body = node.args[1].body
            if isinstance(body, ast.Call) and any(
                    kw.arg == "sarp"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in body.keywords):
                sarp.add(node.args[0].value)
    return sarp


def classify_table(ctx: RepoContext,
                   trait: str = "ideal") -> tuple[dict[str, int], bool]:
    """Classes named in `classify()`'s exact-type dispatch
    (``type(pol) is Cls``) -> line, plus whether a ``pol.<trait>`` branch
    handles the trait-flagged classes before the table."""
    table: dict[str, int] = {}
    has_trait_branch = False
    tree = ctx.tree(ctx.SWEEP_POLICIES)
    if tree is None:
        return table, has_trait_branch
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name != "classify":
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare):
                sides = [node.left, *node.comparators]
                if not any(isinstance(s, ast.Call)
                           and isinstance(s.func, ast.Name)
                           and s.func.id == "type" for s in sides):
                    continue
                for operand in sides:
                    if isinstance(operand, ast.Name) and (
                            operand.id[:1].isupper()):
                        table.setdefault(operand.id, node.lineno)
            elif isinstance(node, ast.Attribute) and node.attr == trait:
                has_trait_branch = True
    return table, has_trait_branch


def _matrix_covers(ctx: RepoContext, rel: str, name: str,
                   list_fn: str = "list_policies") -> bool:
    tree = ctx.tree(rel)
    if tree is None:
        return False
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == list_fn):
            return True
        if (isinstance(node, ast.Constant) and node.value == name):
            return True
    return False


def collect_serving_scenarios(ctx: RepoContext) -> dict[str, Registration]:
    """name -> Registration for every `register_serving_scenario` site in
    the scenario module (decorator form and direct calls)."""
    regs: dict[str, Registration] = {}

    def is_reg(call: ast.Call) -> bool:
        f = call.func
        n = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        return n == "register_serving_scenario"

    tree = ctx.tree(ctx.SCENARIOS)
    if tree is None:
        return regs
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and is_reg(dec) and dec.args:
                    a = dec.args[0]
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str):
                        regs[a.value] = Registration(
                            a.value, node.name, ctx.SCENARIOS, dec.lineno)
        elif (isinstance(node, ast.Call) and is_reg(node)
              and len(node.args) >= 2):
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                fn = node.args[1]
                cls = fn.id if isinstance(fn, ast.Name) else None
                regs[a.value] = Registration(a.value, cls, ctx.SCENARIOS,
                                             node.lineno)
    return regs


@register_pass("registry-coverage", rules=RULES)
def run(ctx: RepoContext) -> list[Finding]:
    """Cross-check `list_policies()` registrations against the test
    matrices and the vectorized fast-path table."""
    out: list[Finding] = []
    regs = collect_registrations(ctx)

    matrices = (
        (ctx.TEST_CONFORMANCE, "RC401", "conformance"),
        (ctx.TEST_MULTIRANK, "RC402", "multirank"),
        (ctx.TEST_SWEEP, "RC403", "sweep"),
    )
    for rel, rule, label in matrices:
        if not ctx.exists(rel):
            out.append(Finding(rel, 0, rule,
                               f"{label} test matrix file missing"))
            continue
        for name, reg in sorted(regs.items()):
            if not _matrix_covers(ctx, rel, name):
                out.append(Finding(
                    rel, 1, rule,
                    f"registered policy '{name}' ({reg.path}:{reg.line}) "
                    f"never reaches the {label} matrix — add it or "
                    "iterate list_policies()"))

    # SARP-trait policies must additionally hit the subarray tier, whose
    # matrix is what pins their idle-sibling-serving semantics to DramSim
    sarp_names = collect_sarp_names(ctx, regs)
    if sarp_names and not ctx.exists(ctx.TEST_SUBARRAY):
        out.append(Finding(ctx.TEST_SUBARRAY, 0, "RC406",
                           "subarray test matrix file missing"))
    elif sarp_names:
        for name in sorted(sarp_names):
            reg = regs[name]
            if not _matrix_covers(ctx, ctx.TEST_SUBARRAY, name):
                out.append(Finding(
                    ctx.TEST_SUBARRAY, 1, "RC406",
                    f"SARP-trait policy '{name}' ({reg.path}:{reg.line}) "
                    "never reaches the subarray matrix — add it or "
                    "iterate list_policies()"))

    # serving scenarios must reach the co-sim matrix: every arrival trace
    # in the registry gets replayed through the engine <-> DramSim loop
    serving = collect_serving_scenarios(ctx)
    if serving and not ctx.exists(ctx.TEST_SERVING_COSIM):
        out.append(Finding(ctx.TEST_SERVING_COSIM, 0, "RC407",
                           "serving co-sim test matrix file missing"))
    elif serving:
        for name, reg in sorted(serving.items()):
            if not _matrix_covers(ctx, ctx.TEST_SERVING_COSIM, name,
                                  list_fn="list_serving_scenarios"):
                out.append(Finding(
                    ctx.TEST_SERVING_COSIM, 1, "RC407",
                    f"serving scenario '{name}' ({reg.path}:{reg.line}) "
                    "never reaches the co-sim matrix — add it or iterate "
                    "list_serving_scenarios()"))

    table, has_trait_branch = classify_table(ctx)
    trait_classes = collect_trait_classes(ctx, "ideal")
    for name, reg in sorted(regs.items()):
        if reg.cls is None:
            out.append(Finding(
                reg.path, reg.line, "RC404",
                f"cannot statically resolve the class behind policy "
                f"'{name}' — the fast-path table check is blind to it"))
        elif reg.cls not in table and not (
                has_trait_branch and reg.cls in trait_classes):
            out.append(Finding(
                reg.path, reg.line, "RC404",
                f"policy '{name}' builds {reg.cls}, which classify() in "
                "sweep/policies.py cannot map to a vectorized kind — it "
                "would silently fall back to the scalar path"))
    known_classes = {r.cls for r in regs.values() if r.cls}
    for cls, line in sorted(table.items()):
        if cls not in known_classes:
            out.append(Finding(
                ctx.SWEEP_POLICIES, line, "RC405",
                f"classify() dispatches on {cls}, but no registration "
                "produces that class — dead fast-path entry"))
    return out
