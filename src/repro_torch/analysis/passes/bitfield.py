"""bitfield pass — packed arbitration-score layout consistency.

`repro_torch/core/sweep/fields.py` is the declared single source of truth for
the packed int32 score layout. This pass does NOT trust that claim: it
re-derives the *effective* constants of each consumer module
(`sweep/arbiter.py`, `kernels/sweep_arbiter.py`) by walking that module's
own top-level statements — an ``from ...fields import`` binds the
fields.py values, a later local assignment overrides them — so a stray
local redefinition, a dropped import, or an edit to fields.py itself all
surface as drift. The field table in `docs/tick-contract.md` is parsed
independently and compared against the same ground truth.

Rules
  BF101  required constant missing from a module's effective view
  BF102  two packed fields overlap
  BF103  malformed layout (cap not 2**k-1, weight not a power of two,
         or priority order broken)
  BF104  packed layout does not fit int32 (max score needs >= 31 bits)
  BF105  consumer module's effective constants drift from fields.py
  BF106  docs/tick-contract.md field table missing or drifted
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.astutil import (EvalError, eval_int, eval_int_str,
                                    module_int_env)
from repro_torch.analysis.core import Finding, RepoContext, register_pass

#: the canonical packed-layout names every consumer must agree on
CANON = ("AGE_CAP", "W_NOCONF", "W_HIT", "W_OCC", "OCC_CAP", "W_WRITE")

RULES = (
    ("BF101", "required score-field constant missing"),
    ("BF102", "packed score fields overlap"),
    ("BF103", "malformed field layout (cap/weight/priority)"),
    ("BF104", "packed score layout exceeds int32"),
    ("BF105", "consumer constants drift from fields.py"),
    ("BF106", "doc field table missing or drifted"),
)


def module_view(ctx: RepoContext, rel: str,
                sources: dict[str, dict[str, int]]) -> tuple[
                    dict[str, int], dict[str, int]]:
    """Effective top-level int constants of a module.

    ``sources`` maps import-suffix (e.g. "fields", "arbiter") to that
    module's already-evaluated env; an ``from x.y.fields import A, B``
    statement binds from it. Later local assignments override — that is
    exactly the drift this pass exists to catch.
    """
    env: dict[str, int] = {}
    lines: dict[str, int] = {}
    tree = ctx.tree(rel)
    if tree is None:
        return env, lines
    for stmt in tree.body:
        if isinstance(stmt, ast.ImportFrom) and stmt.module:
            suffix = stmt.module.rsplit(".", 1)[-1]
            src = sources.get(suffix)
            if src is None:
                continue
            for alias in stmt.names:
                if alias.name == "*":
                    for k, v in src.items():
                        env[k] = v
                        lines[k] = stmt.lineno
                elif alias.name in src:
                    env[alias.asname or alias.name] = src[alias.name]
                    lines[alias.asname or alias.name] = stmt.lineno
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            if value is None:
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            try:
                val = eval_int(value, env)
            except EvalError:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = val
                    lines[tgt.id] = stmt.lineno
    return env, lines


def _layout(env: dict[str, int]) -> dict[str, tuple[int, int]]:
    """name -> (shift, width) of each packed field; assumes env validated."""
    return {
        "age": (0, env["AGE_CAP"].bit_length()),
        "noconf": (env["W_NOCONF"].bit_length() - 1, 1),
        "hit": (env["W_HIT"].bit_length() - 1, 1),
        "occ": (env["W_OCC"].bit_length() - 1, env["OCC_CAP"].bit_length()),
        "write": (env["W_WRITE"].bit_length() - 1, 1),
    }


def check_layout(env: dict[str, int], path: str, line: int) -> list[Finding]:
    """Validate one module's effective constants (BF101-BF104)."""
    out: list[Finding] = []
    missing = [n for n in CANON if n not in env]
    for name in missing:
        out.append(Finding(path, line, "BF101",
                           f"missing score-field constant {name}"))
    if missing:
        return out

    for cap in ("AGE_CAP", "OCC_CAP"):
        v = env[cap]
        if v <= 0 or v & (v + 1):
            out.append(Finding(path, line, "BF103",
                               f"{cap} = {v} is not of the form 2**k - 1"))
    for w in ("W_NOCONF", "W_HIT", "W_OCC", "W_WRITE"):
        v = env[w]
        if v <= 0 or v & (v - 1):
            out.append(Finding(path, line, "BF103",
                               f"{w} = {v} is not a power of two"))
    if out:
        return out

    lay = _layout(env)
    fields = sorted(lay.items(), key=lambda kv: kv[1][0])
    for (na, (sa, wa)), (nb, (sb, _)) in zip(fields, fields[1:]):
        if sa + wa > sb:
            out.append(Finding(
                path, line, "BF102",
                f"fields '{na}' (bits {sa}..{sa + wa - 1}) and '{nb}' "
                f"(shift {sb}) overlap"))
    # priority order is part of the contract: write above occ above hit
    # above noconf above age — disjointness alone would accept a swap
    order = [lay[n][0] for n in ("age", "noconf", "hit", "occ", "write")]
    if order != sorted(order) or len(set(order)) != 5:
        out.append(Finding(
            path, line, "BF103",
            "field priority order broken: need "
            "age < W_NOCONF < W_HIT < W_OCC < W_WRITE shifts, got "
            f"{dict(zip(('age', 'noconf', 'hit', 'occ', 'write'), order))}"))
    max_score = (env["W_WRITE"] + env["OCC_CAP"] * env["W_OCC"]
                 + env["W_HIT"] + env["W_NOCONF"] + env["AGE_CAP"])
    if max_score.bit_length() >= 31:
        out.append(Finding(
            path, line, "BF104",
            f"max packed score {max_score} needs "
            f"{max_score.bit_length()} bits; must stay < 31 for int32 "
            "(with -1 reserved as the ineligible sentinel)"))
    return out


# -- doc table -------------------------------------------------------------

_CONST_RE = re.compile(r"`([A-Za-z_][A-Za-z0-9_]*)\s*=\s*([^`]+)`")


def parse_doc_table(text: str) -> tuple[
        list[dict], int] | tuple[None, int]:
    """Extract the first markdown table whose header names field/shift/width.

    Returns ``(rows, line)`` with one dict per data row
    (``{"field", "shift", "width", "consts": {name: value}, "line"}``),
    or ``(None, 0)`` if no such table parses.
    """
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        if lines[i].lstrip().startswith("|"):
            header = [c.strip().lower()
                      for c in lines[i].strip().strip("|").split("|")]
            if {"field", "shift", "width"} <= set(header):
                col = {name: header.index(name)
                       for name in ("field", "shift", "width")}
                rows: list[dict] = []
                j = i + 2  # skip separator row
                while j < len(lines) and lines[j].lstrip().startswith("|"):
                    cells = [c.strip()
                             for c in lines[j].strip().strip("|").split("|")]
                    if len(cells) < 3:
                        j += 1
                        continue
                    consts = {}
                    for m in _CONST_RE.finditer(lines[j]):
                        try:
                            consts[m.group(1)] = eval_int_str(m.group(2))
                        except EvalError:
                            consts[m.group(1)] = None
                    try:
                        shift = int(cells[col["shift"]])
                        width = int(cells[col["width"]])
                    except ValueError:
                        j += 1
                        continue
                    rows.append({
                        "field": cells[col["field"]].strip("`"),
                        "shift": shift, "width": width,
                        "consts": consts, "line": j + 1,
                    })
                    j += 1
                return rows, i + 1
        i += 1
    return None, 0


def check_doc(ctx: RepoContext, truth: dict[str, int]) -> list[Finding]:
    path = ctx.DOC_CONTRACT
    text = ctx.text(path)
    if text is None:
        return [Finding(path, 0, "BF106", "tick-contract doc missing")]
    rows, tline = parse_doc_table(text)
    if rows is None:
        return [Finding(path, 0, "BF106",
                        "no parseable field table (need a markdown table "
                        "with field/shift/width columns)")]
    out: list[Finding] = []
    doc_consts: dict[str, tuple[int | None, int]] = {}
    doc_layout: list[tuple[int, int, int]] = []
    for row in rows:
        doc_layout.append((row["shift"], row["width"], row["line"]))
        for name, val in row["consts"].items():
            doc_consts[name] = (val, row["line"])
    for name in CANON:
        if name not in doc_consts:
            out.append(Finding(path, tline, "BF106",
                               f"doc table does not state {name}"))
        else:
            val, line = doc_consts[name]
            if val != truth.get(name):
                out.append(Finding(
                    path, line, "BF106",
                    f"doc says {name} = {val}, fields.py says "
                    f"{truth.get(name)}"))
    if not out:
        want = sorted(_layout(truth).values())
        got = sorted((s, w) for s, w, _ in doc_layout)
        if got != want:
            out.append(Finding(
                path, tline, "BF106",
                f"doc (shift, width) rows {got} != layout derived from "
                f"fields.py {want}"))
    return out


@register_pass("bitfield", rules=RULES)
def run(ctx: RepoContext) -> list[Finding]:
    """Prove numpy arbiter, CUDA arbiter wrapper, and the tick-contract doc
    all agree on one well-formed int32-safe packed score layout."""
    out: list[Finding] = []
    ftree = ctx.tree(ctx.FIELDS)
    if ftree is None:
        return [Finding(ctx.FIELDS, 0, "BF101",
                        "fields.py missing or unparsable")]
    truth, truth_lines = module_int_env(ftree)
    out.extend(check_layout(truth, ctx.FIELDS,
                            min(truth_lines.values(), default=1)))
    if any(f.rule in ("BF101", "BF103") for f in out):
        return out  # ground truth malformed; drift checks would be noise

    sources = {"fields": {n: truth[n] for n in CANON}}
    for rel in (ctx.ARBITER, ctx.KERNEL_ARBITER):
        if not ctx.exists(rel):
            out.append(Finding(rel, 0, "BF101", "consumer module missing"))
            continue
        env, lines = module_view(ctx, rel, sources)
        for name in CANON:
            if name not in env:
                out.append(Finding(
                    rel, 1, "BF101",
                    f"{name} not bound (neither imported from fields.py "
                    "nor defined locally)"))
            elif env[name] != truth[name]:
                out.append(Finding(
                    rel, lines[name], "BF105",
                    f"effective {name} = {env[name]} drifts from "
                    f"fields.py value {truth[name]}"))
        # a full consumer view that validates on its own also proves the
        # consumer never repacks into an overlapping/oversized layout
        if all(n in env for n in CANON):
            out.extend(
                f for f in check_layout(env, rel, 1)
                if f.rule in ("BF102", "BF103", "BF104"))
        # make the arbiter's effective env available to modules that
        # import the constants via the historical arbiter import site
        if rel == ctx.ARBITER:
            sources["arbiter"] = {n: env[n] for n in CANON if n in env}

    out.extend(check_doc(ctx, truth))
    return out
