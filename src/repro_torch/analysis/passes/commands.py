"""commands pass — DFI command mnemonic / timing-field doc coverage.

`repro_torch/core/commands/trace.py` declares the closed sets of command
mnemonics (``MNEMONICS``) and trace-meta timing fields
(``TIMING_FIELDS``).  The normative tables live in
`docs/tick-contract.md` (command-layer section): one table whose header
names a ``mnemonic`` column, one whose header names a ``timing field``
column.  This pass re-derives both code tuples by AST and diffs them
against the doc tables in both directions, mirroring the bitfield
pass's code-vs-doc discipline.

Rules
  CM601  code mnemonic/timing field missing from the doc table
  CM602  doc table names a mnemonic/timing field unknown to the code
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import Finding, RepoContext, register_pass

RULES = (
    ("CM601", "command mnemonic/timing field missing from the doc table"),
    ("CM602", "doc table names an unknown mnemonic/timing field"),
)

#: (code tuple name, doc table header cell) pairs checked by this pass
TABLES = (("MNEMONICS", "mnemonic"), ("TIMING_FIELDS", "timing field"))

_TOKEN_RE = re.compile(r"`([A-Za-z_][A-Za-z0-9_]*)`")


def code_tuples(tree: ast.Module) -> dict[str, tuple[dict[str, int], int]]:
    """Top-level string-tuple assignments: name -> ({token: line}, line)."""
    out: dict[str, tuple[dict[str, int], int]] = {}
    for stmt in tree.body:
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            continue
        value = stmt.value
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        if not isinstance(value, (ast.Tuple, ast.List)):
            continue
        elts = value.elts
        if not elts or not all(isinstance(e, ast.Constant)
                               and isinstance(e.value, str) for e in elts):
            continue
        toks = {e.value: e.lineno for e in elts}
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                out[tgt.id] = (toks, stmt.lineno)
    return out


def parse_doc_tokens(text: str, header_cell: str) -> tuple[
        dict[str, int], int] | tuple[None, int]:
    """First-column backticked tokens of the first table whose header row
    contains ``header_cell``.  Returns ``({token: line}, header line)`` or
    ``(None, 0)`` when no such table exists."""
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        if lines[i].lstrip().startswith("|"):
            header = [c.strip().lower()
                      for c in lines[i].strip().strip("|").split("|")]
            if header_cell in header:
                toks: dict[str, int] = {}
                j = i + 2  # skip separator row
                while j < len(lines) and lines[j].lstrip().startswith("|"):
                    cells = [c.strip()
                             for c in lines[j].strip().strip("|").split("|")]
                    if cells:
                        m = _TOKEN_RE.search(cells[0])
                        if m:
                            toks.setdefault(m.group(1), j + 1)
                    j += 1
                return toks, i + 1
        i += 1
    return None, 0


@register_pass("commands", rules=RULES)
def run(ctx: RepoContext) -> list[Finding]:
    """Prove the command-layer doc tables and the code's MNEMONICS /
    TIMING_FIELDS tuples name exactly the same sets."""
    tree = ctx.tree(ctx.COMMANDS)
    if tree is None:
        # corpora without a command layer (and pre-command fixtures) are
        # simply out of scope for this pass, like a missing consumer
        return []
    tuples = code_tuples(tree)
    doc = ctx.text(ctx.DOC_CONTRACT)
    out: list[Finding] = []
    for name, header_cell in TABLES:
        if name not in tuples:
            out.append(Finding(ctx.COMMANDS, 1, "CM601",
                               f"{name} tuple not found in command layer"))
            continue
        toks, tline = tuples[name]
        if doc is None:
            out.append(Finding(ctx.DOC_CONTRACT, 0, "CM601",
                               "tick-contract doc missing; cannot check "
                               f"{name} coverage"))
            continue
        doc_toks, dline = parse_doc_tokens(doc, header_cell)
        if doc_toks is None:
            out.append(Finding(
                ctx.DOC_CONTRACT, 0, "CM601",
                f"no markdown table with a '{header_cell}' column for "
                f"{name}"))
            continue
        for tok in toks:
            if tok not in doc_toks:
                out.append(Finding(
                    ctx.DOC_CONTRACT, dline, "CM601",
                    f"{name} entry `{tok}` "
                    f"({ctx.COMMANDS}:{toks[tok]}) missing from the "
                    f"'{header_cell}' table"))
        for tok, line in doc_toks.items():
            if tok not in toks:
                out.append(Finding(
                    ctx.DOC_CONTRACT, line, "CM602",
                    f"doc '{header_cell}' table names `{tok}`, which is "
                    f"not in {name}"))
    return out
