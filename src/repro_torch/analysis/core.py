"""Core of the `repro_torch.analysis` static-analysis suite.

Findings, the suppression-pragma scanner, the repo context handed to
passes, and the pass registry. The registry mirrors the policy registry
idiom (`repro_torch.core.policy.registry`): passes self-register at import
time under a stable name, and the CLI resolves them by name.

Stdlib-only by design — `tools/check_contract_torch.py` must run in CI
jobs that have neither torch, numpy nor jax installed.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable

# ---------------------------------------------------------------------------
# findings

#: rule ids look like BF101 / DT203 / PL502
RULE_ID_RE = re.compile(r"^[A-Z]{2}\d{3}$")


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a specific site.

    ``path`` is repo-root-relative (posix separators) so output is stable
    across checkouts; ``line`` is 1-based (0 for whole-file findings).
    """
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:  # "path:line: RULE message" (clickable)
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# suppression pragmas
#
# Python:    some_code()  # contract: disable=DT201 -- event-mode plane is float
# Markdown:  <!-- contract: disable=BF106 -- prose example, not the table -->
#
# A pragma suppresses matching findings on its own line; a standalone
# pragma (the line holds nothing else) also covers the next line, so
# multi-line statements can carry the pragma above them.

_PRAGMA_RE = re.compile(
    r"(?:#|<!--)\s*contract:\s*disable=([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"\s*(?:--\s*(.*?))?\s*(?:-->)?\s*$"
)
_STANDALONE_RE = re.compile(r"^\s*(?:#|<!--)\s*contract:")


@dataclass(frozen=True)
class Pragma:
    path: str
    line: int            # line the pragma appears on
    rules: tuple[str, ...]
    reason: str
    covers: tuple[int, ...]   # lines it suppresses


def scan_pragmas(text: str, path: str) -> list[Pragma]:
    out: list[Pragma] = []
    for i, raw in enumerate(text.splitlines(), start=1):
        m = _PRAGMA_RE.search(raw)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(","))
        covers = (i, i + 1) if _STANDALONE_RE.match(raw) else (i,)
        out.append(Pragma(path, i, rules, (m.group(2) or "").strip(), covers))
    return out


# ---------------------------------------------------------------------------
# repo context


class RepoContext:
    """Read-only view of one checkout handed to every pass.

    Caches file text and parsed ASTs; all paths are repo-root-relative.
    The well-known paths below are the contract's anchor files — fixture
    corpora under `tests/fixtures/analysis/` mirror this layout so the
    same passes run unchanged against planted violations; the port's
    corpora live under `tests/fixtures/analysis_torch/`.
    """

    FIELDS = "src/repro_torch/core/sweep/fields.py"
    ARBITER = "src/repro_torch/core/sweep/arbiter.py"
    KERNEL_ARBITER = "src/repro_torch/kernels/sweep_arbiter.py"
    DOC_CONTRACT = "docs/tick-contract.md"
    ENGINE = "src/repro_torch/core/sweep/engine.py"
    TORCHBODY = "src/repro_torch/core/sweep/torchbody.py"
    SIM = "src/repro_torch/core/refresh/sim.py"
    SWEEP_POLICIES = "src/repro_torch/core/sweep/policies.py"
    COMMANDS = "src/repro_torch/core/commands/trace.py"
    POLICY_PKG = "src/repro_torch/core/policy"
    KERNELS_DIR = "src/repro_torch/kernels"
    CSRC_DIR = "src/repro_torch/kernels/csrc"
    BUILD = "src/repro_torch/kernels/_build.py"
    LAYERS = "src/repro_torch/models/layers.py"
    SCENARIOS = "src/repro_torch/core/refresh/scenarios.py"
    SRC_PKG = "src/repro_torch"
    # the port's own tests that hold each matrix against the reference
    TEST_CONFORMANCE = "tests/test_torch_policy_sim.py"
    TEST_MULTIRANK = "tests/test_torch_sweep_host.py"
    TEST_SWEEP = "tests/test_torch_megakernel.py"
    TEST_SUBARRAY = "tests/test_torch_open.py"
    TEST_SERVING_COSIM = "tests/test_torch_serving.py"

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self._text: dict[str, str | None] = {}
        self._tree: dict[str, ast.Module | None] = {}

    def exists(self, rel: str) -> bool:
        return (self.root / rel).is_file()

    def text(self, rel: str) -> str | None:
        if rel not in self._text:
            p = self.root / rel
            self._text[rel] = (
                p.read_text(encoding="utf-8") if p.is_file() else None)
        return self._text[rel]

    def tree(self, rel: str) -> ast.Module | None:
        """Parsed AST, or None if the file is missing or unparsable."""
        if rel not in self._tree:
            src = self.text(rel)
            try:
                self._tree[rel] = ast.parse(src) if src is not None else None
            except SyntaxError:
                self._tree[rel] = None
        return self._tree[rel]

    def py_files(self, rel_dir: str) -> list[str]:
        """Sorted repo-relative paths of .py files under ``rel_dir``."""
        return self.files(rel_dir, "*.py")

    def files(self, rel_dir: str, pattern: str) -> list[str]:
        """Sorted repo-relative paths of files matching ``pattern`` under
        ``rel_dir`` (recursively)."""
        base = self.root / rel_dir
        if not base.is_dir():
            return []
        return sorted(
            p.relative_to(self.root).as_posix()
            for p in base.rglob(pattern))


# ---------------------------------------------------------------------------
# pass registry (mirrors repro_torch.core.policy.registry)

PassFn = Callable[[RepoContext], list[Finding]]


@dataclass(frozen=True)
class PassInfo:
    name: str
    run: PassFn
    doc: str
    rules: tuple[tuple[str, str], ...] = field(default=())  # (id, summary)


_PASSES: dict[str, PassInfo] = {}


def register_pass(name: str, *, rules: Iterable[tuple[str, str]] = ()):
    """Decorator: ``@register_pass("bitfield", rules=[("BF101", "...")])``."""
    rules = tuple(rules)
    for rid, _ in rules:
        if not RULE_ID_RE.match(rid):
            raise ValueError(f"malformed rule id {rid!r}")

    def deco(fn: PassFn) -> PassFn:
        if name in _PASSES:
            raise ValueError(f"duplicate pass {name!r}")
        _PASSES[name] = PassInfo(name, fn, (fn.__doc__ or "").strip(), rules)
        return fn

    return deco


def get_pass(name: str) -> PassInfo:
    _load_builtin_passes()
    try:
        return _PASSES[name]
    except KeyError:
        known = ", ".join(sorted(_PASSES))
        raise KeyError(f"unknown pass {name!r} (known: {known})") from None


def list_passes() -> list[PassInfo]:
    _load_builtin_passes()
    return [_PASSES[k] for k in sorted(_PASSES)]


def _load_builtin_passes() -> None:
    # Import for registration side effects; idempotent.
    from repro_torch.analysis import passes  # noqa: F401


# ---------------------------------------------------------------------------
# driver


@dataclass
class RunResult:
    findings: list[Finding]
    suppressed: list[tuple[Finding, Pragma]]
    unused_pragmas: list[Pragma]

    @property
    def ok(self) -> bool:
        return not self.findings


def run_passes(ctx: RepoContext,
               names: Iterable[str] | None = None) -> RunResult:
    """Run the named passes (default: all) and apply pragma suppression.

    Suppression is applied centrally so passes never need pragma
    awareness: a finding is dropped when a pragma in the same file lists
    its rule id and covers its line.
    """
    infos = ([get_pass(n) for n in names] if names is not None
             else list_passes())
    raw: list[Finding] = []
    for info in infos:
        raw.extend(info.run(ctx))

    pragmas: dict[str, list[Pragma]] = {}
    for f in raw:
        if f.path not in pragmas:
            text = ctx.text(f.path)
            pragmas[f.path] = scan_pragmas(text, f.path) if text else []

    kept: list[Finding] = []
    suppressed: list[tuple[Finding, Pragma]] = []
    used: set[tuple[str, int]] = set()
    for f in sorted(raw):
        hit = next(
            (p for p in pragmas.get(f.path, ())
             if f.rule in p.rules and f.line in p.covers), None)
        if hit is None:
            kept.append(f)
        else:
            suppressed.append((f, hit))
            used.add((hit.path, hit.line))
    unused = [p for ps in pragmas.values() for p in ps
              if (p.path, p.line) not in used]
    return RunResult(kept, suppressed, unused)
