"""The port's static analysis (`repro_torch.analysis`,
`tools/check_contract_torch.py`).

  * fixture corpora under `tests/fixtures/analysis_torch/`: the good tree
    is clean, and each planted overlay (`planted/<RULE>_<what>/`) makes
    the passes, and the CLI with exit code 1, report exactly its rule;
  * the real checkout has no finding, and `cuda-lint` reads the real
    `_build._bind` (its loops unrolled) against every C launcher;
  * the package is stdlib-only, like the reference's.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import RepoContext, list_passes, run_passes
from repro_torch.analysis.core import RULE_ID_RE
from repro_torch.analysis.passes import cuda_lint

HERE = Path(__file__).resolve().parent
REPO_ROOT = HERE.parent
FIXTURES = HERE / "fixtures" / "analysis_torch"
GOOD = FIXTURES / "goodrepo"
PLANTED = sorted(p.name for p in (FIXTURES / "planted").iterdir()
                 if p.is_dir())
CLI = REPO_ROOT / "tools" / "check_contract_torch.py"


def rules_of(root, passes=None):
    return {f.rule for f in run_passes(RepoContext(root), passes).findings}


def planted_tree(tmp_path, case):
    root = tmp_path / case
    shutil.copytree(GOOD, root)
    shutil.copytree(FIXTURES / "planted" / case, root, dirs_exist_ok=True)
    return root


def test_pass_catalog_and_every_rule_has_a_planted_corpus():
    infos = list_passes()
    assert {i.name for i in infos} == {
        "bitfield", "dtype", "policy-purity", "registry-coverage",
        "commands", "cuda-lint"}
    rules = [rid for i in infos for rid, _ in i.rules]
    assert len(rules) == len(set(rules))
    assert all(RULE_ID_RE.match(r) for r in rules)
    assert {c.split("_")[0] for c in PLANTED} == set(rules)


def test_goodrepo_is_clean():
    res = run_passes(RepoContext(GOOD))
    assert res.findings == [], "\n".join(map(str, res.findings))


@pytest.mark.parametrize("case", PLANTED)
def test_planted_corpus_fires_exactly_its_rule(tmp_path, case):
    rule = case.split("_")[0]
    root = planted_tree(tmp_path, case)
    assert rules_of(root) == {rule}
    out = subprocess.run([sys.executable, str(CLI), "--root", str(root)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1, out.stdout + out.stderr
    fired = {line.split()[1] for line in out.stdout.splitlines()
             if line.startswith(("src/", "docs/", "tests/"))}
    assert fired == {rule}


def test_repo_is_clean():
    res = run_passes(RepoContext(REPO_ROOT))
    assert res.findings == [], "\n".join(str(f) for f in res.findings)


def test_bind_table_matches_every_launcher_of_the_real_sources():
    ctx = RepoContext(REPO_ROOT)
    funcs = cuda_lint.extern_c_functions(ctx)
    argtypes, restypes, unreadable = cuda_lint.bind_table(
        ctx.tree(ctx.BUILD))
    assert unreadable == []
    launchers = {n for n in funcs if n.endswith("_launch")}
    # the float launchers are named by `_bind`'s loop over f32 / bf16
    assert {"flash_attention_f32_launch", "flash_attention_bf16_launch",
            "kv_quant_bf16_launch", "paged_attention_bf16_launch",
            "mamba2_ssd_f32_launch", "sweep_mega_open_launch"} <= launchers
    assert launchers <= set(argtypes)
    for name in launchers:
        assert argtypes[name][0] == funcs[name]["params"], name
        assert restypes[name][0] == "i", name
    # E: q, k, v, out, 7 ints and the stream
    assert funcs["flash_attention_f32_launch"]["params"] == \
        ["p"] * 4 + ["i"] * 7 + ["p"]


def test_abi_drift_in_a_copy_of_the_real_kernels(tmp_path):
    kernels = "src/repro_torch/kernels"
    shutil.copytree(REPO_ROOT / kernels, tmp_path / kernels,
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert rules_of(tmp_path, ["cuda-lint"]) == set()
    cu = tmp_path / kernels / "csrc" / "flash_attention.cu"
    text = cu.read_text()
    old = ("int kv_blk, int causal,\n" + " " * 42 + "void* stream)")
    assert old in text
    cu.write_text(text.replace(old, old.replace("int causal,",
                                                "int causal, int extra,"), 1))
    res = run_passes(RepoContext(tmp_path), ["cuda-lint"])
    assert {f.rule for f in res.findings} == {"CU501"}
    assert "flash_attention_f32_launch" in res.findings[0].message
    assert "takes 13 parameters" in res.findings[0].message


def test_cli_exit_codes(tmp_path):
    ok = subprocess.run([sys.executable, str(CLI)], capture_output=True,
                        text=True, timeout=60)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 finding(s)" in ok.stdout
    listed = subprocess.run([sys.executable, str(CLI), "--list"],
                            capture_output=True, text=True, timeout=60)
    assert listed.returncode == 0
    for name in ("bitfield", "dtype", "policy-purity", "registry-coverage",
                 "commands", "cuda-lint"):
        assert f"{name}:" in listed.stdout
    unknown = subprocess.run([sys.executable, str(CLI), "--pass", "nope"],
                             capture_output=True, text=True, timeout=60)
    assert unknown.returncode == 2
    both = subprocess.run([sys.executable, str(CLI), "--all", "--pass",
                           "dtype"], capture_output=True, text=True,
                          timeout=60)
    assert both.returncode == 2


def test_importing_the_analysis_loads_neither_torch_numpy_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.analysis import RepoContext, run_passes\n"
        f"run_passes(RepoContext({str(GOOD)!r}))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO_ROOT),
                         env={"PYTHONPATH": str(REPO_ROOT / "src"),
                              "PATH": ""},
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")
