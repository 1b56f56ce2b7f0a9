"""The port's static-analysis suite (``repro_torch.analysis``): every case
of ``tests/test_analysis.py`` for the port's framework and its five
shared rules, each shared rule held to the JAX package's pass on the same
fixture files, the ``cuda-conventions`` rule on a bad tree (each of its
eight checks broken once) and a good one, the self-check over the repo
at head, and the CLI's exit codes.  AST only: nothing here imports a
module under analysis or runs a model."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import SourceFile as JaxSourceFile
from repro.analysis import passes as jax_passes
from repro_torch.analysis import SourceFile, find_repo_root, run_analysis
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.framework import PASSES, all_rules
from repro_torch.analysis.passes import (AllocatorPairingPass, ApiTypingPass,
                                         CudaConventionsPass, DeterminismPass,
                                         DocsRefsPass, ObsGuardPass)

REPO = find_repo_root()
FIX = REPO / "tests" / "analysis_fixtures"
TFIX = REPO / "tests" / "torch_analysis_fixtures"


def run_on(pass_cls, *paths, source=SourceFile, **attrs):
    """Run one pass over explicit files, applying the framework's
    suppression filter (as run_analysis would)."""
    pa = pass_cls()
    for k, v in attrs.items():
        setattr(pa, k, v)
    sfs = [source(REPO, p) for p in paths]
    by_rel = {sf.rel: sf for sf in sfs}
    return [f for f in pa.run(REPO, sfs)
            if not by_rel[f.path].suppressed(f.rule, f.line)]


def lines(findings):
    return sorted(f.line for f in findings)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_all_rules_registered():
    assert all_rules() == ["allocator-pairing", "api-typing",
                           "cuda-conventions", "determinism", "docs-refs",
                           "obs-guard"]
    for name, cls in PASSES.items():
        assert cls.description, name


def test_default_targets_are_the_ports():
    """Every rule looks at the port's files, never the JAX package's."""
    for cls in PASSES.values():
        for t in cls().targets:
            assert not t.startswith("src/repro/"), (cls.name, t)
    assert DocsRefsPass.targets == ("README.md", "PERF.md")
    assert find_repo_root() == pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the shared rules on the JAX package's fixtures and the port's
# ---------------------------------------------------------------------------
#: (pass, fixture, expected lines), the first of each pair the JAX
#: package's fixture as tests/test_analysis.py expects it
SHARED_CASES = [
    (AllocatorPairingPass, FIX / "allocator_pairing" / "bad.py", [6, 13]),
    (AllocatorPairingPass, FIX / "allocator_pairing" / "good.py", []),
    (AllocatorPairingPass, TFIX / "allocator_pairing" / "bad.py", [6, 13]),
    (AllocatorPairingPass, TFIX / "allocator_pairing" / "good.py", []),
    (ObsGuardPass, FIX / "obs_guard" / "bad.py", [6, 11, 15]),
    (ObsGuardPass, FIX / "obs_guard" / "good.py", []),
    (ObsGuardPass, TFIX / "obs_guard" / "bad.py", [6, 11]),
    (ObsGuardPass, TFIX / "obs_guard" / "good.py", []),
    (DeterminismPass, FIX / "determinism" / "bad.py",
     [9, 10, 11, 12, 13, 15, 17]),
    (DeterminismPass, FIX / "determinism" / "good.py", []),
    (DeterminismPass, TFIX / "determinism" / "bad.py", [8, 9, 10]),
    (DeterminismPass, TFIX / "determinism" / "good.py", []),
    (ApiTypingPass, FIX / "api_typing" / "bad.py", [4, 4, 9, 13]),
    (ApiTypingPass, FIX / "api_typing" / "good.py", []),
    (ApiTypingPass, TFIX / "api_typing" / "bad.py", [5, 10]),
    (ApiTypingPass, TFIX / "api_typing" / "good.py", []),
    (DocsRefsPass, FIX / "docs_refs" / "bad.md", [3, 4, 6]),
    (DocsRefsPass, FIX / "docs_refs" / "good.md", []),
    (DocsRefsPass, TFIX / "docs_refs" / "bad.md", [3, 4, 6]),
    (DocsRefsPass, TFIX / "docs_refs" / "good.md", []),
]


def _case_id(case):
    cls, path, _ = case
    return f"{cls.name}-{path.parent.parent.name}-{path.stem}"


@pytest.mark.parametrize("pass_cls,path,want", SHARED_CASES,
                         ids=[_case_id(c) for c in SHARED_CASES])
def test_shared_rule_fixture_lines(pass_cls, path, want):
    fs = run_on(pass_cls, path)
    assert lines(fs) == want
    assert all(f.rule == pass_cls.name for f in fs)


@pytest.mark.parametrize("pass_cls,path,want", SHARED_CASES,
                         ids=[_case_id(c) for c in SHARED_CASES])
def test_shared_rule_matches_the_jax_pass(pass_cls, path, want):
    """The JAX package's pass and the port's give the same (rule, line,
    message) findings on the same file, up to the package name."""
    jax_cls = getattr(jax_passes, pass_cls.__name__)
    got = [(f.rule, f.line, f.message.replace("repro_torch", "repro"))
           for f in run_on(pass_cls, path)]
    ref = [(f.rule, f.line, f.message.replace("repro_torch", "repro"))
           for f in run_on(jax_cls, path, source=JaxSourceFile)]
    assert got == ref


def test_allocator_pairing_names_the_leak_shapes():
    fs = run_on(AllocatorPairingPass, FIX / "allocator_pairing" / "bad.py")
    # the cancel-path shape: reserve leaks via the early return
    assert "reserve" in fs[0].message
    # release on the normal path only: the exceptional exit still leaks
    assert "exception" in fs[1].message
    fs = run_on(AllocatorPairingPass, TFIX / "allocator_pairing" / "bad.py")
    assert "normal return" in fs[0].message and "share" in fs[1].message


def test_obs_guard_checks_the_receivers_own_chain():
    fs = run_on(ObsGuardPass, FIX / "obs_guard" / "bad.py")
    assert "self.core.obs" in fs[2].message
    fs = run_on(ObsGuardPass, TFIX / "obs_guard" / "bad.py")
    assert all("`self.obs.on_*`" in f.message for f in fs)


def test_determinism_names_every_banned_construct():
    text = " | ".join(f.message for f in run_on(
        DeterminismPass, FIX / "determinism" / "bad.py"))
    for needle in ("wall-clock", "global-RNG", "without a seed", "id()",
                   "unordered set", ".pop()"):
        assert needle in text, needle


def test_docs_refs_names_dead_symbols_files_and_links():
    fs = run_on(DocsRefsPass, TFIX / "docs_refs" / "bad.md")
    assert "no symbol 'Finding.no_such_method'" in fs[0].message
    assert "does not exist" in fs[1].message
    assert "broken link" in fs[2].message


def test_docs_refs_resolves_without_importing(tmp_path):
    """A symbol resolves in the file's syntax tree: the module is never
    imported (a document may name the JAX package), a name bound by an
    import or an assignment resolves, and a method of a class does."""
    mod = tmp_path / "src" / "pkg_not_importable" / "m.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("import jax_that_is_not_installed as np\n"
                   "X = 1\n\n\nclass C:\n    y: int\n\n"
                   "    def f(self):\n        pass\n")
    doc = tmp_path / "doc.md"
    doc.write_text("`src/pkg_not_importable/m.py:C.f` `src/pkg_not_"
                   "importable/m.py:np.anything` `src/pkg_not_importable/"
                   "m.py:X` `src/pkg_not_importable/m.py:C.y`\n"
                   "`src/pkg_not_importable/m.py:C.g`\n")
    pa = DocsRefsPass()
    fs = pa.run(tmp_path, [SourceFile(tmp_path, doc)])
    assert [(f.line, f.message.split(" — ")[1]) for f in fs] == [
        (2, "pkg_not_importable.m has no symbol 'C.g'")]
    assert "pkg_not_importable.m" not in sys.modules


# ---------------------------------------------------------------------------
# cuda-conventions
# ---------------------------------------------------------------------------
def _cuda_run(tree):
    root = TFIX / tree
    pa = CudaConventionsPass()
    sfs = [SourceFile(root, p) for p in pa.files(root)]
    return pa.run(root, sfs)


#: each check's tag and where it fires in cuda_bad (file, line)
CUDA_CHECKS = [
    ("[source]", "build.py", 2),        # csrc/orphan.cu not in KERNELS
    ("[source]", "build.py", 3),        # nosource: no .cu
    ("[module]", "build.py", 4),
    ("[dispatch]", "build.py", 5),
    ("[plain version]", "build.py", 6),
    ("[device gate]", "ops.py", 43),    # no _on_cpu before the launch
    ("[device gate]", "ops.py", 43),    # no _refuse_grad
    ("[no fallback]", "ops.py", 56),
    ("[no availability switch]", "ops.py", 61),
    ("[card test]", "build.py", 10),
]


def test_cuda_conventions_flags_each_of_its_eight_checks():
    fs = _cuda_run("cuda_bad")
    got = sorted((f.message.split("]")[0] + "]",
                  pathlib.PurePosixPath(f.path).name, f.line) for f in fs)
    assert got == sorted(CUDA_CHECKS)
    assert len({tag for tag, _, _ in CUDA_CHECKS}) == 8
    assert all(f.rule == "cuda-conventions" for f in fs)
    text = " | ".join(f.message for f in fs)
    for needle in ("orphan.cu is not in KERNELS", "`nosource` has no CUDA",
                   "`nomodule` has no module", "`undispatched` is not "
                   "dispatched", "no `noref_ref`", "without first testing "
                   "`_on_cpu", "without `_refuse_grad", "ref.rescued_ref",
                   "ref.switched_ref", "`untested` has no test marked"):
        assert needle in text, needle


def test_cuda_conventions_accepts_a_conforming_tree():
    assert _cuda_run("cuda_good") == []


def test_cuda_conventions_holds_the_ports_kernels():
    """The pass reads the port's eight kernels (KERNELS: the seven
    Pallas kernels' ports and the decode loop's condition) and finds each
    one's wrapper, plain version and card test."""
    from repro_torch.kernels.build import KERNELS
    pa = CudaConventionsPass()
    files = pa.files(REPO)
    assert REPO / "tests" / "test_torch_cuda.py" in files
    assert len(KERNELS) == 8
    assert pa.run(REPO, [SourceFile(REPO, p) for p in files]) == []


# ---------------------------------------------------------------------------
# suppression mechanics
# ---------------------------------------------------------------------------
def test_class_header_allow_covers_whole_body(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("class C:  # repro: allow(api-typing)\n"
                 "    def f(self, a):\n"
                 "        return a\n")
    assert run_on(ApiTypingPass, p) == []


def test_wildcard_allow_suppresses_any_rule(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("def f(a):  # repro: allow(*)\n    return a\n")
    assert run_on(ApiTypingPass, p) == []


def test_unsuppressed_twin_still_fires(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("def f(a):\n    return a\n")
    assert len(run_on(ApiTypingPass, p)) == 2


def test_transfer_marker_of_the_jax_package_suppresses(tmp_path):
    """A line copied from the JAX package keeps its marker's meaning."""
    p = tmp_path / "x.py"
    p.write_text("def f(alloc, rid, n):\n"
                 "    alloc.reserve(rid, n)  # repro: transfer(allocator-"
                 "pairing) — caller releases\n")
    assert run_on(AllocatorPairingPass, p) == []


# ---------------------------------------------------------------------------
# self-check + CLI
# ---------------------------------------------------------------------------
def test_suite_is_clean_on_repo_at_head():
    """The acceptance bar: zero unsuppressed findings over the port, no
    baseline, and the only suppressions the five ownership transfers
    whose JAX counterparts carry one."""
    report = run_analysis(repo=REPO)
    assert report.ok, "\n" + report.render()
    assert report.n_files > 100  # really scanned the port, not a subset
    assert report.n_suppressed == 5 and report.n_baselined == 0


@pytest.mark.parametrize("argv,code,needle", [
    (["--list-rules"], 0, "cuda-conventions"),
    (["--all"], 0, "[repro_torch.analysis] OK"),
    (["--rule", "nope"], 2, "unknown rule"),
    (["--all", "--rule", "obs-guard"], 2, "mutually exclusive"),
    (["--rule", "cuda-conventions", "--repo", str(TFIX / "cuda_bad")], 1,
     "10 finding(s)"),
    (["--rule", "cuda-conventions", "--repo", str(TFIX / "cuda_good"),
      "--no-hints"], 0, "OK"),
    (["--rule", "obs-guard", str(REPO / "src" / "repro_torch" / "serving")],
     0, "OK — rules: obs-guard"),
])
def test_cli(argv, code, needle, capsys):
    assert main(argv) == code
    out = capsys.readouterr()
    assert needle in out.out + out.err


def test_cli_names_every_check_of_the_bad_tree(capsys):
    assert main(["--rule", "cuda-conventions", "--no-hints", "--repo",
                 str(TFIX / "cuda_bad")]) == 1
    out = capsys.readouterr().out
    assert "hint:" not in out
    for tag in {tag for tag, _, _ in CUDA_CHECKS}:
        assert tag in out, tag


def test_cli_baseline_round_trip(tmp_path, capsys):
    """--write-baseline records the bad tree's findings and exits 0;
    --baseline then silences exactly them."""
    base = tmp_path / "baseline.json"
    bad = ["--rule", "cuda-conventions", "--repo", str(TFIX / "cuda_bad")]
    assert main(bad + ["--write-baseline", str(base)]) == 0
    assert len(json.loads(base.read_text())["findings"]) == 10
    assert main(bad + ["--baseline", str(base)]) == 0
    assert "10 baselined" in capsys.readouterr().out


def test_module_entry_point_exits_zero_on_the_repo():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[repro_torch.analysis] OK" in proc.stdout
