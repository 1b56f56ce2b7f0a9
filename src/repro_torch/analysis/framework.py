"""Core machinery of the ``repro_torch.analysis`` static-analysis suite
(the port's own copy of ``repro.analysis.framework``).

The port's correctness story rests on invariants that are otherwise
checked only dynamically (golden-log bit-exactness, allocator leak
tests, the ``self.obs.enabled`` guard discipline, the kernel wrappers'
contract).  This module is the shared skeleton that lets each invariant
become a *lint-time* pass:

  * :class:`Finding` — one violation: rule, ``file:line``, message, and a
    fix hint;
  * :class:`SourceFile` — a lazily parsed file (text, lines, AST) plus the
    suppression index built from ``# repro: allow(<rule>)`` comments;
  * :class:`AnalysisPass` — the pass interface: declare target files,
    emit findings; registered via :func:`register`;
  * :func:`run_analysis` — the runner: select rules, collect files, run
    passes, filter suppressed/baselined findings into a
    :class:`AnalysisReport`.

Suppression syntax (both spellings suppress; ``transfer`` documents an
*ownership transfer* for the allocator-pairing rule).  It is the JAX
package's, so a line copied from there keeps its meaning:

    pages = alloc.reserve(rid, n)  # repro: allow(allocator-pairing) — why

A marker on a ``def``/``class`` header line covers the whole body, so a
function-scoped exception needs one annotation, not one per line.  Accepted
exceptions should carry a one-line justification after the marker.

An optional *baseline* file (``--baseline``) records findings to ignore,
keyed by ``(rule, path, message)`` so they survive unrelated line drift —
useful when adopting a new rule over legacy code incrementally.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ``# repro: allow(rule-a, rule-b)`` / ``# repro: transfer(rule)``
ALLOW_RE = re.compile(r"repro:\s*(?:allow|transfer)\(([\w\s,*-]+)\)")

_PY_SUFFIX = ".py"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, pinned to a source location."""

    rule: str
    path: str          # repo-relative, posix separators
    line: int          # 1-indexed
    message: str
    hint: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    @property
    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: stable across unrelated line-number drift."""
        return (self.rule, self.path, self.message)

    def render(self, *, with_hint: bool = True) -> str:
        s = f"{self.location}: [{self.rule}] {self.message}"
        if with_hint and self.hint:
            s += f"\n    hint: {self.hint}"
        return s


class SourceFile:
    """A file under analysis: text, lines, lazy AST, suppression index."""

    def __init__(self, repo: pathlib.Path, path: pathlib.Path):
        self.repo = repo
        self.path = path
        try:
            self.rel = path.resolve().relative_to(repo.resolve()).as_posix()
        except ValueError:
            self.rel = path.as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.Module] = None
        self._parse_error: Optional[SyntaxError] = None
        self._parsed = False
        self._allow: Optional[Dict[int, Set[str]]] = None
        self._scopes: Optional[List[Tuple[int, int, int]]] = None

    # ------------------------------------------------------------------
    @property
    def is_python(self) -> bool:
        return self.path.suffix == _PY_SUFFIX

    @property
    def tree(self) -> Optional[ast.Module]:
        """The parsed AST, or ``None`` for non-Python / unparsable files
        (the runner reports parse failures as findings of rule ``parse``)."""
        if not self._parsed:
            self._parsed = True
            if self.is_python:
                try:
                    self._tree = ast.parse(self.text)
                except SyntaxError as e:
                    self._parse_error = e
        return self._tree

    @property
    def parse_error(self) -> Optional[SyntaxError]:
        self.tree  # noqa: B018 — force the parse
        return self._parse_error

    # ------------------------------------------------------------------
    @property
    def allow(self) -> Dict[int, Set[str]]:
        """Line number -> set of rule names suppressed on that line."""
        if self._allow is None:
            self._allow = {}
            for i, line in enumerate(self.lines, start=1):
                m = ALLOW_RE.search(line)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")
                             if r.strip()}
                    self._allow[i] = rules
        return self._allow

    def _scope_headers(self) -> List[Tuple[int, int, int]]:
        """``(start, end, header_line)`` for every def/class scope."""
        if self._scopes is None:
            self._scopes = []
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.ClassDef)):
                        end = getattr(node, "end_lineno", node.lineno)
                        self._scopes.append((node.lineno, end, node.lineno))
        return self._scopes

    def suppressed(self, rule: str, line: int) -> bool:
        """True when a ``# repro: allow(rule)`` covers ``line``: either on
        the line itself or on the header line of an enclosing def/class."""
        def hit(at: int) -> bool:
            rules = self.allow.get(at)
            return rules is not None and (rule in rules or "*" in rules)

        if hit(line):
            return True
        for start, end, header in self._scope_headers():
            if start <= line <= end and hit(header):
                return True
        return False


# ---------------------------------------------------------------------------
# pass interface + registry
# ---------------------------------------------------------------------------
class AnalysisPass:
    """Base class for a rule.  Subclasses set ``name``/``description``,
    declare which files they want, and implement ``check_file`` (or
    override ``run`` for cross-file rules)."""

    name: str = ""
    description: str = ""
    hint: str = ""
    # repo-relative roots (dirs walked for *.py) or single files
    targets: Sequence[str] = ("src/repro_torch",)
    suffix: str = _PY_SUFFIX

    def files(self, repo: pathlib.Path) -> List[pathlib.Path]:
        out: List[pathlib.Path] = []
        for t in self.targets:
            p = repo / t
            if p.is_dir():
                out.extend(sorted(p.rglob(f"*{self.suffix}")))
            elif p.is_file():
                out.append(p)
        return out

    def run(self, repo: pathlib.Path,
            files: Sequence[SourceFile]) -> List[Finding]:
        out: List[Finding] = []
        for sf in files:
            if sf.is_python and sf.tree is None:
                continue  # parse errors are reported once by the runner
            out.extend(self.check_file(sf))
        return out

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, sf: SourceFile, line: int, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(rule=self.name, path=sf.rel, line=line,
                       message=message,
                       hint=self.hint if hint is None else hint)


PASSES: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator adding a pass to the global registry."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"{cls.__name__} has no rule name")
    if name in PASSES:
        raise ValueError(f"duplicate rule name {name!r}")
    PASSES[name] = cls
    return cls


def all_rules() -> List[str]:
    _load_passes()
    return sorted(PASSES)


def _load_passes() -> None:
    # importing the package registers every pass exactly once
    import repro_torch.analysis.passes  # noqa: F401


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AnalysisReport:
    findings: List[Finding]
    n_suppressed: int
    n_baselined: int
    n_files: int
    rules: List[str]

    @property
    def ok(self) -> bool:
        return not self.findings

    def render(self) -> str:
        out = [f.render() for f in self.findings]
        status = "OK" if self.ok else f"{len(self.findings)} finding(s)"
        out.append(f"[repro_torch.analysis] {status} — rules: "
                   f"{', '.join(self.rules)}"
                   f"; {self.n_files} file(s) scanned"
                   f"; {self.n_suppressed} suppressed"
                   + (f"; {self.n_baselined} baselined"
                      if self.n_baselined else ""))
        return "\n".join(out)


def find_repo_root(start: Optional[pathlib.Path] = None) -> pathlib.Path:
    """The repo is the nearest ancestor holding pyproject.toml — from the
    installed package location first, then the working directory."""
    candidates = []
    here = pathlib.Path(__file__).resolve()
    if len(here.parents) >= 4:
        candidates.append(here.parents[3])  # src/repro_torch/analysis/ -> repo
    candidates.append((start or pathlib.Path.cwd()).resolve())
    for c in candidates:
        p = c
        while True:
            if (p / "pyproject.toml").is_file():
                return p
            if p.parent == p:
                break
            p = p.parent
    return candidates[-1]


def load_baseline(path: pathlib.Path) -> Set[Tuple[str, str, str]]:
    data = json.loads(path.read_text())
    return {(e["rule"], e["path"], e["message"]) for e in data["findings"]}


def write_baseline(path: pathlib.Path, findings: Sequence[Finding]) -> None:
    data = {"findings": [{"rule": f.rule, "path": f.path,
                          "message": f.message} for f in findings]}
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")


def run_analysis(repo: Optional[pathlib.Path] = None,
                 rules: Optional[Sequence[str]] = None,
                 paths: Optional[Sequence[pathlib.Path]] = None,
                 baseline: Optional[Set[Tuple[str, str, str]]] = None,
                 ) -> AnalysisReport:
    """Run the selected rules (default: all) and return the report.

    ``paths`` restricts every pass to files under the given paths (a pass
    whose own target set does not intersect contributes nothing).
    """
    _load_passes()
    repo = (repo or find_repo_root()).resolve()
    names = list(rules) if rules else sorted(PASSES)
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)} "
                       f"(known: {', '.join(sorted(PASSES))})")
    restrict = ([p.resolve() for p in paths] if paths else None)

    cache: Dict[pathlib.Path, SourceFile] = {}

    def source(p: pathlib.Path) -> SourceFile:
        p = p.resolve()
        if p not in cache:
            cache[p] = SourceFile(repo, p)
        return cache[p]

    def in_scope(p: pathlib.Path) -> bool:
        if restrict is None:
            return True
        rp = p.resolve()
        for r in restrict:
            if rp == r or r in rp.parents:
                return True
        return False

    raw: List[Finding] = []
    seen_files: Set[pathlib.Path] = set()
    parse_reported: Set[pathlib.Path] = set()
    for name in names:
        pa = PASSES[name]()
        fs = [source(p) for p in pa.files(repo) if in_scope(p)]
        seen_files.update(sf.path for sf in fs)
        for sf in fs:
            if sf.is_python and sf.parse_error is not None \
                    and sf.path not in parse_reported:
                parse_reported.add(sf.path)
                e = sf.parse_error
                raw.append(Finding(rule="parse", path=sf.rel,
                                   line=e.lineno or 1,
                                   message=f"syntax error: {e.msg}"))
        raw.extend(pa.run(repo, fs))

    findings: List[Finding] = []
    n_sup = n_base = 0
    for f in raw:
        sf = cache.get((repo / f.path).resolve())
        if sf is not None and sf.suppressed(f.rule, f.line):
            n_sup += 1
            continue
        if baseline and f.key in baseline:
            n_base += 1
            continue
        findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return AnalysisReport(findings=findings, n_suppressed=n_sup,
                          n_baselined=n_base, n_files=len(seen_files),
                          rules=names)
