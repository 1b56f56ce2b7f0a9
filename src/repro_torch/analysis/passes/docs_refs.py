"""``docs-refs`` — documentation references resolve against the tree.

The port's account of itself (``README.md`` and ``PERF.md``) names code
as ``path.py:Symbol`` and links local files.  This pass keeps both true:

  * ``` `src/repro_torch/x.py:Symbol.attr` ``` — the file exists AND the
    symbol chain resolves in it;
  * ``[text](relative/path)`` — the link target exists (URLs and
    ``mailto:`` skipped).

The port's copy of ``repro.analysis.passes.docs_refs``, with one
difference: a symbol is resolved in the file's syntax tree, never by
importing its module (a document may name a module of the JAX package,
which the port does not import).  A name resolves when the module binds
it at top level (``def``, ``class``, an assignment or an import), and
each later part of the chain when the class before it binds it in its
body (methods, class attributes, annotated fields); a part after an
imported name or an assigned value is not checked further.
``ROADMAP.md`` is left out: it records work in progress.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable, List, Optional

from repro_torch.analysis.framework import (AnalysisPass, Finding,
                                            SourceFile, register)

# `src/repro_torch/core/memory.py:AnalyticMemoryEstimator.kv_bytes`
REF_RE = re.compile(r"`([\w/.-]+\.py):([A-Za-z_][\w.]*)`")
# [text](local/path.md) — skip URLs and intra-page anchors
LINK_RE = re.compile(r"\[[^\]]*\]\(([^)#\s]+?)(?:#[^)]*)?\)")


def _bindings(body: List[ast.stmt]) -> dict:
    """{name: the node that binds it} of a module's or a class's body:
    defs and classes (their nodes), assignments, annotated names and
    imports (None: not looked into)."""
    out: dict = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out[n.id] = None
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                out[node.target.id] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = None
        elif isinstance(node, (ast.If, ast.Try)):
            for block in (node.body, node.orelse,
                          getattr(node, "finalbody", [])):
                out.update(_bindings(block))
    return out


def check_symbol_ref(repo: pathlib.Path, path: str,
                     symbol: str) -> Optional[str]:
    """Returns an error string, or None when the reference resolves."""
    if not (repo / path).is_file():
        return f"file does not exist: {path}"
    parts = pathlib.PurePosixPath(path).with_suffix("").parts
    if parts and parts[0] == "src":
        parts = parts[1:]
    modname = ".".join(parts)
    try:
        tree = ast.parse((repo / path).read_text())
    except SyntaxError as e:
        return f"cannot parse {modname}: {e.msg}"
    body: Optional[List[ast.stmt]] = tree.body
    for attr in symbol.split("."):
        if body is None:
            return None  # past an import or a value: not followed
        scope = _bindings(body)
        if attr not in scope:
            return f"{modname} has no symbol {symbol!r}"
        node = scope[attr]
        body = node.body if isinstance(node, ast.ClassDef) else None
    return None


@register
class DocsRefsPass(AnalysisPass):
    name = "docs-refs"
    description = ("every `path.py:Symbol` reference in the port's documents "
                   "resolves and every local markdown link exists")
    hint = ("update the reference to the moved/renamed symbol, or the link "
            "to the moved file")
    targets = ("README.md", "PERF.md")
    suffix = ".md"

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        repo = sf.repo
        for lineno, line in enumerate(sf.lines, start=1):
            for path, symbol in REF_RE.findall(line):
                err = check_symbol_ref(repo, path, symbol)
                if err:
                    yield self.finding(
                        sf, lineno, f"`{path}:{symbol}` — {err}")
            for target in LINK_RE.findall(line):
                if "://" in target or target.startswith("mailto:"):
                    continue
                resolved = (sf.path.parent / target).resolve()
                if not resolved.exists():
                    yield self.finding(
                        sf, lineno, f"broken link -> {target}",
                        hint="the link target moved or was deleted")

    def count_refs(self, sf: SourceFile) -> int:
        """Symbol-reference count of a document (the JAX pass's summary
        figure)."""
        return len(REF_RE.findall(sf.text))
