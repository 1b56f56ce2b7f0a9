"""``allocator-pairing`` — every page acquisition must reach a release.

A cancel path that leaves a ``PageAllocator`` envelope charged forever
is the leak this rule is for; the allocator churn tests guard the same
property dynamically.  This pass proves the *shape* of it at lint time:
inside any function over the port's ``engine/``, ``serving/`` and
``cluster/``, a call that acquires pages —

    ``<alloc>.reserve(...)``, ``.extend(...)``, ``.share(...)``,
    ``.fork(...)``

— must not be able to reach a function exit (normal **or** exceptional)
without a matching ``.release(...)`` / ``.shrink(...)`` on an allocator
of the same name, as computed over the statement-level CFG
(:mod:`repro_torch.analysis.cfg`).  The port's copy of
``repro.analysis.passes.allocator_pairing``.

Ownership transfers are real in this codebase (retention deliberately
keeps pages alive past the acquiring function — freed later by
``release_request`` / ``finish_batch`` / eviction): annotate those sites
with ``# repro: transfer(allocator-pairing) — <where it is released>``.

Receiver matching is by trailing identifier (``self.alloc``,
``allocator``, ``self.allocators[wid]`` → ``alloc``/``allocator``/
``allocators``) so list methods like ``pool.extend(items)`` never match.

One idiom is blessed beyond what the dataflow can prove: an acquire
enclosed in a ``try`` whose ``finally`` contains a matching release —
even a *conditional* one (the canonical cleanup loop ``for s in slots:
if s.owner >= 0: alloc.release(s.owner)`` releases exactly the residual
set, which is loop-carried state the CFG cannot track).  A function with
no cleanup at all — the cancel-path shape — is still flagged.
"""
from __future__ import annotations

import ast
import pathlib
from typing import FrozenSet, Iterable, List, Optional, Sequence

from repro_torch.analysis.cfg import FunctionCFG, reaching
from repro_torch.analysis.framework import (AnalysisPass, Finding,
                                            SourceFile, register)

ACQUIRE_METHODS = frozenset({"reserve", "extend", "share", "fork"})
RELEASE_METHODS = frozenset({"release", "shrink"})
ALLOCATOR_NAMES = frozenset({"alloc", "allocator", "allocators",
                             "page_allocator"})


def _trailing_name(expr: ast.expr) -> Optional[str]:
    """``self.allocators[wid]`` -> ``allocators``; ``alloc`` -> ``alloc``;
    call results -> None (not a stable allocator reference)."""
    if isinstance(expr, ast.Subscript):
        return _trailing_name(expr.value)
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _alloc_calls(stmt: ast.stmt, methods: FrozenSet[str],
                 names: FrozenSet[str]) -> List[ast.Call]:
    """Allocator-method calls in ``stmt``'s *own* expressions.  Child
    statements (a compound statement's body) are separate CFG nodes and
    must not be double-counted here; nested defs/lambdas don't run when
    the statement does."""
    out: List[ast.Call] = []
    stack: List[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        if node is not stmt and isinstance(
                node, (ast.stmt, ast.Lambda)):
            continue
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in methods \
                    and _trailing_name(node.func.value) in names:
                out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _subtree_release_names(stmts: Sequence[ast.stmt], methods: FrozenSet[str],
                           names: FrozenSet[str]) -> FrozenSet[str]:
    """Allocator names released anywhere under ``stmts`` (child statements
    included, nested defs/lambdas excluded)."""
    found = set()
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in methods:
                nm = _trailing_name(node.func.value)
                if nm in names:
                    found.add(nm)
        stack.extend(ast.iter_child_nodes(node))
    return frozenset(found)


@register
class AllocatorPairingPass(AnalysisPass):
    name = "allocator-pairing"
    description = ("PageAllocator reserve/extend/share/fork call sites must "
                   "reach a release/shrink on every exit path (incl. "
                   "exceptions) or carry an ownership-transfer annotation")
    hint = ("pair the acquisition with release()/shrink() on all exit paths "
            "(try/finally or an explicit unwind), or annotate a deliberate "
            "ownership transfer: # repro: transfer(allocator-pairing) — "
            "released in <where>")
    targets = ("src/repro_torch/engine", "src/repro_torch/serving",
               "src/repro_torch/cluster")

    # injectable for tests / future per-repo config
    acquire_methods: FrozenSet[str] = ACQUIRE_METHODS
    release_methods: FrozenSet[str] = RELEASE_METHODS
    allocator_names: FrozenSet[str] = ALLOCATOR_NAMES

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        assert sf.tree is not None
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(sf, node)

    # ------------------------------------------------------------------
    def _check_function(self, sf: SourceFile,
                        func: ast.AST) -> Iterable[Finding]:
        # label every acquire site "<name>@<line>#<i>"; kills are by
        # allocator trailing name, so one release discharges every acquire
        # on a same-named allocator (no alias analysis — see docstring)
        site_labels = {}

        def gen(stmt: ast.stmt) -> FrozenSet[str]:
            labels = []
            for i, call in enumerate(_alloc_calls(
                    stmt, self.acquire_methods, self.allocator_names)):
                name = _trailing_name(call.func.value)  # type: ignore[union-attr]
                label = f"{name}@{call.lineno}#{i}"
                meth = call.func.attr  # type: ignore[union-attr]
                site_labels[label] = (call.lineno, meth, name)
                labels.append(label)
            return frozenset(labels)

        def kill(stmt: ast.stmt) -> FrozenSet[str]:
            released = {_trailing_name(c.func.value)  # type: ignore[union-attr]
                        for c in _alloc_calls(stmt, self.release_methods,
                                              self.allocator_names)}
            if not released:
                return frozenset()
            return frozenset(lb for lb, (_, _, nm) in site_labels.items()
                             if nm in released)

        # seed site_labels so kill() sees every site regardless of
        # worklist visit order
        for stmt in ast.walk(func):
            if isinstance(stmt, ast.stmt):
                gen(stmt)

        cfg = FunctionCFG(func)
        IN = reaching(cfg, gen, kill)
        leaked_ok = IN[cfg.exit_ok]
        leaked_raise = IN[cfg.exit_raise]

        # blessed idiom: an enclosing finally with a matching (possibly
        # conditional) release is trusted cleanup — see module docstring
        finally_regions = []
        for node in ast.walk(func):
            if isinstance(node, ast.Try) and node.finalbody:
                released = _subtree_release_names(
                    node.finalbody, self.release_methods,
                    self.allocator_names)
                if released:
                    finally_regions.append(
                        (node.lineno, getattr(node, "end_lineno",
                                              node.lineno), released))

        def cleaned_up(line: int, name: str) -> bool:
            return any(start <= line <= end and name in released
                       for start, end, released in finally_regions)

        for label in sorted(leaked_ok | leaked_raise,
                            key=lambda lb: site_labels[lb][0]):
            line, meth, name = site_labels[label]
            if cleaned_up(line, name):
                continue
            how = []
            if label in leaked_ok:
                how.append("a normal return")
            if label in leaked_raise:
                how.append("an exception")
            yield self.finding(
                sf, line,
                f"`{name}.{meth}()` may reach {' and '.join(how)} without a "
                f"release()/shrink() on `{name}` "
                f"(in `{getattr(func, 'name', '?')}`)")
