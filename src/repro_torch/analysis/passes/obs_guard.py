"""``obs-guard`` — observability hooks stay behind their enabled flag.

The overhead discipline of the tracing layer: the scheduler hot path
pays exactly one attribute read + bool test per hook point when
observability is off, so every ``<x>.obs.on_*(...)`` call must be
dominated by a check of the *same* chain's ``.enabled``:

    if self.obs.enabled:
        self.obs.on_dispatch(...)          # guarded — block form

    if not self.core.obs.enabled:
        return                             # guarded — early-exit form
    ...
    self.core.obs.on_admission(...)

A string count of hooks against guards cannot tell *which* site is
unguarded; this pass can.  The port's copy of
``repro.analysis.passes.obs_guard``, over ``src/repro_torch``.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from repro_torch.analysis.framework import (AnalysisPass, Finding,
                                            SourceFile, register)


def _chain(expr: ast.expr) -> Optional[str]:
    """Dotted-name string of a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _enabled_checks(test: ast.expr, *, negated: bool = False) -> List[Tuple[str, bool]]:
    """``(chain, positive)`` pairs provable from an if-test: ``x.enabled``
    -> (x, True); ``not x.enabled`` -> (x, False); ``a and b`` combines."""
    out: List[Tuple[str, bool]] = []
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        for chain, pos in _enabled_checks(test.operand):
            out.append((chain, not pos if not negated else pos))
        return out
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And) \
            and not negated:
        for v in test.values:
            out.extend(_enabled_checks(v))
        return out
    if isinstance(test, ast.Attribute) and test.attr == "enabled":
        chain = _chain(test.value)
        if chain is not None:
            out.append((chain, not negated))
    return out


def _exits_block(stmts: List[ast.stmt]) -> bool:
    """Does this block unconditionally leave the enclosing flow?"""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


@register
class ObsGuardPass(AnalysisPass):
    name = "obs-guard"
    description = ("every `<x>.obs.on_*(...)` hook call must sit behind an "
                   "`if <x>.obs.enabled:` guard (or an early `if not "
                   "<x>.obs.enabled: return`)")
    hint = ("wrap the call: `if <recv>.enabled: <recv>.on_...(...)` — the "
            "disabled hot path must pay only the attribute read + bool test")
    targets = ("src/repro_torch",)

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        assert sf.tree is not None
        for func in ast.walk(sf.tree):
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_body(sf, func.body, guarded=set(),
                                            top=True)

    # ------------------------------------------------------------------
    def _hook_calls(self, stmt: ast.stmt) -> List[Tuple[int, str]]:
        """``(line, receiver_chain)`` for obs hook calls inside ``stmt``
        (not descending into nested defs)."""
        found: List[Tuple[int, str]] = []
        stack: List[ast.AST] = [stmt]
        while stack:
            node = stack.pop()
            if node is not stmt and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr.startswith("on_"):
                recv = node.func.value
                # receiver chain must end in `.obs` (self.obs, core.obs, …)
                if (isinstance(recv, ast.Attribute) and recv.attr == "obs") \
                        or (isinstance(recv, ast.Name) and recv.id == "obs"):
                    chain = _chain(recv)
                    if chain is not None:
                        found.append((node.lineno, chain))
            stack.extend(ast.iter_child_nodes(node))
        return found

    def _check_body(self, sf: SourceFile, stmts: List[ast.stmt],
                    guarded: set, top: bool) -> Iterable[Finding]:
        """Walk a statement block, tracking which obs chains are known
        enabled here (block guards + early-exit guards seen so far)."""
        known = set(guarded)
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                checks = _enabled_checks(stmt.test)
                pos = {c for c, p in checks if p}
                neg = {c for c, p in checks if not p}
                # `if x.enabled: <body>` — body runs with x known enabled
                yield from self._check_body(sf, stmt.body, known | pos,
                                            top=False)
                # `if not x.enabled: <orelse>` symmetric
                yield from self._check_body(sf, stmt.orelse, known | neg,
                                            top=False)
                # `if not x.enabled: return` — the rest of THIS block runs
                # with x enabled
                if neg and _exits_block(stmt.body):
                    known |= neg
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes are visited by check_file itself
            # other compound statements: recurse into every block with the
            # current knowledge (loops/with/try don't invalidate it)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    yield from self._check_body(sf, sub, known, top=False)
            if isinstance(stmt, ast.Try):
                for h in stmt.handlers:
                    yield from self._check_body(sf, h.body, known, top=False)
                continue
            if hasattr(stmt, "body") and not isinstance(
                    stmt, (ast.Expr, ast.Assign, ast.AugAssign,
                           ast.AnnAssign, ast.Return)):
                continue  # blocks handled above; don't re-scan their calls
            for line, chain in self._hook_calls(stmt):
                if chain not in known:
                    yield self.finding(
                        sf, line,
                        f"`{chain}.on_*` hook call is not guarded by "
                        f"`if {chain}.enabled:`")
