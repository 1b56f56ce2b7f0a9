"""A small statement-level control-flow graph for intra-function dataflow.

Built for the ``allocator-pairing`` pass: the question it answers is "can
execution travel from statement A to a function exit without passing
through statement B?", *including exceptional exits* — a cancel path
that leaks an allocator envelope is exactly a path the eye misses and a
CFG does not.  The port's copy of ``repro.analysis.cfg``.

Design choices (deliberately conservative — over-approximating the path
set only ever produces extra findings, never hides one):

  * every statement containing a call, ``raise``, or ``assert`` *may
    raise*: it gets an edge to the innermost enclosing handler chain, and
    — unless some handler is a catch-all (``except:`` / ``except
    Exception`` / ``except BaseException``) — onward to the exceptional
    exit.  Exceptional edges drop the statement's gens but keep its
    kills (an acquire that raises acquired nothing; a raising release is
    a broken allocator, not a leak) — so ``x = alloc.reserve(n)``
    directly followed by ``try/finally: release`` is clean.  The one
    blind spot: a statement that acquires AND then raises in a *later*
    call on the same line (``use(alloc.reserve(n))``) — split such lines;
  * ``finally`` bodies are built once and joined onto both the normal and
    the propagating path (a slight over-approximation of the real
    continuation routing);
  * loops may execute zero times (``while True`` included), so a release
    that only happens inside a loop body does not discharge an acquire
    before it.

Nodes carry their AST statement; :func:`reaching` runs a forward
union/kill dataflow over user-supplied ``gen``/``kill`` labels.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, FrozenSet, List, Optional, Set

_CATCH_ALL = {"Exception", "BaseException"}


class Node:
    """One CFG node.  ``stmt`` is None for the synthetic entry/exits.
    ``succ`` are fall-through/branch edges (statement completed, its
    gen/kill applied); ``exc_succ`` are exceptional edges (statement did
    not complete — dataflow propagates its IN unchanged)."""

    __slots__ = ("stmt", "succ", "exc_succ", "label")

    def __init__(self, stmt: Optional[ast.stmt], label: str = ""):
        self.stmt = stmt
        self.succ: List["Node"] = []
        self.exc_succ: List["Node"] = []
        self.label = label

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        if self.stmt is None:
            return f"<{self.label}>"
        return f"<{type(self.stmt).__name__}@{self.stmt.lineno}>"


class _Frame:
    """An enclosing ``try`` as seen from inside its body: where a raise
    goes first, and whether it can escape past the handlers."""

    __slots__ = ("handler_entries", "catches_all")

    def __init__(self, handler_entries: List[Node], catches_all: bool):
        self.handler_entries = handler_entries
        self.catches_all = catches_all


class FunctionCFG:
    """CFG of one function body (nested defs are *not* descended into —
    analyze them separately)."""

    def __init__(self, func: ast.AST):
        body = getattr(func, "body", None)
        if body is None:  # pragma: no cover — defensive
            raise TypeError(f"not a function node: {func!r}")
        self.entry = Node(None, "entry")
        self.exit_ok = Node(None, "exit_ok")
        self.exit_raise = Node(None, "exit_raise")
        self.nodes: List[Node] = [self.entry, self.exit_ok, self.exit_raise]
        self._loop_stack: List[tuple] = []   # (header, after)
        self._frames: List[_Frame] = []
        first = self._seq(body, self.exit_ok)
        self.entry.succ.append(first)

    # ------------------------------------------------------------------
    def _node(self, stmt: Optional[ast.stmt], label: str = "") -> Node:
        n = Node(stmt, label)
        self.nodes.append(n)
        return n

    def _raise_targets(self) -> List[Node]:
        """Where control may go when a statement raises: the innermost
        handlers, escaping outward until a catch-all (or the exit)."""
        targets: List[Node] = []
        for frame in reversed(self._frames):
            targets.extend(frame.handler_entries)
            if frame.catches_all:
                return targets
        targets.append(self.exit_raise)
        return targets

    @staticmethod
    def _may_raise(stmt: ast.stmt) -> bool:
        # only this statement's own expressions count: child statements
        # of a compound (try/if/for bodies) are separate CFG nodes with
        # their own exceptional edges, and nested def/lambda bodies don't
        # run when the statement does
        stack: List[ast.AST] = [stmt]
        while stack:
            sub = stack.pop()
            if sub is not stmt and isinstance(
                    sub, (ast.stmt, ast.Lambda)):
                continue
            if isinstance(sub, (ast.Call, ast.Raise, ast.Assert)):
                return True
            stack.extend(ast.iter_child_nodes(sub))
        return False

    # ------------------------------------------------------------------
    def _seq(self, stmts: List[ast.stmt], after: Node) -> Node:
        """Build the chain for ``stmts`` flowing into ``after``; returns
        the entry node of the chain."""
        entry = after
        for stmt in reversed(stmts):
            entry = self._stmt(stmt, entry)
        return entry

    def _stmt(self, stmt: ast.stmt, after: Node) -> Node:
        n = self._node(stmt)
        if isinstance(stmt, (ast.If,)):
            n.succ.append(self._seq(stmt.body, after))
            n.succ.append(self._seq(stmt.orelse, after) if stmt.orelse
                          else after)
        elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            self._loop_stack.append((n, after))
            body_entry = self._seq(stmt.body, n)  # back edge to header
            self._loop_stack.pop()
            n.succ.append(body_entry)
            # the loop may run zero times / its condition may turn false
            n.succ.append(self._seq(stmt.orelse, after) if stmt.orelse
                          else after)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            n.succ.append(self._seq(stmt.body, after))
        elif isinstance(stmt, ast.Try):
            n.succ.append(self._build_try(stmt, after))
        elif isinstance(stmt, ast.Return):
            n.succ.append(self.exit_ok)
        elif isinstance(stmt, ast.Raise):
            n.exc_succ.extend(self._raise_targets())
        elif isinstance(stmt, ast.Break):
            if self._loop_stack:
                n.succ.append(self._loop_stack[-1][1])
            else:  # pragma: no cover — invalid python
                n.succ.append(after)
        elif isinstance(stmt, ast.Continue):
            if self._loop_stack:
                n.succ.append(self._loop_stack[-1][0])
            else:  # pragma: no cover — invalid python
                n.succ.append(after)
        else:
            n.succ.append(after)
        if self._may_raise(stmt) and not isinstance(stmt, ast.Raise):
            n.exc_succ.extend(self._raise_targets())
        return n

    def _build_try(self, stmt: ast.Try, after: Node) -> Node:
        # finally body: one instance, on both the normal path and (joined)
        # the propagating path — see module docstring
        if stmt.finalbody:
            fin_entry = self._seq(stmt.finalbody, after)
            fin_exit_entry = self._seq(stmt.finalbody, self.exit_raise)
        else:
            fin_entry = after
            fin_exit_entry = self.exit_raise

        # handlers run under the *outer* frame stack (an exception inside
        # a handler propagates outward, not back into this try)
        handler_entries: List[Node] = []
        catches_all = False
        for h in stmt.handlers:
            handler_entries.append(self._seq(h.body, fin_entry))
            if h.type is None:
                catches_all = True
            elif isinstance(h.type, ast.Name) and h.type.id in _CATCH_ALL:
                catches_all = True
        if stmt.finalbody and not catches_all:
            # an uncaught exception still runs finally before propagating
            handler_entries.append(fin_exit_entry)
            catches_all = True  # routed: _raise_targets must stop here

        self._frames.append(_Frame(handler_entries, catches_all))
        else_entry = self._seq(stmt.orelse, fin_entry) if stmt.orelse \
            else fin_entry
        body_entry = self._seq(stmt.body, else_entry)
        self._frames.pop()
        return body_entry


def reaching(cfg: FunctionCFG,
             gen: Callable[[ast.stmt], FrozenSet[str]],
             kill: Callable[[ast.stmt], FrozenSet[str]],
             ) -> Dict[Node, FrozenSet[str]]:
    """Forward may-dataflow: label sets generated at statements, killed at
    statements, unioned at joins.  Returns IN[] per node — in particular
    ``IN[cfg.exit_ok]`` / ``IN[cfg.exit_raise]`` are the labels that can
    reach a normal / exceptional exit without being killed on the way."""
    IN: Dict[Node, Set[str]] = {n: set() for n in cfg.nodes}
    work = list(cfg.nodes)
    # (pred, exceptional?) — an exceptional edge propagates the pred's
    # IN minus its kills (no gen: an acquire that raised holds nothing;
    # kill applies: a raising release is a broken allocator, not a leak)
    preds: Dict[Node, List[tuple]] = {n: [] for n in cfg.nodes}
    for n in cfg.nodes:
        for s in n.succ:
            preds[s].append((n, False))
        for s in n.exc_succ:
            preds[s].append((n, True))

    def out_norm(n: Node, inset: Set[str]) -> Set[str]:
        if n.stmt is None:
            return set(inset)
        return (inset - kill(n.stmt)) | gen(n.stmt)

    def out_exc(n: Node, inset: Set[str]) -> Set[str]:
        if n.stmt is None:  # pragma: no cover — exits have no out-edges
            return set(inset)
        return inset - kill(n.stmt)

    norm_cur: Dict[Node, Set[str]] = {n: set() for n in cfg.nodes}
    exc_cur: Dict[Node, Set[str]] = {n: set() for n in cfg.nodes}
    while work:
        n = work.pop()
        inset = set()
        for p, exceptional in preds[n]:
            inset |= exc_cur[p] if exceptional else norm_cur[p]
        IN[n] = inset
        new_norm = out_norm(n, inset)
        new_exc = out_exc(n, inset)
        if new_norm != norm_cur[n] or new_exc != exc_cur[n]:
            norm_cur[n] = new_norm
            exc_cur[n] = new_exc
            work.extend(n.succ)
            work.extend(n.exc_succ)
    return {n: frozenset(s) for n, s in IN.items()}
