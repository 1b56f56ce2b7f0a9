"""``determinism`` — golden-pinned modules must stay bit-reproducible.

The scheduler equivalence story pins ``SchedulerCore`` to golden
dispatch logs (the port's is held to the JAX package's), and the tracer
promises byte-identical traces for identical seeds.  Both break silently the
moment a golden-pinned module consults a wall clock, an unseeded RNG,
object identity, or unordered-set iteration order.  This pass bans those
constructs in the configured modules (the port's ``core/`` and the
``SchedulerCore`` path by default; the port's copy of
``repro.analysis.passes.determinism``):

  * wall clocks / entropy: ``time.time``, ``time.monotonic``,
    ``time.perf_counter`` (+ ``_ns`` variants), ``datetime.now/utcnow/
    today``, ``os.urandom``, ``uuid.uuid1/uuid4``;
  * unseeded randomness: any ``random.*`` module call, global-state
    ``np.random.*`` calls — seeded generator *construction*
    (``np.random.RandomState(seed)`` / ``default_rng(seed)``) is allowed,
    and instance methods on such generators never match;
  * identity ordering: the ``id()`` builtin (CPython address order) and
    the ``hash()`` builtin (string hashing is salted per process via
    ``PYTHONHASHSEED``);
  * unordered iteration: ``for``/comprehension iteration (or ``list``/
    ``tuple``/``iter``/``enumerate``/``.pop()``) over values statically
    known to be ``set``/``frozenset`` — wrap in ``sorted(...)`` instead.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (AnalysisPass, Finding,
                                            SourceFile, register)

_CLOCK_CALLS = {
    ("time", "time"), ("time", "time_ns"),
    ("time", "monotonic"), ("time", "monotonic_ns"),
    ("time", "perf_counter"), ("time", "perf_counter_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("os", "urandom"),
    ("uuid", "uuid1"), ("uuid", "uuid4"),
}
_SEEDED_CTORS = {"RandomState", "default_rng", "Generator", "PCG64",
                 "SeedSequence"}
_ITER_WRAPPERS = {"list", "tuple", "iter", "enumerate"}


def _dotted(expr: ast.expr) -> Optional[str]:
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _is_set_expr(expr: ast.expr) -> bool:
    """Literally a set right here: ``{a, b}``, ``set(...)``,
    ``frozenset(...)``, a set comprehension, or ``a | b`` of sets? (the
    binop case is not tracked — assignments cover the repo's idiom)."""
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in ("set", "frozenset"):
        return True
    return False


def _is_set_annotation(ann: ast.expr) -> bool:
    """``Set[int]`` / ``set[int]`` / ``FrozenSet[...]`` / bare ``set``."""
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    name = ann.attr if isinstance(ann, ast.Attribute) else \
        (ann.id if isinstance(ann, ast.Name) else None)
    return name in ("Set", "set", "FrozenSet", "frozenset", "MutableSet",
                    "AbstractSet")


@register
class DeterminismPass(AnalysisPass):
    name = "determinism"
    description = ("golden-pinned modules must not use wall clocks, "
                   "unseeded RNGs, id()/hash() ordering, or unordered-set "
                   "iteration")
    hint = ("golden logs and traces are pinned byte-identical: thread time "
            "through the event clock, use a seeded np.random.RandomState/"
            "default_rng, and iterate sets via sorted(...)")
    # the byte-identical surfaces: Alg. 1-2 + Eq. 1-12 (core/) and the
    # golden-dispatch-log scheduling loop (SchedulerCore)
    targets = ("src/repro_torch/core", "src/repro_torch/serving/core.py")

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        assert sf.tree is not None
        yield from self._check_calls(sf)
        yield from self._check_set_iteration(sf)

    # ------------------------------------------------------------------
    def _check_calls(self, sf: SourceFile) -> Iterable[Finding]:
        assert sf.tree is not None
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted is None:
                continue
            parts = tuple(dotted.split("."))
            # wall clocks / entropy sources
            if parts[-2:] in _CLOCK_CALLS or parts in _CLOCK_CALLS:
                yield self.finding(
                    sf, node.lineno,
                    f"wall-clock/entropy call `{dotted}()` in a "
                    f"golden-pinned module")
                continue
            # global-state randomness: random.*, np.random.*
            if parts[0] == "random" and len(parts) == 2:
                yield self.finding(
                    sf, node.lineno,
                    f"global-RNG call `{dotted}()` — stdlib `random` module "
                    f"state is process-global")
                continue
            if len(parts) >= 3 and parts[-3] in ("np", "numpy") \
                    and parts[-2] == "random" \
                    and parts[-1] not in _SEEDED_CTORS:
                yield self.finding(
                    sf, node.lineno,
                    f"global-RNG call `{dotted}()` — use a seeded "
                    f"RandomState/default_rng instance")
                continue
            if len(parts) >= 2 and parts[-2] == "random" \
                    and parts[-1] in _SEEDED_CTORS and not node.args \
                    and not node.keywords:
                yield self.finding(
                    sf, node.lineno,
                    f"`{dotted}()` constructed without a seed draws OS "
                    f"entropy")
                continue
            # identity / salted-hash ordering
            if dotted in ("id", "hash"):
                yield self.finding(
                    sf, node.lineno,
                    f"`{dotted}()` is run-dependent ({'CPython address' if dotted == 'id' else 'PYTHONHASHSEED-salted'} "
                    f"ordering) in a golden-pinned module")

    # ------------------------------------------------------------------
    def _set_bindings(self, sf: SourceFile) -> Dict[str, int]:
        """Names/attribute-chains statically known to hold sets, mapped to
        the line that bound them (module- and class/function-level
        assignments, annotations included)."""
        assert sf.tree is not None
        known: Dict[str, int] = {}
        for node in ast.walk(sf.tree):
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign) and _is_set_expr(node.value):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                if _is_set_annotation(node.annotation) or (
                        node.value is not None and _is_set_expr(node.value)):
                    targets = [node.target]
            elif isinstance(node, ast.AugAssign):
                continue
            for t in targets:
                name = _dotted(t)
                if name is not None:
                    known[name] = node.lineno
        return known

    def _check_set_iteration(self, sf: SourceFile) -> Iterable[Finding]:
        assert sf.tree is not None
        known = self._set_bindings(sf)

        def set_like(expr: ast.expr) -> Optional[str]:
            if _is_set_expr(expr):
                return ast.unparse(expr) if len(ast.unparse(expr)) < 40 \
                    else "a set expression"
            name = _dotted(expr)
            if name is not None and name in known:
                return name
            return None

        for node in ast.walk(sf.tree):
            iters: List[Tuple[int, ast.expr]] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append((node.lineno, node.iter))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend((g.iter.lineno, g.iter)
                             for g in node.generators)
            elif isinstance(node, ast.Call):
                fname = node.func.id if isinstance(node.func, ast.Name) \
                    else None
                if fname in _ITER_WRAPPERS and len(node.args) >= 1:
                    iters.append((node.lineno, node.args[0]))
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "pop" and not node.args:
                    tgt = set_like(node.func.value)
                    if tgt is not None:
                        yield self.finding(
                            sf, node.lineno,
                            f"`.pop()` on set `{tgt}` removes an arbitrary "
                            f"element")
            for line, it in iters:
                tgt = set_like(it)
                if tgt is not None:
                    yield self.finding(
                        sf, line,
                        f"iteration over unordered set `{tgt}` — order is "
                        f"insertion/hash dependent")
