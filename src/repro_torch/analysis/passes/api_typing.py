"""``api-typing`` — the exported serving/kvcache surface is fully typed.

The packages downstream code programs against — the port's
``repro_torch.kvcache``, ``repro_torch.serving`` and ``repro_torch.fleet``
— must carry annotations, as the JAX package's do.  This pass checks
what ``mypy --disallow-untyped-defs`` would, at the same sub-second cost
as every other rule and with findings in the shared ``file:line`` +
suppression format (the port's copy of ``repro.analysis.passes.
api_typing``):

  * every function/method parameter annotated (``self``/``cls`` exempt);
  * every function/method return annotated (``__init__`` exempt — its
    return is always ``None`` and mypy infers it).

All defs in the configured packages are checked, private helpers
included, mirroring ``disallow_untyped_defs``; nested closures are
skipped (mypy infers through them and they are not API).
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Sequence, Tuple

from repro_torch.analysis.framework import (AnalysisPass, Finding,
                                            SourceFile, register)


@register
class ApiTypingPass(AnalysisPass):
    name = "api-typing"
    description = ("functions and methods in repro_torch.kvcache / "
                   "repro_torch.serving / repro_torch.fleet must have fully "
                   "annotated signatures (params + return)")
    hint = ("annotate every parameter and the return type, as mypy "
            "--disallow-untyped-defs would ask")
    targets = ("src/repro_torch/kvcache", "src/repro_torch/serving",
               "src/repro_torch/fleet")

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        assert sf.tree is not None
        yield from self._scan(sf, sf.tree.body, prefix="", method=False)

    def _scan(self, sf: SourceFile, body: Sequence[ast.stmt], prefix: str,
              method: bool) -> Iterable[Finding]:
        for node in body:
            if isinstance(node, ast.ClassDef):
                yield from self._scan(sf, node.body,
                                      prefix=f"{prefix}{node.name}.",
                                      method=True)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_def(sf, node, prefix, method)
                # nested defs are closures, not API — not descended into

    def _check_def(self, sf: SourceFile, fn, prefix: str,
                   method: bool) -> Iterable[Finding]:
        name = f"{prefix}{fn.name}"
        args = fn.args
        ordered = args.posonlyargs + args.args
        missing: List[str] = []
        for i, a in enumerate(ordered):
            if method and i == 0 and a.arg in ("self", "cls"):
                continue
            if a.annotation is None:
                missing.append(a.arg)
        missing.extend(a.arg for a in args.kwonlyargs if a.annotation is None)
        if args.vararg is not None and args.vararg.annotation is None:
            missing.append(f"*{args.vararg.arg}")
        if args.kwarg is not None and args.kwarg.annotation is None:
            missing.append(f"**{args.kwarg.arg}")
        if missing:
            yield self.finding(
                sf, fn.lineno,
                f"`{name}` has unannotated parameter(s): "
                f"{', '.join(missing)}")
        if fn.returns is None and fn.name != "__init__":
            yield self.finding(
                sf, fn.lineno, f"`{name}` has no return annotation")
