"""``cuda-conventions`` — the contract of the port's CUDA kernels.

The port's counterpart of ``repro.analysis.passes.pallas_conventions``.
Every kernel named in ``kernels/build.py``'s ``KERNELS`` is built by
``nvcc`` from its own source and reached only through a wrapper in
``kernels/ops.py`` that picks the kernel or its plain version by the
device of the tensors (the device rule: a CUDA tensor launches the
kernel or raises; nothing falls back to the plain version on the card).
For each name in ``KERNELS`` the pass checks:

  1. **source** — ``csrc/<name>.cu`` exists, and every ``csrc/*.cu`` is
     in ``KERNELS`` (a source that is not is never built);
  2. **module** — ``kernels/<name>.py`` exists (the ctypes launcher);
  3. **dispatch** — ``kernels/ops.py`` imports that module and has a
     public wrapper that calls its ``<name>(...)``;
  4. **plain version** — ``kernels/ref.py`` defines ``<name>_ref`` and
     the wrapper calls it;
  5. **device gate** — the wrapper calls ``_on_cpu(...)`` in an ``if``
     before the launch, and ``_refuse_grad(...)`` on its CUDA branch
     before the launch (no kernel has a backward);
  6. **no fallback on failure** — no ``except`` handler in ``kernels/``
     calls a ``*_ref`` or reaches ``ref``: a kernel that fails raises;
  7. **no availability switch** — no test of ``torch.cuda.is_available()``
     in ``kernels/`` selects the plain version: the tensors' device does;
  8. **card test** — ``tests/test_torch_cuda.py`` has a test marked
     ``cuda`` (a ``pytestmark`` or a decorator) that calls the kernel
     (its module's entry or its ``ops`` wrapper) and ``<name>_ref``.

The Pallas rules on index maps, ``input_output_aliases`` and Python
branching on traced refs have no counterpart here: a CUDA kernel's
addressing, aliasing and control flow are C++ in ``csrc/*.cu``, which
this AST pass does not parse; the kernels' tests on the card hold them
to their plain versions instead.  Helpers of a kernel module that are
not kernels (``split.sm_count``, ``ssd_scan.plan``, ``reset_launches``)
are not entries: the entries come from ``KERNELS``.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.framework import (AnalysisPass, Finding,
                                            SourceFile, register)


def _name(func: ast.expr) -> Optional[str]:
    """The called name: ``f`` of ``f(...)`` or of ``a.b.f(...)``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _dotted(expr: ast.expr) -> str:
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return ".".join(reversed(parts))


def _calls(node: ast.AST) -> Iterable[ast.Call]:
    return (n for n in ast.walk(node) if isinstance(n, ast.Call))


def _plain_use(nodes: Sequence[ast.AST]) -> Optional[str]:
    """The first plain-version use under ``nodes``: a call of a ``*_ref``
    or any use of the ``ref`` module, else None."""
    for node in nodes:
        for n in ast.walk(node):
            if isinstance(n, ast.Call) and (_name(n.func) or "").endswith(
                    "_ref"):
                return _dotted(n.func) or "a plain version"
            if isinstance(n, ast.Name) and n.id == "ref" \
                    and isinstance(n.ctx, ast.Load):
                return "ref"
    return None


def _within(node: ast.AST, stmts: Sequence[ast.stmt]) -> bool:
    if not stmts:
        return False
    end = getattr(stmts[-1], "end_lineno", stmts[-1].lineno)
    return stmts[0].lineno <= node.lineno <= end


def _kernel_names(build: SourceFile) -> Tuple[List[Tuple[str, int]], int]:
    """([(name, line)] of ``KERNELS`` in build.py, the line of the
    assignment (1 when there is none))."""
    assert build.tree is not None
    for node in build.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Name) and t.id == "KERNELS"
                   for t in targets) and isinstance(node.value,
                                                    (ast.Tuple, ast.List)):
                return ([(e.value, e.lineno) for e in node.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)], node.lineno)
    return [], 1


def _module_aliases(sf: SourceFile) -> Dict[str, str]:
    """{local name: kernel module name} of the kernel modules a file
    imports (``from <pkg>.kernels import <mod> as <alias>``)."""
    assert sf.tree is not None
    out: Dict[str, str] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[-1] == "kernels":
            for a in node.names:
                out[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if len(parts) >= 2 and parts[-2] == "kernels" and a.asname:
                    out[a.asname] = parts[-1]
    return out


def _launch(fn: ast.FunctionDef, aliases: Dict[str, str],
            name: str) -> Optional[ast.Call]:
    """The first call ``<alias of kernels.name>.<name>(...)`` in ``fn``."""
    for call in _calls(fn):
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == name \
                and isinstance(f.value, ast.Name) \
                and aliases.get(f.value.id) == name:
            return call
    return None


def _marked_cuda(node: ast.AST) -> bool:
    """A ``pytest.mark.cuda`` in a decorator list or a ``pytestmark``."""
    return any(_dotted(n).endswith("mark.cuda")
               for n in ast.walk(node) if isinstance(n, ast.Attribute))


@register
class CudaConventionsPass(AnalysisPass):
    name = "cuda-conventions"
    description = ("each kernel in kernels/build.py's KERNELS has its .cu "
                   "source, its module, an ops.py wrapper gated by "
                   "_on_cpu/_refuse_grad, a ref.py plain version and a "
                   "cuda-marked test; no handler or is_available() test "
                   "falls back to the plain version")
    hint = ("see the docstring of repro_torch.analysis.passes."
            "cuda_conventions and the existing kernels for the contract")
    kernels_dir = "src/repro_torch/kernels"
    test_file = "tests/test_torch_cuda.py"

    @property
    def targets(self) -> Sequence[str]:  # type: ignore[override]
        return (self.kernels_dir, self.test_file)

    def run(self, repo: pathlib.Path,
            files: Sequence[SourceFile]) -> List[Finding]:
        kdir = (repo / self.kernels_dir).resolve()
        parsed = [sf for sf in files if sf.tree is not None]
        here = {sf.path.name: sf for sf in parsed
                if sf.path.resolve().parent == kdir}
        build = here.get("build.py")
        if build is None:
            return []
        kernels, at = _kernel_names(build)
        out: List[Finding] = []
        names = {n for n, _ in kernels}
        csrc = kdir / "csrc"
        for cu in sorted(csrc.glob("*.cu")):
            if cu.stem not in names:
                out.append(self.finding(
                    build, at, f"[source] csrc/{cu.name} is not in KERNELS: "
                               f"it is never built"))
        ops, ref = here.get("ops.py"), here.get("ref.py")
        aliases = _module_aliases(ops) if ops is not None else {}
        ref_defs: Set[str] = set()
        if ref is not None:
            ref_defs = {n.name for n in ref.tree.body  # type: ignore[union-attr]
                        if isinstance(n, ast.FunctionDef)}
        wrappers = [n for n in ops.tree.body  # type: ignore[union-attr]
                    if isinstance(n, ast.FunctionDef)
                    and not n.name.startswith("_")] if ops else []
        test = next((sf for sf in parsed
                     if sf.path.resolve() == (repo / self.test_file)
                     .resolve()), None)
        for name, line in kernels:
            out.extend(self._check_kernel(build, line, name, kdir, ops,
                                          aliases, wrappers, ref_defs, test))
        for sf in parsed:
            if kdir == sf.path.resolve().parent or kdir in \
                    sf.path.resolve().parents:
                out.extend(self._check_fallbacks(sf))
        return out

    # ------------------------------------------------------------------
    def _check_kernel(self, build: SourceFile, line: int, name: str,
                      kdir: pathlib.Path, ops: Optional[SourceFile],
                      aliases: Dict[str, str],
                      wrappers: List[ast.FunctionDef], ref_defs: Set[str],
                      test: Optional[SourceFile]) -> Iterable[Finding]:
        if not (kdir / "csrc" / f"{name}.cu").is_file():
            yield self.finding(build, line, f"[source] kernel `{name}` has "
                                            f"no CUDA source csrc/{name}.cu")
        if not (kdir / f"{name}.py").is_file():
            yield self.finding(build, line, f"[module] kernel `{name}` has "
                                            f"no module kernels/{name}.py")
        wrapper = launch = None
        for fn in wrappers:
            launch = _launch(fn, aliases, name)
            if launch is not None:
                wrapper = fn
                break
        if ops is None or name not in aliases.values():
            yield self.finding(build, line, f"[dispatch] kernel `{name}` is "
                                            f"not dispatched: ops.py never "
                                            f"imports its module")
        elif wrapper is None or launch is None:
            yield self.finding(ops, 1, f"[dispatch] ops.py has no public "
                                       f"wrapper that calls `{name}.{name}`")
        if f"{name}_ref" not in ref_defs:
            yield self.finding(build, line, f"[plain version] kernel "
                                            f"`{name}` has no `{name}_ref` "
                                            f"in ref.py")
        elif wrapper is not None and not any(
                _name(c.func) == f"{name}_ref" for c in _calls(wrapper)):
            yield self.finding(ops, wrapper.lineno,  # type: ignore[arg-type]
                               f"[plain version] wrapper `{wrapper.name}` "
                               f"never calls `{name}_ref`")
        if wrapper is not None and launch is not None:
            yield from self._check_gate(ops, wrapper, launch)  # type: ignore[arg-type]
        if f"{name}_ref" in ref_defs:  # else no test can call it
            yield from self._check_test(build, line, name, test,
                                        wrapper.name if wrapper else None)

    def _check_gate(self, ops: SourceFile, fn: ast.FunctionDef,
                    launch: ast.Call) -> Iterable[Finding]:
        gates = [n for n in ast.walk(fn) if isinstance(n, ast.If)
                 and any(_name(c.func) == "_on_cpu" for c in _calls(n.test))]
        if not any(g.lineno < launch.lineno and not _within(launch, g.body)
                   for g in gates):
            yield self.finding(ops, fn.lineno,
                               f"[device gate] wrapper `{fn.name}` launches "
                               f"without first testing `_on_cpu(...)`")
        refuse = [c for c in _calls(fn) if _name(c.func) == "_refuse_grad"
                  and c.lineno < launch.lineno
                  and not any(_within(c, g.body) for g in gates)]
        if not refuse:
            yield self.finding(ops, fn.lineno,
                               f"[device gate] wrapper `{fn.name}` launches "
                               f"without `_refuse_grad(...)` on its CUDA "
                               f"branch")

    def _check_test(self, build: SourceFile, line: int, name: str,
                    test: Optional[SourceFile],
                    wrapper: Optional[str]) -> Iterable[Finding]:
        msg = (f"[card test] kernel `{name}` has no test marked `cuda` in "
               f"{self.test_file} that calls it and `{name}_ref`")
        if test is None:
            yield self.finding(build, line, msg)
            return
        assert test.tree is not None
        aliases = _module_aliases(test)
        whole = any(isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "pytestmark"
            for t in n.targets) and _marked_cuda(n.value)
            for n in test.tree.body)
        for fn in test.tree.body:
            if not isinstance(fn, ast.FunctionDef) \
                    or not fn.name.startswith("test"):
                continue
            if not (whole or any(_marked_cuda(d)
                                 for d in fn.decorator_list)):
                continue
            calls = list(_calls(fn))
            kernel = _launch(fn, aliases, name) is not None or any(
                isinstance(c.func, ast.Attribute) and c.func.attr == wrapper
                and aliases.get(_dotted(c.func.value)) == "ops"
                for c in calls)
            if kernel and any(_name(c.func) == f"{name}_ref" for c in calls):
                return
        yield self.finding(build, line, msg)

    def _check_fallbacks(self, sf: SourceFile) -> Iterable[Finding]:
        assert sf.tree is not None
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Try):
                for h in node.handlers:
                    use = _plain_use(h.body)
                    if use:
                        yield self.finding(
                            sf, h.lineno,
                            f"[no fallback] an `except` handler reaches the "
                            f"plain version (`{use}`): a kernel that fails "
                            f"must raise")
            elif isinstance(node, (ast.If, ast.IfExp)) and any(
                    _dotted(c.func).endswith("cuda.is_available")
                    for c in _calls(node.test)):
                branches = ([node.body, node.orelse]
                            if isinstance(node, ast.IfExp)
                            else node.body + node.orelse)
                use = _plain_use(branches)
                if use:
                    yield self.finding(
                        sf, node.lineno,
                        f"[no availability switch] a "
                        f"`torch.cuda.is_available()` test selects the "
                        f"plain version (`{use}`): the tensors' device "
                        f"decides")
