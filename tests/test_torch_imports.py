"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) use PyTorch and numpy, never JAX
and never the JAX package ``repro`` (not even its jax-free modules: the
port keeps its own copies)."""
import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_port_module_imports_without_jax_or_repro():
    """In a fresh interpreter (this worker has JAX loaded already): import
    every module of the package and find neither ``jax`` nor ``repro`` in
    ``sys.modules``."""
    mods = _port_modules()
    assert len(mods) > 30
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "jaxlib" or m.startswith("jaxlib.")
                     or m == "repro" or m.startswith("repro."))
        print(",".join(bad))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout.strip()}"


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    examples = os.path.join(REPO, "examples")
    for f in sorted(os.listdir(examples)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(examples, f)


def _forbidden_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                yield f"{os.path.relpath(path, REPO)}:{node.lineno}: {n}"


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_repro(path):
    assert list(_forbidden_imports(path)) == []


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import torch\nfrom repro.core import request\n"
                 "def f():\n    import jax.numpy as jnp\n")
    assert [s.split(": ")[1] for s in _forbidden_imports(str(p))] == \
        ["repro.core", "jax.numpy"]
