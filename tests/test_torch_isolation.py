"""The port imports neither JAX nor the JAX package.

An AST walk over every module of ``spartan_tpu_torch``, over
``chip_smoke.py`` and over the port's scripts in ``tools/`` finds no
``import`` of ``jax``, ``jaxlib`` or ``spartan_tpu``; a fresh
interpreter that imports every module of the port has none of them in
``sys.modules``.
"""

import ast
import os
import subprocess
import sys

import jax  # noqa: F401
import pytest
import torch  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spartan_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "spartan_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    tools = os.path.join(ROOT, "tools")
    for d, _, files in [*os.walk(PKG), *os.walk(tools)]:
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path} imports {bad}"


def test_no_jax_in_sys_modules_after_importing_the_port():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spartan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'spartan_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("BAD []"), out.stdout
