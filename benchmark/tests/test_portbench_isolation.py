"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: top-level names compared whole."""

import ast
import os
import sys
import types

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "spartan_tpu"}


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _modules(sub: str = ""):
    for d, _, files in os.walk(os.path.join(spec.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: _imports(p) & FORBIDDEN for p in _modules()}
    assert not any(found.values()), found
    # the whole name is compared: the port's name begins with the JAX
    # package's and is allowed
    assert "spartan_tpu_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "hashlib", "operator", "random", "struct",
               "types", "numpy"}
    for p in _modules("reference"):
        assert _imports(p) <= allowed, (p, _imports(p) - allowed)


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "spartan_tpu.api"])
def test_no_result_once_jax_or_the_jax_package_is_loaded(monkeypatch,
                                                          capsys, name):
    from benchmark import run

    out = dict(correct=True, checks=dict(failed_requests=dict(value=0,
                                                              limit=0)))
    assert run.emit(out) == 0 and capsys.readouterr().out.strip()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "spartan_tpu_torch_like",
                        types.ModuleType("spartan_tpu_torch_like"))
    assert run.emit(out) != 0
    cap = capsys.readouterr()
    assert cap.out == "" and name in cap.err
