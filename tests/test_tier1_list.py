"""The root conftest's `TIER1_SLOW` names tests that exist, and none of the port's."""

import ast
import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _tier1_slow():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TIER1_SLOW


def test_every_tier1_slow_entry_names_a_jax_package_test():
    entries = _tier1_slow()
    assert entries
    for node_id in entries:
        path, test = node_id.split("::")
        assert path.startswith("tests/test_") and path.count("/") == 1, node_id
        assert not path.startswith("tests/test_torch_"), node_id
        file = ROOT / path
        assert file.is_file(), node_id
        name = test.split("[", 1)[0]
        assert any(isinstance(n, ast.FunctionDef) and n.name == name
                   for n in ast.parse(file.read_text()).body), node_id
