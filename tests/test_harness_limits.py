"""The limits on the port's tests (``tests/port_limits.py``), each on a
throwaway test file run in a subprocess under ``-p xdist -n 1`` with this
repo's ``pyproject.toml`` and a copy of ``port_limits.py`` whose time
limit is 1 s.

* A test past its time limit fails alone, its stack in the output; its
  worker is replaced and the next test still passes.
* A port test that jits a function fails: the port's tests compile no
  XLA.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from port_limits import TIMEOUT_S

pytest.importorskip("xdist")  # the time limit is for runs under xdist

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


def _run(tmp_path, name, source):
    limits = open(os.path.join(TESTS, "port_limits.py")).read()
    assert f"TIMEOUT_S = {TIMEOUT_S}\n" in limits
    (tmp_path / "port_limits.py").write_text(
        limits.replace(f"TIMEOUT_S = {TIMEOUT_S}\n", "TIMEOUT_S = 1.0\n"))
    (tmp_path / name).write_text(textwrap.dedent(source))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "JAX_COMPILATION_CACHE"))}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"  # xdist alone, by -p
    return subprocess.run(
        [sys.executable, "-m", "pytest", str(tmp_path / name), "-q",
         "-c", os.path.join(ROOT, "pyproject.toml"),
         "--rootdir", str(tmp_path), "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)


def test_a_test_past_its_limit_fails_alone(tmp_path):
    out = _run(tmp_path, "test_torch_sleeps.py", """
        import time

        from port_limits import *


        def test_sleeps_past_its_limit():
            time.sleep(30)


        def test_after_it():
            pass
        """)
    log = out.stdout + out.stderr
    assert out.returncode == 1, log
    assert "1 failed, 1 passed" in log, log
    assert "FAILED" in log and "test_sleeps_past_its_limit" in log, log
    assert "Timeout (0:00:01)!" in log, log
    assert "in test_sleeps_past_its_limit" in log, log  # its stack


def test_a_port_test_that_compiles_xla_fails(tmp_path):
    out = _run(tmp_path, "test_torch_compiles.py", """
        import jax
        import jax.numpy as jnp

        from port_limits import *


        def test_jits_a_function():
            assert int(jax.jit(lambda x: x + 1)(jnp.int32(1))) == 2
        """)
    log = out.stdout + out.stderr
    assert out.returncode == 1, log
    assert "1 error" in log, log
    assert "ERROR test_torch_compiles.py::test_jits_a_function" in log, log
    assert "a port test compiled XLA (jit(<lambda>)" in log, log
