"""Limits on the port's tests, as autouse fixtures that every
``tests/test_torch_*.py`` file imports (``from port_limits import *``).

* A time limit.  Each test's setup and call, and the module fixtures its
  file's first test sets up, run under ``TIMEOUT_S``: past it,
  faulthandler writes every thread's stack to the real stderr and ends
  the process.  Under xdist that fails the one test (its worker is
  replaced and the run goes on), even when it hangs inside C++ code.
  ``slow`` tests have none.
* No XLA.  The port's tests compare with JAX values recorded under
  ``tests/golden/port/``, never with live XLA: a test during whose
  setup, call or teardown (or its module's fixtures) JAX built an
  executable, compiled or loaded from the persistent cache, errors,
  naming what was built.  ``slow`` tests are exempt (the live check of
  the recordings must compile).  An executable that an earlier test of
  the same process built is in JAX's own caches and is not seen.
"""

import faulthandler
import os

import jax.monitoring
import pytest

__all__ = ["port_module_limits", "port_test_limits"]

TIMEOUT_S = 450.0
_BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
_built = []
_watching = [False]
_stderr_fd = []


def _on_duration(event, secs, **kwargs):
    if _watching[0] and event == _BACKEND_COMPILE:
        _built.append(kwargs.get("fun_name", "?"))


jax.monitoring.register_event_duration_secs_listener(_on_duration)


def _arm(request):
    faulthandler.cancel_dump_traceback_later()
    if request.node.get_closest_marker("slow"):
        return
    if not _stderr_fd:  # pytest's capture holds fd 2 while a test runs
        capman = request.config.pluginmanager.getplugin("capturemanager")
        with capman.global_and_fixture_disabled():
            _stderr_fd.append(os.dup(2))
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True,
                                      file=_stderr_fd[0])


def _check_no_xla(request):
    names = sorted(set(_built))
    _built.clear()
    if names and not request.node.get_closest_marker("slow"):
        pytest.fail(f"a port test compiled XLA ({', '.join(names)}); "
                    "compare with a fixture of tests/golden/port/ instead",
                    pytrace=False)


@pytest.fixture(autouse=True, scope="module")
def port_module_limits(request):
    _built.clear()
    _watching[0] = True
    _arm(request)
    yield
    _watching[0] = False


@pytest.fixture(autouse=True)
def port_test_limits(request):
    _check_no_xla(request)
    _arm(request)
    yield
    faulthandler.cancel_dump_traceback_later()
    _check_no_xla(request)
