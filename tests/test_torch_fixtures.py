"""The JAX values recorded in ``tests/golden/port/`` for the port's tests,
held to the JAX package.

* Live (``slow``: it compiles the XLA functions the port's tests stay
  clear of): every fixture recomputed by its recorder in ``record.py``
  equals its file, array by array, dtype, shape and bytes.  A mismatch
  fails; nothing is rewritten (``python tests/golden/port/record.py
  NAME`` does that, by hand).
* Every ``.npz`` there has a recorder, and every recorder a file.
"""

import jax  # noqa: F401  (imported first in every port test file)
import numpy as np
import pytest

from golden.port import record
from port_limits import *  # noqa: F403  (time limit, no XLA)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(record.RECORDERS))
def test_port_fixture_matches_jax(name):
    want = record.load(name)
    got = record.RECORDERS[name]()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = np.asarray(got[key])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key


def test_every_fixture_has_a_recorder():
    files = sorted(p.stem for p in record.HERE.glob("*.npz"))
    assert files == sorted(record.RECORDERS)
