"""The witness's one crossing to the device (``r1cs/proof.py``) on the CPU.

* ``witness_z``, z built on the device from the witness's canonical
  scalars, equals the host encode of the whole z list bit for bit.
* ``poly.commit.commit_canonical`` on canonical scalars gives the bytes
  and blinds ``commit`` gives on their Montgomery table.
* A NIZK prove maps on the host (``utils.rt.encoded``) only the constant
  1, the inputs and short tables, not the witness or z.
"""

import random

import jax  # noqa: F401  (imported first in every port test file)
import pytest
import torch

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.merlin import RandomTape, Transcript
from spartan_tpu_torch.ff import limb
from spartan_tpu_torch.poly import commit as pc
from spartan_tpu_torch.poly import dense
from spartan_tpu_torch.r1cs.proof import witness_z
from spartan_tpu_torch.utils import rt


def _scalars(n, seed):
    rng = random.Random(seed)
    return [0, 1, Q - 1, 1 << 252][:n] + [rng.randrange(Q)
                                          for _ in range(n - 4)]


@pytest.mark.parametrize("log_n", [6, 10])
def test_witness_z_equals_host_encode(log_n):
    n = 1 << log_n
    vars_ints = _scalars(n, log_n)
    inputs = _scalars(10, 100 + log_n)
    z = witness_z(limb.ints_to_limbs(vars_ints, "cpu"), inputs)
    z_ints = vars_ints + [1] + inputs + [0] * (n - len(inputs) - 1)
    assert z.shape == (2 * n, limb.NWORDS)
    assert torch.equal(z, dense.from_ints(z_ints, "cpu"))


def test_commit_canonical_equals_commit():
    ell = 6
    vals = _scalars(1 << ell, 7)
    gens = pc.PolyCommitmentGens(ell, b"witness_test")
    want = pc.commit(dense.from_ints(vals, "cpu"), gens,
                     RandomTape(b"t", seed=5))
    got = pc.commit_canonical(limb.ints_to_limbs(vals, "cpu"), gens,
                              RandomTape(b"t", seed=5))
    assert got[0].C == want[0].C
    assert got[1] == want[1]


def test_prove_maps_only_short_vectors_on_the_host():
    """At 2^10 the prove maps the constant 1 and the 10 inputs, the
    evaluation proof's two 32-entry chi tables, the three eq tables'
    points (tau, rx, ry[1:]) and their first entry, a challenge a
    sum-check round (fold_evals takes r in Montgomery form) and r_A, r_B,
    r_C: 132 elements.  Before, it also mapped the witness and z
    (3 * 2^10 elements)."""
    log_n, num_inputs = 10, 10
    n = 1 << log_n
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        n, n, num_inputs, seed=3, device="cpu")
    gens = NIZKGens(n, n, num_inputs)
    before = rt.encoded
    NIZK.prove(inst, vars_a, inputs_a, gens, Transcript(b"witness_test"),
               _tape_seed=1)
    chis = 2 * (1 << (log_n // 2))
    eq_points = 3 * (log_n + 1)
    round_challenges = log_n + (log_n + 1)
    assert rt.encoded - before <= (num_inputs + 1 + chis + eq_points
                                   + round_challenges + 3)
