"""The roofline arithmetic at tiny sizes: B2's launches that
``benchmark/bounds.py`` counts from the sizes are the launches a CPU
prove makes, and B1's digits are the port's."""

import collections
import random

import pytest
import torch

from benchmark import bounds
from benchmark.tests.helpers import SEED, tiny


def _count_launches(monkeypatch, protocol: str) -> collections.Counter:
    from spartan_tpu_torch.ff import round_kernel as rk

    from benchmark.circuit import Circuit
    from benchmark.loop import PROTOCOLS, _port, _tape_seed

    seen = collections.Counter()
    plain = rk.fold_evals_plain

    def counted(tables, r, mode):
        batch = tables[0].shape[0] if len(tables) == 3 else 1
        seen[len(tables), batch, tables[0].shape[-2], mode] += 1
        return plain(tables, r, mode)

    port = _port()
    c = Circuit(64, 64, 10, SEED)
    inst = port.api.Instance.new(64, 64, 10, *c.entries(), device="cpu")
    proto = PROTOCOLS[protocol](port, tiny(protocol), "cpu")
    dep = proto.encode(inst)
    inputs = c.inputs(SEED, 3)
    monkeypatch.setattr(rk, "fold_evals_plain", counted)
    proto.prove(dep, c.witness(inputs), inputs, _tape_seed(SEED, 3))
    return seen


@pytest.mark.parametrize("protocol", ["nizk", "snark"])
def test_b2_launches_from_the_sizes(monkeypatch, protocol):
    want = bounds.sat_proof_launches(64, 64)
    if protocol == "snark":
        want += bounds.spark_launches(64, 64, 64)
    assert _count_launches(monkeypatch, protocol) == collections.Counter(want)


def test_b2_launch_counts_at_the_cell_size():
    n = 1 << 20
    assert len(bounds.sat_proof_launches(n, n)) == 43
    assert len(bounds.spark_launches(n, n, n)) == 439
    # chip_smoke.py's sums at 2^20: 0.332 ms and 3.530 ms a prove
    assert bounds.launches_s(bounds.sat_proof_launches(n, n)) == \
        pytest.approx(0.332e-3, rel=2e-3)
    assert bounds.launches_s(bounds.spark_launches(n, n, n)) == \
        pytest.approx(3.530e-3, rel=2e-3)


def test_b1_digits_are_the_ports():
    from spartan_tpu_torch.curve import row_msm as rm
    from spartan_tpu_torch.ff import limb

    rng = random.Random(4)
    xs = [rng.getrandbits(253) >> rng.randrange(0, 250, 16)
          for _ in range(4 * 8)]
    le = b"".join(x.to_bytes(32, "little") for x in xs)
    ours = bounds.nonzero_digits(le, 4, 8)
    theirs = rm._digits(limb.ints_to_limbs(xs, "cpu").reshape(4, 8, 8)) != 0
    assert (torch.from_numpy(ours) == theirs).all()
    # every digit non-zero gives the full count of chip_smoke.py
    full = bounds.row_msm_s(ours | True)
    assert full > bounds.row_msm_s(ours) > 0
