"""The product-proof writer of the port (``serialize.py::
_w_prod_circuit_proof``) against the JAX package's, byte for byte.

A product proof ends with three lists of dot-product claims (left,
right, weight); both writers write all three, empty when the proof
carries none (``claims_dotp`` empty or ``None``), and both readers read
three.  Each case is written by both writers and read back by the
port's reader.

The proof-size reports (``r1cs_sat_size_report``, ``nizk_size_report``,
``snark_size_report``) and ``compressed_size`` of both packages, read
from the golden proofs' bytes, are equal key by key, and each report
sums to the blob's length.
"""

import os

import jax  # noqa: F401  (imported first in every port test file)
import pytest

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu import serialize as jser
from spartan_tpu.protocols import product_tree as jpt
from spartan_tpu.protocols import sumcheck as jsc
from spartan_tpu_torch import serialize as ser
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.protocols import product_tree as pt
from spartan_tpu_torch.protocols import sumcheck as sc

_POLYS = [[3, Q - 1, 5], [7, 0, 11]]
_LEFT, _RIGHT = [13, 17], [19, Q - 2]
_DOTP = ([1, 2], [3, 4], [Q - 5, 6])


def _port(case):
    if case == "three_lists":
        layer = pt.LayerProofBatched(sc.SumcheckInstanceProof(_POLYS),
                                     _LEFT, _RIGHT)
        return pt.ProductCircuitEvalProofBatched([layer], _DOTP)
    return pt.ProductCircuitEvalProofBatched(
        [], () if case == "empty" else None)


def _ref(case):
    if case == "three_lists":
        layer = jpt.LayerProofBatched(jsc.SumcheckInstanceProof(_POLYS),
                                      _LEFT, _RIGHT)
        return jpt.ProductCircuitEvalProofBatched([layer], _DOTP)
    return jpt.ProductCircuitEvalProofBatched(
        [], () if case == "empty" else None)


def _write(mod, proof) -> bytes:
    w = mod.Writer()
    mod._w_prod_circuit_proof(w, proof)
    return w.getvalue()


@pytest.mark.parametrize("case", ["empty", "none", "three_lists"])
def test_prod_circuit_proof_writer_matches_reference(case):
    got = _write(ser, _port(case))
    assert got == _write(jser, _ref(case))
    # one layer: u64 count, the round polys (u64 + 2 lists of 3), the two
    # claim lists (u64 + 2 each), then three dot-product lists of 2
    assert len(got) == {"empty": 32, "none": 32,
                        "three_lists": 8 + 8 + 2 * (8 + 96)
                        + 2 * (8 + 64) + 3 * (8 + 64)}[case]
    r = ser.Reader(got)
    back = ser._r_prod_circuit_proof(r)
    r.done()
    want_dotp = _DOTP if case == "three_lists" else ([], [], [])
    assert tuple(list(x) for x in back.claims_dotp) == tuple(
        list(x) for x in want_dotp)
    assert _write(ser, back) == got


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("what", ["nizk", "snark"])
def test_size_reports_match_reference(what):
    blob = _golden(f"{what}_proof.bin")
    ours = getattr(ser, f"{what}_from_bytes")(blob)
    ref = getattr(jser, f"{what}_from_bytes")(blob)
    report = getattr(ser, f"{what}_size_report")(ours)
    assert report == getattr(jser, f"{what}_size_report")(ref)
    assert sum(report.values()) == len(blob)
    assert (ser.r1cs_sat_size_report(ours.r1cs_sat_proof)
            == jser.r1cs_sat_size_report(ref.r1cs_sat_proof))
    assert ser.compressed_size(blob) == jser.compressed_size(blob)
    assert 0 < ser.compressed_size(blob) < len(blob)
