"""The circuit generator: every witness satisfies its instance."""

from benchmark.circuit import Circuit, is_satisfied
from benchmark.reference.field import Q


def test_witnesses_satisfy_the_instance_at_2p8():
    c = Circuit(256, 256, 10, 2**31 + 5)
    for request in range(3):
        inputs = c.inputs(2**31 + 5, request)
        vars_ = c.witness(inputs)
        assert len(vars_) == 256 and all(0 < v < Q for v in vars_)
        assert is_satisfied(c, vars_, inputs)
        bad = list(vars_)
        bad[request * 7] = (bad[request * 7] + 1) % Q
        assert not is_satisfied(c, bad, inputs)


def test_the_seed_fixes_the_circuit_and_the_inputs():
    a, b = Circuit(64, 64, 10, 7), Circuit(64, 64, 10, 7)
    assert a.entries() == b.entries()
    assert a.inputs(7, 0) == b.inputs(7, 0) != a.inputs(7, 1)
    assert Circuit(64, 64, 10, 8).entries() != a.entries()
    # a circuit a request: another stream of the same seed
    assert Circuit(64, 64, 10, 7, 5, 0).entries() != a.entries()
    assert Circuit(64, 64, 10, 7, 5, 0).entries() == \
        Circuit(64, 64, 10, 7, 5, 0).entries()


def test_a_witness_prefix_is_the_witness_s_own():
    c = Circuit(128, 128, 10, 9)
    inputs = c.inputs(9, 0)
    whole = c.witness(inputs)
    for upto in (1, 8, 100, 128, 500):
        assert c.witness(inputs, upto=upto) == whole[:upto]


def test_operands_come_before_their_constraint():
    c = Circuit(128, 128, 10, 3)
    (rows, a, _), (_, b, _), (_, cc, vals) = c.matrices()
    for i, x, y in zip(rows.tolist(), a.tolist(), b.tolist()):
        for col in (x, y):
            assert col < i or 128 <= col <= 128 + 10
    assert cc.tolist() == rows.tolist() and all(0 < v < Q for v in vals)
