"""The plain reference against the port, at tiny sizes on the CPU: the
same group, generators and transcript bytes; honest proofs accepted,
every altered byte, other inputs and a broken commitment rejected; the
transcript after the NIZK's digest absorbed as the port absorbs it, and
kept by digest; a witness commitment without blinds, or with a blind
that another proof has too, caught."""

import hashlib
import random
import struct

import pytest

from benchmark import check
from benchmark.circuit import Circuit
from benchmark.loop import LABEL
from benchmark.reference import group as G
from benchmark.reference.field import P, Q
from benchmark.reference.transcript import Transcript, keccak_f
from benchmark.tests.helpers import SEED, prove, ref_check


def _state(transcript) -> tuple:
    """(200-byte sponge, pos, pos_begin, flags) of a port transcript:
    the native STROBE's 203-byte buffer, or the Python sponge's
    fields."""
    s = transcript.strobe
    if hasattr(s, "buf"):
        b = bytes(s.buf)
        return b[:200], b[200], b[201], b[202]
    return bytes(s.state), s.pos, s.pos_begin, s.cur_flags


def _ref_state(s) -> tuple:
    return bytes(s.st), s.pos, s.pos_begin, s.flags


def test_keccak_against_hashlib_sha3():
    """SHA3-256 built on the reference's permutation (rate 136)."""
    for msg in (b"", b"abc", bytes(range(256)) * 3):
        data = bytearray(msg + b"\x06")
        data += bytes(-len(data) % 136)
        data[-1] |= 0x80
        lanes = (0,) * 25
        for k in range(0, len(data), 136):
            block = struct.unpack("<17Q", data[k:k + 136])
            lanes = keccak_f(tuple(a ^ b for a, b in
                                   zip(lanes, block + (0,) * 8)))
        out = struct.pack("<25Q", *lanes)[:32]
        assert out == hashlib.sha3_256(msg).digest()


def test_group_and_generators_match_the_port():
    from spartan_tpu_torch.commitments import _derive_gens
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.core import ristretto as hri

    assert G.SQRT_M1 ** 2 % P == P - 1
    ours = G.derive_generators(b"gens_r1cs_sat", 9)
    theirs = _derive_gens(b"gens_r1cs_sat", 9)
    assert [G.encode(p) for p in ours] == [hri.encode(p) for p in theirs]
    rng = random.Random(5)
    for n in (1, 3, 30):
        ks = [rng.randrange(Q) for _ in range(n)]
        want = hri.encode(hed.msm(ks, [theirs[i % 9] for i in range(n)]))
        assert G.encode(G.msm(ks, [ours[i % 9] for i in range(n)])) == want
    for p in ours:
        assert G.equal(G.decode(G.encode(p)), p)
    assert G.decode(b"\xff" * 32) is None


def test_transcript_matches_the_port():
    from spartan_tpu_torch.core.merlin import Transcript as PortT

    rng = random.Random(9)
    a, b = Transcript(b"t"), PortT(b"t")
    for k in range(40):
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(400)))
        a.append_message(b"m", msg)
        b.append_message(b"m", msg)
        if k % 3 == 0:
            assert a.challenge_scalar(b"c") == b.challenge_scalar(b"c")
    assert _ref_state(a.s) == _state(b)


@pytest.mark.parametrize("protocol", ["nizk", "snark"])
def test_accepts_honest_proofs_and_rejects_altered_ones(protocol):
    p = prove(protocol)
    blob, inputs = p.blob, p.inputs
    assert ref_check(p, [(blob, inputs), p.second]) == dict(
        setup_mismatch=0, reference_rejects=0, zk_unblinded=0,
        zk_blind_repeats=0)
    rng = random.Random(11)
    flips = []
    for k in range(8):
        pos = rng.randrange(len(blob))
        flips.append((blob[:pos] + bytes([blob[pos] ^ (1 << k % 8)])
                      + blob[pos + 1:], inputs))
    flips.append((blob[:-1], inputs))
    flips.append((blob, p.other))
    assert ref_check(p, flips)["reference_rejects"] == len(flips)


def test_a_wrong_commitment_or_digest_is_caught():
    p = prove("snark")
    comm = bytearray(p.dep.setup)
    comm[-5] ^= 1  # a row of the memory's commitment
    out = check.judge("snark", [(p.circuit, bytes(comm),
                                 [(p.blob, p.inputs)])], LABEL, SEED, None)
    assert out["setup_mismatch"] == 1
    p = prove("nizk")
    other = Circuit(64, 64, 10, 12345)
    out = check.judge("nizk", [(other, p.dep.setup, [(p.blob, p.inputs)])],
                      LABEL, SEED, None)
    assert out["setup_mismatch"] == 1 and out["reference_rejects"] == 1


def test_the_digest_absorbed_as_the_port_absorbs_it(tmp_path):
    """The reference's own transcript after the NIZK's digest equals the
    port's; the first call keeps it under the digest's hash, a later
    call reads it back, another digest is absorbed anew."""
    p = prove("nizk")
    t = p.proto.p.Transcript(LABEL)
    t.append_protocol_name(p.proto.p.api.NIZK.PROTOCOL)
    t.append_message(b"R1CSShapeDigest", p.dep.setup)
    want = _state(t)
    assert _ref_state(check.post_digest(LABEL, p.dep.setup, None)) == want
    assert _ref_state(check.post_digest(LABEL, p.dep.setup,
                                        str(tmp_path))) == want
    (kept,) = list(tmp_path.iterdir())
    assert kept.stat().st_size == 203
    assert _ref_state(check.post_digest(LABEL, p.dep.setup,
                                        str(tmp_path))) == want
    other = check.post_digest(LABEL, p.dep.setup + b"x", str(tmp_path))
    assert _ref_state(other) != want and len(list(tmp_path.iterdir())) == 2


@pytest.mark.parametrize("protocol", ["nizk", "snark"])
def test_unblinded_or_repeated_blinds_are_caught(monkeypatch, protocol):
    """Proofs made with every blind of the witness commitment zero, and
    with one tape for every proof: both verify, and only the check of
    zero knowledge catches them."""
    from spartan_tpu_torch.core import merlin

    from benchmark.loop import _tape_seed

    p = prove(protocol)
    draw = merlin.RandomTape.random_vector

    def zero_blinds(self, label, n):
        out = draw(self, label, n)
        return [0] * n if label == b"poly_blinds" else out

    def proofs():
        out = []
        for k in range(2):
            inputs = p.circuit.inputs(SEED, 5 + k)
            out.append((p.proto.prove(p.dep, p.circuit.witness(inputs),
                                      inputs, _tape_seed(SEED, 5 + k)),
                        inputs))
        return out

    monkeypatch.setattr(merlin.RandomTape, "random_vector", zero_blinds)
    out = ref_check(p, proofs())
    assert out["reference_rejects"] == 0 and out["zk_unblinded"] == 2
    monkeypatch.setattr(merlin.RandomTape, "random_vector", draw)
    init = merlin.RandomTape.__init__
    monkeypatch.setattr(merlin.RandomTape, "__init__",
                        lambda self, name, seed=None: init(self, name, 1))
    out = ref_check(p, proofs())
    assert out["reference_rejects"] == 0 and out["zk_unblinded"] == 0
    assert out["zk_blind_repeats"] == 1
