"""The comparison that decides ``correct``: the plain reference judges a
sample of the proofs that the window produced, after the window.

The reference works out again what the program's set-up derived from
the benchmark's own circuit: the instance's padded layout and
evaluations, the generators, Spark's dense representation, and for the
NIZK the transcript after the instance digest.  It reads the program's
outputs only to judge them: the proof bytes; for the SNARK the
commitment bytes, which it checks against its own dense representation;
for the NIZK the instance digest, which it checks against its own
serialisation of the instance and then absorbs itself.

``judge`` takes groups of samples, one group a circuit: the cell's one
circuit, or a circuit a request where the traffic encodes one each."""

from __future__ import annotations

import hashlib
import os
import zlib

from .reference import group as G
from .reference.field import log2
from .reference.instance import RefInstance, commitment_holds
from .reference.transcript import Strobe, Transcript
from .reference.verify import (Reject, append_commitment, nizk_verify,
                               sat_gens, snark_verify, spark_gens)
from .reference.wire import WireError, read_commitment, read_nizk, read_snark

REJECTS = (Reject, WireError, ValueError, ZeroDivisionError)
NIZK_PROTOCOL = b"Spartan NIZK proof"
SNARK_PROTOCOL = b"Spartan SNARK proof"


def _verdicts(verify_one, samples) -> int:
    rejected = 0
    for blob, inputs in samples:
        try:
            verify_one(blob, inputs)
        except REJECTS:
            rejected += 1
    return rejected


def post_digest(label: bytes, digest: bytes, cache_dir: str | None
                ) -> Strobe:
    """The reference's transcript after ``label``, the NIZK's protocol
    name and ``digest``.  Absorbing tens of MB takes the reference a
    minute or more, so the state (203 bytes) is kept in ``cache_dir``
    under the SHA-256 of the label and the digest: the first run of a
    circuit in a checkout absorbs it, the others read it."""
    key = hashlib.sha256(label + b"\0" + digest).hexdigest()
    path = cache_dir and os.path.join(cache_dir, f"nizk-post-digest-{key}")
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            b = f.read()
        if len(b) == 203:
            return Strobe.from_state(b[:200], b[200], b[201], b[202])
    t = Transcript(label)
    t.append_protocol_name(NIZK_PROTOCOL)
    t.append_message(b"R1CSShapeDigest", digest)
    s = t.s
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(bytes(s.st) + bytes([s.pos, s.pos_begin, s.flags]))
        os.replace(tmp, path)
    return s


def _ref(circuit) -> RefInstance:
    return RefInstance(circuit.num_cons, circuit.num_vars,
                       circuit.num_inputs, *circuit.matrices())


def _blind_points(circuit, ref: RefInstance, sats: list, inputs: list,
                  gens) -> list:
    """For each proof's witness commitment, its first row less the
    unblinded MSM of the witness's first row: blind times h.  The
    identity where the row was not blinded."""
    ell = log2(ref.num_vars)
    R = 1 << (ell - ell // 2)
    out = []
    for sat, ins in zip(sats, inputs):
        row = circuit.witness(ins, upto=R)
        row += [0] * (R - len(row))
        C0 = G.decode(sat.comm_vars[0]) if sat.comm_vars else None
        if C0 is not None:
            out.append(G.add(C0, G.neg(G.msm(row, gens.pc_n.G[:R]))))
    return out


def _parsed(read, samples) -> tuple[list, list]:
    sats, inputs = [], []
    for blob, ins in samples:
        try:
            sats.append(read(blob).sat)
            inputs.append(ins)
        except WireError:
            pass
    return sats, inputs


def nizk(circuit, digest: bytes, samples: list, label: bytes,
         cache_dir: str | None) -> dict:
    ref = _ref(circuit)
    try:
        digest_ok = zlib.decompress(digest) == ref.bincode()
    except zlib.error:
        digest_ok = False
    if not digest_ok:
        return dict(setup_mismatch=1, reference_rejects=len(samples),
                    blinds=[])
    gens = sat_gens(ref.num_vars)
    start = post_digest(label, digest, cache_dir)

    def one(blob, inputs):
        t = Transcript(None, start.copy())
        nizk_verify(read_nizk(blob), ref, inputs, t, gens)

    sats, ins = _parsed(read_nizk, samples)
    return dict(setup_mismatch=0,
                reference_rejects=_verdicts(one, samples),
                blinds=_blind_points(circuit, ref, sats, ins, gens))


def snark(circuit, comm_bytes: bytes, samples: list, label: bytes,
          seed: int) -> dict:
    ref = _ref(circuit)
    dense = ref.dense()
    try:
        comm = read_commitment(comm_bytes)
        rows = {k: [G.decode(b) for b in getattr(comm, "comb_" + k)]
                for k in ("ops", "mem")}
        shape_ok = (
            (comm.num_cons, comm.num_vars, comm.num_inputs, comm.batch_size,
             comm.num_ops, comm.num_mem_cells)
            == (ref.num_cons, ref.num_vars, ref.num_inputs, dense["batch"],
                dense["num_ops"], dense["cells"])
            and all(p is not None for v in rows.values() for p in v))
    except WireError:
        shape_ok = False
    if not shape_ok:
        return dict(setup_mismatch=1, reference_rejects=len(samples),
                    blinds=[])
    nnz = max(len(v) for _, _, v in ref.mats)
    sg = spark_gens(ref.num_cons, ref.num_vars, nnz, dense["batch"])
    comm_ok = (commitment_holds(dense["ops"], rows["ops"], sg.ops[0].G,
                                seed)
               and commitment_holds(dense["mem"], rows["mem"], sg.mem[0].G,
                                    seed + 1))
    gens = sat_gens(ref.num_vars)
    t0 = Transcript(label)
    t0.append_protocol_name(SNARK_PROTOCOL)
    append_commitment(t0, comm)

    def one(blob, inputs):
        snark_verify(read_snark(blob), comm, rows, inputs, t0.copy(), gens,
                     sg)

    sats, ins = _parsed(read_snark, samples)
    return dict(setup_mismatch=0 if comm_ok else 1,
                reference_rejects=_verdicts(one, samples),
                blinds=_blind_points(circuit, ref, sats, ins, gens))


def judge(protocol: str, groups: list, label: bytes, seed: int,
          cache_dir: str | None) -> dict:
    """``groups``: (circuit, the set-up's bytes (the NIZK's digest or the
    SNARK's commitment), samples as (proof bytes, claimed inputs)).
    Returns the counts that decide ``correct``: set-ups and proofs the
    reference rejects, and for zero knowledge the sampled proofs whose
    witness commitment is not blinded and the pairs of them with the
    same blind."""
    out = dict(setup_mismatch=0, reference_rejects=0)
    blinds = []
    for k, (circuit, setup, samples) in enumerate(groups):
        if protocol == "nizk":
            r = nizk(circuit, setup, samples, label, cache_dir)
        else:
            r = snark(circuit, setup, samples, label, seed + 2 * k)
        out["setup_mismatch"] += r["setup_mismatch"]
        out["reference_rejects"] += r["reference_rejects"]
        blinds += r["blinds"]
    out["zk_unblinded"] = sum(G.equal(b, G.IDENTITY) for b in blinds)
    out["zk_blind_repeats"] = sum(
        G.equal(blinds[i], blinds[j])
        for i in range(len(blinds)) for j in range(i + 1, len(blinds)))
    return out
