#!/usr/bin/env python3
"""Dry run of the port's multi-device prover (the counterpart of the JAX
package's ``__graft_entry__.py::dryrun_multichip``): a sharded sum-check
round, a sharded product-layer round, a blocked row-MSM and an
end-to-end sharded NIZK at n = 16, each against an oracle.

    python3 tools/dryrun_multichip.py [--devices 8] [--device cpu]

The mesh lists one device ``--devices`` times: ``cuda:0`` by default
(kernels B1 and B2, one launch a shard; raises without a card), the CPU
with ``--device cpu`` (the kernels' plain versions).  Each leg prints a
line; any mismatch raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _progress(msg: str) -> None:
    print(f"[dryrun_multichip] {msg}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda:0 by default; 'cpu' for the plain versions")
    args = ap.parse_args()

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
    from spartan_tpu_torch.commitments import MultiCommitGens
    from spartan_tpu_torch.core import ristretto as hri
    from spartan_tpu_torch.core.edwards import Point
    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.device import resolve
    from spartan_tpu_torch.ff import fq, limb
    from spartan_tpu_torch.parallel import context as pctx
    from spartan_tpu_torch.parallel import mesh as pmesh

    dev = resolve(args.device)
    d = args.devices
    mesh = pmesh.Mesh([dev] * d)
    rng = np.random.default_rng(1)
    _progress(f"mesh of {d} x {dev}")

    # --- a sharded sum-check round: the phase-one comb eq*(Az*Bz - Cz)
    n = max(1 << 8, 4 * d)
    tab_ints = [[int(x) for x in rng.integers(0, 1 << 62, size=n)]
                for _ in range(4)]
    tabs = pmesh.ShardedSumcheckTables(
        mesh, [fq.encode_ints(xs, dev) for xs in tab_ints], "cubic")
    es = pmesh.evals_to_ints(tabs.evals())
    r = 987654321
    tabs.fold(r)
    whole = ([pmesh.unshard_table(ts, dev) for ts in zip(*tabs.shards)]
             if tabs.sharded else tabs.tables)
    folded = [fq.decode_to_ints(T) for T in whole]
    half = n // 2

    def rounds_oracle(tables, comb):
        lo = list(zip(*(T[:half] for T in tables)))
        hi = list(zip(*(T[half:] for T in tables)))
        p2 = [tuple((2 * h - l) % Q for l, h in zip(ls, hs))
              for ls, hs in zip(lo, hi)]
        p3 = [tuple((x2 + h - l) % Q for x2, l, h in zip(x2s, ls, hs))
              for x2s, ls, hs in zip(p2, lo, hi)]
        return [sum(comb(*row) for row in rows) % Q
                for rows in (lo, p2, p3)]

    want = rounds_oracle(tab_ints, lambda a, b, c, e: a * (b * c - e) % Q)
    if es != want:
        raise AssertionError("sharded sum-check evals mismatch")
    want_fold = [[(lo + r * (hi - lo)) % Q
                  for lo, hi in zip(T[:half], T[half:])] for T in tab_ints]
    if folded != want_fold:
        raise AssertionError("sharded fold mismatch")
    _progress(f"sum-check round OK (n = {n}, shards of {n // d})")

    # --- a sharded product-layer round (Spark's grand products) ---------
    bsz, pn = 3, max(64, 2 * d)
    pt_ints = [[[int(x) for x in rng.integers(0, 1 << 62, size=pn)]
                for _ in range(bsz)] for _ in range(3)]
    layer = pmesh.ShardedProductLayerTables(
        mesh, *(fq.encode_ints([x for row in T for x in row], dev)
                .reshape(bsz, pn, 8) for T in pt_ints))
    got = pmesh.evals_to_ints(layer.evals())  # e0s, e2s, e3s of each b
    half = pn // 2
    per_b = [rounds_oracle([pt_ints[t][b] for t in range(3)],
                           lambda a, b_, c: a * b_ % Q * c % Q)
             for b in range(bsz)]
    if got != [per_b[b][i] for i in range(3) for b in range(bsz)]:
        raise AssertionError("sharded product-layer evals mismatch")
    _progress(f"product-layer round OK (B = {bsz}, n = {pn})")

    # --- a blocked row-MSM (the commitments' rows, one block a device) --
    L, R = d, 4
    gens = MultiCommitGens(R, b"dryrun_multichip")
    ks = [int(x) for x in rng.integers(1, 1 << 61, size=L * R)]
    rows = pmesh.msm_rows_blocked(
        limb.ints_to_limbs(ks, dev).reshape(L, R, 8), gens, mesh)
    for i, pt in enumerate(ed.to_host(rows)):
        want_pt = Point.identity()
        for j in range(R):
            want_pt = want_pt.add(gens.G[j].mul(ks[i * R + j]))
        if hri.encode(pt) != hri.encode(want_pt):
            raise AssertionError(f"blocked row-MSM row {i} mismatch")
    _progress(f"row-MSM OK ({L} x {R}, {d} blocks)")

    # --- an end-to-end sharded NIZK -------------------------------------
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=9, device=dev)
    ngens = NIZKGens(16, 16, 2)
    mesh.sharded_rounds.clear()
    with pctx.use_mesh(mesh):
        blob = ser.nizk_to_bytes(NIZK.prove(
            inst, vars_a, inputs_a, ngens, Transcript(b"dryrun_e2e"),
            _tape_seed=5))
    plain = ser.nizk_to_bytes(NIZK.prove(
        inst, vars_a, inputs_a, ngens, Transcript(b"dryrun_e2e"),
        _tape_seed=5))
    if blob != plain:
        raise AssertionError("sharded NIZK bytes differ from one device's")
    ser.nizk_from_bytes(blob).verify(inst, inputs_a,
                                     Transcript(b"dryrun_e2e"), ngens)
    _progress(f"sharded NIZK prove and verify OK ({len(blob)} bytes, "
              f"sharded rounds {dict(mesh.sharded_rounds)})")
    print(f"dryrun_multichip OK on {d} x {dev} (sharded sum-check round "
          f"n={n}, product-layer round B={bsz} n={pn}, row-MSM {L}x{R}, "
          f"end-to-end sharded NIZK at n=16 verified)")


if __name__ == "__main__":
    main()
