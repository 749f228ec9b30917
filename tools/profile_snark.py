#!/usr/bin/env python3
"""SNARK profiler of the port (reference profiler/snark.rs:17-62; the
JAX package's ``profiler/snark.py``): sweeps instance sizes, prints the
hierarchical phase timings and the proof's size, field by field and
zlib-compressed.

    python3 tools/profile_snark.py [--min 10] [--max 20] [--inputs 10]
                                   [--reps 1] [--device cpu]

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions
on the CPU instead (small sizes only: 2^10 takes minutes there).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["SPARTAN_TPU_PROFILE"] = "1"


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--min", type=int, default=10)
    ap.add_argument("--max", type=int, default=20)
    ap.add_argument("--inputs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=1,
                    help="prove() repetitions; rep >= 1 runs warm")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; the card by default")
    args = ap.parse_args()

    from spartan_tpu_torch import native
    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import SNARK, Instance, SNARKGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.device import resolve
    from spartan_tpu_torch.utils.timer import Timer

    dev = resolve(args.device)
    print(f"backend: {dev}; native host crypto: {native.available()}")

    for s in range(args.min, args.max + 1):
        n = 1 << s
        print(f"\n{'=' * 60}\nprofiler:: SNARK 2^{s} "
              f"(cons={n}, vars={n}, inputs={args.inputs})\n{'=' * 60}")
        t = Timer("produce_synthetic_r1cs")
        inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
            n, n, args.inputs, seed=args.seed, device=dev)
        t.stop()

        t = Timer("SNARKGens")
        gens = SNARKGens(n, n, args.inputs, n)
        t.stop()

        t0 = time.perf_counter()
        comm, decomm = SNARK.encode(inst, gens)
        print(f"SNARK::encode wall {time.perf_counter() - t0:.3f}s")

        for rep in range(args.reps):
            t0 = time.perf_counter()
            proof = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                                Transcript(b"snark_example"))
            print(f"[rep {rep}] SNARK::prove wall "
                  f"{time.perf_counter() - t0:.3f}s")

        blob = ser.snark_to_bytes(proof)
        print(f"proof size: {len(blob)} bytes "
              f"({ser.compressed_size(blob)} compressed)")
        rep = ser.snark_size_report(proof)
        if sum(rep.values()) != len(blob):
            raise AssertionError(f"size report {rep} does not sum to "
                                 f"{len(blob)}")
        for k, v in rep.items():
            print(f"  len::{k}: {v} B")

        proof.verify(comm, inputs_a, Transcript(b"snark_example"), gens,
                     device=dev)
        print("proof verification successful")


if __name__ == "__main__":
    main()
