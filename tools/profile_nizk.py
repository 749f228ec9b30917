#!/usr/bin/env python3
"""NIZK profiler of the port (reference profiler/nizk.rs:17-52; the JAX
package's ``profiler/nizk.py``): sweeps instance sizes, prints the
hierarchical phase timings and the proof's size, field by field and
zlib-compressed.

    python3 tools/profile_nizk.py [--min 10] [--max 20] [--inputs 10]
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

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.device import resolve
    from spartan_tpu_torch.utils.timer import Timer

    dev = resolve(args.device)
    print(f"backend: {dev}")

    for s in range(args.min, args.max + 1):
        n = 1 << s
        print(f"\n{'=' * 60}\nprofiler:: NIZK 2^{s} "
              f"(cons={n}, vars={n}, inputs={args.inputs})\n{'=' * 60}")
        t = Timer("produce_synthetic_r1cs")
        inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
            n, n, args.inputs, seed=args.seed, device=dev)
        t.stop()

        t = Timer("NIZKGens")
        gens = NIZKGens(n, n, args.inputs)
        t.stop()

        for rep in range(args.reps):
            t0 = time.perf_counter()
            proof = NIZK.prove(inst, vars_a, inputs_a, gens,
                               Transcript(b"nizk_example"))
            print(f"[rep {rep}] NIZK::prove wall "
                  f"{time.perf_counter() - t0:.3f}s")

        blob = ser.nizk_to_bytes(proof)
        print(f"proof size: {len(blob)} bytes "
              f"({ser.compressed_size(blob)} compressed)")
        rep = ser.nizk_size_report(proof)
        if sum(rep.values()) != len(blob):
            raise AssertionError(f"size report {rep} does not sum to "
                                 f"{len(blob)}")
        for k, v in rep.items():
            print(f"  len::{k}: {v} B")

        proof.verify(inst, inputs_a, Transcript(b"nizk_example"), gens)
        print("proof verification successful")


if __name__ == "__main__":
    main()
