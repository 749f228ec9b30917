#!/usr/bin/env python3
"""Prove knowledge of x satisfying x^3 + x + 5 = y (reference
examples/cubic.rs; the JAX package's ``examples/cubic.py``), end to end
through the port's public API.

    python3 tools/cubic.py [--device cpu]

Runs on the CUDA card; ``--device cpu`` runs on the CPU instead.

R1CS (4 constraints, 4 vars, 1 input):
  Z0 * Z0 - Z1 = 0
  Z1 * Z0 - Z2 = 0
  (Z2 + Z0) * 1 - Z3 = 0
  (Z3 + 5) * 1 - I0 = 0
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def produce_r1cs(device):
    from spartan_tpu_torch.api import Assignment, Instance
    from spartan_tpu_torch.core.field import Q

    num_cons, num_vars, num_inputs = 4, 4, 1
    one = 1
    A, B, C = [], [], []
    # Z0 * Z0 - Z1 = 0
    A.append((0, 0, one)); B.append((0, 0, one)); C.append((0, 1, one))
    # Z1 * Z0 - Z2 = 0
    A.append((1, 1, one)); B.append((1, 0, one)); C.append((1, 2, one))
    # (Z2 + Z0) * 1 - Z3 = 0
    A.append((2, 2, one)); A.append((2, 0, one))
    B.append((2, num_vars, one)); C.append((2, 3, one))
    # (Z3 + 5) * 1 - I0 = 0
    A.append((3, 3, one)); A.append((3, num_vars, 5))
    B.append((3, num_vars, one)); C.append((3, num_vars + 1, one))

    inst = Instance.new(num_cons, num_vars, num_inputs, A, B, C, device)

    z0 = random.randrange(Q)
    z1 = z0 * z0 % Q
    z2 = z1 * z0 % Q
    z3 = (z2 + z0) % Q
    i0 = (z3 + 5) % Q
    vars_a = Assignment([z0, z1, z2, z3])
    inputs_a = Assignment([i0])
    if not inst.is_sat(vars_a, inputs_a):
        raise AssertionError("instance must be satisfiable")
    return inst, vars_a, inputs_a


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; the card by default")
    args = ap.parse_args()

    from spartan_tpu_torch.api import NIZK, Assignment, NIZKGens
    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.device import resolve
    from spartan_tpu_torch.utils.errors import ProofVerifyError

    dev = resolve(args.device)
    print(f"cubic example: x^3 + x + 5 = y (device={dev})")
    inst, vars_a, inputs_a = produce_r1cs(dev)
    print("R1CS built and satisfiability checked (4 cons, 4 vars, 1 input)")
    gens = NIZKGens(4, 4, 1)
    print("generators derived; proving...")

    t0 = time.time()
    proof = NIZK.prove(inst, vars_a, inputs_a, gens,
                       Transcript(b"nizk_example"))
    print(f"NIZK::prove      {time.time() - t0:.3f}s")

    t0 = time.time()
    proof.verify(inst, inputs_a, Transcript(b"nizk_example"), gens)
    print(f"NIZK::verify     {time.time() - t0:.3f}s")
    print("proof verification successful!")

    # negative check: verification must reject a wrong public input
    bad = Assignment([(inputs_a.assignment[0] + 1) % Q])
    try:
        proof.verify(inst, bad, Transcript(b"nizk_example"), gens)
    except ProofVerifyError:
        print("tampered input correctly rejected")
    else:
        raise SystemExit("BUG: tampered input verified")


if __name__ == "__main__":
    main()
