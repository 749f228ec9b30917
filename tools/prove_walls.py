#!/usr/bin/env python3
"""Time the port's 2^20 NIZK prove and verify on one NVIDIA card, several
times in one process, for the ``spartan_tpu_torch`` of a given checkout.

    python3 tools/prove_walls.py [TREE] [--log-n 20] [--reps 5]

TREE is the root of a checkout (default: the one holding this script);
its package is the one imported, so two commits are compared on the same
card by running the script once per checkout, alternating (A, B, B, A).
The instance is ``chip_smoke.py``'s: 2^LOG_N constraints and variables,
10 inputs, ``seed=1``, tape seed 7; the first prove is the process's
first, the later ones run warm.  Per-phase times synchronise the card
(``SPARTAN_TPU_PROFILE=1``), as in ``chip_smoke.py``.  Prints a JSON line
per prove and a last JSON line with the tree's medians.  Exits 2
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

os.environ.setdefault("SPARTAN_TPU_PROFILE", "1")
PHASES = ("polycommit", "prove_sc_phase_one", "prove_sc_phase_two",
          "polyeval")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prove_walls: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from spartan_tpu_torch import _build, native
    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.utils import timer

    # the builds first (kernels and the native host library), so that no
    # prove pays for them
    for name in ("row_msm", "fold_evals"):
        _build.compile_kernel(name)
    native.get_lib()
    dev = torch.device("cuda", 0)
    n = 1 << args.log_n
    t0 = time.perf_counter()
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        n, n, 10, seed=1, device=dev)
    gens = NIZKGens(n, n, 10)
    gens_pc = gens.gens_r1cs_sat.gens_pc.gens.gens_n
    gens_pc.msm_table(dev), gens_pc.msm_table_h(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    runs = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        nizk = NIZK.prove(inst, vars_a, inputs_a, gens,
                          Transcript(b"prove_walls"), _tape_seed=7)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        phases = {k: timer.records[k] for k in PHASES}
        blob = ser.nizk_to_bytes(nizk)
        t0 = time.perf_counter()
        ser.nizk_from_bytes(blob).verify(inst, inputs_a,
                                         Transcript(b"prove_walls"), gens)
        verify_s = time.perf_counter() - t0
        runs.append(dict(rep=rep, prove_s=prove_s, verify_s=verify_s,
                         phases_s=phases))
        print(json.dumps({"tree": tree, **runs[-1]}), flush=True)
    med = {k: statistics.median(r[k] for r in runs)
           for k in ("prove_s", "verify_s")}
    med.update({k: statistics.median(r["phases_s"][k] for r in runs)
                for k in PHASES})
    print(json.dumps({"tree": tree, "setup_s": setup_s, "reps": args.reps,
                      "medians": med}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
