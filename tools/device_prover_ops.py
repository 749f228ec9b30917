#!/usr/bin/env python3
"""Count the torch operations that the device prover enqueues per round
(``spartan_tpu_torch/protocols/device_prover.py``), besides its kernels.

    python3 tools/device_prover_ops.py

Runs on the CPU at small sizes: one Montgomery product and sum of two
scalars (``ff/fq.py``), a ZK sum-check phase (quad and cubic)
and a batched product proof, each at two sizes, and counts every ATen
operation dispatched (``TorchDispatchMode``), with the four kernel
wrappers' plain versions counted as one launch each and their own
operations left out, as on the card, where each is one kernel.  The
difference between the two sizes is the cost of the extra rounds, so a
round's count excludes the phase's set-up and its one fetch.  Prints
one JSON line.  On the card each counted operation is about one kernel
launch; the count does not depend on the device.
"""

from __future__ import annotations

import collections
import json
import os
import random
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spartan_tpu_torch.commitments import MultiCommitGens  # noqa: E402
from spartan_tpu_torch.core.field import Q  # noqa: E402
from spartan_tpu_torch.core.merlin import RandomTape, Transcript  # noqa: E402
from spartan_tpu_torch.curve import ristretto as dri  # noqa: E402
from spartan_tpu_torch.curve import row_msm as rm  # noqa: E402
from spartan_tpu_torch.ff import fq, limb  # noqa: E402
from spartan_tpu_torch.ff import round_kernel as rk  # noqa: E402
from spartan_tpu_torch.protocols import device_prover as dp  # noqa: E402
from spartan_tpu_torch.protocols.product_tree import (  # noqa: E402
    ProductCircuitBatch)
from spartan_tpu_torch.transcript import device as dt  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.kernels = collections.Counter()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def _as_kernel(mod, name: str, mode_ref: list) -> None:
    """mod.name (a plain version) counts as one kernel launch, its own
    operations not counted."""
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        mode = mode_ref[0]
        if mode is None:
            return fn(*a, **k)
        mode.kernels[name] += 1
        mode.paused += 1
        try:
            return fn(*a, **k)
        finally:
            mode.paused -= 1

    setattr(mod, name, wrapped)


def zk_phase(which: str, log_n: int) -> None:
    rng = random.Random(5)
    ntab, deg = (2, 2) if which == "quad" else (4, 3)
    tables = [fq.encode_ints([rng.randrange(Q) for _ in range(1 << log_n)])
              for _ in range(ntab)]
    dp.zk_sumcheck_phase_device(
        rng.randrange(Q), 7, log_n, tables, which,
        MultiCommitGens(1, b"g1"), MultiCommitGens(deg + 1, b"gn"),
        Transcript(b"ops"), RandomTape(b"tape", seed=1))


def product_proof(log_n: int) -> None:
    rng = random.Random(6)
    B, n = 2, 1 << log_n
    leaves = fq.encode_ints([rng.randrange(1, Q) for _ in range(B * n)])
    dp.prove_product_layers_device(
        ProductCircuitBatch(leaves.reshape(B, n, 8)), None,
        Transcript(b"ops"))


def measure(fn, *args) -> Count:
    mode = Count()
    MODE[0] = mode
    with mode:
        fn(*args)
    MODE[0] = None
    return mode


MODE: list = [None]


def main() -> int:
    for mod, name in ((rm, "row_msm_plain"), (rk, "fold_evals_plain"),
                      (dt, "strobe_step_plain"), (dri, "compress_plain")):
        _as_kernel(mod, name, MODE)
    x = fq.encode_ints([3, 5])
    out = {"fq_mul16": measure(fq.mul16, *(limb.unpack(x),) * 2).ops,
           "fq_add16": measure(fq.add16, *(limb.unpack(x),) * 2).ops}
    for which in ("quad", "cubic"):
        a, b = measure(zk_phase, which, 3), measure(zk_phase, which, 4)
        out[f"zk_{which}_round"] = {
            "torch_ops": b.ops - a.ops,
            "kernels": dict(b.kernels - a.kernels)}
    # the product proof of 2^4 leaves has one layer more, of 3 rounds,
    # than that of 2^3 leaves: the last layer's set-up and claims too
    a, b = measure(product_proof, 3), measure(product_proof, 4)
    out["product_layer_of_3_rounds"] = {
        "torch_ops": b.ops - a.ops, "kernels": dict(b.kernels - a.kernels)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
