#!/usr/bin/env python3
"""Count the torch operations that the device prover enqueues per round
(``spartan_tpu_torch/protocols/device_prover.py``), besides its kernels.

    python3 tools/device_prover_ops.py

Runs on the CPU at small sizes: one Montgomery product and sum of two
scalars (``ff/fq.py``), a ZK sum-check phase (quad and cubic)
and a batched product proof, each at two sizes, and counts every ATen
operation dispatched (``TorchDispatchMode``), with the six kernel
wrappers' plain versions counted as one launch each and their own
operations left out, as on the card, where each is one kernel.  The
difference between the two sizes is the cost of the extra rounds, so a
round's count excludes the phase's set-up and its one fetch.  A bullet
round (``protocols/bullet.py``: the default path's device round, with
its 64-byte fetch and the host transcript) and a round of the device
dot-product-log (transcript on the device) are counted inside the
rounds themselves, from the start of ``round_commit`` to the end of
``round_fold``, over the 4 rounds at n = 16, and divided by 4.  The sum
of a sharded round's 4 partial (3, 18, 8) evals is counted both ways
(``parallel/mesh.py``): on the device by ``psum_mod_q`` and fetched and
added on the host by ``evals_to_ints``.  Prints
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
from spartan_tpu_torch.core.edwards import BASEPOINT  # noqa: E402
from spartan_tpu_torch.core.merlin import RandomTape, Transcript  # noqa: E402
from spartan_tpu_torch.curve import point_msm as pm  # noqa: E402
from spartan_tpu_torch.curve import ristretto as dri  # noqa: E402
from spartan_tpu_torch.curve import row_msm as rm  # noqa: E402
from spartan_tpu_torch.ff import bullet_kernel as bk  # noqa: E402
from spartan_tpu_torch.ff import fq, limb  # noqa: E402
from spartan_tpu_torch.ff import round_kernel as rk  # noqa: E402
from spartan_tpu_torch.parallel.mesh import (evals_to_ints,  # noqa: E402
                                             psum_mod_q)
from spartan_tpu_torch.protocols import bullet  # noqa: E402
from spartan_tpu_torch.protocols import device_prover as dp  # noqa: E402
from spartan_tpu_torch.protocols.product_tree import (  # noqa: E402
    ProductCircuitBatch)
from spartan_tpu_torch.protocols.sigma import (  # noqa: E402
    DotProductProofGens)
from spartan_tpu_torch.transcript import device as dt  # noqa: E402


class Count(TorchDispatchMode):
    """Counts operations and kernel launches while ``active``."""

    def __init__(self, active: bool = True):
        super().__init__()
        self.ops = 0
        self.kernels = collections.Counter()
        self.paused = 0
        self.active = active

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.active and not self.paused:
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
        if mode.active:
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


def _windowed(mod) -> None:
    """mod.round_commit turns counting on, mod.round_fold off when it
    returns: only a bullet round's own work is counted."""
    commit, fold = mod.round_commit, mod.round_fold

    def on(*a, **k):
        MODE[0].active = True
        return commit(*a, **k)

    def off(*a, **k):
        try:
            return fold(*a, **k)
        finally:
            MODE[0].active = False

    mod.round_commit, mod.round_fold = on, off


def bullet_rounds(log_n: int) -> None:
    """BulletReductionProof.prove with every round on the device (the
    CPU's DEVICE_MIN set to 1)."""
    rng = random.Random(7)
    n = 1 << log_n
    ints = [rng.randrange(Q) for _ in range(2 * n)]
    saved = bullet.DEVICE_MIN["cpu"]
    bullet.DEVICE_MIN["cpu"] = 1
    try:
        bullet.BulletReductionProof.prove(
            Transcript(b"ops"), BASEPOINT, MultiCommitGens(n, b"ops"),
            fq.encode_ints(ints[:n]), fq.encode_ints(ints[n:]), 5,
            [(k + 1, k + 2) for k in range(log_n)])
    finally:
        bullet.DEVICE_MIN["cpu"] = saved


def dotproduct_log(log_n: int) -> None:
    rng = random.Random(8)
    n = 1 << log_n
    x, a = ([rng.randrange(Q) for _ in range(n)] for _ in range(2))
    dp.dotproduct_log_device(
        DotProductProofGens(n, b"ops"), Transcript(b"ops"),
        RandomTape(b"tape", seed=1), fq.encode_ints(x), 3, fq.encode_ints(a),
        a, sum(p * q for p, q in zip(x, a)) % Q, 4)


def measure(fn, *args, active: bool = True) -> Count:
    mode = Count(active)
    MODE[0] = mode
    with mode:
        fn(*args)
    MODE[0] = None
    return mode


MODE: list = [None]


def main() -> int:
    for mod, name in ((rm, "row_msm_plain"), (rk, "fold_evals_plain"),
                      (dt, "strobe_step_plain"), (dri, "compress_plain"),
                      (pm, "point_msm_plain"), (bk, "bullet_step_plain")):
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
    _windowed(bullet)
    _windowed(dp)
    for name, fn in (("bullet_device_round", bullet_rounds),
                     ("dotproduct_log_device_round", dotproduct_log)):
        c = measure(fn, 4, active=False)
        out[name] = {"torch_ops": c.ops / 4,
                     "kernels": {k: v / 4 for k, v in c.kernels.items()}}
    evs = [fq.encode_ints(range(k, k + 3 * 18)).reshape(3, 18, 8)
           for k in range(4)]
    out["sharded_evals_4x(3,18)"] = {
        "psum_mod_q": measure(psum_mod_q, evs, "cpu").ops,
        "evals_to_ints": measure(evals_to_ints, evs).ops}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
