"""Active-mesh context: the switch that turns the single-device prover
into a sharded one (the JAX package's ``parallel/context.py``).

The reference is a single-process library; its one parallel site is a
rayon loop over commitment rows (dense_mlpoly.rs:148-162).  Here the
analogous knob is a process-wide device mesh: when one is active, the
commitments' row-MSM runs in row blocks across the mesh and the
sum-check and product-layer rounds run on trailing-bit-sharded tables
whose round evals are summed mod q (``parallel/mesh.py``).  Proof bytes
are the same with and without a mesh (``tests/test_torch_parallel.py``)
— sharding is a choice of layout, never a change to the protocol.

Usage:
    from spartan_tpu_torch.parallel import context as pctx
    from spartan_tpu_torch.parallel.mesh import Mesh
    with pctx.use_mesh(Mesh(["cuda:0"] * 4)):
        proof = NIZK.prove(...)
"""

from __future__ import annotations

from contextlib import contextmanager

_ACTIVE = None


def get_mesh():
    """The active mesh, or None.  Meshes with a single device are
    treated as inactive (sharding would be pure overhead)."""
    if _ACTIVE is not None and _ACTIVE.size <= 1:
        return None
    return _ACTIVE


@contextmanager
def use_mesh(mesh):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev
