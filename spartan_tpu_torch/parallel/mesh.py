"""Sharding the prover over a mesh of devices (the JAX package's
``parallel/mesh.py``).

A ``Mesh`` is an ordered list of devices in one process, as JAX's mesh
is single-controller: one process drives every device.  A device may
appear more than once.  A mesh of one card listed four times runs four
shards, each one launch at the shard's own size; that is how the tests
shard over ``["cpu"] * D`` and how one card runs a four-way mesh, as
XLA's virtual CPU devices do for the JAX package.

* Sum-check and product-layer tables are sharded by *trailing* index
  bits: logical index i lives on shard i mod D at local slot i // D.
  A fold pairs i with i + n/2, which differ only in the leading bit, so
  shard k's local lo/hi split (slot j holds i = jD + k) is the global
  split and every fold stays local.  A shard's round is one launch of
  kernel B2 (``ff/round_kernel.py::fold_evals``).  Its evals come back
  reduced mod q; ``evals_to_ints`` fetches the D partials at once and
  adds them mod q on the host, so a round still fetches once.  (Added
  on the device by ``psum_mod_q``, as ``dcn.py`` does, they cost ~1,000
  torch operations a round: 7.9 ms a round of the 2^20 SNARK's product
  layers on an H100, PERF.md.)  The tables unshard before a fold whose
  shards would hold fewer than 4 entries, B2's least size for its
  fold-and-evals mode.
* A commitment's row-MSM runs in row blocks, one launch of kernel B1
  (``curve/row_msm.py``) a device: the rows are independent MSMs that
  share the generators.
* A variable-base MSM runs in point blocks, one launch of kernel K5
  (``curve/point_msm.py``) a device, and the D partial points are
  summed in a tree.

Unsharded tables and row commitments gather on the device the inputs
came from: the instance's, as the JAX package gathers on its default
device.

The JAX names and where they went: ``msm_rows_sharded`` and
``msm_rows_blocked`` became ``msm_rows_blocked``; ``sharded_msm`` and
``sharded_msm_naive`` became ``sharded_msm``; ``sharded_quad_round`` is
the ``"quad"`` case of ``ShardedSumcheckTables``; ``shard_table_batched``
and ``unshard_table_batched`` are ``shard_table`` and ``unshard_table``,
which shard the second-to-last dimension of ``(n, 8)`` and ``(B, n,
8)`` tables alike.  The XLA compile choices behind the variants have no
counterpart.

A mesh counts its sharded work: ``sharded_rounds``, a Counter keyed by
(``"sumcheck"`` or ``"layer"``, the shards' size before the round), and
``msm_blocks``, keyed by (``"row_msm"``, rows a block, generators) and
(``"point_msm"``, points a block).
"""

from __future__ import annotations

import collections
import contextlib

import torch

from ..core.field import Q
from ..curve import edwards as ed
from ..curve import msm
from ..curve.point_msm import point_msm
from ..ff import fq
from ..ff.round_kernel import fold_evals
from ..protocols import _combs


class Mesh:
    """An ordered list of devices in one process."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.sharded_rounds: collections.Counter = collections.Counter()
        self.msm_blocks: collections.Counter = collections.Counter()

    @property
    def size(self) -> int:
        return len(self.devices)


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("spartan_tpu_torch: no CUDA device is available; "
                           "build a Mesh from explicit devices instead")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh() -> Mesh:
    """A mesh over every visible CUDA device."""
    return Mesh(cuda_devices())


def on(device):
    """The context in which a kernel launches on ``device``: its CUDA
    device, or nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def psum_mod_q(partials, device) -> torch.Tensor:
    """The sum mod q, on ``device``, of canonical Montgomery field
    elements of one shape, one from each shard.  Addition is linear, so
    Montgomery form sums as it is."""
    out = partials[0].to(device)
    for p in partials[1:]:
        out = fq.add(out, p.to(device))
    return out


def evals_to_ints(partials) -> list[int]:
    """A round's evals as python ints: the partials that
    ``ShardedSumcheckTables.round`` returns (one tensor when unsharded),
    fetched in one transfer and summed mod q."""
    if len(partials) == 1:
        return fq.decode_to_ints(partials[0])
    home = partials[0].device
    vals = fq.decode_to_ints(torch.stack([p.to(home) for p in partials]))
    k = len(vals) // len(partials)
    return [sum(vals[i::k]) % Q for i in range(k)]


def shard_table(table: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Shard k of ``table`` ((..., n, 8)) on ``mesh.devices[k]``: logical
    index i on shard i mod D, at local slot i // D."""
    d, n = mesh.size, table.shape[-2]
    if n % d:
        raise ValueError(f"a table of {n} entries does not split over {d} "
                         f"shards")
    return [table[..., k::d, :].contiguous().to(dev)
            for k, dev in enumerate(mesh.devices)]


def unshard_table(shards, device) -> torch.Tensor:
    """The logical table of ``shards`` (``shard_table``'s layout) on
    ``device``."""
    return torch.stack([s.to(device) for s in shards], dim=-2).flatten(-3, -2)


class _ShardedTables:
    """Tables whose rounds run on B2, sharded over a mesh while each
    shard holds at least 2 entries, or whole on their own device (with
    no mesh, or once they unshard)."""

    kind = ""

    def __init__(self, mesh: Mesh | None, tables):
        self.mesh = mesh
        self.home = tables[0].device
        d = mesh.size if mesh is not None else 1
        n = tables[0].shape[-2]
        self.sharded = d > 1 and n >= 2 * d and n % d == 0
        self.tables = self.shards = None
        if self.sharded:
            # shards[k] holds every table's shard k
            self.shards = [list(s) for s in
                           zip(*(shard_table(T, mesh) for T in tables))]
        else:
            self.tables = list(tables)

    def round(self, r, mode: str):
        """One B2 step in ``mode`` ("evals", "fold_evals" or "fold"),
        as ``fold_evals`` takes it.  Returns the evals as a list of
        partials, one a shard (one when unsharded), for
        ``evals_to_ints``; None in "fold" mode."""
        if (mode != "evals" and self.sharded
                and self.shards[0][0].shape[-2] < 4):
            # below 4 entries a shard's fold leaves it fewer than 2 for
            # the next round's lo/hi split
            self.tables = [unshard_table(ts, self.home)
                           for ts in zip(*self.shards)]
            self.sharded, self.shards = False, None
        if not self.sharded:
            self.tables, ev = fold_evals(self.tables, r, mode)
            return None if mode == "fold" else [ev]
        size = self.shards[0][0].shape[-2]
        evs = []
        for k, dev in enumerate(self.mesh.devices):
            with on(dev):
                self.shards[k], ev = fold_evals(self.shards[k], r, mode)
            evs.append(ev)
        self.mesh.sharded_rounds[self.kind, size] += 1
        return None if mode == "fold" else evs

    def evals(self) -> list:
        return self.round(None, "evals")

    def fold_evals(self, r) -> list:
        """Fold by ``r``, then the next round's evals."""
        return self.round(r, "fold_evals")

    def fold(self, r) -> None:
        self.round(r, "fold")

    def final_scalars(self) -> torch.Tensor:
        """Every table's logical index 0, stacked: (k, 8) for (n, 8)
        tables, (3, B, 8) for (B, n, 8).  Logical 0 is slot 0 of shard
        0, read once the tables have unsharded."""
        if self.sharded:
            raise RuntimeError("the final scalars are read after the "
                               "tables unshard")
        return torch.stack([T[..., 0, :] for T in self.tables])


class ShardedSumcheckTables(_ShardedTables):
    """A ZK sum-check phase's tables ((n, 8) Montgomery, the ``which``
    comb of ``protocols/_combs.py``; cubic_prod's three as B2 takes
    them, (1, n, 8)) on ``mesh``: the JAX package's
    ``ShardedSumcheckTables``.  Proof bytes equal the unsharded
    rounds'."""

    kind = "sumcheck"

    def __init__(self, mesh: Mesh | None, tables, which: str):
        if len(tables) != _combs.NTABLES[which]:
            raise ValueError(f"the {which} comb takes "
                             f"{_combs.NTABLES[which]} tables, got "
                             f"{len(tables)}")
        super().__init__(mesh, tables)


class ShardedProductLayerTables(_ShardedTables):
    """One product-tree layer's (A, Bt, C) tables, (B, n, 8), sharded
    on the hypercube axis n: the JAX package's
    ``ShardedProductLayerTables``, on B2's batched cubic_prod mode."""

    kind = "layer"

    def __init__(self, mesh: Mesh | None, A, Bt, C):
        super().__init__(mesh, [A, Bt, C])

    step = _ShardedTables.fold_evals


def msm_rows_blocked(scalars: torch.Tensor, gens,
                     mesh: Mesh | None) -> ed.PointArray:
    """The row commitments ``msm.msm_rows(scalars, gens)`` (scalars (L,
    R, 8) canonical) as one B1 launch a device on its block of L/D rows,
    with the generators' table on that device; the rows gather on the
    scalars' device.  Group elements equal ``msm_rows``'s (a block's
    segments may differ from the whole's, so coordinates may not).  With
    no mesh, or when L % D != 0 or L < D, it runs ``msm_rows``, as the
    JAX package does."""
    L, R = scalars.shape[:2]
    d = mesh.size if mesh is not None else 1
    if d == 1 or L % d or L < d:
        return msm.msm_rows(scalars, gens)
    lb = L // d
    parts = []
    for k, dev in enumerate(mesh.devices):
        with on(dev):
            parts.append(msm.msm_rows(
                scalars[k * lb:(k + 1) * lb].to(dev), gens))
        mesh.msm_blocks["row_msm", lb, R] += 1
    return ed.PointArray(*(torch.cat([p[c].to(scalars.device)
                                      for p in parts]) for c in range(4)))


def blocks(x: torch.Tensor, devices, count: int, first: int = 0) -> list:
    """Blocks first, first + 1, ... of ``x`` cut along its first
    dimension into ``count`` equal blocks, one on each of ``devices``."""
    if x.shape[0] % count:
        raise ValueError(f"{x.shape[0]} entries do not split into {count} "
                         f"blocks")
    nb = x.shape[0] // count
    return [x[(first + k) * nb:(first + k + 1) * nb].contiguous().to(dev)
            for k, dev in enumerate(devices)]


def point_msm_blocks(scalars, points, devices, counter) -> list:
    """K5 on each device's block of canonical scalars ((nb, 8)) and
    extended points ((nb, 4, 8)): one (1, 4, 8) partial on each device,
    counted in ``counter``."""
    out = []
    for dev, s, p in zip(devices, scalars, points):
        with on(dev):
            out.append(point_msm(p, s, (0, p.shape[0])))
        counter["point_msm", p.shape[0]] += 1
    return out


def sum_points(points, device) -> torch.Tensor:
    """The sum of (1, 4, 8) points on ``device``, in a tree: (1, 4, 8)."""
    pts = torch.cat([p.to(device) for p in points])
    while pts.shape[0] > 1:
        h = pts.shape[0] // 2
        s = ed.stack(ed.add(ed.unstack(pts[:h]), ed.unstack(pts[h:2 * h])))
        pts = torch.cat([s, pts[2 * h:]])
    return pts


def sharded_msm(mesh: Mesh):
    """fn(scalars (N, 8) canonical, points (N, 4, 8) extended) -> (1, 4,
    8): the MSM with the points cut in D blocks, K5 on each block on its
    device, the D partial points summed in a tree on the points' device.
    N % D must be 0.  The group element equals the one-launch MSM's."""

    def msm_fn(scalars, points):
        devs = mesh.devices
        parts = point_msm_blocks(blocks(scalars, devs, len(devs)),
                                 blocks(points, devs, len(devs)), devs,
                                 mesh.msm_blocks)
        return sum_points(parts, points.device)

    return msm_fn
