"""Two-tier (DCN × ICI) collectives for proving across hosts (the JAX
package's ``parallel/dcn.py``).

A ``Mesh2D`` is a grid of devices: a row a host (the "dcn" axis), the
host's devices along the row (the "ici" axis).  Every collective works
along the rows first, so the network between hosts carries one field
element or one point a host, whatever the table's size:

* ``all_reduce_field``: the devices' partial field elements summed mod
  q over each row, then the rows' sums over the hosts;
* ``msm_two_tier``: kernel K5 on each device's block of points, a tree
  sum of the partial points a row, then one over the rows.

Multi-host start-up is ``init_multihost``, which joins a
``torch.distributed`` process group when the environment announces a
run of more than one process.  With such a group up, the ranks are the
dcn axis: each process holds its own row of local devices, and the dcn
step exchanges each row's one element with ``torch.distributed.
all_gather``.  With none, dcn is the rows of a local grid, as the JAX
package's test shapes eight CPU devices as (2, 4): the same steps run,
only the transport differs.
"""

from __future__ import annotations

import collections
import os

import torch
import torch.distributed as dist

from ..ff import fq
from .mesh import blocks, cuda_devices, point_msm_blocks, psum_mod_q, \
    sum_points

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   backend: str | None = None) -> bool:
    """Join a multi-process run, or do nothing.

    Reads MASTER_ADDR, WORLD_SIZE and RANK (``env://``) when
    ``init_method`` is omitted, and does nothing when neither an
    argument nor the environment announces more than one process, so
    callers may call it unconditionally before building a mesh.  The
    backend is nccl for CUDA tensors where a card is visible, gloo for
    CPU tensors otherwise, unless ``backend`` names one.  Returns
    whether a process group is up."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or world_size <= 1:
            return False
        init_method = "env://"
    if rank is None:
        rank = int(os.environ["RANK"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


class Mesh2D:
    """A (dcn, ici) grid of devices.  ``rows`` are the rows this process
    drives: all ``n_hosts`` of them, or, when the hosts are the ranks of
    a process group, its own one."""

    def __init__(self, rows, n_hosts: int):
        self.rows = [[torch.device(d) for d in row] for row in rows]
        if not self.rows or len({len(row) for row in self.rows}) != 1:
            raise ValueError("a 2-D mesh needs rows of one length")
        self.shape = {DCN_AXIS: n_hosts, ICI_AXIS: len(self.rows[0])}
        self.distributed = n_hosts > len(self.rows)
        self.msm_blocks: collections.Counter = collections.Counter()

    @property
    def devices(self) -> list[torch.device]:
        """This process's devices, row by row."""
        return [d for row in self.rows for d in row]

    @property
    def first_block(self) -> int:
        """The index of this process's first device in the whole grid."""
        if not self.distributed:
            return 0
        return dist.get_rank() * self.shape[ICI_AXIS]


def make_mesh2d(n_hosts: int | None = None,
                chips_per_host: int | None = None,
                devices=None) -> Mesh2D:
    """A (dcn, ici) mesh over ``devices`` (every CUDA device by
    default).  With a process group of world size > 1 up, the hosts are
    its ranks and this process's row is its first ``chips_per_host``
    devices (all of them by default); otherwise the devices, in order,
    fill ``n_hosts`` rows (one by default) of ``chips_per_host``."""
    devs = (cuda_devices() if devices is None
            else [torch.device(d) for d in devices])
    world = _world_size()
    if world > 1:
        if n_hosts not in (None, world):
            raise ValueError(f"{n_hosts} hosts asked for in a process "
                             f"group of {world}")
        return Mesh2D([devs[:chips_per_host or len(devs)]], world)
    n_hosts = n_hosts or 1
    per = chips_per_host or len(devs) // n_hosts
    if per < 1 or n_hosts * per > len(devs):
        raise ValueError(f"{n_hosts} x {per} devices asked of {len(devs)}")
    return Mesh2D([devs[h * per:(h + 1) * per] for h in range(n_hosts)],
                  n_hosts)


def _all_gather(x: torch.Tensor) -> list[torch.Tensor]:
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x.contiguous())
    return out


def _two_tier(partials, mesh2d: Mesh2D, reduce):
    """``reduce`` (a list and a device -> their sum there) over every
    device's partial: over each row first, on the row's first device,
    then over the rows on this process's first device, then over the
    ranks."""
    if len(partials) != len(mesh2d.devices):
        raise ValueError(f"{len(partials)} partials for "
                         f"{len(mesh2d.devices)} devices")
    home = mesh2d.devices[0]
    m = mesh2d.shape[ICI_AXIS]
    hosts = [reduce(partials[i * m:(i + 1) * m], row[0])
             for i, row in enumerate(mesh2d.rows)]
    out = reduce(hosts, home)
    if mesh2d.distributed:
        out = reduce(_all_gather(out), home)
    return out


def all_reduce_field(partials, mesh2d: Mesh2D) -> torch.Tensor:
    """The sum mod q of canonical Montgomery field elements, one a
    device of this process in ``mesh2d.devices`` order, over the whole
    grid: over each host's devices first, then over the hosts.  Every
    process gets the sum, on its first device."""
    return _two_tier(partials, mesh2d, psum_mod_q)


def sum_mod_q_two_tier(mesh2d: Mesh2D):
    """fn(table) -> (8,): the sum mod q of an (n, 8) Montgomery table cut
    in one block a device of the whole grid (each process sums its own
    devices' blocks), reduced ICI-first."""

    def fn(table):
        total = mesh2d.shape[DCN_AXIS] * mesh2d.shape[ICI_AXIS]
        parts = [fq.sum_mod(b) for b in blocks(
            table, mesh2d.devices, total, mesh2d.first_block)]
        return all_reduce_field(parts, mesh2d)

    return fn


def msm_two_tier(mesh2d: Mesh2D):
    """fn(scalars (N, 8) canonical, points (N, 4, 8) extended) -> (1, 4,
    8): the MSM with the points cut in one block a device of the whole
    grid, K5 on each block, a tree sum of the partial points a host,
    then one over the hosts.  The group element equals the one-launch
    MSM's."""

    def fn(scalars, points):
        total = mesh2d.shape[DCN_AXIS] * mesh2d.shape[ICI_AXIS]
        devs, first = mesh2d.devices, mesh2d.first_block
        parts = point_msm_blocks(blocks(scalars, devs, total, first),
                                 blocks(points, devs, total, first), devs,
                                 mesh2d.msm_blocks)
        return _two_tier(parts, mesh2d, sum_points)

    return fn
