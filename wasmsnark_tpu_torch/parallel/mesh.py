"""Point-sharded MSM over torch.distributed, PyTorch port of
wasmsnark_tpu/parallel/mesh.py (make_mesh, make_mesh_2d, msm_sharded,
msm_sharded_point).

The JAX package runs one SPMD program over a Mesh of the devices that one
controller sees (shard_map).  Here a process is a rank, and the mesh is a
torch.distributed DeviceMesh over an initialized process group:

  * each rank takes its contiguous block of ceil(N / D) points (the last
    blocks zero-padded: zero scalars on (0, 0) points), uploads only that
    block, and runs MSMDevice.msm on it (K4-K7 on the card);
  * the D partial window sums (W points a rank, a few KB) are gathered in
    rank order with all_gather over the mesh axis (over a tuple of axes,
    the innermost first, as the JAX gather lowers hierarchically), and
    every rank folds the same gathered tensor in the same order with
    reduce_last: the sums are bit-identical on every rank.

The collective runs where the group's backend takes it: NCCL on the card,
gloo on the CPU (a partial sum on the card is copied to the host and
back).  The backend is the caller's choice at init_process_group:

    torchrun --nproc-per-node 4 prove.py      # env:// rendezvous
    dist.init_process_group("gloo", store=dist.FileStore(path, 4),
                            rank=rank, world_size=4)

NCCL refuses two ranks on one card, so several ranks sharing one card use
gloo.  A failed collective raises to the caller.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..fields.oracle import flatten, unflatten
from ..ops.curve import map_leaf
from ..ops.fp import planes, resolve_device
from ..ops.msm import MSMDevice, fold_windows_device
from ..ops.scan import reduce_last


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized: call "
            "torch.distributed.init_process_group first (torchrun, or a "
            "FileStore)")
    return dist.get_world_size()


def _init_mesh(dev, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    world = _world()
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"need {n} ranks, the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "points",
              device=None):
    """1-D mesh over the first n_devices ranks (default: every rank), on
    the card unless device="cpu".  Every rank of the group calls it."""
    dev = resolve_device(device)
    return _init_mesh(dev, (n_devices or _world(),), (axis,))


def make_mesh_2d(n_hosts: int, chips_per_host: int | None = None,
                 axes: tuple = ("host", "points"), device=None):
    """Hierarchical (host x chip) mesh: points shard over both axes
    flattened, and the partial sums gather within a host first."""
    dev = resolve_device(device)
    per = chips_per_host or _world() // n_hosts
    return _init_mesh(dev, (n_hosts, per), tuple(axes))


def _gather_last(t, group, size):
    """all_gather over `group`, the rank-ordered parts concatenated along
    the last axis.  Only NCCL gathers on the card: for another backend
    (gloo) the tensor goes through the host."""
    via = t if "nccl" in dist.get_backend(group) else t.cpu()
    via = via.contiguous()
    parts = [torch.empty_like(via) for _ in range(size)]
    dist.all_gather(parts, via, group=group)
    return torch.cat(parts, dim=-1).to(t.device)


class ShardedMSM:
    """The callable of msm_sharded / msm_sharded_point for this rank.

    call(scalars, points): scalars [Lr, *K, N] and affine points (X, Y)
    with leaves [.., *K, N] (numpy planes or tensors), whole; only this
    rank's block is uploaded.  Returns the per-window Jacobian sums,
    leaves [.., *K, W] (folded to leaves [.., *K] by msm_sharded_point),
    the same on every rank.  `shard` and `local` split that call for a
    caller that keeps its blocks on the device (the prover's key)."""

    def __init__(self, msm: MSMDevice, mesh, axis="points", fold=False):
        self.msm, self.fold = msm, fold
        axes = axis if isinstance(axis, tuple) else (axis,)
        names = mesh.mesh_dim_names
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self.sizes = [mesh.shape[names.index(a)] for a in axes]
        self.groups = [mesh.get_group(a) for a in axes]
        self.D = math.prod(self.sizes)
        self.index = 0                   # the block: the axes' coordinates
        for a, size in zip(axes, self.sizes):   # flattened, first major
            self.index = self.index * size + mesh.get_local_rank(a)
        self.device = resolve_device(mesh.device_type)

    def block(self, n: int):
        """(start, stop, per): this rank's points [start, stop) of n, in a
        block of per = ceil(n / D)."""
        per = -(-n // self.D)
        start = min(self.index * per, n)
        return start, min(start + per, n), per

    def shard(self, a, n: int | None = None):
        """This rank's block of planes a [.., n'] (numpy or a tensor) of a
        length-n axis (default n'; points past n' are zero), zero-padded
        to ceil(n / D), on the mesh's device."""
        start, stop, per = self.block(a.shape[-1] if n is None else n)
        stop = min(stop, a.shape[-1])
        t = planes(a[..., min(start, stop):stop], self.device)
        return torch.nn.functional.pad(t, (0, per - t.shape[-1]))

    def local(self, scalars, points):
        """The MSM of this rank's blocks (scalars [Lr, *K, per], points
        leaves [.., *K, per], on the device), its window sums gathered
        from every rank and folded."""
        C = self.msm.curve
        win = self.msm.msm(scalars, points)          # leaves [.., *K, W]
        # the leaves stacked, one collective an axis: [n_leaves, .., W, D]
        # after the innermost axis first, each outer rank's parts major
        packed = torch.stack(flatten(win)).unsqueeze(-1)
        for group, size in zip(reversed(self.groups), reversed(self.sizes)):
            packed = _gather_last(packed, group, size)
        red = reduce_last(C, unflatten(win, packed.unbind(0)))
        out = map_leaf(red, lambda a: a[..., 0])
        return fold_windows_device(C, out, self.msm.c) if self.fold else out

    def __call__(self, scalars, points):
        return self.local(self.shard(scalars), map_leaf(points, self.shard))


def msm_sharded(msm: MSMDevice, mesh, axis="points") -> ShardedMSM:
    """Sharded MSM over `axis` of `mesh` (a name or a tuple of names, the
    points sharded over the axes flattened): (scalars, points) ->
    per-window Jacobian sums [.., *K, W], bit-identical on every rank
    (fold with ops.msm.fold_windows_device, or fold_windows on the
    host).  N is padded to a multiple of the mesh size inside, so any
    length works, N < D included (a rank of padding adds the zero
    point)."""
    return ShardedMSM(msm, mesh, axis)


def msm_sharded_point(msm: MSMDevice, mesh, axis="points") -> ShardedMSM:
    """msm_sharded's windows folded to one Jacobian point per batch entry
    on the device (fold_windows_device): the prover's form."""
    return ShardedMSM(msm, mesh, axis, fold=True)
