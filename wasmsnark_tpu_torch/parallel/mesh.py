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

import collections
import math

import numpy as np
import torch
import torch.distributed as dist

from ..fields.oracle import flatten, unflatten
from ..ops.curve import map_leaf
from ..ops.fp import planes, resolve_device
from ..ops.msm import MSMDevice, fold_windows_device
from ..ops.ntt import TILE_LOG, NTTDevice, _bitrev, ntt_pass
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
        axes = self.axes = axis if isinstance(axis, tuple) else (axis,)
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


# ---------------------------------------------------------------------------
# the domain-sharded NTT
# ---------------------------------------------------------------------------

def layout(kind: str, n: int, D: int, r: int) -> np.ndarray:
    """The global index that each local position of rank r holds, for a
    length-n axis split over D ranks (M = n / D a rank, c = M / D):

      block          i -> r*M + i (the JAX package's P(None, ax) block)
      strided        i -> r + D*i
      chunks_rev     ml*D + t -> rev_d(t)*M + r*c + ml (chunks of D, one
                     element of each block, bit-reversed: the D-point
                     DFTs' input)
      chunks         ml*D + t -> t*M + r*c + ml (their forward output)
      chunks_mirror  ml*D + t -> (-t mod D)*M + r*c + ml (their output
                     read as an inverse's)
      upper          i -> n/2 + r*M/2 + i (this rank's block of the upper
                     half: H's block of the 2N inverse)"""
    M = n // D
    if kind == "upper":
        return n // 2 + r * (M // 2) + np.arange(M // 2)
    i = np.arange(M)
    if kind == "block":
        return r * M + i
    if kind == "strided":
        return r + D * i
    ml, t = i // D, i % D
    if kind == "chunks_rev":
        t = _bitrev(D.bit_length() - 1)[t]
    elif kind == "chunks_mirror":
        t = (-t) % D
    elif kind != "chunks":
        raise ValueError(f"unknown layout {kind!r}")
    return t * M + r * (M // D) + ml


class ShardedNTT:
    """NTTDevice's fft and ifft over contiguous domain blocks: rank r of
    the D ranks of `axis` (default the mesh's first, the JAX prover's
    domain axis) holds [L, N/D], block r of a [L, N] transform, and gets
    block r of NTTDevice.fft/ifft of the whole, bit for bit.

    The transform is split N = D * M.  For the input strided (rank r
    holding j = r + D*j2) each rank runs its M-point transform on its own
    (NTTDevice, K3), multiplies by its twiddle plane (K1,
    NTTDevice.rank_plan, with the coset and the 1/N folded in), and the
    ranks exchange once so that each holds one element of every rank in
    chunks of D, where one K3 pass of stages 0..d-1 runs every D-point DFT
    (`strided_in`).  With the input in chunks the order is the reverse
    (`chunks_in`, an inverse: D-point DFTs, twiddles, one exchange,
    M-point transforms, the output strided).  An inverse runs its D-point DFTs
    forward and reads their outputs mirrored (`layout` "chunks_mirror").
    fft and ifft take and return blocks: three exchanges a transform;
    CALC_H (groth16/prover.py) keeps the permuted layouts between its
    transforms and pays one each.

    An exchange is one all_to_all_single over the axis's group, equal
    parts: NCCL on the card, another backend (gloo) through the host.  The
    index maps (which position goes to which rank, in what order) are
    built on the host from `layout` and cached; every global permutation
    (the bit-reverse, the mirror) lives in them.  A failed collective
    raises.  `exchanges` and `exchange_bytes` count the calls and the
    bytes this rank passes to them, by label.  Needs D a power of two, D
    <= 2^TILE_LOG and N >= D^2; one rank runs NTTDevice's launches alone."""

    def __init__(self, ntt: NTTDevice, mesh, axis: str | None = None):
        names = mesh.mesh_dim_names
        self.axis = axis or names[0]
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self.ntt, self.F = ntt, ntt.F
        self.D = mesh.shape[names.index(self.axis)]
        self.d = self.D.bit_length() - 1
        self.index = mesh.get_local_rank(self.axis)
        self.group = mesh.get_group(self.axis)
        self.nccl = "nccl" in dist.get_backend(self.group)
        self._maps: dict = {}
        self.exchanges: collections.Counter = collections.Counter()
        self.exchange_bytes: collections.Counter = collections.Counter()

    def unsupported(self, n: int) -> str | None:
        """Why a 2^k = n point transform cannot be split over these ranks,
        or None."""
        D = self.D
        if D & (D - 1):
            return f"{D} ranks, not a power of two"
        if self.d > TILE_LOG:
            return f"{D} ranks, more than 2^{TILE_LOG}"
        if n & (n - 1) or n < D * D:
            return f"a domain of {n} points, not a power of two >= {D}^2"
        if n.bit_length() - 1 > self.ntt.spec.max_bits:
            return "a domain beyond the field's 2-adicity"
        return None

    # -- exchanges --------------------------------------------------------------

    def _plan(self, src: str, dst: str, n: int):
        """(send, gather, local) for moving the values of `src` layout to
        `dst` layout: this rank's positions to send, destination-major in
        each destination's order (None: all, in order); the receive
        buffer's entry for each dst position (None: in order); and whether
        every rank keeps its own values (no collective)."""
        key = (src, dst, n)
        if key in self._maps:
            return self._maps[key]
        D, me = self.D, self.index

        def index(a, size):
            if len(a) == size and np.array_equal(a, np.arange(size)):
                return None
            return torch.from_numpy(a).to(self.F.device)

        if D == 1:                  # one rank: a local gather, no sort
            inv = np.empty(n, np.int64)
            inv[layout(src, n, 1, 0)] = np.arange(n)
            p = self._maps[key] = (index(inv[layout(dst, n, 1, 0)], n),
                                   None, True)
            return p
        owner = np.full(n, -1, np.int64)
        pos = np.full(n, -1, np.int64)
        for r in range(D):
            g = layout(dst, n, D, r)
            owner[g], pos[g] = r, np.arange(len(g))

        def sends(r):
            g = layout(src, n, D, r)
            keep = np.nonzero(owner[g] >= 0)[0]
            order = keep[np.lexsort((pos[g[keep]], owner[g[keep]]))]
            return order, owner[g[order]], pos[g[order]]

        out = [sends(r) for r in range(D)]
        local = all(np.all(o == r) for r, (_, o, _) in enumerate(out))
        for _, o, _ in [] if local else out:
            if np.any(np.bincount(o, minlength=D) != len(o) // D):
                raise ValueError(f"{src} -> {dst}: unequal parts")
        recv = np.concatenate([p[o == me] for _, o, p in out])
        p = self._maps[key] = (index(out[me][0], n // D),
                               index(np.argsort(recv), len(recv)), local)
        return p

    def exchange(self, xs, src: str, dst: str, n: int, label: str):
        """Planes xs (a list of [L, n_src] tensors, one layout) moved from
        layout `src` to `dst` of a length-n axis, one collective for all
        of them (none where every rank keeps its own values)."""
        send, gather, local = self._plan(src, dst, n)
        if send is not None:
            xs = [x.index_select(1, send) for x in xs]
        if not local:
            B, (L, m) = len(xs), xs[0].shape
            D = self.D
            buf = torch.stack(xs).view(B, L, D, m // D).permute(
                2, 0, 1, 3).contiguous()
            via = buf if self.nccl else buf.cpu()
            got = torch.empty_like(via)
            dist.all_to_all_single(got, via, group=self.group)
            self.exchanges[label] += 1
            self.exchange_bytes[label] += via.numel() * via.element_size()
            xs = list(got.to(buf.device).permute(1, 2, 0, 3).reshape(
                B, L, m).unbind(0))
        if gather is not None:
            xs = [x.index_select(1, gather) for x in xs]
        return xs

    # -- the split transform ----------------------------------------------------

    def _dfts(self, x, bits: int, in_place: bool):
        """Every D-point DFT over chunks of D of x [L, M] (bit-reversed in
        each chunk), forward: one K3 pass of stages 0..d-1 with the M-point
        forward transform's table (a stage's twiddles do not depend on the
        size)."""
        if not self.d:
            return x
        tw = self.ntt.plan(bits)["tw"]
        return ntt_pass(self.ntt.field, x, tw, 0, self.d,
                        out=x if in_place else None,
                        tile_log=min(TILE_LOG, bits))

    def _local(self, x, bits: int, odd: bool, inverse: bool):
        ntt = self.ntt
        if inverse:
            return ntt.ifft(x, odd, plan=ntt.plan(bits, odd, inverse=True))
        return ntt.fft(x, odd, plan=ntt.plan(bits, odd))

    def _twiddle(self, xs, n: int, odd: bool, inverse: bool, strided: bool):
        bits = n.bit_length() - 1
        tw = self.ntt.rank_plan(bits, self.d, self.index, odd, inverse,
                                strided)
        return xs if tw is None else [self.F.mont_mul(x, tw) for x in xs]

    def strided_in(self, xs, n: int, odd=False, inverse=False, label="fft"):
        """Layout strided in, "chunks" (or "chunks_mirror" for an inverse)
        out: M-point transforms, twiddles, one exchange, D-point DFTs."""
        bits = n.bit_length() - 1 - self.d
        xs = [self._local(x, bits, odd, inverse) for x in xs]
        xs = self._twiddle(xs, n, odd, inverse, strided=True)
        xs = self.exchange(xs, "block", "chunks_rev", n, label)
        return [self._dfts(x, bits, in_place=True) for x in xs]

    def chunks_in(self, xs, n: int, label="ifft"):
        """An inverse (no coset), layout "chunks_rev" in, strided out:
        D-point DFTs read mirrored, twiddles, one exchange, M-point
        inverse transforms (the inputs are kept)."""
        bits = n.bit_length() - 1 - self.d
        xs = [self._dfts(x, bits, in_place=False) for x in xs]
        xs = self._twiddle(xs, n, False, True, strided=False)
        xs = self.exchange(xs, "chunks_mirror", "block", n, label)
        return [self._local(x, bits, False, True) for x in xs]

    def _whole(self, x, odd: bool, inverse: bool):
        n = x.shape[1] * self.D
        why = self.unsupported(n)
        if why:
            raise ValueError(f"cannot split this transform: {why}")
        label = ("ifft" if inverse else "fft") + ("_odd" if odd else "")
        x, = self.exchange([x], "block", "strided", n, label)
        x, = self.strided_in([x], n, odd, inverse, label)
        x, = self.exchange([x], "chunks_mirror" if inverse else "chunks",
                           "block", n, label)
        return x

    def gather(self, x):
        """The [L, N] whole from every rank's block [L, N/D] (one
        all_gather over the axis's group)."""
        return _gather_last(x, self.group, self.D)

    def fft(self, x, odd: bool = False):
        """Block r of NTTDevice.fft of the [L, N] whole, from block r."""
        return self._whole(x, odd, False)

    def ifft(self, x, odd: bool = False):
        """Block r of NTTDevice.ifft of the [L, N] whole, from block r."""
        return self._whole(x, odd, True)
