"""A mesh of decode shards: the port's counterpart of jax.sharding.Mesh
and of the collectives that shard_map gives the JAX sharded decoder
(iamf_tpu/parallel/sharded_decoder.py).

A ShardMesh lays named axes ("frames", then "elements" or "substreams")
over shards in row-major order; a shard is a (rank, torch.device) pair.

- In one process every shard is the caller's, and a hop between two shards
  is a tensor ``.to(device)``: the counterpart of one process over
  ``jax.devices()``. On the CPU, n shards are n CPU devices, as XLA's
  virtual host devices are; on the card, the shards lie over the visible
  cards, or over a list the caller gives, which may name one card several
  times.
- Across processes (``torch.distributed`` initialised by the caller), the
  ranks own the shards in contiguous blocks, as a JAX host owns its local
  devices. A hop within a rank is a copy, a hop across ranks a send/recv
  pair; ``psum``, ``all_gather`` and ``process_allgather`` run as
  ``all_reduce`` on the process group of the ranks concerned (int16 PCM
  as int32, which gloo sums, and back).
- gloo carries CPU tensors only, and NCCL takes one rank a card: a mesh
  that breaks either raises when it is built. Nothing is copied through
  the host in silence.

The five operations are those the sharded decoder uses: ``ppermute`` to
the next or previous shard of an axis (the carry chains, the head-trim
halo), ``psum`` over an axis (the elements mixer), ``all_gather`` of lane
slabs (the substreams gather), ``process_allgather`` (the ordered gather
of the PCM to every rank) and ``axis_index``. Each takes and returns dicts
{flat shard index: tensor(s)} holding this rank's shards only.
"""

from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils import trace


def _world() -> tuple[int, int]:
    """(rank, world size) of the caller's process group; (0, 1) when
    torch.distributed is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce(t, group=None):
    """Sum `t` over the group's ranks; int8/int16/uint8 go as int32 (gloo
    sums neither) and come back. Returns the sum."""
    if t.dtype in (torch.int8, torch.int16, torch.uint8):
        wide = t.to(torch.int32)
        dist.all_reduce(wide, group=group)
        return wide.to(t.dtype)
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def _card_id(dev: torch.device) -> str:
    """A card's identity across processes: its host and UUID."""
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}:{getattr(props, 'uuid', dev.index)}"


class ShardMesh:
    """Named axes over shards. ``devices`` are this rank's shards' devices,
    in flat (row-major) order; the rank owns flat shards
    [rank·len(devices), (rank+1)·len(devices))."""

    def __init__(self, axes: tuple, shape: tuple, devices: list):
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, shape))
        self.size = math.prod(shape)
        self.rank, self.world = _world()
        self.devices = [torch.device(d) for d in devices]
        per = len(self.devices)
        if per * self.world != self.size:
            raise ValueError(
                f"a {self.shape} mesh of {self.size} shards needs "
                f"{self.size // self.world} shards a rank over "
                f"{self.world} ranks; this rank has {per}")
        self.per_rank = per
        self.local = list(range(self.rank * per, (self.rank + 1) * per))
        self.shards = [(self.rank, d) for d in self.devices]
        self._groups: dict = {}
        if self.world > 1:
            self._check_backend()
            # every rank builds every group, in the same order
            # (dist.new_group is collective over the world)
            for axis in self.axes:
                for members in self._axis_groups(axis):
                    ranks = sorted({self.owner(i) for i in members})
                    if len(ranks) > 1:
                        self._groups[axis, members[0]] = dist.new_group(ranks)

    @classmethod
    def build(cls, n_devices=None, second: int = 1, name: str | None = None,
              device="cuda", devices=None) -> "ShardMesh":
        """A ("frames",) mesh, or ("frames", name) with `second` shards on
        the second axis, over n_devices shards in all (every rank's). The
        rank's shards lie over `devices` (the first shards one a device,
        contiguous blocks a device when there are more shards) when given;
        else on the CPU (device "cpu"), or over the visible cards in one
        process and on the current card in each of several (the caller
        sets it, one card a rank)."""
        dev = resolve_device(device)
        _, world = _world()
        if devices is None:
            if dev.type == "cpu":
                devices = [dev]
            elif world > 1:
                devices = [torch.device("cuda", torch.cuda.current_device())]
            else:
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d) for d in devices]
        n = n_devices or world * len(devices)
        axes, shape = ("frames",), (n,)
        if second > 1:
            f = n // second
            if f < 1:
                raise ValueError(f"{name} axis of {second} needs >= that "
                                 f"many devices, have {n}")
            # as JAX's mesh, the first f * second shards
            n = f * second
            axes, shape = ("frames", name), (f, second)
        if n % world:
            raise ValueError(f"{n} shards do not split over {world} ranks")
        per = n // world
        # one card a shard while they last, else contiguous blocks a card
        return cls(axes, shape, [devices[k * min(len(devices), per) // per]
                                 for k in range(per)])

    # --- coordinates -------------------------------------------------------

    def coords(self, i: int) -> tuple:
        out = []
        for axis in reversed(self.axes):
            i, c = divmod(i, self.shape[axis])
            out.append(c)
        return tuple(reversed(out))

    def flat(self, coords) -> int:
        i = 0
        for axis, c in zip(self.axes, coords):
            i = i * self.shape[axis] + c
        return i

    def axis_index(self, i: int, axis: str) -> int:
        """The position of shard i on `axis` (jax.lax.axis_index)."""
        return self.coords(i)[self.axes.index(axis)]

    def owner(self, i: int) -> int:
        return i // self.per_rank

    def device(self, i: int) -> torch.device:
        """The device of local shard i."""
        return self.devices[i - self.local[0]]

    def _axis_groups(self, axis: str) -> list:
        """The shards that vary only along `axis`, as tuples in its order."""
        a = self.axes.index(axis)
        groups = {}
        for i in range(self.size):
            c = list(self.coords(i))
            c[a] = 0
            groups.setdefault(self.flat(c), []).append(i)
        return [tuple(g) for _, g in sorted(groups.items())]

    def _moved(self, i: int, axis: str, shift: int):
        c = list(self.coords(i))
        a = self.axes.index(axis)
        c[a] += shift
        if 0 <= c[a] < self.shape[axis]:
            return self.flat(c)
        return None

    # --- backend checks ----------------------------------------------------

    def _check_backend(self) -> None:
        backend = str(dist.get_backend())
        kinds = {d.type for d in self.devices}
        if kinds != {"cpu"} and "nccl" not in backend:
            raise ValueError(
                f"a mesh across processes on {backend} carries CPU tensors "
                f"only (gloo); this rank's shards are on {self.devices}: use "
                "NCCL for cards (one rank a card)")
        if "cpu" in kinds and "gloo" not in backend:
            raise ValueError(f"{backend} carries no CPU tensors; this "
                             f"rank's shards are on {self.devices}")
        ids = None
        if "cuda" in kinds:
            if len(set(self.devices)) != 1:
                raise ValueError(
                    "NCCL takes one card a rank; this rank's shards are on "
                    f"{self.devices}")
            ids = _card_id(self.devices[0])
        # the identities go over gloo: NCCL itself fails on two ranks of
        # one card before it could say so
        side = None if "gloo" in backend else dist.new_group(backend="gloo")
        every = [None] * self.world
        dist.all_gather_object(every, (ids, [str(d) for d in self.devices]),
                               group=side)
        cards = [c for c, _ in every if c is not None]
        if len(set(cards)) != len(cards):
            raise ValueError(f"two ranks share one card: {cards}; NCCL "
                             "takes one rank a card")
        self.shards = [(r, torch.device(d)) for r, (_, ds) in enumerate(every)
                       for d in ds]

    # --- the five operations -------------------------------------------------

    @trace.spanned("mesh.hop")
    def ppermute(self, values: dict, axis: str, shift: int,
                 src: int | None = None) -> dict:
        """Send each shard's tensors to the shard `shift` steps along
        `axis` (+1 the next, -1 the previous), as jax.lax.ppermute: values
        {i: [tensors]} for this rank's shards. A receiver takes its own
        entry's shapes and dtypes, and a shard with no sender on the axis
        receives zeros. With `src`, only the shards at that position of
        the axis send (one hop of a chain) and only their receivers appear
        in the result. Returns {j: [tensors on j's device]}."""
        pairs = []
        for i in range(self.size):
            if src is not None and self.axis_index(i, axis) != src:
                continue
            j = self._moved(i, axis, shift)
            if j is not None:
                pairs.append((i, j))
        out = {}
        sends, recvs = [], []
        for i, j in pairs:
            mine_i, mine_j = self.owner(i) == self.rank, \
                self.owner(j) == self.rank
            if mine_i and mine_j:
                out[j] = [t.to(self.device(j)) for t in values[i]]
            elif mine_i:
                for k, t in enumerate(values[i]):
                    sends.append(dist.isend(t.contiguous(), self.owner(j),
                                            tag=j * 64 + k))
            elif mine_j:
                bufs = [torch.empty_like(t) for t in values[j]]
                for k, b in enumerate(bufs):
                    recvs.append(dist.irecv(b, self.owner(i), tag=j * 64 + k))
                out[j] = bufs
        for w in sends + recvs:
            w.wait()
        if src is None:
            for j in self.local:
                if j not in out:
                    out[j] = [torch.zeros_like(t) for t in values[j]]
        return out

    @trace.spanned("mesh.hop")
    def psum(self, values: dict, axis: str) -> dict:
        """Sum over `axis` (jax.lax.psum): values {i: tensor} for this
        rank's shards; every member gets the sum, on its device. A rank
        sums its own members in axis order, then the ranks all_reduce."""
        out = {}
        for members in self._axis_groups(axis):
            mine = [i for i in members if i in values]
            if not mine:
                continue
            dev = self.device(mine[0])
            total = values[mine[0]].to(dev)
            for i in mine[1:]:
                total = total + values[i].to(dev)
            group = self._groups.get((axis, members[0]))
            if group is not None:
                total = _all_reduce(total, group)
            for i in mine:
                out[i] = total.to(self.device(i))
        return out

    @trace.spanned("mesh.hop")
    def all_gather(self, values: dict, axis: str, dim: int) -> dict:
        """Concatenate the members' tensors along `dim` in `axis` order;
        every member gets the whole. Across ranks each places its slabs in
        a zero tensor and the sum assembles it (exact: the slabs do not
        overlap)."""
        out = {}
        for members in self._axis_groups(axis):
            mine = [i for i in members if i in values]
            if not mine:
                continue
            group = self._groups.get((axis, members[0]))
            dev = self.device(mine[0])
            if group is None:
                full = torch.cat([values[i].to(dev) for i in members],
                                 dim=dim)
            else:
                t0 = values[mine[0]]
                w = t0.shape[dim]
                shape = list(t0.shape)
                shape[dim] = w * len(members)
                full = torch.zeros(shape, dtype=t0.dtype, device=dev)
                for i in mine:
                    p = members.index(i)
                    full.narrow(dim, p * w, w).copy_(values[i])
                full = _all_reduce(full, group)
            for i in mine:
                out[i] = full.to(self.device(i))
        return out

    @trace.spanned("mesh.hop")
    def process_allgather(self, values: dict, axis: str = "frames"):
        """The ordered gather to every rank (multihost_utils.
        process_allgather): the tensors of the shards at position 0 of the
        other axes, stacked along `axis` in order, on the host. values
        {i: tensor} for this rank's shards, all of one shape and dtype.
        Across ranks the gather is an all_reduce of zero-filled slots."""
        n = self.shape[axis]
        rows = {}
        for i, t in values.items():
            c = self.coords(i)
            if all(x == 0 for a, x in zip(self.axes, c) if a != axis):
                rows[self.axis_index(i, axis)] = t
        if self.world == 1:
            # one pinned buffer, each shard's copy queued on its card
            cuda = {t.device for t in rows.values() if t.is_cuda}
            t0 = rows[0]
            out = torch.empty((n,) + tuple(t0.shape), dtype=t0.dtype,
                              pin_memory=bool(cuda))
            for p in range(n):
                out[p].copy_(rows[p], non_blocking=True)
            for d in cuda:
                torch.cuda.synchronize(d)
            return out
        t0 = next(iter(values.values()))
        # on this rank's device: the CPU on gloo, its card on NCCL
        buf = torch.zeros((n,) + tuple(t0.shape), dtype=t0.dtype,
                          device=self.devices[0])
        for p, t in rows.items():
            buf[p].copy_(t)
        return _all_reduce(buf).cpu()
