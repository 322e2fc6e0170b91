"""Device-mesh parallelism over slots: the port of boda_tpu/parallel/mesh.py.

The JAX package lays a jax.sharding.Mesh over its devices and lets GSPMD
place the collectives. The port's mesh is an array of *slots*
(core/device.local_devices): each process holds BODA_TORCH_LOCAL_DEVICES
slots of its device, and a mesh over several processes (multihost.py) holds
every rank's slots, rank-major. The named-dims tables are the JAX package's:

  * data parallel: the `img` named dim shards over the 'dp' mesh axis;
  * model parallel: a weight's `out_chan` shards over 'mp' when it divides;
  * named dims -> PartitionSpec is a table lookup (spec_for_dims returns
    the same per-dimension axis tuple as JAX's PartitionSpec).

What GSPMD and shard_map inserted for free is written out here as four
collectives over the slots of a mesh axis: all_gather (concatenate the
shards), psum (sum them), pmax (their max) and ppermute (shift values
along the axis). A value laid out over a mesh is a dict {mesh position:
tensor} holding this process's positions. Between slots of one process a
collective is a tensor move, a concatenation, a sum or a max. Between
processes it is one torch.distributed all_gather (gloo) of every slot's
value, through an explicit copy to the host and back; pmax and
sum_over_ranks are one all_reduce each, also through the host. Not
DTensor: its sharding propagation cannot see the kernels' ctypes calls,
and it holds one device per rank, not several slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.error import RtErr
from ..core.timers import timer

# the timer tag (core/timers) of the collectives between processes: the
# host copies and the gloo calls, after the device has finished the work
# the values come from
COLLECTIVE_TIMER = "mesh_collective"

# named dim -> mesh axis mapping for activations/weights
_DIM_TO_AXIS = {
    "img": "dp",
    "out_chan": "mp",
}


@dataclass(frozen=True)
class Slot:
    """One entry of a process's device list: `index` of rank `rank`'s
    slots; `device` is its torch device on its own rank, None on others."""
    rank: int
    index: int
    device: Optional[torch.device]

    def __repr__(self) -> str:
        return f"slot({self.rank}:{self.index}, {self.device})"


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_devices(name: str = "cuda") -> list[Slot]:
    """Every process's slots, rank-major: this process's local_devices(name)
    and, under an initialized process group, every other rank's (each rank
    must hold as many slots; spawned ranks inherit the count)."""
    from ..core.device import local_devices
    here = local_devices(name)
    rank, world = _rank_world()
    if world > 1:
        import torch.distributed as dist
        counts = [None] * world
        dist.all_gather_object(counts, len(here))
        if len(set(counts)) != 1:
            raise RtErr(f"mesh: the ranks hold different slot counts "
                        f"{counts}; give every rank the same "
                        f"BODA_TORCH_LOCAL_DEVICES")
    return [Slot(r, i, here[i] if r == rank else None)
            for r in range(world) for i in range(len(here))]


def _as_slots(devices) -> list[Slot]:
    """Slots as given, or torch devices made into this process's slots."""
    rank, _ = _rank_world()
    out = []
    for i, d in enumerate(devices):
        out.append(d if isinstance(d, Slot)
                   else Slot(rank, i, torch.device(d)))
    return out


class Mesh:
    """An N-d array of slots with one name per axis (jax.sharding.Mesh's
    devices and axis_names)."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.size, dtype=object)
        arr[:] = _as_slots(list(src.reshape(-1)))
        self.devices = arr.reshape(src.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise RtErr(f"mesh: {self.devices.ndim}-d slots with axis names "
                        f"{self.axis_names}")
        self.rank, _ = _rank_world()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def positions(self) -> list[tuple]:
        return list(np.ndindex(self.devices.shape))

    def local_positions(self) -> list[tuple]:
        """The positions whose slot this process holds, in mesh order."""
        return [p for p in self.positions()
                if self.devices[p].rank == self.rank]

    def device(self, pos) -> torch.device:
        d = self.devices[pos].device
        if d is None:
            raise RtErr(f"mesh: position {pos} is a slot of rank "
                        f"{self.devices[pos].rank}, not of this one")
        return d

    def ranks(self) -> list[int]:
        return sorted({s.rank for s in self.devices.reshape(-1)})

    def spans_ranks(self) -> bool:
        return len(self.ranks()) > 1

    def group(self, pos, axis: str) -> list[tuple]:
        """The positions that differ from `pos` along `axis` only, in axis
        order."""
        ax = self.axis_names.index(axis)
        return [pos[:ax] + (k,) + pos[ax + 1:]
                for k in range(self.devices.shape[ax])]

    def coord(self, pos, axis: str) -> int:
        return pos[self.axis_names.index(axis)]

    def group_is_local(self, pos, axis: str) -> bool:
        return all(self.devices[q].rank == self.rank
                   for q in self.group(pos, axis))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (None: replicated), trailing Nones
    dropped: jax.sharding.PartitionSpec's tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              mp: int = 1, devices=None) -> Mesh:
    """Build a 2-D ('dp','mp') mesh over the available slots
    (global_devices: every rank's, rank-major)."""
    if devices is None:
        devices = global_devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if dp is None:
        if n % mp:
            raise RtErr(f"mesh: {n} devices not divisible by mp={mp}")
        dp = n // mp
    if dp * mp != n:
        raise RtErr(f"mesh: dp*mp = {dp}*{mp} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, mp), ("dp", "mp"))


def spec_for_dims(dims, mesh: Mesh, shard_weights: bool = True
                  ) -> PartitionSpec:
    """PartitionSpec for a named-dims tensor: img->dp; out_chan->mp
    (weights, when divisible); everything else replicated."""
    axes = []
    used = set()
    sizes = mesh.shape
    for d in dims:
        ax = _DIM_TO_AXIS.get(d.name)
        if ax is None or ax in used or ax not in sizes:
            axes.append(None)
            continue
        if ax == "mp" and not shard_weights:
            axes.append(None)
            continue
        if sizes[ax] > 1 and d.sz % sizes[ax] == 0:
            axes.append(ax)
            used.add(ax)
        else:
            axes.append(None)
    while axes and axes[-1] is None:
        axes.pop()
    return PartitionSpec(*axes)


def plan_shardings(plan, mesh: Mesh, shard_weights: bool = True):
    """Shardings for a lowered Plan's inputs and weights (dicts of
    NamedSharding keyed by node name)."""
    in_sh = {n: NamedSharding(mesh, spec_for_dims(plan.node_dims[n], mesh,
                                                  shard_weights=False))
             for n in plan.input_nodes}
    w_sh = {n: NamedSharding(mesh, spec_for_dims(plan.node_dims[n], mesh,
                                                 shard_weights=shard_weights))
            for n in plan.weight_nodes}
    return in_sh, w_sh


def shard_of(t, sharding: NamedSharding, pos):
    """The shard of the global tensor t at mesh position pos (a view)."""
    mesh = sharding.mesh
    for i, ax in enumerate(sharding.spec):
        if ax is None:
            continue
        n = mesh.shape[ax]
        sz = t.shape[i] // n
        t = t.narrow(i, mesh.coord(pos, ax) * sz, sz)
    return t


# ---------------------------------------------------------------- collectives

def _to_host_bytes(t: torch.Tensor) -> torch.Tensor:
    # explicit host copy: gloo moves CPU tensors; bytes carry every dtype
    # (bf16, int8) through one all_gather
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()


def exchange(mesh: Mesh, vals: dict) -> dict:
    """Every position's value, from this process's `vals` {local position:
    tensor} and, where the mesh spans processes, every other rank's (one
    gloo all_gather through the host; every value must have one shape and
    dtype). Within one process: `vals` itself."""
    local = mesh.local_positions()
    missing = [p for p in local if p not in vals]
    if missing:
        raise RtErr(f"mesh collective: no value at local position(s) "
                    f"{missing}")
    if not mesh.spans_ranks():
        return dict(vals)
    import torch.distributed as dist
    ref = vals[local[0]]
    if any(vals[p].shape != ref.shape or vals[p].dtype != ref.dtype
           for p in local):
        raise RtErr("mesh collective: local values differ in shape or "
                    "dtype")
    dev = mesh.device(local[0])
    _finish(dev)
    with timer(COLLECTIVE_TIMER):
        mine = torch.cat([_to_host_bytes(vals[p]) for p in local])
        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        out = dict(vals)
        for r, part in enumerate(parts):
            pos_r = [p for p in mesh.positions()
                     if mesh.devices[p].rank == r]
            for p, chunk in zip(pos_r, part.chunk(len(pos_r))):
                if p not in out:
                    out[p] = chunk.to(dev).view(ref.dtype).reshape(
                        ref.shape)
    return out


def _finish(dev: torch.device) -> None:
    """Wait for the device's pending work, so that the collective's timer
    holds the copies and the gloo call alone."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def all_gather(mesh: Mesh, vals: dict, axis: str, dim: int) -> dict:
    """{local position: the values of its `axis` group concatenated along
    `dim`, in axis order}. Within one process a torch.cat (differentiable)
    on each slot's device."""
    full = exchange(mesh, vals)
    return {p: torch.cat([full[q].to(mesh.device(p))
                          for q in mesh.group(p, axis)], dim=dim)
            for p in mesh.local_positions()}


def psum(mesh: Mesh, vals: dict, axis: str) -> dict:
    """{local position: the sum of its `axis` group's values}."""
    full = exchange(mesh, vals)
    out = {}
    for p in mesh.local_positions():
        grp = [full[q].to(mesh.device(p)) for q in mesh.group(p, axis)]
        acc = grp[0]
        for v in grp[1:]:
            acc = acc + v
        out[p] = acc
    return out


def pmax(mesh: Mesh, vals: dict, axis: str) -> dict:
    """{local position: the elementwise max of its `axis` group's values,
    NaN where one holds NaN} (lax.pmax). Within one process one
    torch.maximum chain per group on its first slot's device, with no host
    wait. Across processes one gloo all_reduce(MAX) through an explicit
    host copy: each rank puts its positions' values into a [positions,
    numel] buffer of -inf, beside a NaN flag for each value (gloo's max
    does not keep NaN), and reads its groups' maxima from the reduced
    buffer. Calls counted in pmax.calls."""
    pmax.calls += 1
    local = mesh.local_positions()
    if not mesh.spans_ranks():
        out = {}
        for p in local:
            if p not in out:
                grp = mesh.group(p, axis)
                dev = mesh.device(grp[0])
                acc = vals[grp[0]]
                for q in grp[1:]:
                    acc = torch.maximum(acc, vals[q].to(dev))
                out.update({q: acc.to(mesh.device(q)) for q in grp})
        return out
    import torch.distributed as dist
    ref = vals[local[0]]
    pos = mesh.positions()
    dev = mesh.device(local[0])
    _finish(dev)
    with timer(COLLECTIVE_TIMER):
        buf = torch.full((len(pos), 2, ref.numel()), float("-inf"),
                         dtype=torch.float64)
        for p in local:
            v = vals[p].detach().reshape(-1).double().cpu()
            buf[pos.index(p), 0] = v.nan_to_num(nan=float("-inf"))
            buf[pos.index(p), 1] = v.isnan().double()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        out = {}
        for p in local:
            g = buf[[pos.index(q) for q in mesh.group(p, axis)]].amax(0)
            m = torch.where(g[1] > 0, float("nan"), g[0])
            out[p] = m.reshape(ref.shape).to(device=mesh.device(p),
                                             dtype=ref.dtype)
    return out


pmax.calls = 0


def ppermute(mesh: Mesh, vals: dict, axis: str, perm) -> dict:
    """Shift along `axis`: the value at axis coordinate src moves to dst for
    each (src, dst) of perm; a position no pair sends to gets zeros
    (lax.ppermute)."""
    full = exchange(mesh, vals)
    src_of = {dst: src for src, dst in perm}
    out = {}
    for p in mesh.local_positions():
        k = mesh.coord(p, axis)
        if k in src_of:
            q = mesh.group(p, axis)[src_of[k]]
            out[p] = full[q].to(mesh.device(p))
        else:
            out[p] = torch.zeros_like(vals[p])
    return out


def sum_over_ranks(mesh: Mesh, tensors: dict) -> dict:
    """{name: tensor} summed over the processes the mesh spans: one gloo
    all_reduce of the f32 values, through an explicit host copy. Within one
    process: the tensors as they are."""
    if not mesh.spans_ranks():
        return tensors
    import torch.distributed as dist
    names = sorted(tensors)
    if names:
        _finish(tensors[names[0]].device)
    with timer(COLLECTIVE_TIMER):
        flat = torch.cat([tensors[n].detach().float().reshape(-1).cpu()
                          for n in names])
        dist.all_reduce(flat)
        out = {}
        off = 0
        for n in names:
            t = tensors[n]
            out[n] = flat[off:off + t.numel()].reshape(t.shape).to(
                device=t.device, dtype=t.dtype)
            off += t.numel()
    return out
