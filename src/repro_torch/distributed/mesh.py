"""Mesh axis conventions, the world of ranks, and meshes over it.

Twin of ``repro.distributed.mesh``. The axis names are the reference's:

  pod    — cross-pod data parallelism (the slow, WAN-like hop)
  data   — intra-pod data parallelism
  model  — tensor parallelism

The port is multi-controller, PyTorch's idiom: one process a device, and a
``torch.distributed`` process group a mesh axis. ``init_world`` joins this
process to its world (NCCL for the card, gloo for the host: the backend
follows from the device asked for, never from what is installed).
``make_mesh`` over one device is a plain ``Mesh`` of this process; over
more it lays the axes row-major over the world's ranks (as
``jax.make_mesh`` does) with ``init_device_mesh``, and this rank runs on
``cuda:{LOCAL_RANK}`` (or the host). A mesh larger than the world raises
``RuntimeError``, as the reference's ``launch.train.parse_mesh`` does. The
mesh also holds a process group over its batch axes (pod x data): the ranks
that share this rank's ``model`` index, over which gradients are meaned;
and a group over every other set of two or more of its axes over 1
(``Mesh.group_over``): the ranks over which a decode cache's time dim is
cut at a batch that pod x data does not divide.

The sharding rules are the reference's (``_RULES``, ``spec``,
``batch_spec``), with ``PartitionSpec`` a tuple of mesh axes a dim.
``shard`` is the port's ``device_put(x, NamedSharding(mesh, spec))``: it
cuts this rank's block out of a whole tensor along every dim whose entry
names a mesh axis (an entry that is a tuple of axes row-major over them),
and ``gather`` puts the whole tensor back together. Params specs name
``data`` (ZeRO-3: the ``d_model`` dim of every weight) and ``model``
(tensor parallelism). The ``shard_map`` shims of the reference have no
counterpart.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
from typing import Any

import torch
import torch.distributed as dist

POD, DATA, MODEL = "pod", "data", "model"

# A hung ring raises after this long instead of waiting forever.
WORLD_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over ranks. ``devices`` holds what this process drives
    (its one device); ``device_mesh`` is the world's ``DeviceMesh``, None on
    a mesh of one device."""

    shape: dict[str, int]
    devices: tuple[torch.device, ...]
    device_mesh: Any = None
    batch_group: Any = None      # the pod x data group through this rank (None: the world's)
    axis_groups: Any = None      # frozenset of axes -> their group through this rank

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None on a mesh
        of one device)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def group_over(self, axes):
        """The process group of the ranks that share this rank's index on
        every axis but ``axes``: one axis's own group, the world's (None)
        where ``axes`` holds every axis over 1 (and on a mesh of one
        device), else the one ``make_mesh`` created for the set."""
        over = {a for a in self.axis_names if self.shape[a] > 1}
        axes = frozenset(a for a in axes if a in over)
        if self.device_mesh is None or axes == over:
            return None
        if len(axes) == 1:
            return self.group(next(iter(axes)))
        return self.axis_groups[axes]

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 off the mesh's axes)."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)


def available_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh may use: every card for "cuda", one host for "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available "
                "(pass device='cpu' to run on the host)")
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return [dev]


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(device="cuda", init_method: str = "env://") -> int:
    """Join this process to its world and return the world's size.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (the variables
    ``python -m torch.distributed.run`` sets). The backend is NCCL for
    "cuda", with this rank bound to ``cuda:{LOCAL_RANK}`` before the first
    operation, and gloo for "cpu". Every operation of the world times out
    after ``WORLD_TIMEOUT``. A world that is already up is kept, if its
    backend is the device's."""
    available_devices(device)
    want = _backend(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"this world runs {have}; device {device!r} needs {want}")
        return dist.get_world_size()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    kw = {}
    if want == "nccl":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(local)
        kw["device_id"] = local
    dist.init_process_group(want, init_method=init_method, rank=rank, world_size=world,
                            timeout=WORLD_TIMEOUT, **kw)
    return world


def world_size(device="cuda") -> int:
    """Ranks in this process's world: the initialised world's, after joining
    the one ``python -m torch.distributed.run`` describes (``WORLD_SIZE``);
    else 1, this process."""
    available_devices(device)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_world(device)
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0 of the world, or a process outside any world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(axis_shapes, axis_names, *, devices=None, device="cuda") -> Mesh:
    """A ``Mesh`` of ``axis_shapes`` named ``axis_names``: over one device,
    the first of ``devices`` (by default of ``device``); over more, the
    world's ranks, one device each."""
    shapes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shapes) != len(names):
        raise ValueError(f"{len(shapes)} axis sizes for {len(names)} names")
    n = math.prod(shapes)
    if n == 1:
        devs = list(devices) if devices is not None else available_devices(device)
        if not devs:
            raise RuntimeError(f"mesh {shapes} needs 1 device, have 0")
        return Mesh(dict(zip(names, shapes)), (torch.device(devs[0]),))
    world = world_size(device)
    if world < n:
        raise RuntimeError(f"mesh {shapes} needs {n} devices, have {world}")
    if world != n:
        raise RuntimeError(f"mesh {shapes} of {n} ranks in a world of {world}: "
                           "a mesh spans the whole world")
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(dev.type, shapes, mesh_dim_names=names)
    return Mesh(dict(zip(names, shapes)), (dev,), dm, _batch_group(shapes, names),
                _axis_groups(shapes, names))


def _batch_group(shapes: tuple[int, ...], names: tuple[str, ...]):
    """The group of the ranks that share this rank's index on every axis
    but pod and data (the world's, None, when those are the only axes over
    1). Every rank creates every such group, in the same order, as
    ``dist.new_group`` requires."""
    rest = [i for i, n in enumerate(names) if n not in (POD, DATA)]
    if all(shapes[i] == 1 for i in rest):
        return None
    coords = list(itertools.product(*(range(s) for s in shapes)))   # row-major ranks
    me, mine = dist.get_rank(), None
    for key in itertools.product(*(range(shapes[i]) for i in rest)):
        ranks = [r for r, c in enumerate(coords) if tuple(c[i] for i in rest) == key]
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def _axis_groups(shapes: tuple[int, ...], names: tuple[str, ...]) -> dict:
    """For every set of two or more axes over 1 short of all of them, the
    group of the ranks that share this rank's index on every other axis
    (none on a mesh with at most two axes over 1: such a set is the
    world). Every rank creates every such group, in the same order."""
    over = [i for i, s in enumerate(shapes) if s > 1]
    coords = list(itertools.product(*(range(s) for s in shapes)))   # row-major ranks
    me, mine = dist.get_rank(), {}
    for k in range(2, len(over)):
        for subset in itertools.combinations(over, k):
            rest = [i for i in range(len(shapes)) if i not in subset]
            for key in itertools.product(*(range(shapes[i]) for i in rest)):
                ranks = [r for r, c in enumerate(coords) if tuple(c[i] for i in rest) == key]
                group = dist.new_group(ranks)
                if me in ranks:
                    mine[frozenset(names[i] for i in subset)] = group
    return mine


# ---------------------------------------------------------------------------
# sharding rules (the reference's) and this rank's blocks of whole tensors
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """One entry a dim: a mesh axis, a tuple of axes, or None (whole)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# logical dim -> mesh axis (None = replicate)
_RULES: dict[str, str | None] = {
    "batch": DATA,         # + pod, applied by batch_spec()
    "seq": None,           # sequence sharding is opt-in (context parallelism)
    "embed": None,         # activations' feature dim stays unsharded
    "vocab": MODEL,
    "heads": MODEL,
    "kv_heads": MODEL,
    "head_dim": None,
    "ffn": MODEL,
    "experts": MODEL,
    "expert_ffn": None,
    "fsdp": DATA,          # parameter dim chosen for ZeRO-3 sharding
    "state": None,         # SSM / RG-LRU recurrent state dim
    "conv": None,
}


def spec(*logical: str | None) -> PartitionSpec:
    """PartitionSpec from logical dim names, e.g. spec('fsdp','ffn')."""
    axes = []
    for name in logical:
        if name is None:
            axes.append(None)
        else:
            axes.append(_RULES.get(name, None) if isinstance(name, str) else name)
    return P(*axes)


def batch_spec(mesh: Mesh, *, seq_sharded: bool = False) -> PartitionSpec:
    """(batch, seq, ...) activation spec: batch over pod+data when present."""
    batch_axes = tuple(a for a in (POD, DATA) if a in mesh.axis_names)
    b = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    return P(b, MODEL if seq_sharded else None)


def _entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (None: none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def model_dims(pspec) -> list[int]:
    """The dims of ``pspec`` whose entry names the ``model`` axis."""
    return [i for i, e in enumerate(pspec) if MODEL in _entry_axes(e)]


def data_dims(pspec) -> list[int]:
    """The dims of ``pspec`` whose entry names the ``data`` axis (ZeRO-3)."""
    return [i for i, e in enumerate(pspec) if DATA in _entry_axes(e)]


def entry_cut(mesh: Mesh, entry) -> tuple[str, ...]:
    """The axes over 1 that one spec entry cuts its dim over, in the
    entry's order: the dim is cut row-major over them (``shard``)."""
    return tuple(a for a in _entry_axes(entry) if axis_size(mesh, a) > 1)


def block_index(mesh: Mesh, axes) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim cut row-major
    over ``axes``, the first axis outermost."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.rank(a)
        n *= axis_size(mesh, a)
    return idx, n


def cut_axes(mesh: Mesh, pspec) -> tuple[str, ...]:
    """The mesh axes over 1 that cut a leaf of ``pspec``, in mesh order."""
    named = {a for e in pspec for a in _entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a in named and mesh.shape[a] > 1)


def shard(mesh: Mesh, x: torch.Tensor, pspec) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``pspec``: cut
    along every dim whose entry names a mesh axis, row-major over the axes
    of a tuple entry, as ``device_put`` cuts it (a view; ``x`` itself where
    nothing is cut). A dim that does not split evenly raises ``ValueError``."""
    for d, e in enumerate(pspec):
        axes = entry_cut(mesh, e)
        if not axes:
            continue
        idx, n = block_index(mesh, axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over {n} ranks")
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` = the group's contiguous ``x`` stacked along dim 0, in rank
    order (``all_gather_single``, ``all_gather_into_tensor``'s new name
    where torch has it)."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` = this rank's block along dim 0 of the group's contiguous
    ``x``, summed (``reduce_scatter_single``, ``reduce_scatter_tensor``'s
    new name where torch has it)."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def gather(mesh: Mesh, x: torch.Tensor, pspec) -> torch.Tensor:
    """The whole tensor of this rank's block ``x`` under ``pspec``: the
    inverse of ``shard``, an all-gather a cut dim over the group of each
    axis it names, the innermost axis of a tuple entry first (every rank of
    each group calls it, in the same order)."""
    for d, e in enumerate(pspec):
        for a in reversed(_entry_axes(e)):
            n = axis_size(mesh, a)
            if n == 1:
                continue
            blocks = x.movedim(d, 0).contiguous()
            out = blocks.new_empty((n * blocks.shape[0], *blocks.shape[1:]))
            all_gather_into(out, blocks, mesh.group(a))
            x = out.movedim(0, d)
    return x.contiguous()


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolved parallelism plan for a given mesh."""

    mesh: Mesh

    @property
    def n_pods(self) -> int:
        return axis_size(self.mesh, POD)

    @property
    def dp(self) -> int:
        return axis_size(self.mesh, DATA)

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, MODEL)

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def describe(self) -> str:
        return (
            f"mesh{tuple(self.mesh.shape.values())} axes={self.mesh.axis_names} "
            f"pods={self.n_pods} dp={self.dp} tp={self.tp} devices={self.n_devices}"
        )
