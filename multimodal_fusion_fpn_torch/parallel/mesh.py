"""The process mesh: the twin of ``multimodal_fusion_fpn_tpu/parallel/
mesh.py``.

The original project's only parallelism is Lightning's ``strategy='dp'``.
The JAX package puts it on a ``jax.sharding.Mesh`` of devices with a
``data`` axis (the batch) and a ``space`` axis (the en-face width X); here
each rank of the mesh is one process (``torchrun --nproc-per-node N*M``).
Rank r sits at data index ``r // M`` and space index ``r % M``, the JAX
package's device order (``make_mesh`` reshapes the devices to (data,
space), ``mesh.py:44-50``).  Its groups (:mod:`.comm`): ``data``, the
ranks that share its space index; ``space``, the ranks that share its data
index; ``world``, all of them.  Every rank makes every group, in the same
order.

Mesh spec strings are the JAX package's: ``"data=4"``, ``"data=2,space=2"``.

Each rank loads the same global batch from the same seeded loader and
keeps its rows and its X columns of it (:func:`shard_batch`), so the data
order is the one process's.  On the card rank r uses ``cuda:LOCAL_RANK``;
under ``gloo`` several ranks may share a card (``cuda:LOCAL_RANK %
device_count``), under ``nccl`` they may not: such ranks join a gloo group
before :func:`init_mesh`, as the tests and ``chip_smoke.py`` do.
"""

import dataclasses
import datetime
import os
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimodal_fusion_fpn_torch.parallel.comm import Group, broadcast_


def _spec_axes(spec: str) -> Dict[str, int]:
    axes = {}
    for part in spec.split(","):
        m = re.fullmatch(r"\s*(\w+)\s*=\s*(\d+)\s*", part)
        if not m:
            raise ValueError(f"Bad mesh spec: {spec!r}")
        axes[m.group(1)] = int(m.group(2))
    return axes


def parse_mesh_spec(spec: Optional[str], n_devices: int) -> Dict[str, int]:
    """``mesh.py:28-41``: the axis sizes of ``spec`` (all ranks on the data
    axis when empty); raises ValueError on a malformed spec or one whose
    size is not ``n_devices``."""
    if not spec:
        return {"data": n_devices}
    axes = _spec_axes(spec)
    total = int(np.prod(list(axes.values())))
    if total != n_devices:
        raise ValueError(f"Mesh {axes} needs {total} devices, "
                         f"have {n_devices}")
    return axes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axis sizes, this process's groups (module note) and the device
    this rank computes on."""
    axes: Dict[str, int]
    world: Group
    data: Group
    space: Group
    device: torch.device

    @property
    def rank(self) -> int:
        return self.world.rank


def _check_axes(axes: Dict[str, int]) -> None:
    unknown = set(axes) - {"data", "space"}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the axes are "
                         "'data' and 'space'")


def _group(pg, members: Sequence[int], world: Group) -> Group:
    """The Group of ``members`` (world ranks) that this rank belongs to."""
    return Group(pg=pg, rank=members.index(world.rank), size=len(members),
                 backend=world.backend,
                 ranks=tuple(world.ranks[m] for m in members))


def make_mesh(spec: Optional[str], group=None,
              device="cpu") -> Mesh:
    """The mesh of ``spec`` over the initialised process group ``group``
    (None: the default group), computing on ``device``.  An axis of size
    1 gets a group of this rank alone, an axis as large as the mesh the
    mesh's group; with both axes above 1 every rank makes the groups of
    both axes (``dist.new_group``, in one order), and ``group`` must be
    the default group."""
    pg = dist.group.WORLD if group is None else group
    size = dist.get_world_size(pg)
    axes = parse_mesh_spec(spec, size)
    _check_axes(axes)
    world = Group(pg=group, rank=dist.get_rank(pg), size=size,
                  backend=dist.get_backend(pg),
                  ranks=tuple(dist.get_process_group_ranks(pg)))
    n, m = axes.get("data", 1), axes.get("space", 1)
    d, s = divmod(world.rank, m)
    data_members = {i: list(range(i, size, m)) for i in range(m)}
    space_members = {i: list(range(i * m, (i + 1) * m)) for i in range(n)}
    if n > 1 and m > 1:
        if group is not None:
            raise ValueError(f"mesh {axes}: both axes above 1 need the "
                             "default process group")
        made = {(axis, i): dist.new_group(v)
                for axis, members in (("data", data_members),
                                      ("space", space_members))
                for i, v in members.items()}
        data_pg, space_pg = made[("data", s)], made[("space", d)]
    else:
        data_pg = group if n > 1 else None
        space_pg = group if m > 1 else None
    data = (_group(data_pg, data_members[s], world) if n > 1
            else _group(None, [world.rank], world))
    space = (_group(space_pg, space_members[d], world) if m > 1
             else _group(None, [world.rank], world))
    return Mesh(axes=axes, world=world, data=data, space=space,
                device=torch.device(device))


# Rank 0 validates alone while the other ranks wait in one broadcast
# (``train.trainer``): a collective may wait for a whole validation epoch.
COLLECTIVE_TIMEOUT = datetime.timedelta(hours=2)


def init_mesh(spec: Optional[str], device="cuda") -> Mesh:
    """The mesh of ``spec`` over this run's processes.  The process group
    is the one already initialised, else one made from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) over nccl on the card and gloo on the CPU, with
    :data:`COLLECTIVE_TIMEOUT`.  On the card the rank computes on
    ``cuda:LOCAL_RANK`` (module note)."""
    if spec:
        _check_axes(_spec_axes(spec))
        if not dist.is_initialized():
            # a mesh the processes cannot fill is refused before a group
            parse_mesh_spec(spec, int(os.environ.get("WORLD_SIZE", 1)))
    on_cpu = torch.device(device).type == "cpu"
    backend = (dist.get_backend() if dist.is_initialized()
               else "gloo" if on_cpu else "nccl")
    if on_cpu:
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: use gloo")
        dev = torch.device("cpu")
    else:
        local = int(os.environ.get("LOCAL_RANK", 0))
        count = torch.cuda.device_count()
        if local >= count and backend == "nccl":
            raise RuntimeError(
                f"nccl: local rank {local} has no card of its own "
                f"({count} visible); several ranks share a card only "
                "under gloo")
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=COLLECTIVE_TIMEOUT,
                                **({"device_id": dev}
                                   if backend == "nccl" else {}))
    return make_mesh(spec, device=dev)


def _part(v, axis: int, group: Group, what: str):
    """Rank ``group.rank``'s equal part of ``v`` along ``axis``."""
    n = v.shape[axis]
    if n % group.size:
        raise ValueError(f"shard_batch: {what} {n}, which "
                         f"{group.size} ranks do not divide")
    k = n // group.size
    index = [slice(None)] * v.ndim
    index[axis] = slice(group.rank * k, (group.rank + 1) * k)
    return v[tuple(index)]


def shard_batch(batch: Dict, mesh: Mesh, stacked: bool = False) -> Dict:
    """This rank's part of a global batch (``batch_sharding``,
    ``mesh.py:53-90``): a model array (5D, or 6D with ``stacked``, whose
    axis 0 is the micro-batch) keeps rows ``[d*B/N, (d+1)*B/N)`` of its
    batch axis and columns ``[s*W/M, (s+1)*W/M)`` of its last axis, the
    en-face width of the reference layout ((B, 1, D, H, W), (B, 1, H_ef,
    1, W)); other values stay whole.  Raises when N does not divide B or M
    does not divide W."""
    model_ndim, axis = (6, 1) if stacked else (5, 0)
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", None) == model_ndim:
            v = _part(v, axis, mesh.data, f"{k} has batch")
            v = _part(v, model_ndim - 1, mesh.space, f"{k} has width")
        out[k] = v
    return out


def check_widths(batch: Dict, mesh: Mesh, windows: Sequence[int],
                 keys: Sequence[str]) -> None:
    """Raise ValueError, naming the level and the widths, where the
    en-face width of an input in ``keys`` does not split over the space
    axis at every level of a pyramid whose pools have the X windows
    ``windows``: each rank pools its own columns (stride == window, the
    JAX package's ``pool.py:208-216``), so every level's width must be a
    multiple of M times the pool's window, and the deepest level's of M.
    (The JAX package pads such widths through GSPMD; the port does not.)"""
    m = mesh.space.size
    if m == 1:
        return
    for k in keys:
        v = batch.get(k)
        if getattr(v, "ndim", 0) < 5:
            continue
        w = v.shape[-1] * m
        for level, win in enumerate(list(windows) + [1]):
            if w % (m * win):
                raise ValueError(
                    f"space={m}: {k} is {v.shape[-1] * m} wide, so level "
                    f"{level + 1} is {w} wide, which is not a multiple of "
                    f"space {m} x its pool window {win}; the widths of "
                    f"every level must split evenly")
            w //= win


def shard_state(model: torch.nn.Module, optimizer, mesh: Mesh) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank."""
    tensors = list(model.parameters()) + list(model.buffers())
    for st in optimizer.state.values():
        tensors += [v for v in st.values() if torch.is_tensor(v)]
    broadcast_(tensors, mesh.world)
