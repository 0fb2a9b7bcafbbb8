"""The process mesh of data parallelism: the twin of
``multimodal_fusion_fpn_tpu/parallel/mesh.py``.

The original project's only parallelism is Lightning's ``strategy='dp'``.
The JAX package puts it on a ``jax.sharding.Mesh`` of devices; here each
rank of the mesh is one process (``torchrun --nproc-per-node N``), and
the ``data`` axis is the process group its collectives run over
(:mod:`.comm`).  The ``space`` axis (en-face width sharding with halo
exchanges) is a slice of its own: ``space=M`` with M > 1 raises, and
``space=1`` is a no-op, as ``fused_conv.set_space_sharding`` takes it in
the JAX package.

Mesh spec strings are the JAX package's: ``"data=4"``, ``"data=4,space=1"``.

Each rank loads the same global batch from the same seeded loader and
keeps its rows of it (:func:`shard_batch`), so the data order is the one
process's.  On the card rank r uses ``cuda:LOCAL_RANK``; under ``gloo``
several ranks may share a card (``cuda:LOCAL_RANK % device_count``),
under ``nccl`` they may not: such ranks join a gloo group before
:func:`init_mesh`, as the tests and ``chip_smoke.py`` do.
"""

import dataclasses
import datetime
import os
import re
from typing import Dict, Optional

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
    """The axis sizes, this process's rank on the data axis and the data
    group, and the device this rank computes on."""
    axes: Dict[str, int]
    data: Group
    device: torch.device

    @property
    def rank(self) -> int:
        return self.data.rank

    @property
    def size(self) -> int:
        return self.data.size


def _check_axes(axes: Dict[str, int]) -> None:
    unknown = set(axes) - {"data", "space"}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the axes are "
                         "'data' and 'space'")
    if axes.get("space", 1) > 1:
        raise NotImplementedError(
            f"space={axes['space']}: the space axis (en-face width "
            "sharding with halo exchanges) is the next slice of the port "
            "(ROADMAP Queue 1, the space axis); use data=N")


def make_mesh(spec: Optional[str], group=None,
              device="cpu") -> Mesh:
    """The mesh of ``spec`` over the initialised process group ``group``
    (None: the default group), computing on ``device``."""
    pg = dist.group.WORLD if group is None else group
    size = dist.get_world_size(pg)
    axes = parse_mesh_spec(spec, size)
    _check_axes(axes)
    data = Group(pg=group, rank=dist.get_rank(pg), size=size,
                 backend=dist.get_backend(pg))
    return Mesh(axes=axes, data=data, device=torch.device(device))


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


def shard_batch(batch: Dict, mesh: Mesh, stacked: bool = False) -> Dict:
    """This rank's part of a global batch (``mesh.py:77-90``): a model
    array (5D, or 6D with ``stacked``, whose axis 0 is the micro-batch)
    keeps rows ``[r*B/N, (r+1)*B/N)`` of its batch axis; other values stay
    whole.  Raises when N does not divide B."""
    model_ndim, axis = (6, 1) if stacked else (5, 0)
    n, r = mesh.size, mesh.rank
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", None) == model_ndim:
            b = v.shape[axis]
            if b % n:
                raise ValueError(f"shard_batch: {k} has batch {b}, which "
                                 f"data={n} does not divide")
            rows = slice(r * (b // n), (r + 1) * (b // n))
            v = v[rows] if axis == 0 else v[:, rows]
        out[k] = v
    return out


def shard_state(model: torch.nn.Module, optimizer, mesh: Mesh) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank."""
    tensors = list(model.parameters()) + list(model.buffers())
    for st in optimizer.state.values():
        tensors += [v for v in st.values() if torch.is_tensor(v)]
    broadcast_(tensors, mesh.data)
