"""The collectives of data parallelism, over one process group.

Every collective the port runs goes through this module:

  * :func:`all_reduce_sum`, differentiable: its backward is the sum
    all-reduce of the cotangent.  Every rank of a synced step computes the
    same global loss from all-reduced sums, so each rank's gradient comes
    out as ``size`` times its share of the global gradient, and the mean
    all-reduce of the gradients (:func:`all_reduce_mean_`) is the global
    gradient exactly;
  * :func:`all_reduce_mean_`, in place, for the gradients and the running
    statistics;
  * :func:`all_gather`, in rank order along the first axis;
  * :func:`broadcast_`, in place, from one rank.

The backend is the group's and is chosen by the caller: ``nccl`` on the
card, ``gloo`` on the CPU or where several ranks share one card.  Nothing
here switches backends.  Under ``gloo`` a CUDA tensor is staged through
the host (copied to the CPU, reduced there, copied back): gloo's CUDA
support differs between builds, and the host copy is what it would do
anyway.  ``nccl`` takes the CUDA tensors as they are.

:func:`synced` makes a group the one the model's BatchNorm statistics,
the losses and the dropout masks are reduced over (:func:`sync_group`):
``models.blocks.BNFold.folded``, ``losses.dice_loss_joint`` /
``losses.bce_loss`` and ``models.blocks.dropout`` read it.
"""

import contextlib
import dataclasses
from typing import Any, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group with this process's rank in it and its size;
    ``pg`` None is the default group."""
    pg: Any
    rank: int
    size: int
    backend: str


def _staged(group: Group, t: torch.Tensor) -> bool:
    return group.backend == "gloo" and t.device.type != "cpu"


def _all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over the group."""
    if _staged(group, t):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group.pg)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group.pg)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group, differentiable (module note)."""
    return _AllReduceSum.apply(t.contiguous(), group)


def _flat_by_dtype(tensors: Sequence[torch.Tensor]):
    by = {}
    for t in tensors:
        by.setdefault(t.dtype, []).append(t)
    return by.values()


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Each tensor replaced by its mean over the group; one collective
    per dtype."""
    for ts in _flat_by_dtype(tensors):
        flat = _all_reduce(torch.cat([t.reshape(-1) for t in ts]), group)
        flat /= group.size
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along axis 0 in rank order (every
    rank's ``t`` has the same shape)."""
    src = t.detach().contiguous()
    staged = _staged(group, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts).to(t.device)


def broadcast_(tensors: Sequence[torch.Tensor], group: Group,
               src: int = 0) -> None:
    """Each tensor replaced by rank ``src``'s (its rank in the group)."""
    for ts in _flat_by_dtype(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if _staged(group, flat):
            flat = flat.cpu()
        dist.broadcast(flat, group_src=src, group=group.pg)
        off = 0
        for t in ts:
            with torch.no_grad():
                t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


# the groups that batch statistics and losses are reduced over, innermost
# last (synced)
_SYNCED: List[Group] = []


@contextlib.contextmanager
def synced(group: Group) -> Iterator[Group]:
    """Inside, the model's batch statistics, losses and dropout masks are
    those of the group's global batch (module note)."""
    _SYNCED.append(group)
    try:
        yield group
    finally:
        _SYNCED.pop()


def sync_group() -> Optional[Group]:
    """The group of the innermost :func:`synced`, or None."""
    return _SYNCED[-1] if _SYNCED else None
