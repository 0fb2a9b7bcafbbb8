"""The collectives of the process mesh, over one process group each.

Every collective the port runs goes through this module:

  * :func:`all_reduce_sum`, differentiable: its backward is the sum
    all-reduce of the cotangent.  Every rank of a synced step computes the
    same global loss from all-reduced sums, so the backward computes the
    gradient of the sum of the group's equal copies of the loss: each
    rank's gradient comes out as ``size`` times its share of the global
    gradient, and the mean all-reduce of the gradients
    (:func:`all_reduce_mean_`) is the global gradient exactly.  The
    backwards of :func:`halo_x` and :func:`gather_cols` return each
    cotangent to the rank it came from, which keeps that factor;
  * :func:`all_reduce_mean_`, in place, for the gradients and the running
    statistics;
  * :func:`all_gather`, in rank order along an axis;
  * :func:`broadcast_`, in place, from one rank;
  * :func:`halo_x`, differentiable: a shard of the en-face width with its
    neighbours' boundary columns on either side, point to point;
  * :func:`gather_cols`, differentiable: the space group's shards
    concatenated along one axis.

The backend is the group's and is chosen by the caller: ``nccl`` on the
card, ``gloo`` on the CPU or where several ranks share one card.  Nothing
here switches backends.  Under ``gloo`` a CUDA tensor is staged through
the host (copied to the CPU, reduced there, copied back): gloo's CUDA
support differs between builds, and the host copy is what it would do
anyway.  ``nccl`` takes the CUDA tensors as they are.

A collective over a group of one rank is the identity and calls nothing.

:func:`sharded` says where this rank's tensors sit in the global batch
(:class:`Shards`, read through :func:`shards`): ``rows``, the data group
whose shards are one batch (synced BatchNorm); ``cols``, the space group
whose shards split the en-face width X; ``total``, the group a sum over
the global batch runs over (the world under both, else the one that is
set).  ``models.blocks`` (the BatchNorm sums, the halos, the dropout
masks), ``losses``, ``metrics.device`` and the alignments of the 2D maps
read it.
"""

import contextlib
import dataclasses
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group with this process's rank in it and its size;
    ``pg`` None is the default group.  ``ranks``: the members' global
    ranks in group order (the peers of :func:`halo_x`)."""
    pg: Any
    rank: int
    size: int
    backend: str
    ranks: Tuple[int, ...] = ()


def _staged(group: Group, t: torch.Tensor) -> bool:
    return group.backend == "gloo" and t.device.type != "cpu"


def _all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over the group."""
    if group.size == 1:
        return t.detach().clone()
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
    if group.size == 1:
        return
    for ts in _flat_by_dtype(tensors):
        flat = _all_reduce(torch.cat([t.reshape(-1) for t in ts]), group)
        flat /= group.size
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_gather(t: torch.Tensor, group: Group, axis: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``axis`` in rank order (every
    rank's ``t`` has the same shape)."""
    src = t.detach().contiguous()
    if group.size == 1:
        return src.clone()
    if _staged(group, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim=axis).to(t.device)


def broadcast_(tensors: Sequence[torch.Tensor], group: Group,
               src: int = 0) -> None:
    """Each tensor replaced by rank ``src``'s (its rank in the group)."""
    if group.size == 1:
        return
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


# Bytes this process has sent point to point since the last reset (the
# halos of halo_x and their cotangents)
sent = {"halo_x": 0}


def _exchange(sends, group: Group):
    """Point-to-point: ``sends`` is [(group rank, tensor)], one tensor to
    each peer, and each peer sends back one tensor of the same shape; the
    received tensors in the order of ``sends``.  One batch of isend /
    irecv (a send and a receive between two ranks are posted together,
    which nccl needs); under gloo CUDA tensors go through the host."""
    if not sends:
        return []
    staged = _staged(group, sends[0][1])
    out, ops = [], []
    for peer, t in sends:
        t = t.contiguous()
        sent["halo_x"] += t.numel() * t.element_size()
        if staged:
            t = t.cpu()
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, group.ranks[peer], group.pg),
                dist.P2POp(dist.irecv, buf, group.ranks[peer], group.pg)]
        out.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [buf.to(sends[0][1].device) if staged else buf for buf in out]


def _halo(t: torch.Tensor, h: int, group: Group, axis: int):
    """(left, right): the ``h`` columns along ``axis`` that the left
    neighbour's shard ends with and the right neighbour's begins with,
    zeros at the true edges (``fused_conv.py:864-875``)."""
    r, n = group.rank, group.size
    sends, sides = [], []
    if r > 0:
        sends.append((r - 1, t.narrow(axis, 0, h)))
        sides.append("left")
    if r < n - 1:
        sends.append((r + 1, t.narrow(axis, t.shape[axis] - h, h)))
        sides.append("right")
    got = dict(zip(sides, _exchange(sends, group)))
    shape = list(t.shape)
    shape[axis] = h
    return tuple(got[s] if s in got else t.new_zeros(shape)
                 for s in ("left", "right"))


class _HaloX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, h, group, axis):
        ctx.conf = (h, group, axis)
        left, right = _halo(t, h, group, axis)
        return torch.cat([left, t, right], dim=axis)

    @staticmethod
    def backward(ctx, g):
        h, group, axis = ctx.conf
        r, n = group.rank, group.size
        w = g.shape[axis] - 2 * h
        dt = g.narrow(axis, h, w).clone()
        # each halo's cotangent goes back to the neighbour it came from,
        # which adds it to its boundary columns: what this rank receives
        # from the left belongs to its first columns, from the right to
        # its last
        sends, sides = [], []
        if r > 0:
            sends.append((r - 1, g.narrow(axis, 0, h)))
            sides.append(0)
        if r < n - 1:
            sends.append((r + 1, g.narrow(axis, h + w, h)))
            sides.append(w - h)
        for start, back in zip(sides, _exchange(sends, group)):
            dt.narrow(axis, start, h).add_(back)
        return dt, None, None, None


def halo_x(t: torch.Tensor, h: int, group: Group,
           axis: int = 2) -> torch.Tensor:
    """This rank's shard ``t`` of the width along ``axis`` (X of a
    (B, Y, X, Z, C) volume) with the ``h`` neighbouring columns of the
    group's neighbours on each side: (..., X + 2h, ...).  The halos at
    the true edges are zero, so a SAME conv on the result, cropped by its
    padding, is the whole tensor's conv sliced.  The backward sends each
    halo's cotangent back to its owner and adds it there."""
    if h <= 0:
        return t
    return _HaloX.apply(t.contiguous(), h, group, axis)


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, axis):
        ctx.conf = (group, axis, t.shape[axis])
        return all_gather(t, group, axis)

    @staticmethod
    def backward(ctx, g):
        group, axis, n = ctx.conf
        whole = _all_reduce(g.contiguous(), group)
        return whole.narrow(axis, group.rank * n, n).contiguous(), None, None


def gather_cols(t: torch.Tensor, group: Group, axis: int) -> torch.Tensor:
    """The group's shards concatenated along ``axis`` in rank order,
    differentiable: the backward sums the cotangents of the whole over
    the group and keeps this rank's columns."""
    return _GatherCols.apply(t, group, axis)


@dataclasses.dataclass(frozen=True)
class Shards:
    """Where this rank's tensors sit in the global batch (module note)."""
    rows: Optional[Group] = None
    cols: Optional[Group] = None
    total: Optional[Group] = None


_SHARDS: List[Shards] = []


@contextlib.contextmanager
def sharded(layout: Shards) -> Iterator[Shards]:
    """Inside, the model's batch statistics, losses, dropout masks and
    metrics are those of the global batch that ``layout`` places this
    rank's shard in (module note)."""
    _SHARDS.append(layout)
    try:
        yield layout
    finally:
        _SHARDS.pop()


def shards() -> Shards:
    """The layout of the innermost :func:`sharded`; outside, one process
    (every field None)."""
    return _SHARDS[-1] if _SHARDS else Shards()


def space_group() -> Optional[Group]:
    """The space group of the innermost :func:`sharded`, or None."""
    return shards().cols


def across_cols(fn, x: torch.Tensor, out_sizes, axes, col_axis: int):
    """``fn(x, out_sizes, axes)`` of an op that resizes along ``axes``
    one axis at a time (``ops.interpolate.linear_resize``,
    ``ops.pooling.adaptive_max_pool``) under the space group: where the
    op keeps the sharded ``col_axis``'s size it is local; where it resizes
    it, it mixes columns of other ranks, so it runs on the gathered whole
    width and keeps this rank's slice."""
    group = space_group()
    sizes = dict(zip(axes, (int(o) for o in out_sizes)))
    if group is None or sizes.get(col_axis, x.shape[col_axis]) == \
            x.shape[col_axis]:
        return fn(x, out_sizes, axes)
    n = sizes[col_axis]
    sizes[col_axis] = n * group.size
    y = fn(gather_cols(x, group, col_axis), [sizes[a] for a in axes], axes)
    return y.narrow(col_axis, group.rank * n, n)
