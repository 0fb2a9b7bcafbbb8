"""Ops over the TRUE extents of data held in zero-padded buffers (exact
shape bucketing), ``multimodal_fusion_fpn_tpu/ops/dynamic_extent.py:25-162``.

Bucketed serving pads every volume to bucket multiples and carries its
true extents beside it; these are the size-dependent ops that must see the
true extents instead of the padded ones: masking, the masked mean, the
adaptive max pool and the linear resize of the 2D-skip alignment, and the
nearest-upsample index map.  Each computes over the true extents what its
static twin (``ops/pooling.py``, ``ops/interpolate.py``,
``ops/upsample.py``) computes on the unpadded data, and writes zeros
beyond them.

The extents are host integers (the port runs eagerly and the harness knows
them), where the JAX package carries traced int32 scalars.  Data beyond a
true extent must be zero (``mask_valid``) for the max-type ops.
"""

from typing import Dict, Optional, Sequence

import torch


def mask_valid(x: torch.Tensor, extents: Dict[int, Optional[int]]
               ) -> torch.Tensor:
    """``x`` with every entry at or beyond the true extent of an axis set
    to 0; ``extents`` maps axis -> true extent (None: the whole axis).
    Returns ``x`` itself when no axis is cut."""
    mask = None
    for axis, t in extents.items():
        if t is None or t >= x.shape[axis]:
            continue
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        m = (torch.arange(x.shape[axis], device=x.device) < t).reshape(shape)
        mask = m if mask is None else mask & m
    if mask is None:
        return x
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def masked_mean(x: torch.Tensor, axis: int, n_true: int) -> torch.Tensor:
    """Mean over the first ``n_true`` entries of ``axis`` (the entries
    beyond must be zero), keeping the axis; summed in fp32 (or x's wider
    type) and rounded once, as ``Tensor.mean`` does."""
    acc = torch.promote_types(x.dtype, torch.float32)
    s = torch.sum(x, dim=axis, keepdim=True, dtype=acc)
    return (s / n_true).to(x.dtype)


def _axis_adaptive_max_dynamic(x: torch.Tensor, axis: int, n: int, m: int,
                               max_ratio: int,
                               m_pad: Optional[int] = None) -> torch.Tensor:
    """torch's adaptive max pool along one axis, from the true input extent
    ``n`` to the true output extent ``m``, in a padded output of ``m_pad``
    cells (default: the input's padded extent).  Cell i < m is the max over
    [floor(i*n/m), ceil((i+1)*n/m)); cells i >= m are 0.  A window holds at
    most ``max_ratio + 1`` entries."""
    n_pad = x.shape[axis]
    m_pad = n_pad if m_pad is None else m_pad
    width = max_ratio + 1
    i = torch.arange(m_pad, device=x.device)
    den = max(m, 1)
    starts = (i * n) // den
    ends = -((-(i + 1) * n) // den)
    idx = starts[:, None] + torch.arange(width, device=x.device)[None, :]
    valid = (idx < ends[:, None]) & (i < m)[:, None]
    gathered = torch.index_select(x, axis, idx.clamp(0, n_pad - 1).reshape(-1))
    shape = list(x.shape)
    shape[axis:axis + 1] = [m_pad, width]
    gathered = gathered.reshape(shape)
    mask_shape = [1] * gathered.dim()
    mask_shape[axis], mask_shape[axis + 1] = m_pad, width
    neg_inf = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    out = torch.where(valid.reshape(mask_shape), gathered, neg_inf)
    return mask_valid(out.amax(dim=axis + 1), {axis: m})


def adaptive_max_pool_dynamic(x: torch.Tensor, true_in: Sequence,
                              true_out: Sequence, axes: Sequence[int],
                              max_ratio: int = 8,
                              out_pads: Optional[Sequence] = None
                              ) -> torch.Tensor:
    """The twin of ``ops.pooling.adaptive_max_pool`` over true extents:
    per axis, ``true_in`` -> ``true_out`` in a padded output of
    ``out_pads`` (None: the input's padded extent); an axis whose true
    input extent is None is left as it is."""
    out_pads = out_pads or [None] * len(axes)
    for axis, n_t, m_t, mp in zip(axes, true_in, true_out, out_pads):
        if n_t is not None:
            x = _axis_adaptive_max_dynamic(x, axis, n_t, m_t, max_ratio, mp)
    return x


def _axis_linear_dynamic(x: torch.Tensor, axis: int, n: int, m: int,
                         m_pad: Optional[int] = None) -> torch.Tensor:
    """torch's ``align_corners=False`` linear resize along one axis from the
    true extent ``n`` to ``m``, in a padded output of ``m_pad`` cells.  The
    source coordinate ((2i+1)*n - m) / (2m) keeps an integer numerator, so
    its floor and the lerp weight are exact."""
    n_pad = x.shape[axis]
    m_pad = n_pad if m_pad is None else m_pad
    den = 2 * max(m, 1)
    i = torch.arange(m_pad, device=x.device)
    num = (2 * i + 1) * n - max(m, 1)
    lo = torch.div(num, den, rounding_mode="floor")
    w = ((num - lo * den).to(torch.float32) / float(den)).to(x.dtype)
    lo_c = lo.clamp(0, n - 1)
    hi_c = (lo + 1).clamp(0, n - 1)
    shape = [1] * x.dim()
    shape[axis] = m_pad
    w = w.reshape(shape)
    out = (torch.index_select(x, axis, lo_c) * (1 - w)
           + torch.index_select(x, axis, hi_c) * w)
    return mask_valid(out, {axis: m})


def linear_resize_dynamic(x: torch.Tensor, true_in: Sequence,
                          true_out: Sequence, axes: Sequence[int],
                          out_pads: Optional[Sequence] = None
                          ) -> torch.Tensor:
    """The twin of ``ops.interpolate.linear_resize`` over true extents
    (arguments as :func:`adaptive_max_pool_dynamic`)."""
    out_pads = out_pads or [None] * len(axes)
    for axis, n_t, m_t, mp in zip(axes, true_in, true_out, out_pads):
        if n_t is not None:
            x = _axis_linear_dynamic(x, axis, n_t, m_t, mp)
    return x


def upsample_nearest_indices_dynamic(n_in_true: int, n_out_true: int,
                                     n_out_pad: int,
                                     device=None) -> torch.Tensor:
    """The nearest-upsample gather map over true extents: output i gathers
    ``ceil((i+1) * n_in / n_out) - 1`` (``ops/upsample.py``'s rule), clamped
    into the true input; positions i >= n_out_true map to 0.  (n_out_pad,)
    int64."""
    i = torch.arange(n_out_pad, device=device)
    den = max(n_out_true, 1)
    src = (((i + 1) * n_in_true + den - 1) // den - 1).clamp(0, n_in_true - 1)
    return torch.where(i < n_out_true, src, torch.zeros_like(src))
