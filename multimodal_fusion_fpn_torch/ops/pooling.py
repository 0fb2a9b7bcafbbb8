"""Adaptive max pooling with torch semantics on arbitrary axes.

Output cell ``i`` along an axis of input length ``n`` and output length
``m`` is the max over ``[floor(i*n/m), ceil((i+1)*n/m))``
(``torch.nn.functional.adaptive_max_pool3d``); the box is a product of
per-axis windows, so the axes are reduced one after another.  Used by the
``2d_max`` alignment of the 2D skips (``multimodal_fusion_fpn_tpu/ops/
pooling.py``).
"""

from typing import Sequence

import torch


def _axis_adaptive_max(x: torch.Tensor, axis: int, out: int) -> torch.Tensor:
    n = x.shape[axis]
    if out == n:
        return x
    if n % out == 0:
        shape = list(x.shape)
        shape[axis:axis + 1] = [out, n // out]
        return x.reshape(shape).amax(dim=axis + 1)
    parts = []
    for i in range(out):
        start, end = (i * n) // out, -((-(i + 1) * n) // out)
        parts.append(x.narrow(axis, start, end - start).amax(
            dim=axis, keepdim=True))
    return torch.cat(parts, dim=axis)


def adaptive_max_pool(x: torch.Tensor, out_sizes: Sequence[int],
                      axes: Sequence[int]) -> torch.Tensor:
    """Adaptive max pool over ``axes`` to the given output sizes."""
    for axis, out in zip(axes, out_sizes):
        x = _axis_adaptive_max(x, axis, int(out))
    return x
