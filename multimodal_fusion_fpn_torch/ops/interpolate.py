"""Multi-linear resize with torch ``align_corners=False`` semantics.

Output coordinate ``i`` samples input coordinate
``(i + 0.5) * n_in / n_out - 0.5`` with edge clamping, one axis at a time
(``multimodal_fusion_fpn_tpu/ops/interpolate.py``).  Used by the ``2d``
alignment of the 2D skips.
"""

from typing import Sequence

import numpy as np
import torch


def _axis_linear(x: torch.Tensor, axis: int, out: int) -> torch.Tensor:
    n = x.shape[axis]
    if out == n:
        return x
    coords = (np.arange(out) + 0.5) * (n / out) - 0.5
    lo = np.floor(coords)
    w = (coords - lo).astype(np.float32)
    lo_c = torch.as_tensor(np.clip(lo, 0, n - 1).astype(np.int64),
                           device=x.device)
    hi_c = torch.as_tensor(np.clip(lo + 1, 0, n - 1).astype(np.int64),
                           device=x.device)
    shape = [1] * x.dim()
    shape[axis] = out
    wt = torch.as_tensor(w.reshape(shape), device=x.device).to(x.dtype)
    return (x.index_select(axis, lo_c) * (1 - wt)
            + x.index_select(axis, hi_c) * wt)


def linear_resize(x: torch.Tensor, out_sizes: Sequence[int],
                  axes: Sequence[int]) -> torch.Tensor:
    """Linearly resize ``x`` along ``axes`` to ``out_sizes``."""
    for axis, out in zip(axes, out_sizes):
        x = _axis_linear(x, axis, int(out))
    return x
