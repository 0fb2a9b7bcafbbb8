"""Index-gather nearest-neighbour upsampling.

Semantics of the original project's ``Upsample_Custom3d_nearest``
(``components.py:230-323``), as ``multimodal_fusion_fpn_tpu/ops/upsample.py``
implements them: along each axis output index ``i`` (1-based) gathers input
index ``ceil(i / scale) - 1``, output length ``floor(n * scale)``.  For the
integer factors the models use this is an element repeat.
"""

from typing import Sequence

import torch


def upsample_nearest(x: torch.Tensor, scale: Sequence[int],
                     axes: Sequence[int]) -> torch.Tensor:
    """Upsample ``x`` along ``axes`` by integer per-axis factors."""
    for axis, f in zip(axes, scale):
        if int(f) != f or f < 1:
            raise ValueError(f"upsample_nearest: integer factors only, got {f}")
        if f > 1:
            x = torch.repeat_interleave(x, int(f), dim=axis)
    return x
