"""The 3D and 2D encoder loops (``multimodal_fusion_fpn_tpu/models/
encoder3d.py:42-195``): five stages with a window == stride max pool
between them.  The port is channels-last throughout, so there is no packed
inter-stage layout; every pool runs the hand-written kernel when
``kernels`` is True.

The pool's backward follows the JAX package's default lowering per stage:
the outputs of the fused stages (at most 64 channels, packed in the JAX
package) pool with the Pallas kernel, whose backward sends the cotangent
to every tied max; the wider stage-4 outputs pool with XLA's
``reduce_window``, whose backward sends it to the first max.

Under exact shape bucketing (eval) the loops also carry each level's true
extents: a window == stride pool floors them (``pooled_ext``,
``encoder3d.py:29-40``), and the next conv's prologue masks the one cell
that straddles a true extent.  The padded extents are bucket multiples, so
every window divides them and the pool kernel runs unchanged.
"""

from typing import Optional, Sequence

import torch

from multimodal_fusion_fpn_torch.models.blocks import FUSED_MAX_CHANNELS
from multimodal_fusion_fpn_torch.ops.pool import (max_pool3d_cl,
                                                  max_pool3d_cl_plain)


def _pool(x: torch.Tensor, window, kernels: bool) -> torch.Tensor:
    pool = max_pool3d_cl if kernels else max_pool3d_cl_plain
    return pool(x, window, first_max=x.shape[-1] > FUSED_MAX_CHANNELS)


def pooled_ext(ext: Optional[tuple], window: Sequence[int]):
    """True extents after a window == stride max pool (floor)."""
    if ext is None:
        return None
    return tuple(None if e is None else e // w for e, w in zip(ext, window))


def proj_depth_ext(ext: Optional[tuple], num_reductions: int,
                   final_kernel: int) -> Optional[int]:
    """The true depth of a projection head's output (``encoder3d.py:
    198-207``): ``num_reductions`` stride-2 convs, then the VALID final
    conv.  None outside bucketing."""
    if ext is None or ext[2] is None:
        return None
    z = ext[2]
    for _ in range(num_reductions):
        z = (z + 1) // 2
    return z - final_kernel + 1


def run_3d_encoder(stages: Sequence[torch.nn.Module], x: torch.Tensor,
                   pools, kernels: bool = True, ext=None,
                   block_fusion: Optional[str] = None):
    """Per-level PRE-POOL stage outputs, each (B, Y, X, Z, C), and each
    level's true (y, x, z) extents (all None outside bucketing).
    ``block_fusion``: the stages' eval block fusion (``blocks.ConvX``)."""
    convs, exts = [], []
    for lvl, stage in enumerate(stages):
        x = stage(x, kernels, ext, block_fusion)
        convs.append(x)
        exts.append(ext)
        if lvl < len(stages) - 1:
            x = _pool(x, pools[lvl], kernels)
            ext = pooled_ext(ext, pools[lvl])
    return convs, exts


def run_2d_encoder(stages: Sequence[torch.nn.Module], x: torch.Tensor,
                   pools, kernels: bool = True, ext=None):
    """2D twin on (B, H, W, C) maps with (h, w) extents; a (wH, wW) pool
    runs as (wH, 1, wW) on the singleton-X view."""
    convs, exts = [], []
    for lvl, stage in enumerate(stages):
        x = stage(x, kernels, ext)
        convs.append(x)
        exts.append(ext)
        if lvl < len(stages) - 1:
            wh, ww = pools[lvl]
            x = _pool(x.unsqueeze(2), (wh, 1, ww), kernels).squeeze(2)
            ext = pooled_ext(ext, pools[lvl])
    return convs, exts
