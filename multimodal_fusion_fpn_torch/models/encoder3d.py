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
"""

from typing import List, Sequence

import torch

from multimodal_fusion_fpn_torch.models.blocks import FUSED_MAX_CHANNELS
from multimodal_fusion_fpn_torch.ops.pool import (max_pool3d_cl,
                                                  max_pool3d_cl_plain)


def _pool(x: torch.Tensor, window, kernels: bool) -> torch.Tensor:
    pool = max_pool3d_cl if kernels else max_pool3d_cl_plain
    return pool(x, window, first_max=x.shape[-1] > FUSED_MAX_CHANNELS)


def run_3d_encoder(stages: Sequence[torch.nn.Module], x: torch.Tensor,
                   pools, kernels: bool = True) -> List[torch.Tensor]:
    """Per-level PRE-POOL stage outputs, each (B, Y, X, Z, C)."""
    convs = []
    for lvl, stage in enumerate(stages):
        x = stage(x, kernels)
        convs.append(x)
        if lvl < len(stages) - 1:
            x = _pool(x, pools[lvl], kernels)
    return convs


def run_2d_encoder(stages: Sequence[torch.nn.Module], x: torch.Tensor,
                   pools, kernels: bool = True) -> List[torch.Tensor]:
    """2D twin on (B, H, W, C) maps; a (wH, wW) pool runs as (wH, 1, wW)
    on the singleton-X view."""
    convs = []
    for lvl, stage in enumerate(stages):
        x = stage(x, kernels)
        convs.append(x)
        if lvl < len(stages) - 1:
            wh, ww = pools[lvl]
            x = _pool(x.unsqueeze(2), (wh, 1, ww), kernels).squeeze(2)
    return convs
