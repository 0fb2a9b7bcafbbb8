"""The 3D and 2D encoder loops (``multimodal_fusion_fpn_tpu/models/
encoder3d.py:42-195``): five stages with a window == stride max pool
between them.  The port is channels-last throughout, so there is no packed
inter-stage layout; every pool runs the hand-written kernel when
``kernels`` is True.
"""

from typing import List, Sequence

import torch

from multimodal_fusion_fpn_torch.ops.pool import (max_pool3d_cl,
                                                  max_pool3d_cl_plain)


def run_3d_encoder(stages: Sequence[torch.nn.Module], x: torch.Tensor,
                   pools, kernels: bool = True) -> List[torch.Tensor]:
    """Per-level PRE-POOL stage outputs, each (B, Y, X, Z, C)."""
    pool = max_pool3d_cl if kernels else max_pool3d_cl_plain
    convs = []
    for lvl, stage in enumerate(stages):
        x = stage(x, kernels)
        convs.append(x)
        if lvl < len(stages) - 1:
            x = pool(x, pools[lvl])
    return convs


def run_2d_encoder(stages: Sequence[torch.nn.Module], x: torch.Tensor,
                   pools, kernels: bool = True) -> List[torch.Tensor]:
    """2D twin on (B, H, W, C) maps; a (wH, wW) pool runs as (wH, 1, wW)
    on the singleton-X view."""
    pool = max_pool3d_cl if kernels else max_pool3d_cl_plain
    convs = []
    for lvl, stage in enumerate(stages):
        x = stage(x, kernels)
        convs.append(x)
        if lvl < len(stages) - 1:
            wh, ww = pools[lvl]
            x = pool(x.unsqueeze(2), (wh, 1, ww)).squeeze(2)
    return convs
