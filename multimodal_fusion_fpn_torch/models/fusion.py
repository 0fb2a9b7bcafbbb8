"""Hybrid 3D+2D fusion U-Net, 5-level (``ModifiedUnet3D2D(levels=5)``,
``multimodal_fusion_fpn_tpu/models/fusion.py:36-176``).

A 5-stage 3D encoder with depth-projection heads and a depth mean, a
parallel 5-stage 2D encoder whose skips are aligned to the 3D en-face
resolution, the two bottlenecks concatenated, and a decoder fusing
(3D skip, 2D skip, deeper) per level, then ``final1``.
Layouts: 3D (B, Y, X, Z, C); 2D (B, H, W, C).
"""

from typing import Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.blocks import (Conv1x1, EncoderStage,
                                                       UpBlockFusion,
                                                       ZDimReduction)
from multimodal_fusion_fpn_torch.models.encoder3d import (run_2d_encoder,
                                                          run_3d_encoder)
from multimodal_fusion_fpn_torch.models.unet3d import (NUM_REDUCTIONS,
                                                       POOLS_3D, UPFACTORS)
from multimodal_fusion_fpn_torch.ops.interpolate import linear_resize
from multimodal_fusion_fpn_torch.ops.pooling import adaptive_max_pool

POOLS_2D = ((1, 2), (1, 2), (2, 2), (2, 2))


def align_2d_skip(skip2d: torch.Tensor, target_shape,
                  interpolate: Optional[str]) -> torch.Tensor:
    """Lift a (B, H, W, C) skip to (B, H, W, 1, C) and align it to the 3D
    skip's (Y, X, Z) shape (static path of ``fusion.py:36-68``)."""
    x = skip2d.unsqueeze(3)
    if interpolate == "2d":
        return linear_resize(x, target_shape, axes=(1, 2, 3))
    if interpolate == "2d_max":
        return adaptive_max_pool(x, target_shape, axes=(1, 2, 3))
    if interpolate is not None:
        raise ValueError(f"Unknown interpolate mode: {interpolate}")
    return x


class ModifiedUnet3D2D(nn.Module):
    """The levels=5 hybrid net; submodule names follow the original
    project's state dict (``conv1``, ``conv1_2d``, ``zdimRed1``,
    ``up_concat1``, ``final1``, ...)."""

    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 interpolate: Optional[str] = None):
        super().__init__()
        if not spec.is_batchnorm or spec.is_deconv:
            raise NotImplementedError(
                "the port supports is_batchnorm=True, is_deconv=False")
        ch = spec.channels
        self.interpolate = interpolate
        cins = (1,) + tuple(ch[:4])
        for i in range(5):
            setattr(self, f"conv{i + 1}", EncoderStage(cins[i], ch[i], 3))
            setattr(self, f"conv{i + 1}_2d", EncoderStage(cins[i], ch[i], 2))
            setattr(self, f"zdimRed{i + 1}",
                    ZDimReduction(ch[i], NUM_REDUCTIONS[i]))
        lows = (ch[4] * 2, ch[3], ch[2], ch[1])  # bottleneck concat first
        for i, lvl in enumerate((3, 2, 1, 0)):
            setattr(self, f"up_concat{lvl + 1}",
                    UpBlockFusion(lows[i], ch[lvl], UPFACTORS[i]))
        self.final1 = Conv1x1(ch[0], n_classes)

    def forward(self, volume: torch.Tensor, enface: torch.Tensor,
                kernels: bool = True) -> torch.Tensor:
        """volume (B, Y, X, Z, 1), enface (B, H, W, 1) ->
        (B, Y, X, 1, n_classes)."""
        skips2d = run_2d_encoder(
            [getattr(self, f"conv{i + 1}_2d") for i in range(5)], enface,
            POOLS_2D, kernels)
        skips3d = run_3d_encoder(
            [getattr(self, f"conv{i + 1}") for i in range(5)], volume,
            POOLS_3D, kernels)
        projected = [
            getattr(self, f"zdimRed{i + 1}")(s, kernels).mean(dim=3,
                                                               keepdim=True)
            for i, s in enumerate(skips3d)]
        aligned = [align_2d_skip(s, p.shape[1:4], self.interpolate)
                   for s, p in zip(skips2d, projected)]
        up = torch.cat([projected[4], aligned[4]], dim=-1)
        for lvl in (3, 2, 1, 0):
            up = getattr(self, f"up_concat{lvl + 1}")(
                projected[lvl], aligned[lvl], up, kernels)
        return self.final1(up)
