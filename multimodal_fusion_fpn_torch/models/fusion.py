"""Hybrid 3D+2D fusion U-Net, 5-level (``ModifiedUnet3D2D(levels=5)``,
``multimodal_fusion_fpn_tpu/models/fusion.py:36-176``).

A 5-stage 3D encoder with depth-projection heads and a depth mean, a
parallel 5-stage 2D encoder whose skips are aligned to the 3D en-face
resolution, the two bottlenecks concatenated, and a decoder fusing
(3D skip, 2D skip, deeper) per level, then ``final1``.
Layouts: 3D (B, Y, X, Z, C); 2D (B, H, W, C).

Exact shape bucketing (eval): ``forward`` takes the true extents of the
padded volume (y, x, z) and en-face map (h, w).  The encoders carry them
per level, the depth mean divides by the projection's true depth, the 2D
skips align over the true extents (``ops.dynamic_extent``) and the
decoder masks to each level's (y, x) (``fusion.py:36-68,118-159``).
"""

from typing import Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.blocks import (Conv1x1, EncoderStage,
                                                       UpBlockFusion,
                                                       ZDimReduction)
from multimodal_fusion_fpn_torch.models.encoder3d import (proj_depth_ext,
                                                          run_2d_encoder,
                                                          run_3d_encoder)
from multimodal_fusion_fpn_torch.models.unet3d import (NUM_REDUCTIONS,
                                                       POOLS_3D, UPFACTORS)
from multimodal_fusion_fpn_torch.ops.dynamic_extent import (
    adaptive_max_pool_dynamic, linear_resize_dynamic, masked_mean)
from multimodal_fusion_fpn_torch.ops.interpolate import linear_resize
from multimodal_fusion_fpn_torch.ops.pooling import adaptive_max_pool

POOLS_2D = ((1, 2), (1, 2), (2, 2), (2, 2))


def align_2d_skip(skip2d: torch.Tensor, target_shape,
                  interpolate: Optional[str], true_2d=None,
                  true_3d=None) -> torch.Tensor:
    """Lift a (B, H, W, C) skip to (B, H, W, 1, C) and align it to the 3D
    skip's (Y, X, Z) shape (``fusion.py:36-68``).  Under bucketing
    ``true_2d`` (h, w) and ``true_3d`` (y, x, z) are the true extents, and
    the alignment maps the one onto the other inside the padded target."""
    x = skip2d.unsqueeze(3)
    if true_2d is not None and true_3d is not None:
        t_in = (true_2d[0], true_2d[1], None)
        t_out = (true_3d[0], true_3d[1], None)
        pads = (target_shape[0], target_shape[1], None)
        if interpolate == "2d":
            return linear_resize_dynamic(x, t_in, t_out, axes=(1, 2, 3),
                                         out_pads=pads)
        if interpolate == "2d_max":
            return adaptive_max_pool_dynamic(x, t_in, t_out, axes=(1, 2, 3),
                                             max_ratio=16, out_pads=pads)
        if interpolate is not None:
            raise ValueError(f"Unknown interpolate mode: {interpolate}")
        return x
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
        self.dropout = tuple(spec.dropout)
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

    def _refuse_dropout(self):
        """The JAX package applies each block's dropout in training
        (``blocks.py:777-778``) and then runs that stage off its fused
        kernels; the port has no dropout yet (ROADMAP M8), so a spec with
        any slot > 0 cannot train here.  In eval dropout is the identity."""
        for slot, p in enumerate(self.dropout):
            if p > 0:
                where = (f"encoder level {slot + 1} (conv{slot + 1}, "
                         f"conv{slot + 1}_2d)" if slot < 5 else
                         f"decoder block up_concat{9 - slot}")
                raise NotImplementedError(
                    f"dropout slot {slot} ({where}) is {p}: the port does not "
                    f"apply dropout in training yet (ROADMAP M8)")

    def forward(self, volume: torch.Tensor, enface: torch.Tensor,
                kernels: bool = True, ext3d=None, ext2d=None,
                block_fusion: Optional[str] = None) -> torch.Tensor:
        """volume (B, Y, X, Z, 1), enface (B, H, W, 1) ->
        (B, Y, X, 1, n_classes).  ``ext3d`` (y, x, z) / ``ext2d`` (h, w):
        the true extents of the zero-padded inputs, or None.
        ``block_fusion``: None, "pair" or "chain", the eval block fusion
        of the 3D encoder stages (``blocks.ConvX``)."""
        if self.training:
            self._refuse_dropout()
        skips2d, exts2d = run_2d_encoder(
            [getattr(self, f"conv{i + 1}_2d") for i in range(5)], enface,
            POOLS_2D, kernels, ext2d)
        skips3d, exts = run_3d_encoder(
            [getattr(self, f"conv{i + 1}") for i in range(5)], volume,
            POOLS_3D, kernels, ext3d, block_fusion)
        projected = []
        for i, s in enumerate(skips3d):
            p = getattr(self, f"zdimRed{i + 1}")(s, kernels, exts[i])
            zf = proj_depth_ext(exts[i], NUM_REDUCTIONS[i], 4)
            projected.append(p.mean(dim=3, keepdim=True) if zf is None
                             else masked_mean(p, 3, zf))
        aligned = [align_2d_skip(s, p.shape[1:4], self.interpolate, e2, e3)
                   for s, p, e2, e3 in zip(skips2d, projected, exts2d, exts)]
        up = torch.cat([projected[4], aligned[4]], dim=-1)
        for lvl in (3, 2, 1, 0):
            dec = None if exts[lvl] is None else exts[lvl][:2] + (None,)
            up = getattr(self, f"up_concat{lvl + 1}")(
                projected[lvl], aligned[lvl], up, kernels, dec)
        return self.final1(up)
