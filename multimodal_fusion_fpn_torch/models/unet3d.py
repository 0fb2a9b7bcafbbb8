"""``ModifiedUnet3D``, the projective 3D -> 2D U-Net (``multimodal_fusion_
fpn_tpu/models/unet3d.py:29-94``), and its pyramid constants, which the
hybrid fusion net shares.

A 5-stage 3D encoder over (B, Y, X, Z, C) volumes, per-level depth
projection heads (``zdimRed1..5``) each followed by a mean over the
remaining depth, a 4-level decoder of 2-input up blocks (``UpBlock2``)
and a final 1x1x1 conv (``final1``, left out when ``use_1x1`` is False).
``classification=True`` returns the stage-5 output before any pool and
builds no projection or decoder.  The architecture ini's toggles hold for
every block: ``is_batchnorm=False`` gives each conv a bias in place of its
BatchNorm (such stages run the plain convs: ``blocks.EncoderStage``),
``is_deconv=True`` upsamples in the decoder with a transposed conv
(``blocks.UpConv``).  The JAX package's ``original`` variant (final kernel
8, no mean) is not ported yet (ROADMAP).

Exact shape bucketing (eval): ``forward`` takes the true extents (y, x, z)
of the padded volume; the encoder carries them per level, the depth mean
divides by the projection's true depth and the decoder masks to each
level's (y, x), as in the hybrid net (``models/fusion.py``).
"""

from typing import Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.blocks import (Conv1x1, EncoderStage,
                                                       UpBlock2,
                                                       ZDimReduction)
from multimodal_fusion_fpn_torch.models.encoder3d import (proj_depth_ext,
                                                          run_3d_encoder)
from multimodal_fusion_fpn_torch.ops.dynamic_extent import masked_mean

POOLS_3D = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2))
UPFACTORS = ((2, 2, 1), (2, 2, 1), (1, 2, 1), (1, 2, 1))
NUM_REDUCTIONS = (4, 3, 2, 1, 0)


def project(net: nn.Module, skips, exts, kernels: bool):
    """Each level's skip through ``net.zdimRed<level>``, then the mean over
    the remaining depth (over its true depth under bucketing): a list of
    (B, Y, X, 1, C)."""
    projected = []
    for i, s in enumerate(skips):
        p = getattr(net, f"zdimRed{i + 1}")(s, kernels, exts[i])
        zf = proj_depth_ext(exts[i], NUM_REDUCTIONS[i], 4)
        projected.append(p.mean(dim=3, keepdim=True) if zf is None
                         else masked_mean(p, 3, zf))
    return projected


def decode(net: nn.Module, skips, exts, kernels: bool) -> torch.Tensor:
    """The 2-input decoder: ``net.up_concat4`` .. ``up_concat1`` from the
    deepest skip up; ``exts`` the per-level true (y, x, ...) extents of the
    skips, or Nones."""
    up = skips[4]
    for lvl in (3, 2, 1, 0):
        dec = None if exts[lvl] is None else tuple(exts[lvl][:2]) + (None,)
        up = getattr(net, f"up_concat{lvl + 1}")(skips[lvl], up, kernels,
                                                 dec)
    return up


def add_decoder(net: nn.Module, spec: ArchSpec,
                n_classes: Optional[int]) -> None:
    """``up_concat1..4`` of 2-input blocks, ``up_concat4`` .. ``up_concat1``
    with the dropout of slots 5-8 and the spec's toggles, and ``final1``
    (None when ``n_classes`` is None)."""
    ch = spec.channels
    lows = (ch[4], ch[3], ch[2], ch[1])
    for i, lvl in enumerate((3, 2, 1, 0)):
        setattr(net, f"up_concat{lvl + 1}",
                UpBlock2(lows[i], ch[lvl], UPFACTORS[i],
                         spec.dropout[5 + i], spec.is_batchnorm,
                         spec.is_deconv))
    net.final1 = None if n_classes is None else Conv1x1(ch[0], n_classes)


class ModifiedUnet3D(nn.Module):
    """Submodule names follow the original project's state dict
    (``conv1``, ``zdimRed1``, ``up_concat1``, ``final1``, ...)."""

    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 use_1x1: bool = True, classification: bool = False):
        super().__init__()
        ch, drop, bn = spec.channels, spec.dropout, spec.is_batchnorm
        self.classification = classification
        cins = (1,) + tuple(ch[:4])
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    EncoderStage(cins[i], ch[i], 3, drop[i], bn))
        if not classification:
            for i in range(5):
                setattr(self, f"zdimRed{i + 1}",
                        ZDimReduction(ch[i], NUM_REDUCTIONS[i], bn=bn))
            add_decoder(self, spec, n_classes if use_1x1 else None)

    def forward(self, volume: torch.Tensor, kernels: bool = True,
                ext3d=None,
                block_fusion: Optional[str] = None) -> torch.Tensor:
        """volume (B, Y, X, Z, 1) -> (B, Y, X, 1, n_classes), or the
        (B, Y, X, 1, channels[0]) features without ``final1``, or the
        stage-5 output (B, Y', X', Z', channels[4]) when
        ``classification``.  ``ext3d`` (y, x, z): the true extents of the
        zero-padded volume, or None; ``block_fusion``: the eval block
        fusion of the encoder stages (``blocks.ConvX``)."""
        skips, exts = run_3d_encoder(
            [getattr(self, f"conv{i + 1}") for i in range(5)], volume,
            POOLS_3D, kernels, ext3d, block_fusion)
        if self.classification:
            return skips[4]
        up = decode(self, project(self, skips, exts, kernels), exts, kernels)
        return up if self.final1 is None else self.final1(up)
