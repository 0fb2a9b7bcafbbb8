"""``ModifiedUnet2D(levels=5)``, the en-face U-Net (``multimodal_fusion_
fpn_tpu/models/unet2d.py:24-93``).

The 2D encoder stages of the fusion net (``conv1_2d`` .. ``conv5_2d``) over
a (B, H, W, C) map, the skips lifted to (B, H, W, 1, C) (the volume names
y, x for h, w), the decoder of 2-input up blocks of ``ModifiedUnet3D`` and
``final1``, or the (B, H, W, 1, channels[0]) features before it when
``output_features``.  The JAX package's 4-level variant is not ported: no
zoo model reaches it.

Exact shape bucketing (eval): ``forward`` takes the true (h, w) of the
padded map; the encoder carries them per level and the decoder masks to
each level's (h, w) under the volume names (y, x).
"""

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.blocks import (EncoderStage,
                                                       refuse_dropout)
from multimodal_fusion_fpn_torch.models.encoder3d import run_2d_encoder
from multimodal_fusion_fpn_torch.models.fusion import POOLS_2D
from multimodal_fusion_fpn_torch.models.unet3d import (add_decoder,
                                                       check_spec, decode)


class ModifiedUnet2D(nn.Module):
    """Submodule names follow the original project's state dict
    (``conv1_2d``, ``up_concat1``, ``final1``, ...)."""

    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 output_features: bool = False):
        super().__init__()
        check_spec(spec)
        ch = spec.channels
        self.dropout = tuple(spec.dropout)
        cins = (1,) + tuple(ch[:4])
        for i in range(5):
            setattr(self, f"conv{i + 1}_2d", EncoderStage(cins[i], ch[i], 2))
        add_decoder(self, ch, None if output_features else n_classes)

    def forward(self, enface: torch.Tensor, kernels: bool = True,
                ext2d=None) -> torch.Tensor:
        """enface (B, H, W, 1) -> (B, H, W, 1, n_classes), or the features
        before ``final1``.  ``ext2d`` (h, w): the true extents of the
        zero-padded map, or None."""
        if self.training:
            refuse_dropout(self.dropout, encoders=("_2d",))
        skips, exts = run_2d_encoder(
            [getattr(self, f"conv{i + 1}_2d") for i in range(5)], enface,
            POOLS_2D, kernels, ext2d)
        up = decode(self, [s.unsqueeze(3) for s in skips], exts, kernels)
        return up if self.final1 is None else self.final1(up)
