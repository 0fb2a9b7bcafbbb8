"""Layout conversion between the reference batch layout and channels-last.

The public batch layout is the original project's
(``multimodal_fusion_fpn_tpu/models/layouts.py``):

  * ``image``: (B, 1, D, H, W) — D = #B-scans (en-face rows, "Y"),
    H = B-scan depth ("Z"), W = en-face width ("X").
  * ``mask`` / ``slo`` / ``faf``: (B, 1, H_ef, 1, W).

Inside the port everything is channels-last: volumes (B, Y, X, Z, C) and
2D maps (B, H, W, C).  The results are contiguous.
"""

import torch


def volume_to_device(image: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, Y=D, X=W, Z=H, C)."""
    return image.permute(0, 2, 4, 3, 1).contiguous()


def seg_from_device(seg: torch.Tensor) -> torch.Tensor:
    """(B, Y, X, Z=1, C) -> reference prediction layout (B, C, Y, 1, X)."""
    return seg.permute(0, 4, 1, 3, 2).contiguous()


def enface_to_device(modality: torch.Tensor) -> torch.Tensor:
    """(B, C, H, 1, W) -> (B, H, W, C)."""
    return modality[:, :, :, 0, :].permute(0, 2, 3, 1).contiguous()
