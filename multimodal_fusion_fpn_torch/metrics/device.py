"""Per-sample training metrics on the device
(``multimodal_fusion_fpn_tpu/metrics/device.py:18-36``): hard Dice at a
threshold with empty-empty -> 1, and the BCE with torch's -100 log clamp.
Hausdorff distances are not ported yet."""

import torch


def dice_per_sample(pred: torch.Tensor, gt: torch.Tensor,
                    slice_idx: int = 0, threshold: float = 0.5
                    ) -> torch.Tensor:
    """Hard Dice@threshold per batch element; pred/gt (B, C, ...)."""
    n = pred.shape[0]
    p = (pred[:, slice_idx] > threshold).float().reshape(n, -1)
    g = (gt[:, slice_idx] > threshold).float().reshape(n, -1)
    num = (p * g).sum(dim=1)
    den = (p + g).sum(dim=1)
    return torch.where(den == 0.0, torch.ones_like(den),
                       2.0 * num / torch.clamp(den, min=1.0))


def bce_scalar(pred: torch.Tensor, gt: torch.Tensor,
               slice_idx: int = 0) -> torch.Tensor:
    """Mean BCE over the batch slice (one scalar)."""
    p = pred[:, slice_idx].reshape(-1)
    g = gt[:, slice_idx].reshape(-1).to(p.dtype)
    log_p = torch.clamp(torch.log(p), min=-100.0)
    log_1p = torch.clamp(torch.log1p(-p), min=-100.0)
    return -torch.mean(g * log_p + (1.0 - g) * log_1p)
