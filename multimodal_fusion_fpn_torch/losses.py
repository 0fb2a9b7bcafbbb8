"""Losses of the port (``multimodal_fusion_fpn_tpu/losses.py``): pure
functions over dicts of tensors in the reference layout, computed in the
prediction's dtype as the JAX ones are."""

from typing import Callable, Dict, Optional

import torch


def _clamped_log(v: torch.Tensor, log, at: float) -> torch.Tensor:
    """``max(log(v), -100)``, and -100 where ``v == at`` (where ``log`` is
    -inf) taken without ``log``, so its gradient there is 0, as the clamp
    gives it wherever ``log`` is finite, and not 0 * inf = NaN.  A NaN
    ``v`` stays NaN."""
    hit = v == at
    return torch.where(hit, -100.0,
                       torch.clamp(log(torch.where(hit, 0.5, v)), min=-100.0))


def bce_loss(output_key: str = "prediction", target_key: str = "mask"):
    """Mean binary cross-entropy on flattened probabilities, each log term
    clamped at -100 (``F.binary_cross_entropy`` semantics).  The values are
    the JAX package's; so is the gradient, except at a prediction of
    exactly 0 or 1 (a bf16 sigmoid reaches 1 from a logit of about 6),
    where JAX's clip of ``log(0) = -inf`` gives NaN and this gives the
    clamp's 0 (ROADMAP Queue 3)."""
    def fn(target: Dict, predict: Dict) -> torch.Tensor:
        assert target[target_key].shape == predict[output_key].shape, (
            target[target_key].shape, predict[output_key].shape)
        pred = predict[output_key].reshape(-1)
        gt = target[target_key].reshape(-1).to(pred.dtype)
        log_p = _clamped_log(pred, torch.log, 0.0)
        log_1p = _clamped_log(pred, lambda v: torch.log1p(-v), 1.0)
        return -torch.mean(gt * log_p + (1.0 - gt) * log_1p)
    return fn


def dice_loss_joint(output_key: str = "prediction",
                    target_key: str = "mask",
                    force_binary: bool = False,
                    threshold: float = 0.5):
    """Soft dice with the squared-prediction denominator: per channel
    ``2*(sum(p*g)+1e-6) / (sum(p^2)+sum(g)+2e-6)`` over batch and space;
    the loss is ``1 - mean over channels``."""
    def fn(target: Dict, predict: Dict) -> torch.Tensor:
        assert target[target_key].shape == predict[output_key].shape, (
            f"{target[target_key].shape} != {predict[output_key].shape}")
        shape = target[target_key].shape
        pred = predict[output_key].reshape(shape[0], shape[1], -1)
        gt = target[target_key].reshape(shape[0], shape[1], -1).to(pred.dtype)
        if force_binary:
            gt = (gt > threshold).to(pred.dtype)
        intersection = (pred * gt).sum(dim=(0, 2)) + 1e-6
        union = (pred ** 2 + gt).sum(dim=(0, 2)) + 2e-6
        return 1.0 - torch.mean(2.0 * intersection / union)
    return fn


class Mix:
    """Coefficient-weighted sum of sub-losses divided by the COUNT of
    sub-losses.  Returns ``(total, {name: value})``."""

    def __init__(self, losses: Dict[str, Callable],
                 coefficients: Optional[Dict[str, float]] = None):
        self.losses = losses
        self.coefficients = coefficients or {k: 1.0 for k in losses}

    def __call__(self, target: Dict, predict: Dict):
        results = {k: fn(target, predict) for k, fn in self.losses.items()}
        total = sum(results[k] * self.coefficients[k]
                    for k in results) / len(results)
        return total, results
