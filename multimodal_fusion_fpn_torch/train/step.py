"""The train step (``multimodal_fusion_fpn_tpu/train/step.py:34-125``):
forward in train mode, the loss, the backward, the optimizer step and the
BatchNorm running-stat update, plus the per-sample Dice / BCE training
metrics.

With ``accum_steps > 1`` the batch values carry a leading
``(accum_steps, micro_batch, ...)`` shape: every micro-batch runs from the
same parameters, the gradients are averaged, the BatchNorm running stats
update once per micro-batch, and the optimizer takes one step.  Per-sample
metrics are concatenated over micro-batches, the loss, its parts and scalar
metrics averaged.
"""

from typing import Callable, Dict

import torch
from torch import nn

from multimodal_fusion_fpn_torch.metrics.device import (bce_scalar,
                                                        dice_per_sample)
from multimodal_fusion_fpn_torch.train.state import TrainState

MODEL_KEYS = ("image", "mask", "slo", "faf", "weight")


def model_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array keys the model and the loss consume, on ``device``."""
    return {k: torch.as_tensor(batch[k], device=device)
            for k in MODEL_KEYS if k in batch}


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    criterion: Callable, compute_train_metrics: bool = True,
                    accum_steps: int = 1, device="cuda") -> Callable:
    """``step(state, batch, kernels=True) -> aux`` with aux = {'loss',
    'parts', 'metrics'} (detached tensors); the step updates ``model``,
    ``optimizer`` and ``state.step`` in place.  ``kernels`` chooses the
    hand-written kernels or their plain versions."""

    def metrics_from(out, b):
        if not compute_train_metrics or "mask" not in b:
            return {}
        pred = out["prediction"].detach()
        return {"Dice": dice_per_sample(pred, b["mask"]),
                "BCE": bce_scalar(pred, b["mask"])}

    def forward_backward(b, kernels, scale):
        out = model(b, kernels=kernels)
        loss, parts = criterion(b, out)
        (loss * scale if scale != 1 else loss).backward()
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                metrics_from(out, b))

    def step(state: TrainState, batch, kernels: bool = True):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state holds another model or optimizer than "
                             "the step was made for")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        b = model_batch(batch, device)
        if accum_steps == 1:
            loss, parts, metrics = forward_backward(b, kernels, 1)
        else:
            loss, parts, metrics = 0.0, {}, {}
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in b.items()}
                li, pi, mi = forward_backward(mb, kernels, 1.0 / accum_steps)
                loss = loss + li
                parts = {k: parts.get(k, 0.0) + v for k, v in pi.items()}
                for k, v in mi.items():
                    metrics[k] = (v if k not in metrics else
                                  torch.cat([metrics[k], v]) if v.dim()
                                  else metrics[k] + v)
            loss = loss / accum_steps
            parts = {k: v / accum_steps for k, v in parts.items()}
            metrics = {k: v if v.dim() else v / accum_steps
                       for k, v in metrics.items()}
        optimizer.step()
        state.step += 1
        return {"loss": loss, "parts": parts, "metrics": metrics}

    return step
