"""The train step (``multimodal_fusion_fpn_tpu/train/step.py:34-125``):
forward in train mode, the loss, the backward, the optimizer step and the
BatchNorm running-stat update, plus the per-sample Dice / BCE training
metrics; and the eval step (``step.py:137-145``), one model's forward in
eval mode (running-stat BatchNorm).

The dropout masks of a step come from the ``torch.Generator`` it is given
(the JAX step's ``rng``), drawn in the order of the forward; the trainer
seeds one per step from (seed, epoch, step in the epoch).

With ``accum_steps > 1`` the batch values carry a leading
``(accum_steps, micro_batch, ...)`` shape: every micro-batch runs from the
same parameters, the gradients are averaged, the BatchNorm running stats
update once per micro-batch, and the optimizer takes one step.  Per-sample
metrics are concatenated over micro-batches, the loss, its parts and scalar
metrics averaged.
"""

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.metrics.device import (bce_scalar,
                                                        dice_per_sample)
from multimodal_fusion_fpn_torch.models.blocks import dropout_generator
from multimodal_fusion_fpn_torch.train.state import TrainState

MODEL_KEYS = ("image", "mask", "slo", "faf", "weight")


def model_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array keys the model and the loss consume, on ``device``."""
    return {k: torch.as_tensor(batch[k], device=device)
            for k in MODEL_KEYS if k in batch}


def train_metrics(out: Dict, b: Dict, compute: bool = True) -> Dict:
    """The per-sample Dice and the scalar BCE of a train forward."""
    if not compute or "mask" not in b:
        return {}
    pred = out["prediction"].detach()
    return {"Dice": dice_per_sample(pred, b["mask"]),
            "BCE": bce_scalar(pred, b["mask"])}


def run_micro_batches(model: nn.Module, criterion: Callable, b: Dict,
                      kernels: bool, accum_steps: int,
                      metrics_from: Callable):
    """Forward and backward of ``b`` (a leading micro-batch axis when
    ``accum_steps`` > 1), the gradients averaged over the micro-batches
    into ``.grad``: (loss, parts, metrics), detached, the loss and its
    parts averaged, per-sample metrics (``metrics_from(out, micro_batch)``)
    concatenated and scalar ones averaged."""

    def forward_backward(mb, scale):
        out = model(mb, kernels=kernels)
        loss, parts = criterion(mb, out)
        (loss * scale if scale != 1 else loss).backward()
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                metrics_from(out, mb))

    if accum_steps == 1:
        return forward_backward(b, 1)
    loss, parts, metrics = 0.0, {}, {}
    for i in range(accum_steps):
        mb = {k: v[i] for k, v in b.items()}
        li, pi, mi = forward_backward(mb, 1.0 / accum_steps)
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
    return loss, parts, metrics


def check_state(state: TrainState, model: nn.Module,
                optimizer: torch.optim.Optimizer) -> None:
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("state holds another model or optimizer than "
                         "the step was made for")


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    criterion: Callable, compute_train_metrics: bool = True,
                    accum_steps: int = 1, device="cuda") -> Callable:
    """``step(state, batch, kernels=True, generator=None) -> aux`` with
    aux = {'loss', 'parts', 'metrics'} (detached tensors); the step updates
    ``model``, ``optimizer`` and ``state.step`` in place.  ``kernels``
    chooses the hand-written kernels or their plain versions; ``generator``
    (on ``device``) draws the dropout masks, which a model with dropout
    needs."""

    def metrics_from(out, b):
        return train_metrics(out, b, compute_train_metrics)

    def step(state: TrainState, batch, kernels: bool = True,
             generator: Optional[torch.Generator] = None):
        check_state(state, model, optimizer)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        b = model_batch(batch, device)
        with (dropout_generator(generator) if generator is not None
              else contextlib.nullcontext()):
            loss, parts, metrics = run_micro_batches(
                model, criterion, b, kernels, accum_steps, metrics_from)
        optimizer.step()
        state.step += 1
        return {"loss": loss, "parts": parts, "metrics": metrics}

    return step


def make_eval_step(model: nn.Module, device="cuda") -> Callable:
    """``eval_step(batch, kernels=True) -> the model's outputs``: one
    forward in eval mode (running-stat BatchNorm, dropout off) without
    gradients, on ``device``; the model returns to the mode it was in."""

    @torch.inference_mode()
    def eval_step(batch, kernels: bool = True):
        was_training = model.training
        model.eval()
        try:
            return model(model_batch(batch, device), kernels=kernels)
        finally:
            model.train(was_training)

    return eval_step
