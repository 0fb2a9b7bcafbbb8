"""Ensemble inference: the mean prediction of N members of one model
(``multimodal_fusion_fpn_tpu/train/step.py:148-174``,
``make_ensemble_eval_step(model, with_hd=False)``).

The JAX package vmaps the stacked member trees; here one module runs each
member's state dict in turn through ``torch.func.functional_call``.  The
eval harness, its metrics and the device Hausdorff distance are not
ported yet, nor is exact shape bucketing (which is bit-exact to this
unbucketed run).
"""

from typing import Callable, Mapping, Sequence

import torch
from torch import nn
from torch.func import functional_call


def make_ensemble_eval_step(model: nn.Module,
                            state_dicts: Sequence[Mapping[str, torch.Tensor]],
                            device="cuda") -> Callable:
    """``step(batch, kernels=True) -> {'prediction': mean over members}``.

    ``batch`` maps names to arrays or tensors in the reference layout; they
    are moved to ``device``.  The mean is taken in fp32 and returned in the
    model's compute dtype, as ``jnp.mean`` does for the JAX ensemble."""
    model = model.to(device).eval()
    members = [{k: v.to(device) for k, v in sd.items()}
               for sd in state_dicts]

    @torch.inference_mode()
    def ensemble_step(batch, kernels: bool = True):
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        preds = [functional_call(model, sd, (b,), {"kernels": kernels})
                 ["prediction"] for sd in members]
        mean = torch.stack(preds).float().mean(dim=0)
        return {"prediction": mean.to(preds[0].dtype)}

    return ensemble_step
