"""Ensemble inference: the mean output of N members of one model
(``multimodal_fusion_fpn_tpu/train/step.py:148-204``,
``make_ensemble_eval_step``): every output the model returns is averaged
over the members, as the JAX step's ``jax.tree.map(jnp.mean, ...)`` does,
the late-fusion net's ``out_features`` included.  Any zoo model serves:
one with no en-face input (FPN) takes a batch without the en-face key, and
FPN2D's prediction comes at the mask's shape.

The JAX package vmaps the stacked member trees; here one module runs each
member's state dict in turn through ``torch.func.functional_call``.  A
batch padded by the harness's shape bucketing carries the true extents in
``__valid_image__`` / ``__valid_enface__``; they stay on the host and the
model evaluates exactly over them (:mod:`..eval.harness`).

``with_hd`` adds the Hausdorff distance (connectivity 1) and its 95th
percentile (connectivity 3) of the thresholded mean prediction's en-face
mid-plane against the mask, computed on the device
(:func:`..metrics.device.hausdorff_device`), as ``'__device_hd__'`` and
``'__device_hd95__'``.  The prediction is first cropped to the mask's
extent: under bucketing it is padded and the mask is not (the JAX step
compares the padded prediction and fails there, ROADMAP Queue 3).
"""

from typing import Callable, Mapping, Sequence

import torch
from torch import nn
from torch.func import functional_call

from multimodal_fusion_fpn_torch.metrics.device import hausdorff_device


def _hd_pair(pred2d, gt2d, spacing):
    """(hd at connectivity 1, hd95 at connectivity 3), the original
    project's pair (``common/metrics.py:402,449``)."""
    hd, _ = hausdorff_device(pred2d, gt2d, spacing, connectivity=1)
    _, hd95 = hausdorff_device(pred2d, gt2d, spacing, connectivity=3)
    return hd, hd95


def make_ensemble_eval_step(model: nn.Module,
                            state_dicts: Sequence[Mapping[str, torch.Tensor]],
                            device="cuda", with_hd: bool = False) -> Callable:
    """``step(batch, spacing=None, kernels=True, block_fusion=None) ->
    {each output of the model: its mean over members}`` (``block_fusion``:
    None, "pair" or "chain", the model's eval block fusion).

    ``batch`` maps names to arrays or tensors in the reference layout; they
    are moved to ``device``, except the reserved extent keys, which are
    read on the host.  Each mean is taken in fp32 and returned in the
    model's compute dtype, as ``jnp.mean`` does for the JAX ensemble.  With
    ``with_hd`` the step needs ``spacing``, (2,) for the first image or
    (B, 2) for each, and also returns the distances: 0-dim or (B,) fp32."""
    model = model.to(device).eval()
    members = [{k: v.to(device) for k, v in sd.items()}
               for sd in state_dicts]

    @torch.inference_mode()
    def ensemble_step(batch, spacing=None, kernels: bool = True,
                      block_fusion=None):
        b = {k: v if k.startswith("__valid_")
             else torch.as_tensor(v, device=device) for k, v in batch.items()}
        kw = {"kernels": kernels, "block_fusion": block_fusion}
        outs = [functional_call(model, sd, (b,), kw) for sd in members]
        out = {k: torch.stack([o[k] for o in outs]).float().mean(dim=0).to(
            outs[0][k].dtype) for k in outs[0]}
        if not with_hd:
            return out
        if spacing is None:
            raise ValueError("ensemble step with_hd: spacing is required")
        gt = b["mask"][:, 0, :, 0, :] > 0.5
        pred = out["prediction"][:, 0, :gt.shape[1], 0, :gt.shape[2]] > 0.5
        sp = torch.as_tensor(spacing, dtype=torch.float32)
        if sp.dim() == 1:
            hd, hd95 = _hd_pair(pred[0], gt[0], sp)
        else:
            pairs = [_hd_pair(p, g, s) for p, g, s in zip(pred, gt, sp)]
            hd = torch.stack([h for h, _ in pairs])
            hd95 = torch.stack([h for _, h in pairs])
        out["__device_hd__"], out["__device_hd95__"] = hd, hd95
        return out

    return ensemble_step
