"""Ensemble serving over whole volumes: the device-facing part of the
evaluation harness (``multimodal_fusion_fpn_tpu/eval/harness.py:54-98,
148-307``).

:func:`evaluate` is the loop of ``run_evaluation_instance``: each image's
model inputs are zero-padded to bucket multiples (:func:`bucket_pad`, the
default bucket 64 of ``validate_ensemble.py``), images of the same true
shape are grouped into one dispatch of up to ``eval_batch``, the ensemble
step runs (with the Hausdorff distances on the device when a metric asks
for them), and each image's prediction is cropped back to its true extent
before its metrics row is computed (:func:`compute_metrics`).  Padding
changes no prediction: the model evaluates over the true extents.  Rows
come out in input order.

Not here yet: the data loader and the noise of the JAX harness, the
artifacts (PNGs, CSV, JSON), the global metrics and the twin of
``validate_ensemble.py``.
"""

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_fusion_fpn_torch.train.step import MODEL_KEYS

FUSED_HD_KEYS = ("__device_hd__", "__device_hd95__")


def bucket_pad(batch: Mapping, bucket: int) -> Dict:
    """Zero-pad the model input volumes (``image``, ``slo``, ``faf``, each
    (B, C, D, H, W)) so every non-singleton spatial extent is a multiple of
    the bucket, and attach the true extents as ``__valid_image__`` (D, H, W)
    and ``__valid_enface__`` (H, W).  Extents under 2 * bucket take the
    finer bucket max(16, bucket // 4), so the relative padding of the short
    B-scan axis stays small (the rule of ``_bucket_pad``)."""
    out = dict(batch)
    for k in ("image", "slo", "faf"):
        v = out.get(k)
        if v is None or not hasattr(v, "shape") or v.ndim != 5:
            continue
        pads = [(0, 0)] * 5
        for d in (2, 3, 4):
            n = v.shape[d]
            if n > 1:
                b = bucket if n >= 4 * bucket // 2 else max(16, bucket // 4)
                pads[d] = (0, -(-n // b) * b - n)
        if any(p != (0, 0) for p in pads):
            if k == "image":
                out["__valid_image__"] = np.asarray(v.shape[2:5], np.int32)
            else:
                out["__valid_enface__"] = np.asarray((v.shape[2],
                                                      v.shape[4]), np.int32)
            out[k] = np.pad(np.asarray(v), pads)
    return out


def compute_metrics(output: Mapping, batch: Mapping, metrics_val: Mapping,
                    results: List, results_dict: Dict) -> Dict:
    """One image's metrics row (``harness.py:54-98``): each metric of
    ``metrics_val`` against the mask, and the GA area in mm^2 from the
    spacing (``Area``, ``Area_manual``, ``Area_diff``).  Appends the row to
    ``results`` and its Dice to ``results_dict`` under the image's
    ``FileSetId``, which must be new."""
    row = {}
    output_np = np.asarray(output["prediction"])
    for c in ("VRCPatId", "FileSetId"):
        if c in batch:
            v = batch[c]
            row[c] = v[0] if isinstance(v, (list, np.ndarray)) else v
    identifier = row["FileSetId"]
    if "mask" in batch:
        host_out = {"prediction": output_np}
        host_out.update({k: output[k] for k in FUSED_HD_KEYS if k in output})
        for m, metric in metrics_val.items():
            row[m] = float(np.asarray(
                metric.calculate_batch(batch, host_out)).item())
    if identifier in results_dict:
        raise ValueError("Identifier already in results_dict")
    results_dict[identifier] = row.get("Dice", row.get("WeightedL1"))
    if "spacing" in batch:
        spacing = np.asarray(batch["spacing"][0])
        row["Area"] = float((output_np[0, 0] > 0.5).sum()
                            * spacing[0] * spacing[2])
        if "mask" in batch:
            mask = np.asarray(batch["mask"])[0, 0]
            row["Area_manual"] = float((mask > 0.5).sum()
                                       * spacing[0] * spacing[2])
            row["Area_diff"] = row["Area"] - row["Area_manual"]
    results.append(row)
    return row


def _host(v):
    return v.float().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def evaluate(step: Callable, batches: Iterable[Mapping],
             metrics_val: Mapping, shape_bucket: int = 64,
             eval_batch: int = 1,
             block_fusion: Optional[str] = None) -> Tuple[List[Dict], Dict]:
    """Run the ensemble ``step`` (``eval.ensemble.make_ensemble_eval_step``,
    built ``with_hd`` when a metric has ``device=True``) over ``batches``:
    dicts of numpy arrays in the reference layout with B = 1 and a
    ``FileSetId``.  ``shape_bucket`` 0 runs each image at its own shape.
    ``block_fusion`` (None, "pair" or "chain") goes to the step as its
    keyword when it is given.  Returns (the metrics rows in input order,
    {FileSetId: Dice})."""
    use_hd_device = any(getattr(m, "device", False)
                        for m in metrics_val.values())
    kw = {} if block_fusion is None else {"block_fusion": block_fusion}
    results, results_dict = [], {}
    pending = []   # (batch, model input, true (Y, X), spacing)

    def flush():
        if not pending:
            return
        # the extents are per dispatch: one true shape per group
        first = pending[0][1]
        group = {k: first[k] if k.startswith("__valid_")
                 else np.concatenate([p[1][k] for p in pending])
                 for k in first}
        if use_hd_device:
            sps = np.stack([p[3] for p in pending])
            out = step(group, sps if len(pending) > 1 else sps[0], **kw)
        else:
            out = step(group, **kw)
        out = {k: _host(v) for k, v in out.items()}
        n = len(pending)
        for i, (batch, _, true_yx, _) in enumerate(pending):
            per = {}
            for k, v in out.items():
                if k in FUSED_HD_KEYS:
                    per[k] = v if v.ndim == 0 else v[i]
                elif v.ndim >= 1 and v.shape[0] == n:
                    per[k] = v[i:i + 1]
                else:
                    per[k] = v
            if shape_bucket and per["prediction"].ndim == 5:
                per["prediction"] = per["prediction"][
                    :, :, :true_yx[0], :, :true_yx[1]]
            compute_metrics(per, batch, metrics_val, results, results_dict)
        pending.clear()

    group_key = None
    for batch in batches:
        model_in = {k: batch[k] for k in MODEL_KEYS if k in batch}
        # the mask is never padded, so its shape is the true extent of the
        # prediction (the volume's for a batch without one)
        ref = batch.get("mask", batch.get("image"))
        true_yx = (ref.shape[2], ref.shape[4])
        if shape_bucket:
            model_in = bucket_pad(model_in, shape_bucket)
        sp = (np.asarray(batch["spacing"][0], np.float32)[[0, 2]]
              if "spacing" in batch else np.ones(2, np.float32))
        key = tuple(sorted((k, np.shape(v)) for k, v in batch.items()
                           if isinstance(v, np.ndarray)))
        if pending and (key != group_key or len(pending) >= eval_batch):
            flush()
        group_key = key
        pending.append((batch, model_in, true_yx, sp))
        if len(pending) >= max(1, eval_batch):
            flush()
    flush()
    return results, results_dict
