"""Ensemble serving over whole volumes: the port's copy of
``multimodal_fusion_fpn_tpu/eval/harness.py``.

:func:`evaluate` is the loop of ``run_evaluation_instance``: each image's
model inputs are zero-padded to bucket multiples (:func:`bucket_pad`, the
default bucket 64 of ``validate_ensemble.py``), images of the same true
shape are grouped into one dispatch of up to ``eval_batch``, the ensemble
step runs (with the Hausdorff distances on the device when a metric asks
for them), and each image's prediction is cropped back to its true extent
before its metrics row is computed (:func:`compute_metrics`).  Padding
changes no prediction: the model evaluates over the true extents.  Rows
come out in input order.  Every segmentation model of the zoo serves:
FPN's batches need no en-face map, FPN2D's prediction already has the
mask's (unpadded) shape, so the crop leaves it as it is, and the
late-fusion net's ``out_features`` pass through each image's output
uncropped.

Given an ``output_path``, :func:`compute_metrics` also writes each image's
artifacts (``info.json``, ``test.png``, ``test_soft.png``, ``mask.png``
once, and ``features.png`` from ``out_features``) and gathers every
prediction and mask into ``all_outputs``; the predictions are fp32 on the
host whatever the compute dtype, and ``all_outputs`` holds them as float64,
as the JAX harness's concatenation does.  :func:`run_evaluation_instance`
feeds :func:`evaluate` from the data loader (with the noise of
``--noise``), and :func:`get_mean_results` writes ``test_output.csv``,
``results_dict.json``, ``mean_results.json`` and ``global_metrics.json``
without pandas, with pandas' conventions (see :func:`write_csv` and
:func:`column_stats`).  The VRC global metrics and ``--debug-images``
(``viz.py``) are not ported yet.
"""

import csv
import functools
import json
import math
import os
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_fusion_fpn_torch.data.imageio_utils import imsave
from multimodal_fusion_fpn_torch.data.loader import DataLoader
from multimodal_fusion_fpn_torch.eval.noise import noise_classes
from multimodal_fusion_fpn_torch.ops.resize import resize
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


def _tick(timing: Optional[Dict[str, float]], part: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``timing[part]``; the time now."""
    now = time.perf_counter()
    if timing is not None:
        timing[part] = timing.get(part, 0.0) + now - t0
    return now


def _features_png(feats: np.ndarray) -> np.ndarray:
    """``features.png`` of the late-fusion net: the mean over each half of
    the channels (the 3D trunk's, the en-face net's) of the first image's
    mid-plane, side by side, resized to 256 x 512 and stretched to 0-255."""
    half = feats.shape[0] // 2
    f0 = feats[:half, :, 0, :].mean(axis=0)
    f1 = feats[half:, :, 0, :].mean(axis=0)
    combined = resize(np.concatenate((f0, f1), axis=1), (256, 512), order=1,
                      anti_aliasing=False)
    return (255 * (combined - combined.min())
            / (np.ptp(combined) + 1e-8)).astype(np.uint8)


def write_artifacts(output: Mapping, row: Dict, mask_crop: np.ndarray,
                    sample_output_path: str) -> None:
    """One image's files (``harness.py:110-137``): ``features.png`` when
    the output has ``out_features``, ``info.json`` (the metrics row),
    ``test.png`` (the prediction's mid-plane above 0.5), ``test_soft.png``
    (clipped to [0, 1]) and ``mask.png``, which an earlier run may have
    written already."""
    os.makedirs(sample_output_path, exist_ok=True)
    if "out_features" in output:
        imsave(os.path.join(sample_output_path, "features.png"),
               _features_png(np.asarray(output["out_features"])[0]))
    with open(os.path.join(sample_output_path, "info.json"), "w") as fp:
        json.dump(row, fp, indent=4)
    pred = np.asarray(output["prediction"])[0, 0][:, 0, :]
    imsave(os.path.join(sample_output_path, "test.png"),
           ((pred > 0.5) * 255).astype(np.uint8))
    imsave(os.path.join(sample_output_path, "test_soft.png"),
           (np.clip(pred, 0, 1) * 255).astype(np.uint8))
    mask_path = os.path.join(sample_output_path, "mask.png")
    if not os.path.exists(mask_path):
        imsave(mask_path,
               (np.clip(mask_crop[:, 0, :], 0, 1) * 255).astype(np.uint8))


def compute_metrics(output: Mapping, batch: Mapping, metrics_val: Mapping,
                    results: List, results_dict: Dict,
                    all_outputs: Optional[Dict] = None,
                    output_path: Optional[str] = None,
                    save_data: bool = True,
                    timing: Optional[Dict[str, float]] = None) -> Dict:
    """One image's metrics row (``harness.py:54-98``): each metric of
    ``metrics_val`` against the mask, and the GA area in mm^2 from the
    spacing (``Area``, ``Area_manual``, ``Area_diff``).  Appends the row to
    ``results`` and its Dice to ``results_dict`` under the image's
    ``FileSetId``, which must be new.  With ``all_outputs`` the
    prediction's and the mask's first image are appended to its ``pred``
    and ``gt``; with an ``output_path`` and ``save_data`` the image's
    artifacts go to ``output_path/<FileSetId>`` (:func:`write_artifacts`),
    and their seconds to ``timing["artifacts"]``."""
    t0 = time.perf_counter()
    row = {}
    output_np = np.asarray(output["prediction"])
    if all_outputs is not None:
        all_outputs["pred"] = np.concatenate(
            (all_outputs["pred"], output_np[0, 0].flatten()))
        all_outputs["gt"] = np.concatenate(
            (all_outputs["gt"], np.asarray(batch["mask"])[0, 0].flatten()))
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
    t0 = _tick(timing, "metrics", t0)
    if output_path is not None and save_data:
        write_artifacts(output, row, np.asarray(batch["mask"])[0, 0],
                        os.path.join(output_path, identifier))
        _tick(timing, "artifacts", t0)
    results.append(row)
    return row


def _host(v):
    return v.float().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def evaluate(step: Callable, batches: Iterable[Mapping],
             metrics_val: Mapping, shape_bucket: int = 64,
             eval_batch: int = 1,
             block_fusion: Optional[str] = None,
             all_outputs: Optional[Dict] = None,
             output_path: Optional[str] = None, save_data: bool = True,
             timing: Optional[Dict[str, float]] = None
             ) -> Tuple[List[Dict], Dict]:
    """Run the ensemble ``step`` (``eval.ensemble.make_ensemble_eval_step``,
    built ``with_hd`` when a metric has ``device=True``) over ``batches``:
    dicts of numpy arrays in the reference layout with B = 1 and a
    ``FileSetId``.  ``shape_bucket`` 0 runs each image at its own shape.
    ``block_fusion`` (None, "pair" or "chain") goes to the step as its
    keyword when it is given.  ``all_outputs``, ``output_path`` and
    ``save_data`` go to :func:`compute_metrics`.  A ``timing`` dict gathers
    the seconds spent taking batches from ``batches`` ("load"), in the
    step and its copy to the host ("step"), in the metrics ("metrics") and
    in writing files ("artifacts").  Returns (the metrics rows in input
    order, {FileSetId: Dice})."""
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
        t0 = time.perf_counter()
        if use_hd_device:
            sps = np.stack([p[3] for p in pending])
            out = step(group, sps if len(pending) > 1 else sps[0], **kw)
        else:
            out = step(group, **kw)
        out = {k: _host(v) for k, v in out.items()}
        _tick(timing, "step", t0)
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
            compute_metrics(per, batch, metrics_val, results, results_dict,
                            all_outputs, output_path, save_data, timing)
        pending.clear()

    group_key = None
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        _tick(timing, "load", t0)
        if batch is None:
            break
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


def create_val_dataloader(opt, val_ids, data_transform_val,
                          num_workers: int = 8) -> DataLoader:
    """The eval loader of ``opt``'s validation dataset: batches of one
    image in the split's order, the transforms without random draws."""
    val_data = opt.val_data(val_ids, data_transform_val=data_transform_val)
    return DataLoader(val_data, batch_size=1, shuffle=False,
                      drop_last=False, num_workers=num_workers,
                      transform_rng=False)


def _noised(loader, noise: Optional[str], seed: int):
    """The loader's batches, one modality corrupted by ``noise``
    ("<modality>-<type>-<level>", e.g. "slo-gaussian-0.2")."""
    if noise is None:
        yield from loader
        return
    modality, noise_type, level = noise.split("-")
    noise_fn = noise_classes[noise_type](float(level), seed=seed)
    for batch in loader:
        batch[modality] = noise_fn(batch[modality])
        yield batch


def run_evaluation_instance(opt, all_outputs: Dict, val_ids,
                            data_transform_val, step: Callable,
                            metrics_val: Mapping, results: List,
                            results_dict: Dict, output_path: str,
                            noise: Optional[str] = None,
                            debug_images: bool = False,
                            noise_seed: int = 1234,
                            shape_bucket: int = 0, eval_batch: int = 1,
                            kernels: bool = True,
                            timing: Optional[Dict[str, float]] = None
                            ) -> None:
    """Evaluate the ensemble ``step`` (``make_ensemble_eval_step`` over the
    members) over the validation ids (``harness.py:148-307``): the loader's
    batches, with ``noise`` applied, through :func:`evaluate`, which writes
    each image's artifacts under ``output_path`` when ``opt.save_data``
    and appends to ``all_outputs``, ``results`` and ``results_dict``.
    ``kernels=False`` runs the step's plain versions."""
    if debug_images:
        raise NotImplementedError(
            "--debug-images needs viz.py, which is not ported yet "
            "(ROADMAP M8)")
    if not kernels:
        step = functools.partial(step, kernels=False)
    loader = create_val_dataloader(opt, val_ids, data_transform_val)
    rows, scores = evaluate(step, _noised(loader, noise, noise_seed),
                            metrics_val, shape_bucket=shape_bucket,
                            eval_batch=eval_batch, all_outputs=all_outputs,
                            output_path=output_path,
                            save_data=opt.save_data, timing=timing)
    for row in rows:
        print(row)
    if set(scores) & set(results_dict):
        raise ValueError("Identifier already in results_dict")
    results.extend(rows)
    results_dict.update(scores)


# --- the run's tables, without pandas ------------------------------------

def _csv_field(v) -> str:
    """One field as ``DataFrame.to_csv`` writes it: floats in their
    shortest repr, NaN (and a missing key) as an empty field, strings
    quoted only when they must be."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    s = str(v)
    if any(c in s for c in ',"\n\r'):
        s = '"' + s.replace('"', '""') + '"'
    return s


def write_csv(path: str, rows: List[Mapping]) -> None:
    """``pd.DataFrame(rows).to_csv(path)``: the columns in order of first
    appearance, an unnamed index column 0..n-1."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w") as f:
        f.write(",".join([""] + [_csv_field(c) for c in columns]) + "\n")
        for i, row in enumerate(rows):
            f.write(",".join([str(i)] + [_csv_field(row.get(c))
                                         for c in columns]) + "\n")


def read_csv_columns(path: str, columns) -> Dict[str, np.ndarray]:
    """The named columns of a file :func:`write_csv` wrote, as float64
    (an empty field is NaN), as ``pd.read_csv(path, index_col=0)`` reads
    a numeric column."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        data = list(reader)
    out = {}
    for c in columns:
        j = header.index(c)
        out[c] = np.array([float(r[j]) if r[j] != "" else np.nan
                           for r in data], np.float64)
    return out


def column_stats(values: np.ndarray) -> Dict[str, float]:
    """pandas' Series statistics over the non-NaN values: mean, std
    (ddof 1, NaN below two values), median (the reference stores the mean
    there, ``test_utils.py:124``) and the linear 25th and 75th
    percentiles."""
    v = values[~np.isnan(values)]
    nan = float("nan")
    if v.size == 0:
        return {"mean": nan, "std": nan, "median": nan, "q25": nan,
                "q75": nan}
    with np.errstate(invalid="ignore"):
        mean = float(v.sum() / v.size)
        std = (float(np.sqrt(((v - mean) ** 2).sum() / (v.size - 1)))
               if v.size > 1 else nan)
        q25, q75 = (float(q) for q in np.quantile(v, [0.25, 0.75]))
    return {"mean": mean, "std": std, "median": mean, "q25": q25,
            "q75": q75}


def get_final_results_only(output_path: str, metrics_val: Mapping,
                           columns: Mapping[str, np.ndarray]) -> Dict:
    """``mean_results.json``: :func:`column_stats` of each metric's
    column."""
    mean_results = {k: column_stats(columns[k]) for k in metrics_val}
    for k, st in mean_results.items():
        print("Mean {}: {} std {} Q25 {} Q75 {}".format(
            k, st["mean"], st["std"], st["q25"], st["q75"]))
    with open(os.path.join(output_path, "mean_results.json"), "w") as fp:
        json.dump(mean_results, fp, indent=4)
    return mean_results


def compute_global_metrics(global_metrics: Mapping, all_outputs: Mapping,
                           output_path: str) -> Dict:
    """``global_metrics.json``: each global metric over every pixel of the
    run (HRF's set is empty)."""
    gm_results = {}
    for gm, metric in global_metrics.items():
        gm_results[gm] = float(metric.calculate(all_outputs["gt"],
                                                all_outputs["pred"]))
        print(f"{gm}: {gm_results[gm]}")
    with open(os.path.join(output_path, "global_metrics.json"), "w") as fp:
        json.dump(gm_results, fp, indent=4)
    return gm_results


def get_mean_results(opt, all_outputs: Mapping, results: List[Mapping],
                     results_dict: Mapping, output_path: str) -> None:
    """``test_output.csv`` and ``results_dict.json``, then the statistics
    of the CSV read back (``harness.py:340-352``) and the global
    metrics."""
    results_file = os.path.join(output_path, "test_output.csv")
    write_csv(results_file, results)
    with open(os.path.join(output_path, "results_dict.json"), "w") as fp:
        json.dump(results_dict, fp, indent=4)
    columns = read_csv_columns(results_file, list(opt.metrics_val))
    get_final_results_only(output_path, opt.metrics_val, columns)
    compute_global_metrics(opt.global_metrics, all_outputs, output_path)
