"""Synthetic dataset generator in the reference's on-disk layout: the
port's copy of ``make_synthetic_hrf`` (``multimodal_fusion_fpn_tpu/data/
synthetic.py``), which writes the same records, its PNGs through the
port's own encoder (the same pixels, other bytes).

Creates an HRF-style dataset tree (the original project's
``README.md:21-78``):

    root/
      hrf_data.json                 visits JSON {patient: [visit, ...]}
      split.json                    {'train': [...], 'val': [...],
                                     'test': [...]}
      <FileSetId>/
        bscan_flat.<id>.npy         (D, H, W) float volume
        spacing.<id>.npy            (3,) voxel spacing in mm
        preprocessed_images/bscan_size.mask_faf.<id>.png
        preprocessed_images/bscan_size.slo.<id>.png   (crop='oct' variant)
        slo.<id>.png                en-face SLO
        faf.<id>.png                en-face FAF

so the full train→ensemble-eval pipeline can run end-to-end in tests and
benchmarks without real patient data.  Masks are random soft blobs
thresholded to reasonable GA-like regions; volumes carry the mask signal
at a depth band so the model has something learnable.
"""

import json
import os
from os.path import join

import numpy as np

from multimodal_fusion_fpn_torch.data.imageio_utils import imsave


def _blob_mask(rng, h, w, n_blobs=3):
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), dtype=np.float64)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0.2 * h, 0.8 * h), rng.uniform(0.2 * w, 0.8 * w)
        ry, rx = rng.uniform(0.05, 0.2) * h, rng.uniform(0.05, 0.2) * w
        mask += np.exp(-(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2))
    return (mask > 0.5).astype(np.float64)


def make_synthetic_hrf(root: str, n_patients: int = 4,
                       visits_per_patient: int = 1,
                       d: int = 32, h: int = 64, w: int = 128,
                       enface_h: int = 160, enface_w: int = 128,
                       seed: int = 0) -> dict:
    """Write a synthetic HRF-style dataset and return its paths dict."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    visits = {}
    all_patients = []
    for p in range(n_patients):
        pid = f"P{p:03d}"
        all_patients.append(pid)
        visits[pid] = []
        for v in range(visits_per_patient):
            fsid = f"{pid}V{v}"
            visits[pid].append({"FileSetId": fsid, "DayInStudy": v * 30,
                                "Position": "OD"})
            vdir = join(root, fsid)
            os.makedirs(join(vdir, "preprocessed_images"), exist_ok=True)

            mask = _blob_mask(rng, d, w)
            # Volume: noise + the mask signal smeared over a depth band.
            vol = rng.normal(0.3, 0.1, size=(d, h, w))
            band = slice(h // 4, h // 2)
            vol[:, band, :] += 0.5 * mask[:, None, :]
            np.save(join(vdir, f"bscan_flat.{fsid}.npy"),
                    vol.astype(np.float32))
            np.save(join(vdir, f"spacing.{fsid}.npy"),
                    np.array([0.12, 0.004, 0.012]))

            mask_png = (mask * 255).astype(np.uint8)
            imsave(join(vdir, "preprocessed_images",
                        f"bscan_size.mask_faf.{fsid}.png"), mask_png)
            imsave(join(vdir, f"mask_oct.{fsid}.png"), mask_png)

            # En-face modalities at their own (higher) resolution,
            # correlated with an upsampled mask.
            up = np.kron(mask, np.ones((max(1, enface_h // d),
                                        max(1, enface_w // w))))
            up = up[:enface_h, :enface_w]
            pad_h = enface_h - up.shape[0]
            pad_w = enface_w - up.shape[1]
            if pad_h or pad_w:
                up = np.pad(up, ((0, pad_h), (0, pad_w)))
            slo = np.clip(rng.normal(0.4, 0.15, size=(enface_h, enface_w))
                          + 0.4 * up, 0, 1)
            imsave(join(vdir, f"slo.{fsid}.png"),
                   (slo * 255).astype(np.uint8))
            imsave(join(vdir, f"faf.{fsid}.png"),
                   (255 - (slo * 255)).astype(np.uint8))
            # crop='oct' variants resized to the OCT en-face grid (D, W).
            slo_oct = (slo[:d, :w] * 255).astype(np.uint8)
            imsave(join(vdir, "preprocessed_images",
                        f"bscan_size.slo.{fsid}.png"), slo_oct)
            imsave(join(vdir, "preprocessed_images",
                        f"bscan_size.faf.{fsid}.png"), 255 - slo_oct)

    with open(join(root, "hrf_data.json"), "w") as fp:
        json.dump(visits, fp)

    n_train = max(1, int(0.5 * n_patients))
    n_val = max(1, (n_patients - n_train) // 2)
    split = {
        "train": all_patients[:n_train],
        "val": all_patients[n_train:n_train + n_val],
        "test": all_patients[n_train + n_val:] or all_patients[-1:],
    }
    with open(join(root, "split.json"), "w") as fp:
        json.dump(split, fp)

    return {"oct": root,
            "split": join(root, "split.json"),
            "visits": join(root, "hrf_data.json")}
