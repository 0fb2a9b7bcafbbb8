"""VRC vessel-segmentation dataset (OCT volume + SLO en-face): the port's
copy of ``multimodal_fusion_fpn_tpu/data/vrc.py``.

Disk-layout parity with the original project's
``common/dataloader_vrc_vessel.py:15-172``, expressed as a modality-source
table (see :mod:`.sources`):

  * 'flat' variant: ``bscan_flat.<id>.npy`` (or the low-res
    ``preprocessed_images/bscan_flat.lr2.*`` when
    ``preprocessed_bscan='lr2'``); mask from
    ``preprocessed_images/bscan_size.vs_proj.dil.*.png`` (on the OCT's
    en-face grid) when ``mask_variant='sq_proj_dil'``, else
    ``preprocessed_images/vs.vmirror.*.png`` (on the SLO's) — the
    flat-variant mask stays BOOLEAN (> 0.5), a quirk of the original;
    the SLO from ``preprocessed_images/bscan_size.`` under ``crop='oct'``;
  * 'crop' variant: everything under ``cropped/`` with the float
    >= 0.5 mask convention; spacing still in the visit directory.
"""

import json
import os
from typing import Dict, Optional

from multimodal_fusion_fpn_torch.data.abstract import AbstractDataset
from multimodal_fusion_fpn_torch.data.sources import NpySource, PngSource


def _vrc_plan(oct_variant: str, preprocessed_bscan: Optional[str],
              mask_variant: Optional[str], crop: str,
              get_spacing: bool) -> Dict:
    if oct_variant == "flat":
        bscan = ("bscan_flat.{id}.npy" if preprocessed_bscan is None else
                 f"preprocessed_images/bscan_flat.{preprocessed_bscan}"
                 ".{id}.npy")
        mask = ("preprocessed_images/bscan_size.vs_proj.dil.{id}.png"
                if mask_variant == "sq_proj_dil"
                else "preprocessed_images/vs.vmirror.{id}.png")
        slo_prefix = ("preprocessed_images/bscan_size."
                      if crop == "oct" else "")
        plan = {
            "image": NpySource(bscan),
            "mask": PngSource(mask, binarize="gt"),
            "slo": PngSource(slo_prefix + "slo.{id}.png"),
        }
    elif oct_variant == "crop":
        plan = {
            "image": NpySource("cropped/bscan_crop.{id}.npy"),
            "mask": PngSource("cropped/vs_crop.{id}.png", binarize="ge"),
            "slo": PngSource("cropped/slo_crop.{id}.png"),
        }
    else:
        raise ValueError(f"Unknown OCT variant: {oct_variant}")
    if get_spacing:
        plan["spacing"] = NpySource("spacing.{id}.npy", layout="raw")
    return plan


class VRC_Dataset(AbstractDataset):
    def __init__(self, path, patients=None, multiplier=1,
                 patches_from_single_image=1, transforms=None,
                 mask_variant=None, get_spacing=False,
                 visits_fn: Optional[str] = None,
                 preprocessed_bscan: Optional[str] = None,
                 oct_variant: str = "flat",
                 crop: str = "none",
                 debug: bool = False):
        self.path = path
        self.multiplier = multiplier
        self.patches_from_single_image = patches_from_single_image
        self.transforms = transforms
        self.debug = debug
        assert visits_fn is not None
        with open(visits_fn) as fp:
            self.visits = json.load(fp)
        self._plan = _vrc_plan(oct_variant, preprocessed_bscan,
                               mask_variant, crop, get_spacing)
        self._finish_init(patients)
        print(f"VRC dataset: {self.real_length} scans")

    def visit_row(self, patient_id: str, visit: dict) -> Dict:
        return {
            "path": os.path.join(self.path, patient_id),
            "FileSetId": visit["FileSetId"],
            "VRCPatId": patient_id,
        }

    def expand_visits(self, patients):
        # VRC splits are plain patient lists (the id selection is an HRF
        # feature; the original loader implements only the list).
        if isinstance(patients, dict):
            raise NotImplementedError(
                "VRC selects by patient list, not FileSetIds")
        return super().expand_visits(patients)

    @property
    def plan(self) -> Dict:
        return self._plan
