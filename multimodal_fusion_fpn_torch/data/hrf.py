"""HRF GA-segmentation dataset (OCT volume + SLO/FAF en-face): the port's
copy of ``multimodal_fusion_fpn_tpu/data/hrf.py``.

Disk-layout parity with the original project's
``common/dataloader_hrf_spec_aligned_seg.py:13-112``,
expressed as a modality-source table (see :mod:`.sources`):

  * ``bscan_flat.<id>.npy`` OCT volume -> ``image`` (1, D, H, W);
  * ``spacing.<id>.npy`` when ``get_spacing``;
  * mask PNG /256 then >=0.5 — FAF-derived
    (``preprocessed_images/bscan_size.mask_faf.*``) or OCT-derived
    (``mask_oct.*``);
  * complementary modality: SLO (/256) or FAF (inverted then /256),
    each (1, H, 1, W), from the ``preprocessed_images/bscan_size.``
    pre-resized variants when ``crop == 'oct'``.
"""

import json
from typing import Dict, Optional, Union

from multimodal_fusion_fpn_torch.data.abstract import (AbstractDataset,
                                                     hrf_visit_row)
from multimodal_fusion_fpn_torch.data.sources import NpySource, PngSource

_MASKS = {
    "faf": PngSource("preprocessed_images/bscan_size.mask_faf.{id}.png",
                     binarize="ge"),
    "oct": PngSource("mask_oct.{id}.png", binarize="ge"),
}


def _hrf_plan(mask_variant: str, fusion_modality: Optional[str],
              crop: str, get_spacing: bool) -> Dict:
    if mask_variant not in _MASKS:
        raise ValueError(f"Unknown mask variant: {mask_variant}")
    plan = {"image": NpySource("bscan_flat.{id}.npy")}
    if get_spacing:
        plan["spacing"] = NpySource("spacing.{id}.npy", layout="raw")
    plan["mask"] = _MASKS[mask_variant]
    # Pre-resized 2D images when training on raw-OCT-sized crops
    # (reference :66-69).
    prefix = "preprocessed_images/bscan_size." if crop == "oct" else ""
    if fusion_modality == "slo":
        plan["slo"] = PngSource(prefix + "slo.{id}.png")
    elif fusion_modality == "faf":
        plan["faf"] = PngSource(prefix + "faf.{id}.png", invert=True)
    else:
        raise ValueError(f"Unknown fusion modality: {fusion_modality}")
    return plan


class HRF_SPEC_Dataset(AbstractDataset):
    def __init__(self, path, patients: Optional[Union[dict, list]] = None,
                 multiplier=1, patches_from_single_image=1, transforms=None,
                 mask_variant="faf", get_spacing=False,
                 visits_fn: Optional[str] = None,
                 crop: str = "none",
                 fusion_modality: Optional[str] = "slo",
                 debug: bool = False):
        self.path = path
        self.multiplier = multiplier
        self.patches_from_single_image = patches_from_single_image
        self.transforms = transforms
        self.debug = debug
        assert visits_fn is not None
        with open(visits_fn) as fp:
            self.visits = json.load(fp)
        self._plan = _hrf_plan(mask_variant, fusion_modality, crop,
                               get_spacing)
        self._finish_init(patients)
        print(f"HRF dataset: {self.real_length} scans")

    def visit_row(self, patient_id: str, visit: dict) -> Dict:
        return hrf_visit_row(self.path, patient_id, visit)

    @property
    def plan(self) -> Dict:
        return self._plan
