"""Declarative on-disk modality sources: the port's copy of
``multimodal_fusion_fpn_tpu/data/sources.py``.

Each dataset describes its disk layout as a *plan*: a mapping from
record key ('image', 'mask', 'slo', ...) to an array source spec.  A
generic executor resolves the plan against a visit row.  This replaces
imperative per-dataset loader branches (the reference spells the same
information out long-hand in its
``common/dataloader_hrf_spec_aligned_seg.py:47-112`` and
``dataloader_vrc_vessel.py:75-172``) with data.

Numeric conventions preserved from the reference:

  * PNGs are divided by 256 (not 255);
  * FAF is inverted (``1 - x``) *before* the division — on the uint8
    arrays the subtraction wraps modulo 256, which is the reference's
    arithmetic too (so :func:`..imageio_utils.imread` returns uint8);
  * masks binarize either to float {0.,1.} at >= 0.5 ('ge') or to bool
    at > 0.5 ('gt', the VRC flat variant).

Array layouts: 'volume' (D,H,W)->(1,D,H,W); 'enface' (H,W)->(1,H,1,W);
'raw' passthrough (spacing vectors).
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from multimodal_fusion_fpn_torch.data.imageio_utils import imread

_LAYOUTS = {
    "volume": lambda a: a[None],
    "enface": lambda a: a[None, :, None, :],
    "raw": lambda a: a,
}


@dataclass(frozen=True)
class NpySource:
    """A ``.npy`` file; ``template`` contains an ``{id}`` placeholder."""
    template: str
    layout: str = "volume"

    def load(self, base: str, fsid: str) -> np.ndarray:
        arr = np.load(os.path.join(base, self.template.format(id=fsid)))
        return _LAYOUTS[self.layout](arr)


@dataclass(frozen=True)
class PngSource:
    """A PNG image with the reference's /256 intensity convention."""
    template: str
    layout: str = "enface"
    invert: bool = False
    binarize: Optional[str] = None  # None | 'ge' | 'gt'

    def load(self, base: str, fsid: str) -> np.ndarray:
        arr = imread(os.path.join(base, self.template.format(id=fsid)))
        if self.invert:
            arr = 1 - arr
        arr = arr / 256
        if self.binarize == "ge":
            arr = np.where(arr >= 0.5, 1.0, 0.0)
        elif self.binarize == "gt":
            arr = arr > 0.5
        return _LAYOUTS[self.layout](arr)


def resolve_plan(row: Dict, plan: Dict) -> Dict:
    """Execute a modality plan against a visit row: returns the row dict
    extended with one loaded array per plan entry."""
    record = dict(row)
    for key, source in plan.items():
        record[key] = source.load(record["path"], record["FileSetId"])
    return record
