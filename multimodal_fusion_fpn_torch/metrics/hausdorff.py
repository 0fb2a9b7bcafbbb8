"""Hausdorff distances on the host (scipy), formula parity with MedPy
0.4.0: the port's copy of ``multimodal_fusion_fpn_tpu/metrics/
hausdorff.py``, the path the metric classes take when the distance is not
computed on the device.

The original project computes ``medpy.metric.binary.hd`` / ``hd95`` on 2D
en-face masks with ``voxelspacing=spacing[[0,2]]`` and (for hd95)
``connectivity=3`` (its ``common/metrics.py:402,449``).

MedPy's definition: the surface of a mask is ``mask ^ binary_erosion(mask,
generate_binary_structure(ndim, connectivity))`` (with border value 0, so
the image border counts as surface); the directed surface distances are
the Euclidean distance transform of the complement of the other surface,
sampled at the surface voxels and scaled by the voxel spacing.  ``hd`` is
the max over both directions; ``hd95`` is the 95th percentile of the
concatenation of both directed distance sets.
"""

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage as ndi


def _surface_distances(result: np.ndarray, reference: np.ndarray,
                       voxelspacing: Optional[Sequence[float]] = None,
                       connectivity: int = 1) -> np.ndarray:
    result = np.atleast_1d(result.astype(bool))
    reference = np.atleast_1d(reference.astype(bool))
    if voxelspacing is not None:
        voxelspacing = np.asarray(voxelspacing, dtype=np.float64)
        if voxelspacing.ndim == 0:
            voxelspacing = np.full(result.ndim, float(voxelspacing))

    if 0 == np.count_nonzero(result):
        raise RuntimeError("The first supplied array does not contain any "
                           "binary object.")
    if 0 == np.count_nonzero(reference):
        raise RuntimeError("The second supplied array does not contain any "
                           "binary object.")

    footprint = ndi.generate_binary_structure(result.ndim, connectivity)
    result_border = result ^ ndi.binary_erosion(result, structure=footprint,
                                                iterations=1)
    reference_border = reference ^ ndi.binary_erosion(
        reference, structure=footprint, iterations=1)

    dt = ndi.distance_transform_edt(~reference_border,
                                    sampling=voxelspacing)
    return dt[result_border]


def hd(result: np.ndarray, reference: np.ndarray,
       voxelspacing: Optional[Sequence[float]] = None,
       connectivity: int = 1) -> float:
    """Symmetric Hausdorff distance (MedPy ``hd`` parity)."""
    hd1 = _surface_distances(result, reference, voxelspacing,
                             connectivity).max()
    hd2 = _surface_distances(reference, result, voxelspacing,
                             connectivity).max()
    return float(max(hd1, hd2))


def hd95(result: np.ndarray, reference: np.ndarray,
         voxelspacing: Optional[Sequence[float]] = None,
         connectivity: int = 1) -> float:
    """95th-percentile Hausdorff distance (MedPy ``hd95`` parity)."""
    hd1 = _surface_distances(result, reference, voxelspacing, connectivity)
    hd2 = _surface_distances(reference, result, voxelspacing, connectivity)
    return float(np.percentile(np.hstack((hd1, hd2)), 95))
