"""Host-side N-D resize replicating scikit-image 0.17.2 semantics: the
port's copy of ``multimodal_fusion_fpn_tpu/ops/resize.py`` (numpy and
scipy only).

The original project's preprocessing uses
``skimage.transform.resize(image, shape, order=0|1, preserve_range=True)``
(its ``common/mytransforms.py:102-107,142-147``).  The port does not
depend on scikit-image, so the exact 0.17.2 behavior is rebuilt on top of
``scipy.ndimage``:

  * output pixel ``i`` samples input coordinate ``f * (i + 0.5) - 0.5``
    (half-pixel centers), where ``f = n_in / n_out`` — skimage's N-D path
    builds this coordinate map and calls ``ndi.map_coordinates`` with
    ``mode='mirror'`` (skimage mode 'reflect' maps to ndimage 'mirror');
    ``scipy.ndimage.zoom(..., grid_mode=True, mode='mirror')`` computes the
    identical map, and multi-linear/nearest interpolation is separable so
    we zoom per axis.
  * anti-aliasing default (0.17.2): enabled when any axis downsamples and
    the dtype is not bool — *regardless of order* (the order-0 exclusion
    only landed in skimage 0.19).  Sigma per axis: ``max(0, (f - 1) / 2)``,
    applied as a single N-D gaussian with ``mode='mirror'`` before zooming.
  * the image is always converted to float64 (``preserve_range=True`` keeps
    the value range); order<=1 keeps output within the filtered input range
    so the final clip is a no-op and is skipped.
"""

from typing import Sequence

import numpy as np
from scipy import ndimage as ndi


def resize(image: np.ndarray, output_shape: Sequence[int],
           order: int = 1, anti_aliasing=None) -> np.ndarray:
    output_shape = tuple(int(s) for s in output_shape)
    input_shape = image.shape
    if len(output_shape) != image.ndim:
        raise ValueError("output_shape rank must match input rank")
    if output_shape == input_shape:
        return np.asarray(image, dtype=np.float64)

    factors = np.asarray(input_shape, dtype=float) / np.asarray(
        output_shape, dtype=float)

    if anti_aliasing is None:
        anti_aliasing = (image.dtype != bool
                         and any(o < i for o, i in
                                 zip(output_shape, input_shape)))

    img = np.asarray(image, dtype=np.float64)
    if anti_aliasing:
        sigma = np.maximum(0.0, (factors - 1.0) / 2.0)
        img = ndi.gaussian_filter(img, sigma, mode="mirror")

    for axis in range(img.ndim):
        if output_shape[axis] == img.shape[axis]:
            continue
        zoom = [1.0] * img.ndim
        zoom[axis] = output_shape[axis] / img.shape[axis]
        img = ndi.zoom(img, zoom, order=order, mode="mirror",
                       grid_mode=True, prefilter=False)
        assert img.shape[axis] == output_shape[axis], (
            img.shape, output_shape)
    return img
