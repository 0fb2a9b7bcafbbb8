"""Dict-in/dict-out transforms over 4D numpy arrays (C, H, D, W): the
port's copy of ``multimodal_fusion_fpn_tpu/data/transforms.py``, class for
class, with the same generator draws in the same order.

Behavioral parity with the original project's ``common/mytransforms.py``
(cited per class), with one idiomatic change: randomness is threaded
explicitly.  Every transform takes ``(data, rng)`` where ``rng`` is a
``numpy.random.Generator``, instead of mutating global ``random`` /
``np.random`` state — the host analogue of JAX's explicit PRNG keys,
and what makes the input pipeline reproducible per (seed, epoch, index)
regardless of worker scheduling.

Array layout per key (as produced by the datasets):
  * ``image``: (1, D, H, W) OCT volume (D = B-scans, H = depth, W = width)
  * ``mask`` / ``slo`` / ``faf``: (1, H_enface, 1, W)

Quirks of the reference that are kept deliberately (they affect trained
behavior): mask keys are matched by substring (``'mask' in key``); resize
uses scikit-image 0.17 semantics including its anti-aliasing default (see
:mod:`..ops.resize`); ``Compose`` hands the *same* dict to every
transform (in-place mutation is the contract).

Structure note: entries may be plain arrays or one-level dicts of
arrays (the reference re-implements that branch inside every class;
here it is centralized in :func:`apply_to_entry`), and geometric
transforms express their window/flip decision once as data (a
fractional window, an axis tuple) and project it onto each array —
rather than recomputing per-key slice arithmetic inline.
"""

import copy
from typing import List, Optional, Tuple, Union

import numpy as np
from scipy import ndimage

from multimodal_fusion_fpn_torch.ops.resize import resize


class Transform:
    def __init__(self, transform_keys: list):
        self.transform_keys = transform_keys

    def __call__(self, data: dict, rng: np.random.Generator):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: list):
        self.transforms = transforms

    def __call__(self, data: dict, rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng()
        for t in self.transforms:
            result = t(data, rng)
            if result is not None:
                data = result
        return data


def apply_to_entry(data: dict, key: str, fn):
    """Apply ``fn`` to the array stored at ``key``, descending one level
    into dict-valued entries (``None`` sub-entries are skipped — the
    reference's optional-modality convention)."""
    entry = data[key]
    if isinstance(entry, dict):
        for sub, arr in entry.items():
            if arr is not None:
                entry[sub] = fn(arr)
    else:
        data[key] = fn(entry)


def _entry_ndim(entry) -> int:
    """Rank of an entry's arrays.  Dict entries report the rank of
    sub-entry ``0`` — the reference's (quirky) probe
    (mytransforms.py:247: ``first[0].shape``)."""
    return entry[0].ndim if isinstance(entry, dict) else entry.ndim


def _resize_key(array: np.ndarray, shape, key: str) -> np.ndarray:
    order = 0 if "mask" in key else 1
    return resize(array, shape, order=order)


def _axis_shape(shape, active_dims) -> list:
    """Broadcast shape keeping only ``active_dims`` at full extent."""
    return [n if i in active_dims else 1 for i, n in enumerate(shape)]


class NewRandomRelCrop(Transform):
    """Pick a random crop window on the reference key and apply the same
    *relative* window to every key (singleton dims skipped).

    Parity: mytransforms.py:30-66 — including its rounding (start and
    length rounded independently per key) and the start-at-zero rule
    when the requested size exceeds the reference extent.
    """

    def __init__(self, reference_key: str, transform_keys: list,
                 size: List[Union[int, None]]):
        super().__init__(transform_keys)
        self.size = size
        self.reference_key = reference_key

    def _draw_window(self, ref_shape, rng) -> list:
        """One fractional (start, length) pair per active axis, ``None``
        for axes the crop leaves alone.  One rng draw per active axis,
        in axis order (fixed draw sequence = reproducible pipelines)."""
        window = []
        for extent, want in zip(ref_shape, self.size):
            if want is None:
                window.append(None)
                continue
            hi = extent - want
            lo = 0 if hi < 0 else int(rng.integers(0, hi, endpoint=True))
            window.append((lo / extent, want / extent))
        return window

    @staticmethod
    def _project(shape, window) -> tuple:
        """Realize the fractional window as slices on one array's shape.
        Inactive axes and singleton axes pass through whole."""
        slices = []
        for extent, frac in zip(shape, window):
            if frac is None or extent <= 1:
                slices.append(slice(None))
            else:
                lo = int(round(extent * frac[0]))
                slices.append(slice(lo, lo + int(round(extent * frac[1]))))
        return tuple(slices)

    def __call__(self, data: dict, rng: np.random.Generator):
        window = self._draw_window(data[self.reference_key].shape, rng)
        for k in self.transform_keys:
            data[k] = data[k][self._project(data[k].shape, window)]
        return data


class NewRandomRelFit(Transform):
    """Resize each non-None dim to the nearest multiple of ``fit``
    (min one multiple) — used at validation time so pooling divides
    evenly without padding.  Parity: mytransforms.py:69-97."""

    def __init__(self, transform_keys: list, fit: List[Union[int, None]]):
        super().__init__(transform_keys)
        self.fit = fit

    def __call__(self, data: dict, rng: np.random.Generator):
        for k in self.transform_keys:
            target = tuple(
                n if f is None else max(f, int(round(n / f) * f))
                for n, f in zip(data[k].shape, self.fit))
            if target != data[k].shape:
                data[k] = _resize_key(data[k], target, k)
        return data


class NewRandomRelSize(Transform):
    """Resize to fixed sizes per dim (None / singleton dims preserved).
    Parity: mytransforms.py:100-124."""

    def __init__(self, transform_keys: List[str],
                 fixed_size: List[Union[int, None]]):
        super().__init__(transform_keys)
        self.fixed_size = fixed_size

    def __call__(self, data: dict, rng: np.random.Generator):
        for k in self.transform_keys:
            target = tuple(
                n if want is None or n == 1 else want
                for n, want in zip(data[k].shape, self.fixed_size))
            if target != data[k].shape:
                data[k] = _resize_key(data[k], target, k)
        return data


class RandomRotation180(Transform):
    """Parity: mytransforms.py:127-140."""

    def __init__(self, keys: list):
        self.keys = keys

    def __call__(self, data: dict, rng: np.random.Generator):
        if rng.random() > 0.5:
            for k in self.keys:
                data[k] = np.rot90(data[k], k=2, axes=(1, 3))
        return data


class Disable(Transform):
    """Replace a key with all-zeros (1,1,1,1) — complementary-only
    ablations.  Parity: mytransforms.py:143-152."""

    def __init__(self, keys: list):
        self.keys = keys

    def __call__(self, data: dict, rng: np.random.Generator):
        for k in self.keys:
            data[k] = np.zeros((1,) * data[k].ndim)
        return data


class RandomEnfaceRotation(Transform):
    """Parity: mytransforms.py:155-172 (incl. the 'probablity' typo in
    the reference's kwarg name, kept for config compatibility)."""

    def __init__(self, keys: list, range: Tuple[float, float] = (-5.0, 5.0),
                 probablity: float = 0.5):
        self.keys = keys
        self.range = range
        self.probablity = probablity

    def __call__(self, data: dict, rng: np.random.Generator):
        if rng.random() < self.probablity:
            rotation = float(rng.uniform(*self.range))
            for k in self.keys:
                order = 0 if "mask" in k else 1
                data[k] = ndimage.rotate(
                    data[k], rotation, axes=(1, 3), reshape=False,
                    order=order, mode="constant", cval=0.0, prefilter=False)
        return data


class RandomDownsample(Transform):
    """Strided subsample along ``dimensions`` with a (possibly random)
    common start offset.  Parity: mytransforms.py:175-206."""

    def __init__(self, transform_keys: list, factor: int = 2,
                 dimensions: list = [1],
                 start_slice: Union[int, None] = None):
        super().__init__(transform_keys)
        self.factor = factor
        self.dimensions = dimensions
        self.start_slice = start_slice
        assert all(0 < dim < 4 for dim in dimensions)

    def __call__(self, data: dict, rng: np.random.Generator):
        if self.start_slice is None:
            start = int(rng.integers(0, self.factor - 1, endpoint=True))
        else:
            start = self.start_slice
        for k in self.transform_keys:
            for dim in self.dimensions:
                sl = [slice(None)] * 4
                sl[dim] = slice(start, None, self.factor)
                data[k] = data[k][tuple(sl)]
        return data


class RandomMirror(Transform):
    """Flip all keys along the same randomly-chosen subset of
    ``dimensions`` (one uniform draw per array axis; axis ``i`` flips
    when draw ``i`` < 0.5).  Parity: mytransforms.py:238-263."""

    def __init__(self, transform_keys: list, dimensions: list):
        super().__init__(transform_keys)
        self.dimensions = dimensions

    def __call__(self, data: dict, rng: np.random.Generator):
        ndim = _entry_ndim(data[self.transform_keys[0]])
        draws = rng.random(ndim)
        axes = tuple(d for d in self.dimensions if draws[d] < 0.5)
        for key in self.transform_keys:
            if key in data:
                apply_to_entry(
                    data, key,
                    lambda a: np.flip(a, axis=axes).copy() if axes else a)
        return data


def _standardize(arr: np.ndarray, axis, eps: float) -> np.ndarray:
    mu = arr.mean(axis=axis, keepdims=True)
    sd = arr.std(axis=axis, keepdims=True)
    return (arr - mu) / (sd + eps)


class ZScoreNormalization(Transform):
    """Per-array standardization over ``axis``.  Parity:
    mytransforms.py:266-296 — including its asymmetry: dict sub-entries
    divide by the raw std while plain arrays get a 1e-8 guard."""

    def __init__(self, transform_keys: list, axis):
        super().__init__(transform_keys)
        self.axis = axis

    def __call__(self, data: dict, rng: np.random.Generator):
        for key in self.transform_keys:
            if isinstance(data[key], dict):
                apply_to_entry(data, key,
                               lambda a: _standardize(a, self.axis, 0.0))
            else:
                apply_to_entry(data, key,
                               lambda a: _standardize(a, self.axis, 1e-8))
        return data


class IntensityShift(Transform):
    """One uniform additive shift per KEY (shared by its sub-entries).
    Parity: mytransforms.py:299-316."""

    def __init__(self, transform_keys: list, min: float = -0.6,
                 max: float = 0.6):
        super().__init__(transform_keys)
        self.min = min
        self.max = max

    def __call__(self, data: dict, rng: np.random.Generator):
        for key in self.transform_keys:
            shift = float(rng.uniform(self.min, self.max))
            apply_to_entry(data, key, lambda a: a + shift)
        return data


class ContrastAugmentation(Transform):
    """One uniform gain per KEY.  Parity: mytransforms.py:319-336."""

    def __init__(self, transform_keys: list, min: float = 0.6,
                 max: float = 1.4):
        super().__init__(transform_keys)
        self.min = min
        self.max = max

    def __call__(self, data: dict, rng: np.random.Generator):
        for key in self.transform_keys:
            gain = float(rng.uniform(self.min, self.max))
            apply_to_entry(data, key, lambda a: a * gain)
        return data


class AddNoiseAugmentation(Transform):
    """Additive gaussian noise shaped only along ``dim`` (broadcast over
    the other axes) — e.g. per-voxel (dim=(0,)) or per-B-scan (dim=(1,)).
    One noise draw per ARRAY.  Parity: mytransforms.py:339-362."""

    def __init__(self, transform_keys: list, dim, mu: float = 0.0,
                 sigma: float = 1.0):
        super().__init__(transform_keys)
        self.mu = mu
        self.sigma = sigma
        self.dim = dim

    def __call__(self, data: dict, rng: np.random.Generator):
        def add(a):
            return a + rng.normal(self.mu, self.sigma,
                                  size=_axis_shape(a.shape, self.dim))
        for key in self.transform_keys:
            apply_to_entry(data, key, add)
        return data


class MulNoiseAugmentation(Transform):
    """Multiplicative gaussian noise along ``dim`` (per-B-scan brightness
    jitter with mu=1).  One noise draw per ARRAY.  Parity:
    mytransforms.py:365-388."""

    def __init__(self, transform_keys: list, dim, mu: float = 1.0,
                 sigma: float = 1.0):
        super().__init__(transform_keys)
        self.mu = mu
        self.sigma = sigma
        self.dim = dim

    def __call__(self, data: dict, rng: np.random.Generator):
        def mul(a):
            return a * rng.normal(self.mu, self.sigma,
                                  size=_axis_shape(a.shape, self.dim))
        for key in self.transform_keys:
            apply_to_entry(data, key, mul)
        return data


class ToTensorDict(Transform):
    """Convert arrays to contiguous float32 (host-side; the device copy
    happens at batch collation).  API-parity name
    (mytransforms.py:209-235)."""

    def __init__(self, transform_keys: list):
        super().__init__(transform_keys)

    def __call__(self, data: dict, rng: np.random.Generator):
        for key in self.transform_keys:
            if key in data:
                apply_to_entry(
                    data, key,
                    lambda a: np.ascontiguousarray(a, dtype=np.float32))
        return data


def deepcopy_record(record: dict) -> dict:
    """Copy a record so transforms can mutate arrays safely."""
    out = {}
    for k, v in record.items():
        if isinstance(v, np.ndarray):
            out[k] = v.copy()
        elif isinstance(v, dict):
            out[k] = copy.deepcopy(v)
        else:
            out[k] = v
    return out
