"""Noise-robustness injectors: the port's copy of
``multimodal_fusion_fpn_tpu/eval/noise.py``, the same draws from the same
seed.

Behavioral parity with the original project's ``noise.py:15-76``:
evaluation-time corruption of one modality, selected by ``--noise
<modality>-<type> --noise-level x``.  ``GaussianNoise(level)`` adds N(0,
level*range) noise then min-max rescales back onto the original range;
``MaskingNoise(level)`` stamps ``level*200`` near-mean constant boxes
(each ≈10% of H/W and near-full depth).  Operates on host numpy batches (N, C, H, D, W) before
the step.

Idiom note: randomness is an explicit seeded ``numpy.random.Generator``
(the reference mixes ``random``/``np.random`` globals), and the masking
injector draws all patch values/corners up front as vectors before the
stamping sweep.
"""

import numpy as np

from multimodal_fusion_fpn_torch.registry import get_factory_adder

add_noise_class, noise_classes = get_factory_adder()


@add_noise_class("gaussian")
class GaussianNoise:
    """Additive white noise at ``level`` x the data range, rescaled back
    onto the original [min, max] (reference noise.py:18-46, incl. its
    1e-8-guarded unit normalization)."""

    def __init__(self, level: float, seed: int = 1234):
        self.level = level
        self.rng = np.random.default_rng(seed)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data)
        lo, hi = data.min(), data.max()
        sigma = self.level * (hi - lo)
        noisy = data + sigma * self.rng.standard_normal(
            data.shape).astype(data.dtype)
        span = noisy - noisy.min()
        return span / (span.max() + 1e-8) * (hi - lo) + lo


@add_noise_class("masking")
class MaskingNoise:
    """Stamp ``int(level * 200)`` constant boxes, each valued at the
    volume mean jittered by up to ±10% of the data range (reference
    noise.py:49-76).  Box extents: ``patch_size`` of H and W, and — the
    reference's convention — almost the WHOLE depth (D*(1-patch_size/2));
    singleton-depth (en-face) inputs skip the depth dimension."""

    def __init__(self, level: float, patch_size: float = 0.1,
                 seed: int = 1234):
        self.level = level
        self.num_masks = int(self.level * 200)
        self.patch_size = patch_size
        self.rng = np.random.default_rng(seed)

    def _box_extents(self, h, d, w):
        frac = self.patch_size
        return (max(int(h * frac), 1),
                max(int(d * (1 - frac / 2)), 1),
                max(int(w * frac), 1))

    def __call__(self, data: np.ndarray) -> np.ndarray:
        out = np.array(data, copy=True)
        H, D, W = out.shape[-3:]
        bh, bd, bw = self._box_extents(H, D, W)
        n = self.num_masks
        jitter = float(out.max() - out.min()) * 0.1
        values = out.mean() + self.rng.uniform(-jitter, jitter, size=n)
        # corner draws match the reference's exclusive-high randint
        corners_w = self.rng.integers(0, W - bw, size=n)
        corners_h = self.rng.integers(0, H - bh, size=n)
        with_depth = D > 1
        corners_d = (self.rng.integers(0, D - bd, size=n)
                     if with_depth else np.zeros(n, np.int64))
        for v, h0, d0, w0 in zip(values, corners_h, corners_d,
                                 corners_w):
            dsl = slice(d0, d0 + bd) if with_depth else slice(None)
            out[:, :, h0:h0 + bh, dsl, w0:w0 + bw] = v
        return out
