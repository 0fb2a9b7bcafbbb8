"""Per-image metric accumulators of the evaluation harness, on the host
(``multimodal_fusion_fpn_tpu/metrics/streaming.py:56-173,237-310``): Dice,
BCE, Precision, Recall, Hausdorff and Hausdorff95, with the original
project's conventions:

  * aggregation is ``np.nanmean`` over every accumulated per-image value;
  * Dice@0.5 is 1 when prediction and ground truth are both empty;
  * Precision and Recall are 1 when their denominator is empty;
  * the Hausdorff distances are taken on the mid-plane slice ``[:, 0]``
    with ``voxelspacing=spacing[[0, 2]]`` (hd95 at connectivity 3), are
    NaN when either mask is empty, and a RuntimeError is printed and
    skipped.

``device=True`` on a Hausdorff metric takes the distance from the device
(:func:`..device.hausdorff_device`, on ``torch_device``) instead of scipy;
when the ensemble step already computed it (``'__device_hd__'`` /
``'__device_hd95__'`` in the prediction dict) the value is read from there.
Inputs are numpy arrays (or anything ``np.asarray`` takes).
"""

from typing import Union

import numpy as np
import torch

from multimodal_fusion_fpn_torch.metrics.device import hausdorff_device
from multimodal_fusion_fpn_torch.metrics.hausdorff import hd as _hd
from multimodal_fusion_fpn_torch.metrics.hausdorff import hd95 as _hd95

Key = Union[int, str]


class Metrics:
    def __init__(self):
        self.accumulator = []

    def calculate_batch(self, ground: dict, predict: dict) -> np.ndarray:
        raise NotImplementedError

    def update(self, ground, predict):
        result = self.calculate_batch(ground, predict)
        if result is not None:
            self.accumulator.extend(np.atleast_1d(result).tolist())

    def extend_values(self, values):
        """Feed per-image values computed elsewhere."""
        self.accumulator.extend(np.atleast_1d(np.asarray(values)).tolist())

    def get(self):
        return np.nanmean(self.accumulator)

    def reset(self):
        self.accumulator = []


def _binary(a, threshold=0.5) -> np.ndarray:
    return (np.asarray(a) > threshold).astype(np.float64)


class Dice(Metrics):
    def __init__(self, output_key: Key = 0, target_key: Key = 0,
                 slice: int = 0, output_threshold: float = 0.5,
                 target_threshold: float = 0.5):
        super().__init__()
        self.output_key = output_key
        self.target_key = target_key
        self.slice = slice
        self.output_threshold = output_threshold
        self.target_threshold = target_threshold

    def calculate_batch(self, ground: dict, predict: dict) -> np.ndarray:
        pred = np.asarray(predict[self.output_key])
        gr = np.asarray(ground[self.target_key])
        assert gr[:, self.slice].shape == pred[:, self.slice].shape, (
            f"GT: {gr.shape}, Pred.: {pred.shape}")
        n = pred.shape[0]
        p = _binary(pred[:, self.slice], self.output_threshold).reshape(n, -1)
        g = _binary(gr[:, self.slice], self.target_threshold).reshape(n, -1)
        numerator = (p * g).sum(axis=1)
        denominator = (p + g).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = 2 * numerator / denominator
        r[denominator == 0.0] = 1
        return r


class _Ratio(Metrics):
    """tp / (the positives of prediction or ground truth), 1 when empty."""
    of_prediction = True

    def __init__(self, output_key: Key = 0, target_key: Key = 0,
                 slice: int = 0):
        super().__init__()
        self.output_key = output_key
        self.target_key = target_key
        self.slice = slice

    def calculate_batch(self, ground: dict, predict: dict) -> np.ndarray:
        pred = np.asarray(predict[self.output_key])[:, self.slice]
        gr = np.asarray(ground[self.target_key])[:, self.slice]
        n = pred.shape[0]
        p = _binary(pred).reshape(n, -1)
        g = _binary(gr).reshape(n, -1)
        tp = (p * g).sum(axis=1)
        denominator = (p if self.of_prediction else g).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = tp / denominator
        r[denominator == 0.0] = 1
        return r


class Precision(_Ratio):
    of_prediction = True


class Recall(_Ratio):
    of_prediction = False


class BCE(Metrics):
    def __init__(self, output_key: Key = 0, target_key: Key = 0, slice=0):
        super().__init__()
        self.output_key = output_key
        self.target_key = target_key
        self.slice = slice

    def calculate_batch(self, ground: dict, predict: dict) -> np.ndarray:
        pred = np.asarray(predict[self.output_key]).astype(np.float64)
        gr = np.asarray(ground[self.target_key]).astype(np.float64)
        if self.slice is not None:
            pred = pred[:, self.slice].reshape(-1)
            gr = gr[:, self.slice].reshape(-1)
        log_p = np.maximum(np.log(np.maximum(pred, 1e-300)), -100.0)
        log_1p = np.maximum(np.log(np.maximum(1.0 - pred, 1e-300)), -100.0)
        return np.array([-np.mean(gr * log_p + (1.0 - gr) * log_1p)])


class _HausdorffBase(Metrics):
    _fused_key = None   # '__device_hd__' / '__device_hd95__'
    connectivity = 1
    want95 = False

    def __init__(self, output_key: Key = 0, target_key: Key = 0,
                 slice: int = 0, device: bool = False,
                 torch_device="cuda"):
        super().__init__()
        self.output_key = output_key
        self.target_key = target_key
        self.slice = slice
        self.device = device
        self.torch_device = torch_device

    def _distance(self, p, g, spacing):
        if self.device:
            sp = [1.0, 1.0] if spacing is None else list(spacing)
            hd_v, hd95_v = hausdorff_device(
                torch.as_tensor(p, device=self.torch_device),
                torch.as_tensor(g, device=self.torch_device), sp,
                connectivity=self.connectivity)
            return float(hd95_v if self.want95 else hd_v)
        fn = _hd95 if self.want95 else _hd
        return fn(p, g, voxelspacing=spacing, connectivity=self.connectivity)

    def calculate_batch(self, ground: dict, predict: dict) -> np.ndarray:
        if self.device and self._fused_key in predict:
            # computed by the ensemble step beside the prediction
            return np.array([float(predict[self._fused_key])])
        pred = (np.asarray(predict[self.output_key]) > 0.5).astype(np.uint8)
        gr = (np.asarray(ground[self.target_key]) > 0.5).astype(np.uint8)
        result = []
        for n in range(pred.shape[0]):
            p = pred[n, self.slice]
            g = gr[n, self.slice]
            if p.sum() == 0 or g.sum() == 0:
                result.append(np.nan)
                continue
            spacing = (np.asarray(ground["spacing"][n]).astype(np.float64)
                       if "spacing" in ground else None)
            try:
                vs = spacing[[0, 2]] if spacing is not None else None
                # the en-face mid-plane, as the original project
                result.append(self._distance(p[:, 0], g[:, 0], vs))
            except RuntimeError as exc:
                print(f"{type(self).__name__}:RuntimeError: {exc}")
        return np.array(result)


class Hausdorff(_HausdorffBase):
    _fused_key = "__device_hd__"
    connectivity = 1


class Hausdorff95(_HausdorffBase):
    _fused_key = "__device_hd95__"
    connectivity = 3
    want95 = True
