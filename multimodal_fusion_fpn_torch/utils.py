"""Generic utilities: the port's copy of ``multimodal_fusion_fpn_tpu/
utils.py``, with PyTorch in place of JAX.

:func:`count_parameters` and :func:`count_convs` give the JAX package's
numbers for the same net: the learnable parameters (conv kernels and
biases, BatchNorm scales and biases, not the running stats), and the conv
kernels, whose weights have 4 (2D) or 5 (3D) dimensions in both layouts.
:func:`device_prefetch` copies batches to the device on a thread, ``depth``
ahead of the consumer.
"""

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch import nn


class MonitorLearning:
    """Throttle debug-image dumps to one per minute (``utils.py:10-23``)."""

    def __init__(self):
        self.minute = -1

    def is_save_time(self) -> bool:
        now_minute = int(time.time() / 60)
        is_save_time = now_minute > self.minute
        if is_save_time:
            self.minute = now_minute
        return is_save_time


def normalize_data(data: np.ndarray, zero_nans: bool = True) -> np.ndarray:
    """Normalize data to the [0, 1] range (``utils.py:26-30``)."""
    if zero_nans:
        data = np.nan_to_num(data)
    return (data - np.min(data)) / (np.max(data) + 1e-10 - np.min(data))


def count_parameters(model: nn.Module) -> int:
    """Number of learnable parameters of ``model``."""
    return sum(p.numel() for p in model.parameters())


def count_convs(model: nn.Module) -> int:
    """Number of convolution kernels of ``model`` (weights of 4 or more
    dimensions, as the JAX package counts its ``kernel`` leaves)."""
    return sum(1 for name, p in model.named_parameters()
               if name.endswith("weight") and p.dim() >= 4)


def print_net_info(model: nn.Module) -> None:
    print("=====  Net info  =====")
    print("Layers:", count_convs(model))
    print("Parameters:", count_parameters(model))
    print("======================")


def tree_to_device(batch: Any, device) -> Any:
    """A (possibly nested) dict or list of numpy arrays with each array
    moved to ``device`` as a tensor; other values (ids, strings) pass
    through unchanged (``utils.py:54-71``)."""
    if isinstance(batch, dict):
        return {k: tree_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, list):
        return [tree_to_device(v, device) for v in batch]
    if isinstance(batch, np.ndarray):
        return torch.as_tensor(batch, device=device)
    return batch


def device_prefetch(iterator: Iterator, depth: int = 2,
                    transfer: Optional[Callable] = None,
                    device="cuda") -> Iterator:
    """Yield the items of ``iterator`` through ``transfer`` (default:
    :func:`tree_to_device` to ``device``), which a background thread runs
    ``depth`` items ahead of the consumer (``utils.py:74-139``).  The order
    is kept; an error of the iterator or of ``transfer`` is raised in the
    consumer; when the consumer abandons the generator (an exception in
    its loop, ``close``) the thread stops within a fraction of a second
    and the staged items are released."""
    if transfer is None:
        def transfer(item):
            return tree_to_device(item, device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer is gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(transfer(item)) or stop.is_set():
                    return
        except BaseException as exc:  # raised on the consumer side
            put(exc)
            return
        put(end)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
