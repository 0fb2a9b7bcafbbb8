"""Profiling and step timing: the port's copy of ``multimodal_fusion_fpn_
tpu/profiling.py``.

  * :class:`StepTimer`: per-step wall-time statistics.  A step is done
    once its work on the device is: :meth:`StepTimer.stop` fetches
    ``sync_value`` (e.g. the loss) to the host, or synchronizes the card
    when the timer was made for a CUDA device.
  * :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
    trace (``trace.json``) under ``log_dir``; the profile itself is
    yielded, so the caller can read ``key_averages()``.  With a card it
    records the card's activity alone (its kernels and copies: the busy
    time), since the host's events of a whole training run take the
    profiler far longer to gather than the run takes; the host's time is
    the trainer's split and :class:`StepTimer`'s.  Without a card it
    records the CPU's.  Where the profiler cannot start, the block runs
    untraced and the profile is None.
"""

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


class StepTimer:
    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = torch.device(device) if device is not None else None
        self.times = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        """The seconds since :meth:`start`, after the host has fetched
        ``sync_value``, or (without one) after the card has finished its
        work when the timer's device is CUDA.  The first ``warmup`` steps
        are not kept."""
        if sync_value is not None:
            float(sync_value)
        elif self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "min_ms": float(arr.min() * 1e3),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block with ``torch.profiler`` when ``log_dir``
    is given: yields the profile (None without ``log_dir`` or when the
    profiler cannot start) and writes ``<log_dir>/trace.json`` at the
    end."""
    prof = None
    if log_dir is not None:
        activity = (torch.profiler.ProfilerActivity.CUDA
                    if torch.cuda.is_available()
                    else torch.profiler.ProfilerActivity.CPU)
        try:
            prof = torch.profiler.profile(activities=[activity])
            prof.__enter__()
        except Exception as exc:  # a platform without the profiler
            print(f"torch.profiler unavailable ({exc}); falling back to "
                  "step timing only")
            prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
