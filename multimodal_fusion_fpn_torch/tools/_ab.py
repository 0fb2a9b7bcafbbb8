"""Shared pieces of the A/B scripts that time another version's build of a
kernel source against this tree's, within one process on one GPU
(``k10_ab.py``, ``pool_ab.py``)."""

import ctypes
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import torch

from multimodal_fusion_fpn_torch.ops import _build

MEMBERS = 5
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# true whole-volume shapes of bucketed serving, (D, H, W) and en-face (H, W)
SERVE_OCT, SERVE_SLO, BUCKET = (48, 496, 176), (208, 176), 64
_busy = []


def compile_lib(src_dir: str, name: str, tag: str) -> ctypes.CDLL:
    """``src_dir/<name>.cu`` compiled with the package's nvcc flags into
    ``build/ab/<name>-<tag>.so`` and loaded."""
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "ab",
                       f"{name}-{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o",
                    out, os.path.join(src_dir, name + ".cu")], check=True)
    return ctypes.CDLL(out)


def device_ms(fn, reps=20, warm=3):
    """Device time per call: the calls are queued behind a long matmul, so
    the host's launch time stays out of the timed window."""
    for _ in range(warm):
        fn()
    if not _busy:
        g = torch.Generator(device="cuda").manual_seed(1)
        _busy.append(torch.randn(6144, 6144, generator=g, device="cuda"))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _busy[0] @ _busy[0]
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(runs, order=("other", "this", "this", "other"), **kw):
    """{name: best device ms} of each run, taken in ``order``."""
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(device_ms(runs[k], **kw))
    return {k: min(v) for k, v in times.items()}


def bytes_bound_ms(nbytes):
    return nbytes / PEAK_BYTES_PER_S * 1e3


def main_path_calls(module, dtype, B):
    """{"crop": calls, "bucketed": calls}: ``module.calls`` of one
    FPNHybridFusion member's eval forward (random weights) at the crop
    shapes (OCT (B, 1, 32, 496, 128), SLO (B, 1, 320, 1, 128)) and at one
    bucket of whole volumes (``bucket_pad`` of SERVE_OCT / SERVE_SLO)."""
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.harness import bucket_pad
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)
    model = build_model(cfg, dtype=dtype)
    rng = np.random.default_rng(0)
    crop = {"image": rng.normal(size=(B, 1, 32, 496, 128)),
            "slo": rng.normal(size=(B, 1, 320, 1, 128))}
    whole = bucket_pad({"image": rng.normal(size=(B, 1) + SERVE_OCT),
                        "slo": rng.normal(size=(B, 1, SERVE_SLO[0], 1,
                                                SERVE_SLO[1]))}, BUCKET)
    out = {}
    for tag, batch in (("crop", crop), ("bucketed", whole)):
        ops.reset_launches()
        with torch.inference_mode():
            model({k: v if k.startswith("__")
                   else torch.as_tensor(v, dtype=torch.float32,
                                        device="cuda")
                   for k, v in batch.items()})
        torch.cuda.synchronize()
        out[tag] = dict(module.calls)
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
