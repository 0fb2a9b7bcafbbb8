#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. Build the CUDA kernels from ``multimodal_fusion_fpn_torch/csrc``
   (``nvcc`` for sm_90a, one process per source, in parallel) and print
   the card's name and power limit.
2. Kernels against their plain PyTorch versions, on the card, at every
   call shape of the main path: the shapes are taken from one member's
   forward at each of the two end-to-end configurations below.  fp32 runs
   with TF32 off and must agree to max-abs-err <= 1e-4 * max|y|; bf16 by
   cosine >= 0.999 and a norm ratio within 1%.  Each shape prints a JSON
   line with the kernel's, the plain version's and one library call's
   time (``library_ms``: ``F.conv3d`` on the already activated input, or
   ``F.max_pool3d``; a yardstick only, the port never calls it) and the
   least time the card could take (``bound_ms``).
3. End to end: the 5-member ensemble of FPNHybridFusion at the ini widths,
   seeded weights with seeded non-trivial BatchNorm running stats, at the
   crop shapes (OCT (B, 1, 32, 496, 128), SLO (B, 1, 320, 1, 128)): bf16 at
   B=4 (the main path) and fp32 at B=1.  The kernel path is held against
   ``kernels=False`` on the card, one member's small-input output against
   the CPU, and every kernel's launch count must grow.  Images/s come from
   CUDA events: the best of four timings of three steps per path, the
   two paths taken in turns.  One more step per path runs under
   ``torch.profiler`` for the card's busy time and its largest kernels.
4. A ``kernels`` JSON line (per kernel: launches in the main path's run,
   max-abs-err of the fp32 comparisons, and per-ensemble-step times summed
   over the main path's bf16 calls), the card line, and last the
   ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, without CUDA or without the package.
"""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

PEAK_BYTES_PER_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12,          # dense bf16 tensor cores
              "torch.float32": 67e12}            # fp32 outside tensor cores
CUDA_CORE_FLOPS = PEAK_FLOPS["torch.float32"]    # fp32 FMA units, any type
MEMBERS = 5
OCT_YZX = (32, 496, 128)
SLO_HW = (320, 128)
KERNELS = {
    "fused_conv": ("multimodal_fusion_fpn_torch/csrc/fused_conv.cu",
                   "multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py:375"),
    "fused_conv_ky3": ("multimodal_fusion_fpn_torch/csrc/fused_conv.cu",
                       "multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py:2580"),
    "max_pool3d_cl": ("multimodal_fusion_fpn_torch/csrc/pool.cu",
                      "multimodal_fusion_fpn_tpu/ops/pallas/pool.py:117"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, warm=2):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(y, ref, dtype):
    """(ok, stats): fp32 by max-abs-err <= 1e-4 * max|ref|, bf16 by
    cosine >= 0.999 and norm ratio within 1%."""
    import torch
    y, ref = y.double(), ref.double()
    err = (y - ref).abs().max().item()
    peak = ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        y.flatten(), ref.flatten(), dim=0).item()
    ratio = (y.norm() / ref.norm()).item()
    finite = bool(torch.isfinite(y).all())
    if dtype == torch.float32:
        ok = finite and err <= 1e-4 * peak
    else:
        ok = finite and cos >= 0.999 and abs(ratio - 1) <= 0.01
    return ok, dict(max_err=err, max_ref=peak, cos=cos, norm_ratio=ratio)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_conv_shape(key, n_calls, gen):
    """Kernel vs plain (vs F.conv3d) at one recorded fused_conv call."""
    import torch
    import torch.nn.functional as F
    from multimodal_fusion_fpn_torch.ops import fused_conv as fc
    name, xs, ws, sz, relu, affine, dts = key
    dt = getattr(torch, dts.split(".")[1])
    dev = "cuda"
    x = torch.randn(xs, generator=gen, device=dev).to(dt)
    s = b = None
    if affine:
        s = (0.5 + torch.rand(xs[-1], generator=gen, device=dev)).to(dt)
        b = (0.5 * torch.randn(xs[-1], generator=gen, device=dev)).to(dt)
    fan_in = ws[0] * ws[1] * ws[2] * ws[3]
    w = (torch.randn(ws, generator=gen, device=dev) / fan_in ** 0.5).to(dt)
    y = fc.fused_conv(x, s, b, w, relu, sz)
    ref = fc.fused_conv_plain(x, s, b, w, relu, sz)
    torch.cuda.synchronize()
    ok, stats = compare(y, ref, dt)
    t = fc.affine_relu(x, s, b, relu).permute(0, 4, 1, 2, 3)
    wl = w.permute(4, 3, 0, 1, 2).contiguous()
    pad = tuple(k // 2 for k in ws[:3])
    esize = x.element_size()
    n_out = y.numel()
    nbytes = (x.numel() + w.numel() + n_out) * esize
    if affine:
        nbytes += 2 * xs[-1] * esize
    flops = 2.0 * n_out * ws[0] * ws[1] * ws[2] * ws[3]
    b_ms, b_by = bound(nbytes, flops, dts)
    # the kernel accumulates on the fp32 CUDA cores whatever the type
    cc_ms = max(nbytes / PEAK_BYTES_PER_S, flops / CUDA_CORE_FLOPS) * 1e3
    rec = dict(kernel=name, dtype=dts, x=list(xs), w=list(ws), stride_z=sz,
               relu=relu, affine=affine, calls_per_member=n_calls,
               flop=flops, bytes=nbytes, bound_cuda_cores_ms=cc_ms,
               kernel_ms=time_ms(lambda: fc.fused_conv(x, s, b, w, relu, sz)),
               plain_ms=time_ms(
                   lambda: fc.fused_conv_plain(x, s, b, w, relu, sz)),
               library_ms=time_ms(lambda: F.conv3d(
                   t, wl, stride=(1, 1, sz), padding=pad)),
               bound_ms=b_ms, bound_by=b_by, ok=ok, **stats)
    return rec


def check_pool_shape(key, n_calls, gen):
    import torch
    import torch.nn.functional as F
    from multimodal_fusion_fpn_torch.ops import pool
    name, xs, win, dts = key
    dt = getattr(torch, dts.split(".")[1])
    x = torch.randn(xs, generator=gen, device="cuda").to(dt)
    y = pool.max_pool3d_cl(x, win)
    ref = pool.max_pool3d_cl_plain(x, win)
    torch.cuda.synchronize()
    exact = torch.equal(y, ref)
    nbytes = (x.numel() + y.numel()) * x.element_size()
    b_ms, b_by = bound(nbytes, float(x.numel()), dts)
    xc = x.permute(0, 4, 1, 2, 3)
    return dict(kernel=name, dtype=dts, x=list(xs), window=list(win),
                calls_per_member=n_calls,
                kernel_ms=time_ms(lambda: pool.max_pool3d_cl(x, win)),
                plain_ms=time_ms(lambda: pool.max_pool3d_cl_plain(x, win)),
                library_ms=time_ms(lambda: F.max_pool3d(xc, win)),
                bound_ms=b_ms, bound_by=b_by, ok=exact,
                max_err=(y.float() - ref.float()).abs().max().item())


def trace_step(step, batch, kernels):
    """One step under torch.profiler: the card's busy time (the sum of its
    kernels' durations, ms) and the largest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, kernels=kernels)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return busy, [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                  for e in top]


def make_batch(B, seed):
    rng = np.random.default_rng(seed)
    Y, Z, X = OCT_YZX
    H, W = SLO_HW
    return {"image": rng.normal(size=(B, 1, Y, Z, X)).astype(np.float32),
            "slo": rng.normal(size=(B, 1, H, 1, W)).astype(np.float32)}


def member_state_dicts(model, n):
    """Seeded weights (the package's init) with seeded non-trivial
    BatchNorm affines and running stats, so no prologue is the identity."""
    import torch
    from multimodal_fusion_fpn_torch.weights import init_state_dict
    out = []
    for seed in range(n):
        sd = {k: v.cpu() for k, v in init_state_dict(model, seed).items()}
        gen = torch.Generator().manual_seed(1000 + seed)
        for k, v in sd.items():
            if k.endswith("running_mean"):
                v.normal_(0.0, 0.5, generator=gen)
            elif k.endswith("running_var"):
                v.uniform_(0.5, 2.0, generator=gen)
            elif k.endswith(".1.weight") and v.dim() == 1:
                v.normal_(1.0, 0.1, generator=gen)
            elif k.endswith(".1.bias"):
                v.normal_(0.0, 0.1, generator=gen)
        out.append(sd)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from multimodal_fusion_fpn_torch import ops
    from multimodal_fusion_fpn_torch.eval.ensemble import \
        make_ensemble_eval_step
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    from multimodal_fusion_fpn_torch.ops import _build, fused_conv, pool

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []

    # --- 1. build ---------------------------------------------------------
    t0 = time.time()
    _build.build(["fused_conv", "pool"])
    for name in ("fused_conv", "pool"):
        _build.load(name)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": [_build.library_path(n) for n in ("fused_conv",
                                                          "pool")]})

    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)

    configs = [("bf16_B4", torch.bfloat16, 4), ("fp32_B1", torch.float32, 1)]
    models = {tag: build_model(cfg, dtype=dt) for tag, dt, _ in configs}
    sds = member_state_dicts(models["fp32_B1"], MEMBERS)

    # --- 2. kernels vs plain at every main-path call shape ---------------
    shapes = {}
    for tag, dt, B in configs:
        model = models[tag]
        model.load_state_dict(sds[0])
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in make_batch(B, 0).items()}
        ops.reset_launches()
        with torch.inference_mode():
            model(batch)
        torch.cuda.synchronize()
        shapes[tag] = (dict(fused_conv.calls), dict(pool.calls),
                       ops.kernel_launches())
        emit({"phase": "shapes", "config": tag,
              "launches_per_member": shapes[tag][2]})
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    for tag, _, _ in configs:
        conv_calls, pool_calls, _ = shapes[tag]
        for key, n in sorted(conv_calls.items(), key=str):
            rec = check_conv_shape(key, n, gen)
            records[(tag, key)] = rec
            emit(rec)
        for key, n in sorted(pool_calls.items(), key=str):
            rec = check_pool_shape(key, n, gen)
            records[(tag, key)] = rec
            emit(rec)
    bad = [r for r in records.values() if not r["ok"]]
    if bad:
        failures.append(f"{len(bad)} kernel/plain comparisons failed")

    # --- 3. end to end ----------------------------------------------------
    main_launches = None
    for tag, dt, B in configs:
        model = models[tag]
        step = make_ensemble_eval_step(model, sds)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in make_batch(B, 1).items()}
        step(batch, kernels=False)
        step(batch)
        torch.cuda.synchronize()
        ops.reset_launches()
        pred = step(batch)["prediction"]
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
        ref = step(batch, kernels=False)["prediction"]
        torch.cuda.synchronize()
        if tag == "bf16_B4":
            main_launches = launches
        ok, stats = compare(pred.float() - 0.5, ref.float() - 0.5, dt)
        if pred.shape != (B, 1, OCT_YZX[0], 1, OCT_YZX[2]):
            ok = False
        per_member = shapes[tag][2]
        counted = all(launches[k] == MEMBERS * per_member[k] > 0
                      for k in KERNELS)
        times = {}
        for kern in (False, True, True, False) * 2:
            times.setdefault(kern, []).append(
                time_ms(lambda: step(batch, kernels=kern), reps=3, warm=0))
        # the card's busy share: its kernel time over the step's time
        busy = {kern: trace_step(step, batch, kern) for kern in (True, False)}
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        emit({"phase": "e2e", "config": tag, "members": MEMBERS, "batch": B,
              "prediction_shape": list(pred.shape), "ok": ok,
              "launches": launches, "launches_match": counted,
              "step_ms_kernels": min(times[True]),
              "step_ms_plain": min(times[False]),
              "img_per_s_kernels": B * 1e3 / min(times[True]),
              "img_per_s_plain": B * 1e3 / min(times[False]),
              "step_ms_kernels_runs": times[True],
              "step_ms_plain_runs": times[False],
              "device_busy_ms_kernels": busy[True][0],
              "device_busy_ms_plain": busy[False][0],
              "device_busy_share_kernels": busy[True][0] / min(times[True]),
              "device_busy_share_plain": busy[False][0] / min(times[False]),
              "top_device_kernels_kernels": busy[True][1],
              "top_device_kernels_plain": busy[False][1],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "card": card, **stats})
        if not ok:
            failures.append(f"e2e {tag}: kernel path disagrees with plain")
        if not counted:
            failures.append(f"e2e {tag}: launches {launches} != "
                            f"{MEMBERS} x {per_member}")

    # one member on a small input against the CPU's plain path
    small = {"image": np.random.default_rng(2).normal(
        size=(1, 1, 8, 64, 32)).astype(np.float32),
        "slo": np.random.default_rng(3).normal(
        size=(1, 1, 80, 1, 32)).astype(np.float32)}
    model = models["fp32_B1"]
    model.load_state_dict(sds[1])
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v).cuda()
                     for k, v in small.items()})["prediction"].cpu()
        cpu_model = build_model(cfg, device="cpu")
        cpu_model.load_state_dict(sds[1])
        want = cpu_model({k: torch.from_numpy(v)
                          for k, v in small.items()})["prediction"]
    ok, stats = compare(got, want, torch.float32)
    emit({"phase": "small_vs_cpu", "ok": ok, **stats})
    if not ok:
        failures.append("small input: card disagrees with the CPU")

    # --- 4. summary -------------------------------------------------------
    summary = []
    for name, (source, replaces) in KERNELS.items():
        main = [r for (tag, _), r in records.items()
                if tag == "bf16_B4" and r["kernel"] == name]
        fp32 = [r for (tag, _), r in records.items()
                if tag == "fp32_B1" and r["kernel"] == name]
        per_step = lambda f: MEMBERS * sum(r[f] * r["calls_per_member"]
                                           for r in main)
        t_bytes = MEMBERS * sum(r["calls_per_member"] * r["bound_ms"]
                                for r in main if r["bound_by"] == "bytes")
        t_ops = MEMBERS * sum(r["calls_per_member"] * r["bound_ms"]
                              for r in main if r["bound_by"] != "bytes")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(r["max_err"] for r in fp32),
            "bf16_min_cos": min(r.get("cos", 1.0) for r in main),
            "ms": per_step("kernel_ms"), "plain_ms": per_step("plain_ms"),
            "bound_ms": per_step("bound_ms"),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": per_step("library_ms")})
        if main_launches[name] <= 0:
            failures.append(f"{name} was not launched on the main path")
    if failures:
        for f in failures:
            print("chip_smoke: FAILED:", f, file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
