"""Time two builds of the bf16 forward conv kernel
(``csrc/fused_conv_mma.cu``, the tensor cores) against each other at the
eval call shapes of one FPNHybridFusion member, within one process on one
GPU.

    python -m multimodal_fusion_fpn_torch.tools.forward_ab --other DIR

``DIR`` holds the other version's ``fused_conv_mma.cu`` and the headers it
includes (e.g. another commit's ``multimodal_fusion_fpn_torch/csrc``,
unpacked with ``git archive``).  Both are compiled with the package's nvcc
flags.  At every bf16 B=4 eval shape (ini widths, crop shapes) the script
times the stats-free instance of each build in the order other, this,
this, other (CUDA events, the best of each), checks that the two outputs
are bitwise equal, and prints one JSON line per shape, one line of totals
per 5-member ensemble step, and the register, stack and spill counts that
``cuobjdump -res-usage`` reports for each build's kernels (and for this
tree's backward kernels).
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
from types import SimpleNamespace

import torch

from multimodal_fusion_fpn_torch.ops import _build
from multimodal_fusion_fpn_torch.ops import fused_conv as fc

MEMBERS = 5
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def compile_lib(src_dir: str, tag: str) -> str:
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "ab",
                       f"fused_conv_mma-{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o",
                    out, os.path.join(src_dir, "fused_conv_mma.cu")],
                   check=True)
    return out


def entry(path: str):
    """``run(x, s, b, w, out, relu, sz)`` for the library at ``path``: its
    ``mmf_fused_conv_mma`` with the stats and extents pointers NULL."""
    fn = ctypes.CDLL(path).mmf_fused_conv_mma
    fn.argtypes = [_INT] * 4 + [_PTR] * 9 + [_INT] * 8 + [_PTR]
    fn.restype = _INT

    def run(x, s, b, w, out, relu, sz):
        B, Y, X, Z, ci = x.shape
        kY, kX, kz, _, co = w.shape
        rc = fn(kY, kX, kz, sz, x.data_ptr(), fc._ptr(s), fc._ptr(b),
                w.data_ptr(), out.data_ptr(), None, None, None, None,
                B, Y, X, Z, out.shape[3], ci, co, int(relu),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{path}: launch failed, CUDA error {rc}")
    return run


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eval_shapes():
    """{call key: calls per member} of one bf16 B=4 eval forward."""
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)
    model = build_model(cfg, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn((4, 1, 32, 496, 128), generator=g,
                                  device="cuda"),
             "slo": torch.randn((4, 1, 320, 1, 128), generator=g,
                                device="cuda")}
    fc.calls.clear()
    with torch.inference_mode():
        model(batch)
    torch.cuda.synchronize()
    return dict(fc.calls)


def res_usage(path: str):
    """[[kernel, REG, STACK, LOCAL], ...] from ``cuobjdump -res-usage``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-res-usage", path],
                          capture_output=True, text=True, check=True).stdout
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if m and name and "_kernel" in name:
            out.append([name, *(int(v) for v in m.groups())])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other version's "
                         "fused_conv_mma.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("forward_ab: CUDA is not available")
    libs = {"other": compile_lib(args.other, "other"),
            "this": compile_lib(_build.SRC_DIR, "this")}
    runs = {k: entry(path) for k, path in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {"other": 0.0, "this": 0.0}
    for key, n in sorted(eval_shapes().items(), key=str):
        name, xs, ws, sz, relu, affine = key[:6]
        x = torch.randn(xs, generator=gen, device="cuda").bfloat16()
        s = b = None
        if affine:
            s = (0.5 + torch.rand(xs[-1], generator=gen, device="cuda")
                 ).bfloat16()
            b = (0.5 * torch.randn(xs[-1], generator=gen, device="cuda")
                 ).bfloat16()
        w = (torch.randn(ws, generator=gen, device="cuda")
             / (ws[0] * ws[1] * ws[2] * ws[3]) ** 0.5).bfloat16()
        outs = {k: torch.empty(fc._out_shape(x, w, sz), dtype=x.dtype,
                               device="cuda") for k in runs}
        times = {k: [] for k in runs}
        for k in ("other", "this", "this", "other"):
            times[k].append(time_ms(
                lambda: runs[k](x, s, b, w, outs[k], relu, sz), args.reps))
        equal = torch.equal(outs["other"], outs["this"])
        for k in runs:
            totals[k] += MEMBERS * n * min(times[k])
        print(json.dumps({"kernel": name, "x": list(xs), "w": list(ws),
                          "stride_z": sz, "relu": relu, "affine": affine,
                          "calls_per_member": n, "other_ms": times["other"],
                          "this_ms": times["this"], "bitwise_equal": equal}),
              flush=True)
    print(json.dumps({"ensemble_step_ms": totals}), flush=True)
    libs["this fused_conv_bwd"] = _build.library_path("fused_conv_bwd")
    _build.build(["fused_conv_bwd"])
    for k, path in libs.items():
        print(json.dumps({"build": k, "res_usage": res_usage(path)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
