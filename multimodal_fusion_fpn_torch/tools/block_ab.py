"""Time two builds of the bf16 whole-block eval kernel on the tensor cores
(``csrc/fused_block_mma.cu``, K8) against each other, against its bf16
CUDA-core instance (``csrc/fused_block.cu``) and against the per-conv
kernel path, at the chain and pair call shapes of one FPNHybridFusion
member, within one process on one GPU.

    python -m multimodal_fusion_fpn_torch.tools.block_ab --other DIR

``DIR`` holds the other version's ``fused_block_mma.cu`` and the headers
it includes (``fused_conv_mma.cuh``, ``fused_conv_common.cuh``), e.g. an
older commit's ``multimodal_fusion_fpn_torch/csrc`` unpacked with ``git
archive``; its C interface must be this one's.  Both are compiled with the
package's nvcc flags.  At every bf16 B=4 chain and pair call of a
crop-shape eval forward (ini widths) the script times each build in the
order other, this, this, other (CUDA events, the best of each), the
CUDA-core instance and the per-conv kernel path once, checks that the two
builds' outputs are bitwise equal (and this build's to the tensor-core
per-conv path), and prints one JSON line per call shape, one line of totals
per 5-member ensemble step, and the register, stack and spill counts that
``cuobjdump -res-usage`` reports for each build's kernels.  Each shape's
line also has ``phases``: the share of one call's block cycles in each
phase of this build's kernel, from a copy compiled with
``-DMMF_K8_PROFILE`` (``mmf_k8_profile``; that copy's clock reads and
atomics make it slower, so it is not timed).
"""

import argparse
import ctypes
import json
import os
import subprocess
from types import SimpleNamespace

import torch

from multimodal_fusion_fpn_torch.ops import _build
from multimodal_fusion_fpn_torch.ops import fused_block as fb
from multimodal_fusion_fpn_torch.tools.forward_ab import res_usage, time_ms

MEMBERS = 5


LIB = "fused_block_mma"
# mmf_k8_profile's phase indices
PHASES = {0: "set_up", 1: "input_wait", 2: "row_barrier",
          8: "conv0_mma", 3: "conv0_epilogue", 4: "conv0_barrier",
          5: "next_row_copy", 9: "conv1_mma", 6: "conv1_ring_epilogue",
          7: "conv2_barrier", 10: "conv2_mma", 12: "output_staging_1x1",
          11: "output"}


def compile_lib(src_dir: str, tag: str, flags=()) -> str:
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "ab",
                       f"{LIB}-{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", src_dir,
                    "-o", out, os.path.join(src_dir, LIB + ".cu")],
                   check=True)
    return out


def phases(lib, kernel, fargs):
    """{phase: share of the block cycles} of one call of ``kernel`` on the
    profiled build ``lib``."""
    fn = lib.mmf_k8_profile
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_longlong * 16)()
    _build._loaded[LIB] = lib
    kernel(*fargs)
    torch.cuda.synchronize()
    fn(ctypes.addressof(out), 1)
    kernel(*fargs)
    torch.cuda.synchronize()
    fn(ctypes.addressof(out), 1)
    total = sum(out) or 1
    return {name: out[k] / total for k, name in PHASES.items()}


def block_shapes():
    """{call key: calls per member} of one bf16 B=4 eval forward under each
    block fusion."""
    from multimodal_fusion_fpn_torch.models.zoo import build_model
    cfg = SimpleNamespace(model="FPNHybridFusion", crop="relative_2d_max",
                          fusion_modality="slo", number_of_outputs=1)
    model = build_model(cfg, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn((4, 1, 32, 496, 128), generator=g,
                                  device="cuda"),
             "slo": torch.randn((4, 1, 320, 1, 128), generator=g,
                                device="cuda")}
    calls = {}
    for mode in ("chain", "pair"):
        fb.calls.clear()
        with torch.inference_mode():
            model(batch, block_fusion=mode)
        torch.cuda.synchronize()
        calls.update(fb.calls)
    return calls


def inputs(key, gen):
    """(kernel function, per-conv function, arguments, ``fb._launch``'s
    arguments) of one call key."""
    name, xs, wshapes, final, relu0, entry, _, _ = key
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    ci, co = xs[-1], wshapes[0][-1]
    affine = lambda n: ((0.5 + torch.rand(n, generator=gen, device="cuda")
                         ).bfloat16(), (0.5 * rnd(n)).bfloat16())
    s_in, b_in = affine(ci) if entry else (None, None)
    convs = []
    for ws in wshapes:
        fan = ws[0] * ws[1] * ws[2] * ws[3]
        convs.append(((rnd(*ws) / fan ** 0.5).bfloat16(), *affine(co)))
    x = rnd(*xs).bfloat16()
    if name == "fused_pair":
        return fb.fused_pair, fb.fused_pair_per_conv, (
            x, s_in, b_in, convs[0][0], convs[0][1], convs[0][2],
            convs[1][0], relu0), (name, x, s_in, b_in, relu0,
                                  [convs[0], (convs[1][0], None, None)],
                                  "raw", None, None)
    ds = None
    if final == "res_conv":
        ds = ((rnd(1, 1, 1, ci, co) / ci ** 0.5).bfloat16(), *affine(co))
    fargs = (x, s_in, b_in, relu0, convs, final, ds)
    return (fb.fused_chain, fb.fused_chain_per_conv, fargs,
            (name, *fargs, None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help=f"directory with the other version's {LIB}.cu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_ab: CUDA is not available")
    libs = {"other": compile_lib(args.other, "other"),
            "this": compile_lib(_build.SRC_DIR, "this")}
    cdll = {k: ctypes.CDLL(p) for k, p in libs.items()}
    profiled = ctypes.CDLL(compile_lib(_build.SRC_DIR, "profiled",
                                       ("-DMMF_K8_PROFILE",)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {"other": 0.0, "this": 0.0, "cuda_cores": 0.0, "per_conv": 0.0}
    for key, n in sorted(block_shapes().items(), key=str):
        kernel, per_conv, fargs, largs = inputs(key, gen)
        outs, times = {}, {k: [] for k in libs}
        for k in ("other", "this", "this", "other"):
            _build._loaded[LIB] = cdll[k]
            outs[k] = kernel(*fargs)
            times[k].append(time_ms(lambda: kernel(*fargs), args.reps))
        cc = lambda: fb._launch(*largs, tensor_cores=False)
        cc_ms = time_ms(cc, args.reps)
        pc = per_conv(*fargs)
        pc_ms = time_ms(lambda: per_conv(*fargs), args.reps)
        shares = phases(profiled, kernel, fargs)
        _build._loaded[LIB] = cdll["this"]
        equal = torch.equal(outs["other"], outs["this"])
        for k in libs:
            totals[k] += MEMBERS * n * min(times[k])
        totals["cuda_cores"] += MEMBERS * n * cc_ms
        totals["per_conv"] += MEMBERS * n * pc_ms
        print(json.dumps({"kernel": key[0], "x": list(key[1]),
                          "w": [list(w) for w in key[2]], "final": key[3],
                          "calls_per_member": n, "other_ms": times["other"],
                          "this_ms": times["this"], "cuda_cores_ms": cc_ms,
                          "per_conv_ms": pc_ms,
                          "plan_this": fb.plan(fargs[0], len(key[2]),
                                               key[2][0][-1], key[3]),
                          "bitwise_equal": equal,
                          "bit_equal_to_per_conv": torch.equal(outs["this"],
                                                               pc),
                          "phases": shares}),
              flush=True)
    print(json.dumps({"ensemble_step_ms": totals}), flush=True)
    for k, path in libs.items():
        print(json.dumps({"build": k, "res_usage": res_usage(path)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
