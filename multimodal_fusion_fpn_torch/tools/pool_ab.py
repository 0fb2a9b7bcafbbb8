"""Time two builds of the pool forward (K5f, ``csrc/pool.cu``) against each
other and against ``amax`` and ``F.max_pool3d`` at the pool's main-path
call shapes, within one process on one GPU.

    python -m multimodal_fusion_fpn_torch.tools.pool_ab --other DIR

``DIR`` holds the other version's ``pool.cu`` (e.g. another commit's
``multimodal_fusion_fpn_torch/csrc``, unpacked with ``git archive``).  Both
are compiled with the package's nvcc flags.  At every pool call shape of
one FPNHybridFusion member, bf16 B=4 and fp32 B=1, at the crop shapes and
at one bucket of whole volumes, the script runs each build's
``mmf_max_pool3d`` on the same seeded input, ``amax`` on the window view
and ``F.max_pool3d`` on the channels-first view, in turns on the device
alone (best of each), checks that the builds' outputs are bitwise equal
(randn input: no NaN, no zero), and prints one JSON line per shape with
the bytes bound, then per-step totals (5 members, bf16 B=4) and the
card's name and power limit.
"""

import argparse
import ctypes
import json

import torch
import torch.nn.functional as F

from multimodal_fusion_fpn_torch.ops import pool
from multimodal_fusion_fpn_torch.ops import _build
from multimodal_fusion_fpn_torch.tools import _ab

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def entry(lib):
    """``run(x, win, out)``: the library's ``mmf_max_pool3d``."""
    fn = lib.mmf_max_pool3d
    fn.argtypes = [_INT] + [_PTR] * 2 + [_INT] * 8 + [_PTR]
    fn.restype = _INT

    def run(x, win, out):
        rc = fn(pool._DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
                *x.shape, *win, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mmf_max_pool3d: launch failed, CUDA error "
                               f"{rc}")
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other version's pool.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pool_ab: CUDA is not available")
    runs = {"other": entry(_ab.compile_lib(args.other, "pool", "other")),
            "this": entry(_ab.compile_lib(_build.SRC_DIR, "pool",
                                          "this"))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals, all_equal = {}, True
    for dt, B in ((torch.bfloat16, 4), (torch.float32, 1)):
        for tag, calls in _ab.main_path_calls(pool, dt, B).items():
            for key, n in sorted(calls.items(), key=str):
                name, xs, win, dts = key
                x = torch.randn(xs, generator=gen, device="cuda").to(dt)
                oshape = (xs[0], xs[1] // win[0], xs[2] // win[1],
                          xs[3] // win[2], xs[4])
                outs = {k: torch.empty(oshape, dtype=dt, device="cuda")
                        for k in runs}
                xw, xc = pool._windows(x, win), x.permute(0, 4, 1, 2, 3)
                call = {"other": lambda: runs["other"](x, win, outs["other"]),
                        "this": lambda: runs["this"](x, win, outs["this"]),
                        "amax": lambda: xw.amax(dim=(2, 4, 6)),
                        "max_pool3d": lambda: F.max_pool3d(xc, win)}
                ms = _ab.in_turns(call, ("other", "this", "amax",
                                         "max_pool3d", "max_pool3d", "amax",
                                         "this", "other"), reps=args.reps)
                equal = torch.equal(outs["this"], outs["other"]) and \
                    torch.equal(outs["this"], xw.amax(dim=(2, 4, 6)))
                all_equal &= equal
                nbytes = (x.numel() + outs["this"].numel()) * x.element_size()
                bound = _ab.bytes_bound_ms(nbytes)
                if dt == torch.bfloat16:
                    for k in list(ms) + ["bound"]:
                        totals.setdefault(f"{tag} {k}", 0.0)
                        totals[f"{tag} {k}"] += _ab.MEMBERS * n * (
                            bound if k == "bound" else ms[k])
                print(json.dumps({
                    "kernel": name, "path": tag, "dtype": dts, "x": list(xs),
                    "window": list(win), "calls_per_member": n,
                    **{f"{k}_ms": v for k, v in ms.items()},
                    "bound_ms": bound, "this_over_bound": ms["this"] / bound,
                    "bitwise_equal": equal}), flush=True)
    print(json.dumps({"per_step_bf16_B4_ms": totals,
                      "all_bitwise_equal": all_equal, "card": _ab.card()}),
          flush=True)
    return 0 if all_equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
