"""Time two builds of K10's forward (``csrc/banded_conv.cu``) against each
other at the narrow-entry conv's main-path call shapes, within one process
on one GPU, and check that they give the same bits.

    python -m multimodal_fusion_fpn_torch.tools.k10_ab --other DIR

``DIR`` holds the other version's ``banded_conv.cu`` and the headers it
includes (e.g. another commit's ``multimodal_fusion_fpn_torch/csrc``,
unpacked with ``git archive``).  Both are compiled with the package's nvcc
flags.  At every K10 forward call shape of one FPNHybridFusion member,
bf16 B=4 and fp32 B=1, at the crop shapes and at one bucket of whole
volumes (with the extents), the script runs each build's
``mmf_banded_conv`` on the same seeded input in the order other, this,
this, other, on the device alone (best of each), times this tree's
generic kernel (``mmf_banded_conv_generic``) beside them, checks that
the builds' outputs (and the generic kernel's) are bitwise equal, and
prints one JSON line per shape with the bytes bound, then per-step
totals (5 members, bf16 B=4) and the card's name and power limit.
"""

import argparse
import ctypes
import json

import numpy as np
import torch

from multimodal_fusion_fpn_torch.ops import banded_conv as bc
from multimodal_fusion_fpn_torch.ops import _build
from multimodal_fusion_fpn_torch.tools import _ab

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = [_INT] * 4 + [_PTR] * 4 + [_INT] * 6 + [_PTR]


def entry(lib, name="mmf_banded_conv"):
    """``run(x, w, ext, out)`` for the forward entry point ``name``."""
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = _ARGS, _INT

    def run(x, w, ext, out):
        B, Y, X, Z, ci = x.shape
        kY, kX, kz, _, co = w.shape
        dyn = None if ext is None else (ctypes.c_int * 3)(*ext)
        rc = fn(bc._DTYPES[x.dtype], kY, kX, kz, x.data_ptr(), w.data_ptr(),
                out.data_ptr(), None if dyn is None else ctypes.addressof(dyn),
                B, Y, X, Z, ci, co, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other version's banded_conv.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k10_ab: CUDA is not available")
    other = _ab.compile_lib(args.other, "banded_conv", "other")
    this = _ab.compile_lib(_build.SRC_DIR, "banded_conv", "this")
    runs = {"other": entry(other), "this": entry(this),
            "generic": entry(this, "mmf_banded_conv_generic")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    all_equal = True
    for dt, B in ((torch.bfloat16, 4), (torch.float32, 1)):
        for tag, calls in _ab.main_path_calls(bc, dt, B).items():
            for key, n in sorted(calls.items(), key=str):
                name, xs, ws, dts, ext = key
                x = torch.randn(xs, generator=gen, device="cuda").to(dt)
                w = (torch.randn(ws, generator=gen, device="cuda")
                     / np.prod(ws[:4]) ** 0.5).to(dt)
                outs = {k: torch.empty(xs[:4] + (ws[4],), dtype=dt,
                                       device="cuda") for k in runs}
                call = {k: (lambda k=k: runs[k](x, w, ext, outs[k]))
                        for k in runs}
                ms = _ab.in_turns(call, ("other", "this", "generic", "this",
                                         "other"), reps=args.reps)
                ints = torch.int16 if dt == torch.bfloat16 else torch.int32
                equal = {k: torch.equal(outs[k].view(ints),
                                        outs["other"].view(ints))
                         for k in ("this", "generic")}
                all_equal &= all(equal.values())
                nbytes = (x.numel() + w.numel()
                          + int(np.prod(xs[:4])) * ws[4]) * x.element_size()
                bound = _ab.bytes_bound_ms(nbytes)
                if dt == torch.bfloat16:
                    for k in ms:
                        totals.setdefault(f"{tag} {k}", 0.0)
                        totals[f"{tag} {k}"] += _ab.MEMBERS * n * ms[k]
                    totals.setdefault(f"{tag} bound", 0.0)
                    totals[f"{tag} bound"] += _ab.MEMBERS * n * bound
                print(json.dumps({
                    "kernel": name, "path": tag, "dtype": dts, "x": list(xs),
                    "w": list(ws), "extents": ext, "calls_per_member": n,
                    "other_ms": ms["other"], "this_ms": ms["this"],
                    "generic_ms": ms["generic"], "bound_ms": bound,
                    "this_over_bound": ms["this"] / bound,
                    "bitwise_equal_to_other": equal["this"],
                    "generic_equal_to_other": equal["generic"]}),
                    flush=True)
    print(json.dumps({"per_step_bf16_B4_ms": totals,
                      "all_bitwise_equal": all_equal, "card": _ab.card()}),
          flush=True)
    return 0 if all_equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
