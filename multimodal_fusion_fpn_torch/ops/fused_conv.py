"""Fused affine + ReLU + convolution on channels-last volumes.

    y = conv(relu?(x * scale + bias), w)      SAME padding k//2 per axis,
                                              z stride 1 or 2

``x`` is (B, Y, X, Z, ci), ``w`` the logical (kY, kX, kz, ci, co) kernel,
``scale``/``bias`` per input channel (the previous BatchNorm folded), or
both None for the identity.  Padding applies to the activated input: an
out-of-range tap reads 0, not relu(bias).  At z stride 2 the output depth
is (Z + 1) // 2.

Source note.  The CUDA kernel (``csrc/fused_conv.cu``) replaces the TPU
kernels ``multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py:_kernel``
(K1, via ``_fused_conv_pallas_mats``: the (1,3,3), (1,1,3), 1x1x1 and
stride-2 (1,1,3) convs) and ``_yck_kernel`` (K2, via
``_fused_conv_pallas_yck``: the (3,1,1) conv).  Both are one template
here, counted apart: ``launches["fused_conv"]`` for kY == 1 and
``launches["fused_conv_ky3"]`` for kY == 3.  The TPU kernel's second
input (``n_in=2``) is unused on every model path and is left out; so is
its training-only BN-stats epilogue and its ``preferred_element_type``
(the models always emit the compute dtype).  At the stage 1-3 shapes a
call is compute-bound on the H100 (about 37 GFLOP against 0.5 GB of
bf16 traffic at B=4); the kernel runs on the fp32 CUDA cores with the
activated input tile in shared memory and 16 output channels per thread
(see the .cu header).  Tensor cores are later work.

bf16: the prologue rounds like the JAX bf16 prologue (``x*s`` and then
``+b`` each rounded to bf16), products accumulate in fp32 and the output
is rounded once.  :func:`fused_conv_plain` rounds at the same points on
the prologue; its conv (cuDNN on the card) accumulates in another order.
"""

import collections
import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from multimodal_fusion_fpn_torch.ops import _build

# Kernel launches since the last reset, per kernel, and the call shapes
# they ran at: (kernel, x shape, w shape, z stride, relu, affine, dtype).
launches = {"fused_conv": 0, "fused_conv_ky3": 0}
calls: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS = {(1, 3, 3, 1), (3, 1, 1, 1), (1, 1, 1, 1), (1, 1, 3, 1), (1, 1, 3, 2)}


def affine_relu(x: torch.Tensor, scale: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """``relu?(x * scale + bias)`` in x's dtype (scale/bias both or None)."""
    t = x if scale is None else x * scale + bias
    return torch.relu(t) if relu else t


def conv3d_cl(t: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
              padding: Sequence[int]) -> torch.Tensor:
    """Plain channels-last conv: t (B, Y, X, Z, ci), w (kY, kX, kz, ci, co)
    -> contiguous (B, Y', X', Z', co)."""
    y = F.conv3d(t.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 stride=tuple(stride), padding=tuple(padding))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def fused_conv_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], w: torch.Tensor,
                     relu: bool, stride_z: int = 1) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_conv` (same contract)."""
    pad = tuple(k // 2 for k in w.shape[:3])
    return conv3d_cl(affine_relu(x, scale, bias, relu), w,
                     (1, 1, stride_z), pad)


def _check(x, scale, bias, w, stride_z):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv: unsupported dtype {x.dtype}")
    if x.dim() != 5 or w.dim() != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(f"fused_conv: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} mismatch")
    if tuple(w.shape[:3]) + (stride_z,) not in _TAPS:
        raise ValueError(f"fused_conv: no kernel for taps {tuple(w.shape[:3])}"
                         f" at z stride {stride_z}")
    ci, co = w.shape[3], w.shape[4]
    if ci % 8 or co % 16:
        raise ValueError(f"fused_conv: kernel needs ci % 8 == 0 and "
                         f"co % 16 == 0, got ci={ci}, co={co}")
    if (scale is None) != (bias is None):
        raise ValueError("fused_conv: scale and bias must both be given "
                         "or both be None")
    for name, t, shape in (("w", w, None), ("scale", scale, (ci,)),
                           ("bias", bias, (ci,))):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"fused_conv: {name} is {t.dtype} on {t.device},"
                             f" x is {x.dtype} on {x.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_conv: {name} shape {tuple(t.shape)}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_conv: {name} is not contiguous")


def _lib():
    lib = _build.load("fused_conv")
    fn = lib.mmf_fused_conv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_conv(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], w: torch.Tensor, relu: bool,
               stride_z: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; run
    :func:`fused_conv_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_conv_plain(x, scale, bias, w, relu, stride_z)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv: unsupported device {x.device}")
    _check(x, scale, bias, w, stride_z)
    B, Y, X, Z, ci = x.shape
    kY, kX, kz, _, co = w.shape
    Zo = (Z - 1) // stride_z + 1
    out = torch.empty((B, Y, X, Zo, co), dtype=x.dtype, device=x.device)
    rc = _lib()(_DTYPES[x.dtype], kY, kX, kz, stride_z, x.data_ptr(),
                None if scale is None else scale.data_ptr(),
                None if bias is None else bias.data_ptr(), w.data_ptr(),
                out.data_ptr(), B, Y, X, Z, Zo, ci, co, int(relu),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_conv: kernel launch failed, CUDA error {rc}")
    name = "fused_conv_ky3" if kY == 3 else "fused_conv"
    launches[name] += 1
    calls[(name, tuple(x.shape), tuple(w.shape), stride_z, bool(relu),
           scale is not None, str(x.dtype))] += 1
    return out
