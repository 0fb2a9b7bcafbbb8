"""Channels-last max pool with window == stride (floor output sizes).

Source note.  The CUDA kernel (``csrc/pool.cu``) replaces the TPU kernel
``multimodal_fusion_fpn_tpu/ops/pallas/pool.py:_pool_fwd_impl``
(``_fwd_row_kernel`` / ``_fwd_kernel``), which pools the packed (bs, nb)
layout.  On channels-last data that is a plain max pool.  It is bound by
memory on the H100 (each input byte read once, each output byte written
once); one thread per output element, consecutive threads on consecutive
channels, keeps every read coalesced.  2D maps (B, H, W, C) pool as
(B, H, 1, W, C) with window (wH, 1, wW).
"""

import collections
import ctypes
from typing import Sequence

import torch

from multimodal_fusion_fpn_torch.ops import _build

# Kernel launches since the last reset, and the call shapes they ran at:
# (kernel, x shape, window, dtype).
launches = {"max_pool3d_cl": 0}
calls: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def max_pool3d_cl_plain(x: torch.Tensor,
                        window: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version of :func:`max_pool3d_cl`."""
    wy, wx, wz = window
    B, Y, X, Z, C = x.shape
    Yo, Xo, Zo = Y // wy, X // wx, Z // wz
    v = x[:, :Yo * wy, :Xo * wx, :Zo * wz]
    return v.reshape(B, Yo, wy, Xo, wx, Zo, wz, C).amax(dim=(2, 4, 6))


def _lib():
    fn = _build.load("pool").mmf_max_pool3d
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def max_pool3d_cl(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, Y, X, Z, C) -> (B, Y//wy, X//wx, Z//wz, C): the CUDA kernel on a
    CUDA tensor, :func:`max_pool3d_cl_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return max_pool3d_cl_plain(x, window)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool3d_cl: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"max_pool3d_cl: unsupported dtype {x.dtype}")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError("max_pool3d_cl: x must be a contiguous "
                         f"(B, Y, X, Z, C) tensor, got {tuple(x.shape)}")
    wy, wx, wz = (int(w) for w in window)
    if min(wy, wx, wz) < 1:
        raise ValueError(f"max_pool3d_cl: bad window {tuple(window)}")
    B, Y, X, Z, C = x.shape
    out = torch.empty((B, Y // wy, X // wx, Z // wz, C), dtype=x.dtype,
                      device=x.device)
    rc = _lib()(_DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), B, Y, X, Z,
                C, wy, wx, wz,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"max_pool3d_cl: kernel launch failed, CUDA error {rc}")
    launches["max_pool3d_cl"] += 1
    calls[("max_pool3d_cl", tuple(x.shape), (wy, wx, wz),
           str(x.dtype))] += 1
    return out
