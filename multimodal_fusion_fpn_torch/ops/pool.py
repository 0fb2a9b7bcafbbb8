"""Channels-last max pool with window == stride (floor output sizes), and
its backward.

Two tie rules, as the JAX package's default lowering has them:

* all ties (the default): the cotangent goes to EVERY input that equals its
  window's max, with +0 == -0 (``pool.py:_tie_mask``, the Pallas pool's
  backward).  The JAX package pools the packed stage 1-3 outputs (at most
  64 channels) this way.
* ``first_max``: the cotangent goes to the first max in (Y, X, Z) window
  order, as XLA's ``reduce_window`` max VJP (``blocks.max_pool``, the
  compact 128-channel stage-4 pools in the JAX package) and
  ``F.max_pool3d`` do.

Source note.  The CUDA kernels (``csrc/pool.cu``) replace the TPU kernels
``multimodal_fusion_fpn_tpu/ops/pallas/pool.py:_pool_fwd_impl``
(``_fwd_row_kernel`` / ``_fwd_kernel``, K5f) and ``_pool_vjp_bwd``
(``_bwd_row_kernel`` / ``_bwd_kernel``, K5b), which pool the packed (bs, nb)
layout.  On channels-last data that is a plain max pool.  Both are bound by
memory on the H100 (each byte read once, each output byte written once).
Both run over a grid of pooled rows with 32-bit offsets inside a row, each
thread on 8 channels (16-byte vectors in bf16); C % 8 != 0 takes their
scalar lanes.  The forward gives a thread 2 or 4 consecutive pooled z
positions and loads all their window inputs before it reduces them, in the
storage type; the main path's windows are compiled instances.  The
backward loads ``y`` and ``g`` once, compares the window's inputs lane by
lane and zeroes the region beyond the floor-sized pool itself.  The
first-max backward stays plain PyTorch, as the JAX package leaves it to
XLA.  2D maps (B, H, W, C) pool as (B, H, 1, W, C) with window (wH, 1, wW).

NaN.  A window that holds a NaN pools to NaN, as ``jnp.maximum`` and
``amax`` give it (the kernel returns the type's canonical NaN).  The
all-ties backward gives the cotangent to every NaN input of a window whose
output is NaN, as the JAX backward's bit compare does wherever the
window's NaNs share one bit pattern; the first-max backward's NaN rule is
``F.max_pool3d``'s and is not held against JAX.
"""

import collections
import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_fusion_fpn_torch.ops.fused_conv import _fn, _stream

# Kernel launches since the last reset, and the call shapes they ran at:
# (kernel, x shape, window, dtype).
launches = {"max_pool3d_cl": 0, "max_pool3d_cl_bwd": 0}
calls: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# ctypes signatures of the C entry points
_FWD_ARGS = [_INT] + [_PTR] * 2 + [_INT] * 8 + [_PTR]
_BWD_ARGS = [_INT] + [_PTR] * 4 + [_INT] * 8 + [_PTR]


def _windows(x, window):
    """x cut to the pooled region as (B, Yo, wy, Xo, wx, Zo, wz, C)."""
    wy, wx, wz = window
    B, Y, X, Z, C = x.shape
    Yo, Xo, Zo = Y // wy, X // wx, Z // wz
    v = x[:, :Yo * wy, :Xo * wx, :Zo * wz]
    return v.reshape(B, Yo, wy, Xo, wx, Zo, wz, C)


def _scatter(x, d):
    """Windows (B, Yo, wy, Xo, wx, Zo, wz, C) of dx -> dx shaped like x,
    zero beyond the pooled region."""
    B, Yo, wy, Xo, wx, Zo, wz, C = d.shape
    dx = torch.zeros_like(x)
    dx[:, :Yo * wy, :Xo * wx, :Zo * wz] = d.reshape(B, Yo * wy, Xo * wx,
                                                    Zo * wz, C)
    return dx


def _max_pool_plain_fwd(x, window):
    return _windows(x, window).amax(dim=(2, 4, 6))


def max_pool3d_cl_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                            g: torch.Tensor,
                            window: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version of :func:`max_pool3d_cl_bwd` (all ties;
    a NaN output's cotangent goes to every NaN input of its window)."""
    B, Yo, Xo, Zo, C = y.shape
    at = lambda t: t.reshape(B, Yo, 1, Xo, 1, Zo, 1, C)
    gb, yb, xw = at(g.to(x.dtype)), at(y), _windows(x, window)
    hit = (xw == yb) | (xw.isnan() & yb.isnan())
    return _scatter(x, torch.where(hit, gb, gb.new_zeros(())))


def max_pool3d_cl_bwd_first(x: torch.Tensor, g: torch.Tensor,
                            window: Sequence[int]) -> torch.Tensor:
    """First-max backward (plain PyTorch): ``F.max_pool3d``'s autograd on
    the channels-first view gives g to the first max of each window in
    (Y, X, Z) order."""
    with torch.enable_grad():
        xc = x.detach().permute(0, 4, 1, 2, 3).requires_grad_()
        dx, = torch.autograd.grad(F.max_pool3d(xc, tuple(window)), xc,
                                  g.to(x.dtype).permute(0, 4, 1, 2, 3))
    return dx.permute(0, 2, 3, 4, 1).contiguous()


def _check(x, who):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{who}: unsupported dtype {x.dtype}")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"{who}: x must be a contiguous (B, Y, X, Z, C) "
                         f"tensor, got {tuple(x.shape)}")


def _window(window, who):
    wy, wx, wz = (int(w) for w in window)
    if min(wy, wx, wz) < 1:
        raise ValueError(f"{who}: bad window {tuple(window)}")
    return wy, wx, wz


def _launch_fwd(x, window):
    _check(x, "max_pool3d_cl")
    wy, wx, wz = _window(window, "max_pool3d_cl")
    B, Y, X, Z, C = x.shape
    out = x.new_empty((B, Y // wy, X // wx, Z // wz, C))
    rc = _fn("pool", "mmf_max_pool3d", _FWD_ARGS)(
        _DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), B, Y, X, Z, C, wy, wx,
        wz, _stream(x))
    if rc != 0:
        raise RuntimeError(
            f"max_pool3d_cl: kernel launch failed, CUDA error {rc}")
    launches["max_pool3d_cl"] += 1
    calls[("max_pool3d_cl", tuple(x.shape), (wy, wx, wz),
           str(x.dtype))] += 1
    return out


def max_pool3d_cl_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                      window: Sequence[int]) -> torch.Tensor:
    """dx of the pool (all ties) for the output cotangent ``g``, with ``y``
    the forward's output: the CUDA kernel on CUDA tensors,
    :func:`max_pool3d_cl_bwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return max_pool3d_cl_bwd_plain(x, y, g, window)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool3d_cl_bwd: unsupported device {x.device}")
    _check(x, "max_pool3d_cl_bwd")
    wy, wx, wz = _window(window, "max_pool3d_cl_bwd")
    B, Y, X, Z, C = x.shape
    shape = (B, Y // wy, X // wx, Z // wz, C)
    for name, t in (("y", y), ("g", g)):
        if (tuple(t.shape) != shape or t.dtype != x.dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"max_pool3d_cl_bwd: {name} must be a contiguous {x.dtype} "
                f"{shape} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    dx = torch.empty_like(x)
    rc = _fn("pool", "mmf_max_pool3d_bwd", _BWD_ARGS)(
        _DTYPES[x.dtype], x.data_ptr(), y.data_ptr(), g.data_ptr(),
        dx.data_ptr(), B, Y, X, Z, C, wy, wx, wz, _stream(x))
    if rc != 0:
        raise RuntimeError(
            f"max_pool3d_cl_bwd: kernel launch failed, CUDA error {rc}")
    launches["max_pool3d_cl_bwd"] += 1
    calls[("max_pool3d_cl_bwd", tuple(x.shape), (wy, wx, wz),
           str(x.dtype))] += 1
    return dx


class MaxPool(torch.autograd.Function):
    """Autograd of the pool: the kernels (``kernel``) or the plain versions,
    with the all-ties backward, or the plain first-max backward when
    ``first_max``."""

    @staticmethod
    def forward(ctx, x, window, first_max, kernel):
        y = _launch_fwd(x, window) if kernel else _max_pool_plain_fwd(x, window)
        ctx.save_for_backward(x, y)
        ctx.conf = (tuple(window), first_max, kernel)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        window, first_max, kernel = ctx.conf
        g = g.contiguous()
        if first_max:
            dx = max_pool3d_cl_bwd_first(x, g, window)
        elif kernel:
            dx = max_pool3d_cl_bwd(x, y, g, window)
        else:
            dx = max_pool3d_cl_bwd_plain(x, y, g, window)
        return dx, None, None, None


def _pool(x, window, first_max, kernel):
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool.apply(x, window, first_max, kernel)
    return _launch_fwd(x, window) if kernel else _max_pool_plain_fwd(x,
                                                                      window)


def max_pool3d_cl_plain(x: torch.Tensor, window: Sequence[int],
                        first_max: bool = False) -> torch.Tensor:
    """The plain PyTorch version of :func:`max_pool3d_cl`, with the same
    backward rules."""
    return _pool(x, window, first_max, kernel=False)


def max_pool3d_cl(x: torch.Tensor, window: Sequence[int],
                  first_max: bool = False) -> torch.Tensor:
    """(B, Y, X, Z, C) -> (B, Y//wy, X//wx, Z//wz, C): the CUDA kernel on a
    CUDA tensor (its backward the K5b kernel, or the plain first-max rule),
    :func:`max_pool3d_cl_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return max_pool3d_cl_plain(x, window, first_max)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool3d_cl: unsupported device {x.device}")
    return _pool(x, window, first_max, kernel=True)
