"""The narrow-entry convolution (K10) on channels-last volumes, with its
weight and data gradients.

    y[b,p,o]    = sum_{tap,i} xin[b, p + tap - k//2, i] * w[tap, i, o]
    dw[tap,i,o] = sum_{b,p}   xin[b, p + tap - k//2, i] * g[b, p, o]

``x`` is (B, Y, X, Z, ci), ``w`` the logical (kY, kX, kz, ci, co) kernel,
stride 1 and SAME padding, every tap in {1, 3}.  ``xin`` reads 0 outside
the volume and, with ``dyn_extents`` = (yt, xt, zt) (eval under exact shape
bucketing), at or beyond the true extents of x; the outputs beyond them
are whatever the conv gives, for the caller to mask.  There is no affine
and no ReLU.  The weight gradient accumulates in fp32 (or x's wider type)
and is rounded once to x's type; the data gradient is the same conv run on
g with the flipped, (ci, co)-transposed kernel.  :class:`BandedConv` ties
them together for autograd.

Source note.  ``csrc/banded_conv.cu`` replaces the TPU kernel
``multimodal_fusion_fpn_tpu/ops/pallas/banded_conv.py::_kernel`` (launched
by ``banded_conv_blocked_pallas``, the Pallas body of
``ops/banded.py::banded_conv_blocked``, whose custom VJP computes dx with
the same kernel and dw as one contraction per lead tap).  The TPU kernel's
z-blocking, band and wrap matrices, sublane padding and row rolls are TPU
layout work that a contiguous channels-last tensor does not need.  The
kernels take fp32 and bf16, 1 <= ci <= 64 and co in {1, 16, 32, 64}: the
model's ci = 1 entry convs and 1x1x1 downsamples (co 16) and their data
gradient (ci 16 -> co 1).  They are bound by memory on the H100 (see the
.cu header).  The forward has two kernels: the entry kernel, for ci = 1 ->
co = 16 with at most 9 taps (every forward the model launches), stages x
by tiles of whole output rows in shared memory and stores whole 128-byte
lines; the generic kernel, one thread per output position, runs the rest
(the data gradient among them).  Both add the taps in the same order and
give the same bits (short of a partial sum that underflows to -0, or a
weight that is not finite, at a tap outside the volume: the .cu note).
Launches are counted as ``launches["banded_conv"]``,
``"banded_conv_dyn"`` (with extents), ``"banded_conv_wgrad"`` and
``"banded_conv_dgrad"``; ``calls`` keeps (kernel, x shape, w shape, dtype,
extents) per launch, x being g for the data gradient and w the kernel the
launch ran.
"""

import collections
import ctypes
from typing import Optional, Sequence

import torch

from multimodal_fusion_fpn_torch.ops.dynamic_extent import mask_valid
from multimodal_fusion_fpn_torch.ops.fused_conv import (_acc_dtype,
                                                        _check_extents,
                                                        _device, _fn,
                                                        _stream, _work,
                                                        conv3d_cl)

launches = {name: 0 for name in ("banded_conv", "banded_conv_dyn",
                                 "banded_conv_wgrad", "banded_conv_dgrad")}
calls: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CO = (1, 16, 32, 64)
_PTR, _INT, _SIZE = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong


def _mask(x: torch.Tensor, dyn_extents) -> torch.Tensor:
    return (x if dyn_extents is None
            else mask_valid(x, dict(zip((1, 2, 3), dyn_extents))))


def banded_conv_plain(x: torch.Tensor, w: torch.Tensor,
                      dyn_extents: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """The plain PyTorch version of :func:`banded_conv`: x masked to its
    true extents (if given), then the SAME conv."""
    return conv3d_cl(_mask(x, dyn_extents), w, (1, 1, 1),
                     tuple(k // 2 for k in w.shape[:3]))


def banded_conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                            kernel_shape: Sequence[int],
                            dyn_extents: Optional[Sequence[int]] = None
                            ) -> torch.Tensor:
    """The plain PyTorch version of :func:`banded_conv_wgrad`: per tap, the
    shifted (masked) x against g over every position, in fp32 (or x's
    wider type), rounded once to x's type."""
    acc = _acc_dtype(x.dtype)
    kY, kX, kz, ci, co = kernel_shape
    B, Y, X, Z, _ = x.shape
    t = torch.nn.functional.pad(
        _mask(x, dyn_extents).to(acc),
        (0, 0, kz // 2, kz // 2, kX // 2, kX // 2, kY // 2, kY // 2))
    g2 = g.to(acc).reshape(-1, co)
    dw = torch.empty((kY, kX, kz, ci, co), dtype=acc, device=x.device)
    for dy in range(kY):
        for dx in range(kX):
            for dz in range(kz):
                sl = t[:, dy:dy + Y, dx:dx + X, dz:dz + Z]
                dw[dy, dx, dz] = sl.reshape(-1, ci).t() @ g2
    return dw.to(x.dtype)


def flipped(w: torch.Tensor) -> torch.Tensor:
    """The kernel of the data gradient: ``w`` flipped in every tap axis
    with ci and co swapped (``_bcb_bwd``, ``ops/banded.py:322-327``)."""
    return w.flip((0, 1, 2)).transpose(3, 4).contiguous()


def banded_conv_dgrad_plain(g: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """The plain PyTorch version of :func:`banded_conv_dgrad`."""
    return banded_conv_plain(g, flipped(w))


def _check_kernel(kernel_shape) -> None:
    """Raises ValueError unless the kernels take a (kY, kX, kz, ci, co)
    kernel: every tap in {1, 3}, 1 <= ci <= 64, co in {1, 16, 32, 64}."""
    if any(k not in (1, 3) for k in kernel_shape[:3]):
        raise ValueError(f"banded_conv: no kernel for taps "
                         f"{tuple(kernel_shape[:3])}")
    ci, co = kernel_shape[3], kernel_shape[4]
    if not 1 <= ci <= 64 or co not in _CO:
        raise ValueError(f"banded_conv: kernel needs 1 <= ci <= 64 and co in "
                         f"{_CO}, got ci={ci}, co={co}")


def _check(x: torch.Tensor, kernel_shape: Sequence[int], others) -> None:
    """What the CUDA kernels take (raises ValueError otherwise): x
    (B, Y, X, Z, ci) fp32 or bf16 with a kernel :func:`_check_kernel`
    takes, and ``others`` ((name, tensor, shape or None): w, or g for the
    weight gradient) of x's type on x's device; all contiguous."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"banded_conv: unsupported dtype {x.dtype}")
    kernel_shape = tuple(kernel_shape)
    if x.dim() != 5 or len(kernel_shape) != 5 or kernel_shape[3] != x.shape[4]:
        raise ValueError(f"banded_conv: x {tuple(x.shape)} / kernel "
                         f"{kernel_shape} mismatch")
    _check_kernel(kernel_shape)
    for name, t, shape in others:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"banded_conv: {name} is {t.dtype} on "
                             f"{t.device}, x is {x.dtype} on {x.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"banded_conv: {name} shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    for name, t in [("x", x)] + [(n, t) for n, t, _ in others]:
        if not t.is_contiguous():
            raise ValueError(f"banded_conv: {name} is not contiguous")


def _count(name, x, w, ext):
    launches[name] += 1
    calls[(name, tuple(x.shape), tuple(w.shape), str(x.dtype), ext)] += 1


def _run(x, w, ext, entry="mmf_banded_conv"):
    """The forward on CUDA tensors through the C entry point ``entry``:
    ``mmf_banded_conv`` (the entry kernel for ci = 1 -> co = 16, else the
    generic one) or ``mmf_banded_conv_generic`` (the generic kernel on any
    call, which only comparisons run).  Not counted."""
    B, Y, X, Z, ci = x.shape
    kY, kX, kz, _, co = w.shape
    out = torch.empty((B, Y, X, Z, co), dtype=x.dtype, device=x.device)
    dyn = None if ext is None else (ctypes.c_int * 3)(*ext)
    fn = _fn("banded_conv", entry,
             [_INT] * 4 + [_PTR] * 4 + [_INT] * 6 + [_PTR])
    rc = fn(_DTYPES[x.dtype], kY, kX, kz, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), None if dyn is None else ctypes.addressof(dyn), B,
            Y, X, Z, ci, co, _stream(x))
    if rc != 0:
        raise RuntimeError(f"banded_conv: kernel launch failed, CUDA error "
                           f"{rc}")
    return out


def _launch(x, w, ext, name):
    """The forward kernel on CUDA tensors, counted as ``name``."""
    out = _run(x, w, ext)
    _count(name, x, w, ext)
    return out


def _launch_wgrad(x, g, kernel_shape, ext):
    B, Y, X, Z, ci = x.shape
    kY, kX, kz, _, co = kernel_shape
    dw = torch.empty(tuple(kernel_shape), dtype=x.dtype, device=x.device)
    work = _work(_fn("banded_conv", "mmf_banded_conv_wgrad_work_bytes",
                     [_INT] * 9, _SIZE)(kY, kX, kz, B, Y, X, Z, ci, co),
                 x.device)
    dyn = None if ext is None else (ctypes.c_int * 3)(*ext)
    fn = _fn("banded_conv", "mmf_banded_conv_wgrad",
             [_INT] * 4 + [_PTR] * 5 + [_INT] * 6 + [_PTR])
    rc = fn(_DTYPES[x.dtype], kY, kX, kz, x.data_ptr(), g.data_ptr(),
            dw.data_ptr(), work.data_ptr(),
            None if dyn is None else ctypes.addressof(dyn), B, Y, X, Z, ci,
            co, _stream(x))
    if rc != 0:
        raise RuntimeError(f"banded_conv_wgrad: kernel launch failed, CUDA "
                           f"error {rc}")
    _count("banded_conv_wgrad", x, dw, ext)
    return dw


def _forward(x, w, ext):
    if _device(x, "banded_conv") == "cpu":
        return banded_conv_plain(x, w, ext)
    _check(x, w.shape, [("w", w, None)])
    return _launch(x, w, ext, "banded_conv_dyn" if ext else "banded_conv")


def banded_conv_wgrad(x: torch.Tensor, g: torch.Tensor,
                      kernel_shape: Sequence[int],
                      dyn_extents: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """dw of shape ``kernel_shape`` (kY, kX, kz, ci, co) in x's type, from x
    and the output cotangent g: the CUDA kernel on CUDA tensors,
    :func:`banded_conv_wgrad_plain` on CPU tensors.  Bitwise repeatable."""
    ext = _check_extents(x, dyn_extents, "banded_conv_wgrad")
    kernel_shape = tuple(int(k) for k in kernel_shape)
    if _device(x, "banded_conv_wgrad") == "cpu":
        return banded_conv_wgrad_plain(x, g, kernel_shape, ext)
    _check(x, kernel_shape, [("g", g, x.shape[:4] + kernel_shape[4:])])
    return _launch_wgrad(x, g, kernel_shape, ext)


def banded_conv_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of :func:`banded_conv` for the output cotangent g: the forward
    kernel on g with :func:`flipped` w on CUDA tensors,
    :func:`banded_conv_dgrad_plain` on CPU tensors."""
    if _device(g, "banded_conv_dgrad") == "cpu":
        return banded_conv_dgrad_plain(g, w)
    wf = flipped(w)
    _check(g, wf.shape, [("w", wf, None)])
    return _launch(g, wf, None, "banded_conv_dgrad")


class BandedConv(torch.autograd.Function):
    """Autograd of :func:`banded_conv`: dw through the weight-gradient
    kernel, and dx, only where x needs it, through the forward kernel on the
    flipped kernel.  On CPU tensors all three are the plain versions."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w, None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = banded_conv_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = (banded_conv_wgrad(x, g, w.shape) if ctx.needs_input_grad[1]
              else None)
        return dx, dw


def banded_conv(x: torch.Tensor, w: torch.Tensor,
                dyn_extents: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; run
    :func:`banded_conv_plain` on a CPU tensor.  Differentiable through
    :class:`BandedConv` when x or w requires grad; ``dyn_extents`` (the
    true (yt, xt, zt) of x) is eval-only."""
    ext = _check_extents(x, dyn_extents, "banded_conv")
    needs_grad = torch.is_grad_enabled() and (x.requires_grad
                                              or w.requires_grad)
    if not needs_grad:
        return _forward(x, w, ext)
    if ext is not None:
        raise ValueError("banded_conv: dyn_extents is eval-only (no "
                         "gradient)")
    if _device(x, "banded_conv") == "cuda":
        _check(x, w.shape, [("w", w, None)])
        if x.requires_grad:   # the data gradient's kernel
            _check_kernel(tuple(w.shape[:3]) + (w.shape[4], w.shape[3]))
    return BandedConv.apply(x, w)
