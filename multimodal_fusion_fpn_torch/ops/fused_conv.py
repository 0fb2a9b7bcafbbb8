"""Fused affine + ReLU + convolution on channels-last volumes, and its
backward.

    y = conv(relu?(x * scale + bias), w)      SAME padding k//2 per axis,
                                              z stride 1 or 2

``x`` is (B, Y, X, Z, ci), ``w`` the logical (kY, kX, kz, ci, co) kernel,
``scale``/``bias`` per input channel (the previous BatchNorm folded), or
both None for the identity.  Padding applies to the activated input: an
out-of-range tap reads 0, not relu(bias).  At z stride 2 the output depth
is (Z + 1) // 2.  ``with_stats`` (training) also returns the fp32
per-output-channel sums of y and y*y of the rounded output, which feed the
next BatchNorm.  ``dyn_extents`` (eval under exact shape bucketing) gives
the true extents (yt, xt, zt) of x inside its zero-padded buffer: the
activated input also reads 0 at or beyond them (:func:`fused_conv_dyn_plain`).

The backward (:func:`fused_conv_bwd`) takes the output cotangent g and,
for the stats instance, the stats cotangent (y, gs1, gs2), folded in as
``g + gs1 + 2*y*gs2``, and returns ``(dx, ds, db, dw)``: ``dt =
conv_transpose(g, w) * [pre > 0]`` with ``pre = x*s+b`` recomputed with the
forward's rounding, ``dx = dt*s``, ``ds = sum dt*x``, ``db = sum dt`` (fp32,
None without the affine) and ``dw = sum_p t[p + tap]^T g[p]``, rounded to
the compute dtype as the JAX backward rounds its band cotangent.
:class:`FusedConv` ties the two together for autograd; :func:`fused_conv`
uses it whenever an input requires grad.

Source note.  The CUDA kernels replace the TPU kernels of
``multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py``:

* ``csrc/fused_conv.cu``: ``_kernel`` (K1, via ``_fused_conv_pallas_mats``:
  the (1,3,3), (1,1,3), 1x1x1 and stride-2 (1,1,3) convs) and
  ``_yck_kernel`` (K2, via ``_fused_conv_pallas_yck``: the (3,1,1) conv),
  with their ``with_stats`` epilogue, and K7: the same kernels ``with_dyn``
  (``fused_conv_dyn`` / ``fused_conv_strided_dyn``, the prologue masked to
  the true extents, ``fused_conv.py:445-491``, ``:2594-2625``).  One
  template, counted apart: ``launches["fused_conv"]`` for kY == 1,
  ``"fused_conv_ky3"`` for kY == 3, ``"fused_conv_stats"`` /
  ``"fused_conv_ky3_stats"`` for the stats instances and
  ``"fused_conv_dyn"`` / ``"fused_conv_dyn_ky3"`` for the extents
  instances.  The model's paths run its fp32 instances.
* ``csrc/fused_conv_mma.cu``: the bf16 instances of the same forward (K1,
  K2, K7, ± stats, and the function of the roll-free ``_rf_kernel``, K9's
  forward), on the tensor cores (``mma.sync``), counted under the same
  names.  The bf16 CUDA-core instances of ``fused_conv.cu`` stay reachable
  through the private ``tensor_cores=False`` of :func:`_launch_forward`,
  for comparing the two on the card (and for the bit-equality of K8's bf16
  CUDA-core instance to the CUDA-core per-conv path, ``fused_block``).
* ``csrc/fused_conv_bwd.cu``: ``_dx_kernel`` (K3, ``_dx_pallas(...,
  want_band=True)``, the merged backward) and ``_yck_dx_kernel`` (K4,
  ``_dx_pallas_yck``), as a dgrad kernel (dx, ds, db) and a wgrad kernel
  (dw, the function of the split path's ``_dband_kernel``, K6), counted as
  ``"fused_conv_dgrad"`` / ``"fused_conv_wgrad"`` for kY == 1 and
  ``"fused_conv_ky3_dgrad"`` / ``"fused_conv_ky3_wgrad"`` for kY == 3.
  These are the fp32 instances.
* ``csrc/fused_conv_bwd_mma.cu``: the bf16 instances of the same dgrad
  and wgrad, on the tensor cores (``mma.sync``), counted under the same
  names; they also compute the function of the roll-free merged backward
  ``_rf_dx_kernel`` (K9, ``MMF_ROLLFREE=1``), as the forward kernels
  compute that of ``_rf_kernel``.  The bf16 CUDA-core instances of
  ``fused_conv_bwd.cu`` stay reachable through the private
  ``tensor_cores=False`` of :func:`_launch_dgrad` / :func:`_launch_wgrad`,
  for comparing the two on the card.

Widths.  The kernels take the taps above with ci % 8 == 0 and co % 16 ==
0, and their backward ci % 16 == 0.  :func:`refusal` says why a conv is
not taken (None when it is), :func:`takes` whether it is; the wrappers'
checks on a CUDA tensor and the model's routing (``models.blocks.ConvX``)
both apply it, so the model sends a conv the kernels refuse to the plain
version, and a caller that passes one on the card gets ``ValueError``.

The TPU kernel's second input (``n_in=2``) is unused on every model path
and is left out; so is its ``preferred_element_type`` (the models always
emit the compute dtype).  At the stage 1-3 shapes a call is about 37 GFLOP
against 0.5 GB of bf16 traffic at B=4: bound by the FMA rate on the fp32
CUDA cores, by bytes on the tensor cores.  bf16 runs on the tensor cores,
fp32 on the CUDA cores, with the input tiles in shared memory (see the .cu
headers).

bf16: the prologue rounds like the JAX bf16 prologue (``x*s`` and then
``+b`` each rounded to bf16), products accumulate in fp32 and each output
is rounded once.  The plain versions round at the same points on the
prologue; their convs (cuDNN on the card) accumulate in another order.
"""

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_fusion_fpn_torch.ops import _build
from multimodal_fusion_fpn_torch.ops.dynamic_extent import mask_valid

# Kernel launches since the last reset, per kernel, and the call shapes
# they ran at: (kernel, x shape, w shape, z stride, relu, affine, stats,
# dtype, extents); ``stats`` is the stats epilogue of a forward, or the
# stats cotangent of a backward; ``extents`` the true (yt, xt, zt) of an
# extents instance, else None.
launches = {name: 0 for name in (
    "fused_conv", "fused_conv_ky3", "fused_conv_stats", "fused_conv_ky3_stats",
    "fused_conv_dgrad", "fused_conv_wgrad", "fused_conv_ky3_dgrad",
    "fused_conv_ky3_wgrad", "fused_conv_dyn", "fused_conv_dyn_ky3")}
calls: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS = {(1, 3, 3, 1), (3, 1, 1, 1), (1, 1, 1, 1), (1, 1, 3, 1), (1, 1, 3, 2)}
_PTR, _INT, _SIZE = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong


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


def fused_conv_dyn_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], w: torch.Tensor,
                         relu: bool, stride_z: int,
                         dyn_extents: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version of the extents instance (K7): the activated
    input masked to the true extents ``(yt, xt, zt)`` of x, then the conv."""
    t = affine_relu(x, scale, bias, relu)
    t = mask_valid(t, dict(zip((1, 2, 3), dyn_extents)))
    return conv3d_cl(t, w, (1, 1, stride_z),
                     tuple(k // 2 for k in w.shape[:3]))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or the input's type where that is wider."""
    return torch.promote_types(dtype, torch.float32)


def channel_sums(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (or wider) per-channel (sum y, sum y*y) over every axis but
    the last."""
    yf = y.to(_acc_dtype(y.dtype))
    dims = tuple(range(y.dim() - 1))
    return yf.sum(dims), (yf * yf).sum(dims)


def fused_conv_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], w: torch.Tensor,
                     relu: bool, stride_z: int = 1, with_stats: bool = False):
    """The plain PyTorch version of the forward (same contract as
    :func:`fused_conv`)."""
    pad = tuple(k // 2 for k in w.shape[:3])
    y = conv3d_cl(affine_relu(x, scale, bias, relu), w, (1, 1, stride_z), pad)
    return (y, *channel_sums(y)) if with_stats else y


def _fold_stats_cot(g, stats_cot):
    """g + gs1 + 2*y*gs2 in fp32, rounded to g's dtype (``_fused_ws_bwd``)."""
    if stats_cot is None:
        return g
    y, gs1, gs2 = stats_cot
    acc = _acc_dtype(g.dtype)
    return (g.to(acc) + gs1 + 2.0 * y.to(acc) * gs2).to(g.dtype)


def fused_conv_dgrad_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], w: torch.Tensor,
                           g: torch.Tensor, relu: bool, stride_z: int = 1,
                           stats_cot=None):
    """``(dx, ds, db)`` of :func:`fused_conv_bwd_plain`."""
    dt_, acc = x.dtype, _acc_dtype(x.dtype)
    kY, kX, kz = w.shape[:3]
    Z, Zo = x.shape[3], g.shape[3]
    pad = (kY // 2, kX // 2, kz // 2)
    gf = _fold_stats_cot(g, stats_cot).to(acc)
    # dt: the adjoint of the forward conv, at x's full depth
    out_pad = Z - ((Zo - 1) * stride_z - 2 * pad[2] + kz)
    dt = F.conv_transpose3d(gf.permute(0, 4, 1, 2, 3),
                            w.to(acc).permute(4, 3, 0, 1, 2),
                            stride=(1, 1, stride_z), padding=pad,
                            output_padding=(0, 0, out_pad))
    dt = dt.permute(0, 2, 3, 4, 1)
    if relu:
        dt = dt * (affine_relu(x, scale, bias, False) > 0)
    if scale is None:
        return dt.to(dt_), None, None
    dims = (0, 1, 2, 3)
    return ((dt * scale.to(acc)).to(dt_), (dt * x.to(acc)).sum(dims),
            dt.sum(dims))


def fused_conv_wgrad_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], w: torch.Tensor,
                           g: torch.Tensor, relu: bool, stride_z: int = 1,
                           stats_cot=None) -> torch.Tensor:
    """``dw`` of :func:`fused_conv_bwd_plain` (``w`` gives its shape and
    type)."""
    acc = _acc_dtype(x.dtype)
    kY, kX, kz, ci, co = w.shape
    B, Y, X, _, _ = x.shape
    Zo = g.shape[3]
    pad = (kY // 2, kX // 2, kz // 2)
    # dw[tap] = sum over positions of the shifted activated input x g
    t = F.pad(affine_relu(x, scale, bias, relu).to(acc),
              (0, 0, pad[2], pad[2], pad[1], pad[1], pad[0], pad[0]))
    g2 = _fold_stats_cot(g, stats_cot).to(acc).reshape(-1, co)
    dw = torch.empty((kY, kX, kz, ci, co), dtype=acc, device=x.device)
    for dy in range(kY):
        for dx in range(kX):
            for dz in range(kz):
                sl = t[:, dy:dy + Y, dx:dx + X,
                       dz:dz + stride_z * (Zo - 1) + 1:stride_z]
                dw[dy, dx, dz] = sl.reshape(-1, ci).t() @ g2
    return dw.to(x.dtype)


def fused_conv_bwd_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], w: torch.Tensor,
                         g: torch.Tensor, relu: bool, stride_z: int = 1,
                         stats_cot=None):
    """The plain PyTorch version of :func:`fused_conv_bwd`, written from the
    formulas (module note), in fp32 (or x's wider type) with the forward's
    prologue rounding."""
    args = (x, scale, bias, w, g, relu, stride_z, stats_cot)
    return (*fused_conv_dgrad_plain(*args), fused_conv_wgrad_plain(*args))


def _check_extents(x, dyn_extents, who="fused_conv"):
    """The extents as three ints within x's (Y, X, Z), or None."""
    if dyn_extents is None:
        return None
    ext = tuple(int(e) for e in dyn_extents)
    if len(ext) != 3 or not all(1 <= e <= n
                                for e, n in zip(ext, x.shape[1:4])):
        raise ValueError(f"{who}: extents {tuple(dyn_extents)} outside "
                         f"x's (Y, X, Z) {tuple(x.shape[1:4])}")
    return ext


def refusal(ci: int, co: int, taps: Sequence[int], stride_z: int = 1,
            training: bool = False,
            dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """Why the CUDA kernels do not take a conv of ``ci`` -> ``co`` channels
    with logical taps (kY, kX, kz) at z stride ``stride_z`` in ``dtype``, or
    None when they take it: the forward (K1, K2, K7) and, with
    ``training``, the backward (K3, K4, K6).  The one rule that the
    wrappers' checks and the model's routing (``blocks.ConvX``) share."""
    if dtype not in _DTYPES:
        return f"unsupported dtype {dtype}"
    if tuple(taps) + (stride_z,) not in _TAPS:
        return f"no kernel for taps {tuple(taps)} at z stride {stride_z}"
    if ci % 8 or co % 16:
        return (f"kernel needs ci % 8 == 0 and co % 16 == 0, got ci={ci}, "
                f"co={co}")
    if training and ci % 16:
        return f"the backward kernels need ci % 16 == 0, got ci={ci}"
    return None


def takes(ci: int, co: int, taps: Sequence[int], stride_z: int = 1,
          training: bool = False, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the CUDA kernels take the conv (:func:`refusal`)."""
    return refusal(ci, co, taps, stride_z, training, dtype) is None


def _check(x, scale, bias, w, stride_z):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv: unsupported dtype {x.dtype}")
    if x.dim() != 5 or w.dim() != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(f"fused_conv: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} mismatch")
    ci, co = w.shape[3], w.shape[4]
    why = refusal(ci, co, w.shape[:3], stride_z, False, x.dtype)
    if why is not None:
        raise ValueError(f"fused_conv: {why}")
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


def _out_shape(x, w, stride_z):
    B, Y, X, Z, _ = x.shape
    return (B, Y, X, (Z - 1) // stride_z + 1, w.shape[4])


def _check_bwd(x, w, stride_z, g=None, stats_cot=None):
    """What the backward kernels take beyond the forward's checks."""
    why = refusal(w.shape[3], w.shape[4], w.shape[:3], stride_z, True,
                  x.dtype)
    if why is not None:
        raise ValueError(f"fused_conv_bwd: {why}")
    tensors = [] if g is None else [("g", g, _out_shape(x, w, stride_z))]
    if stats_cot is not None:
        y, gs1, gs2 = stats_cot
        co = (w.shape[4],)
        tensors += [("y", y, _out_shape(x, w, stride_z)), ("gs1", gs1, co),
                    ("gs2", gs2, co)]
    for name, t, shape in tensors:
        dtype = torch.float32 if name.startswith("gs") else x.dtype
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"fused_conv_bwd: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _fn(lib_name, fn_name, argtypes, restype=_INT):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    """The raw handle of x's device's current stream: what
    ``torch.cuda.current_stream(x.device).cuda_stream`` gives, without
    building a Stream object (0.24 against 3.0 us of host time per call on
    the H100 machine, chip_smoke.py's ``pool_host_path``)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _work(nbytes, device):
    return torch.empty(max(int(nbytes), 4), dtype=torch.uint8, device=device)


def _name(kY, suffix=""):
    return ("fused_conv_ky3" if kY == 3 else "fused_conv") + suffix


def _count(name, x, w, stride_z, relu, scale, stats, ext=None):
    launches[name] += 1
    calls[(name, tuple(x.shape), tuple(w.shape), stride_z, bool(relu),
           scale is not None, bool(stats), str(x.dtype), ext)] += 1


def _launch_forward(x, scale, bias, w, relu, stride_z, with_stats, ext=None,
                    tensor_cores=True):
    """The forward kernel (and its stats reduction) on CUDA tensors; with
    ``ext`` (three ints) the extents instance.  bf16 on the tensor cores
    (``csrc/fused_conv_mma.cu``), fp32 on the CUDA cores
    (``csrc/fused_conv.cu``).  ``tensor_cores=False`` takes the bf16
    CUDA-core instance: only for comparing the two on the card; the model
    never passes it."""
    B, Y, X, Z, ci = x.shape
    kY, kX, kz, _, co = w.shape
    mma = tensor_cores and x.dtype == torch.bfloat16
    out = torch.empty(_out_shape(x, w, stride_z), dtype=x.dtype,
                      device=x.device)
    Zo = out.shape[3]
    s1 = s2 = work = None
    if with_stats:
        s1 = torch.empty(co, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
        if mma:
            nbytes = _fn("fused_conv_mma", "mmf_fused_conv_mma_work_bytes",
                         [_INT] * 11, _SIZE)(kY, kX, kz, stride_z, B, Y, X,
                                             Z, Zo, ci, co)
        else:
            nbytes = _fn("fused_conv", "mmf_fused_conv_work_bytes",
                         [_INT] * 5, _SIZE)(B, Y, X, Zo, co)
        work = _work(nbytes, x.device)
    dyn = None if ext is None else (ctypes.c_int * 3)(*ext)
    args = (x.data_ptr(), _ptr(scale), _ptr(bias), w.data_ptr(),
            out.data_ptr(), _ptr(s1), _ptr(s2), _ptr(work),
            None if dyn is None else ctypes.addressof(dyn), B, Y, X, Z, Zo,
            ci, co, int(relu), _stream(x))
    if mma:
        fn = _fn("fused_conv_mma", "mmf_fused_conv_mma",
                 [_INT] * 4 + [_PTR] * 9 + [_INT] * 8 + [_PTR])
        rc = fn(kY, kX, kz, stride_z, *args)
    else:
        fn = _fn("fused_conv", "mmf_fused_conv",
                 [_INT] * 5 + [_PTR] * 9 + [_INT] * 8 + [_PTR])
        rc = fn(_DTYPES[x.dtype], kY, kX, kz, stride_z, *args)
    if rc != 0:
        raise RuntimeError(f"fused_conv: kernel launch failed, CUDA error {rc}")
    if ext is not None:
        name = "fused_conv_dyn_ky3" if kY == 3 else "fused_conv_dyn"
    else:
        name = _name(kY, "_stats" if with_stats else "")
    _count(name, x, w, stride_z, relu, scale, with_stats, ext)
    return (out, s1, s2) if with_stats else out


def _launch_dgrad(x, scale, bias, w, g, relu, stride_z, stats_cot,
                  tensor_cores=True):
    """dx, ds, db (K3 / K4 dgrad) on CUDA tensors: bf16 on the tensor cores
    (``csrc/fused_conv_bwd_mma.cu``), fp32 on the CUDA cores.
    ``tensor_cores=False`` takes the bf16 CUDA-core instance: only for
    comparing the two on the card; the model never passes it."""
    B, Y, X, Z, ci = x.shape
    kY, kX, kz, _, co = w.shape
    y, gs1, gs2 = stats_cot if stats_cot is not None else (None,) * 3
    mma = tensor_cores and x.dtype == torch.bfloat16
    lib = "fused_conv_bwd_mma" if mma else "fused_conv_bwd"
    dx = torch.empty_like(x)
    ds = db = work = None
    if scale is not None:
        ds = torch.empty(ci, dtype=torch.float32, device=x.device)
        db = torch.empty_like(ds)
        if mma:
            nbytes = _fn(lib, "mmf_fused_conv_dgrad_mma_work_bytes",
                         [_INT] * 10, _SIZE)(kY, kX, kz, stride_z, B, Y, X,
                                             Z, ci, co)
        else:
            nbytes = _fn(lib, "mmf_fused_conv_dgrad_work_bytes", [_INT] * 5,
                         _SIZE)(B, Y, X, Z, ci)
        work = _work(nbytes, x.device)
    ptrs = (x.data_ptr(), _ptr(scale), _ptr(bias), w.data_ptr(),
            g.data_ptr(), _ptr(y), _ptr(gs1), _ptr(gs2), dx.data_ptr(),
            _ptr(ds), _ptr(db), _ptr(work), B, Y, X, Z, g.shape[3], ci, co,
            int(relu), _stream(x))
    if mma:
        fn = _fn(lib, "mmf_fused_conv_dgrad_mma",
                 [_INT] * 4 + [_PTR] * 12 + [_INT] * 8 + [_PTR])
        rc = fn(kY, kX, kz, stride_z, *ptrs)
    else:
        fn = _fn(lib, "mmf_fused_conv_dgrad",
                 [_INT] * 5 + [_PTR] * 12 + [_INT] * 8 + [_PTR])
        rc = fn(_DTYPES[x.dtype], kY, kX, kz, stride_z, *ptrs)
    if rc != 0:
        raise RuntimeError(
            f"fused_conv_bwd: dgrad launch failed, CUDA error {rc}")
    _count(_name(kY, "_dgrad"), x, w, stride_z, relu, scale, y is not None)
    return dx, ds, db


def _launch_wgrad(x, scale, bias, w, g, relu, stride_z, stats_cot,
                  tensor_cores=True):
    """dw (K3 / K4 wgrad) on CUDA tensors; dtypes and ``tensor_cores`` as
    for :func:`_launch_dgrad`."""
    B, Y, X, Z, ci = x.shape
    kY, kX, kz, _, co = w.shape
    Zo = g.shape[3]
    y, gs1, gs2 = stats_cot if stats_cot is not None else (None,) * 3
    mma = tensor_cores and x.dtype == torch.bfloat16
    lib = "fused_conv_bwd_mma" if mma else "fused_conv_bwd"
    dw = torch.empty(w.shape, dtype=x.dtype, device=x.device)
    if mma:
        nbytes = _fn(lib, "mmf_fused_conv_wgrad_mma_work_bytes", [_INT] * 10,
                     _SIZE)(kY, kX, kz, stride_z, B, Y, X, Zo, ci, co)
    else:
        nbytes = _fn(lib, "mmf_fused_conv_wgrad_work_bytes", [_INT] * 9,
                     _SIZE)(kY, kX, kz, B, Y, X, Zo, ci, co)
    work = _work(nbytes, x.device)
    ptrs = (x.data_ptr(), _ptr(scale), _ptr(bias), g.data_ptr(), _ptr(y),
            _ptr(gs1), _ptr(gs2), dw.data_ptr(), work.data_ptr(), B, Y, X, Z,
            Zo, ci, co, int(relu), _stream(x))
    if mma:
        fn = _fn(lib, "mmf_fused_conv_wgrad_mma",
                 [_INT] * 4 + [_PTR] * 9 + [_INT] * 8 + [_PTR])
        rc = fn(kY, kX, kz, stride_z, *ptrs)
    else:
        fn = _fn(lib, "mmf_fused_conv_wgrad",
                 [_INT] * 5 + [_PTR] * 9 + [_INT] * 8 + [_PTR])
        rc = fn(_DTYPES[x.dtype], kY, kX, kz, stride_z, *ptrs)
    if rc != 0:
        raise RuntimeError(
            f"fused_conv_bwd: wgrad launch failed, CUDA error {rc}")
    _count(_name(kY, "_wgrad"), x, w, stride_z, relu, scale, y is not None)
    return dw


def _device(x, who):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")
    return x.device.type


def _forward(x, scale, bias, w, relu, stride_z, with_stats, ext=None,
             tensor_cores=True):
    if _device(x, "fused_conv") == "cpu":
        if ext is not None:
            return fused_conv_dyn_plain(x, scale, bias, w, relu, stride_z,
                                        ext)
        return fused_conv_plain(x, scale, bias, w, relu, stride_z, with_stats)
    _check(x, scale, bias, w, stride_z)
    return _launch_forward(x, scale, bias, w, relu, stride_z, with_stats,
                           ext, tensor_cores)


def fused_conv_bwd(x: torch.Tensor, scale: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], w: torch.Tensor,
                   g: torch.Tensor, relu: bool, stride_z: int = 1,
                   stats_cot=None):
    """``(dx, ds, db, dw)`` of the fused conv for the output cotangent ``g``
    and the optional stats cotangent ``(y, gs1, gs2)``: the CUDA kernels on
    CUDA tensors, :func:`fused_conv_bwd_plain` on CPU tensors."""
    if _device(x, "fused_conv_bwd") == "cpu":
        return fused_conv_bwd_plain(x, scale, bias, w, g, relu, stride_z,
                                    stats_cot)
    _check(x, scale, bias, w, stride_z)
    _check_bwd(x, w, stride_z, g, stats_cot)
    dx, ds, db = _launch_dgrad(x, scale, bias, w, g, relu, stride_z,
                               stats_cot)
    dw = _launch_wgrad(x, scale, bias, w, g, relu, stride_z, stats_cot)
    return dx, ds, db, dw


class FusedConv(torch.autograd.Function):
    """Autograd of the fused conv: the forward kernel (with or without its
    stats epilogue) and :func:`fused_conv_bwd`, which folds the stats
    cotangent into the backward kernels.  On CPU tensors both are the plain
    versions."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, relu, stride_z, with_stats):
        out = _forward(x, scale, bias, w, relu, stride_z, with_stats)
        y = out[0] if with_stats else out
        ctx.save_for_backward(x, scale, bias, w, y if with_stats else None)
        ctx.conf = (relu, stride_z)
        return out

    @staticmethod
    def backward(ctx, gy, gs1=None, gs2=None):
        x, scale, bias, w, y = ctx.saved_tensors
        relu, stride_z = ctx.conf
        stats_cot = None if y is None else (y, gs1.contiguous(),
                                            gs2.contiguous())
        dx, ds, db, dw = fused_conv_bwd(x, scale, bias, w, gy.contiguous(),
                                        relu, stride_z, stats_cot)
        if scale is not None:
            ds, db = ds.to(scale.dtype), db.to(bias.dtype)
        return dx, ds, db, dw, None, None, None


def fused_conv(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], w: torch.Tensor, relu: bool,
               stride_z: int = 1, with_stats: bool = False,
               dyn_extents: Optional[Sequence[int]] = None):
    """Launch the CUDA kernel on a CUDA tensor; run
    :func:`fused_conv_plain` (:func:`fused_conv_dyn_plain` with
    ``dyn_extents``) on a CPU tensor.  Returns ``y``, or ``(y, s1, s2)``
    with ``with_stats``; differentiable through :class:`FusedConv` when an
    input requires grad.  ``dyn_extents`` (the true (yt, xt, zt) of x) is
    eval-only: it takes no stats and no gradient."""
    ext = _check_extents(x, dyn_extents)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, scale, bias, w))
    if ext is not None and (with_stats or needs_grad):
        raise ValueError("fused_conv: dyn_extents is eval-only (no stats, "
                         "no gradient)")
    if not needs_grad:
        return _forward(x, scale, bias, w, relu, stride_z, with_stats, ext)
    if _device(x, "fused_conv") == "cuda":
        _check(x, scale, bias, w, stride_z)
        _check_bwd(x, w, stride_z)
    return FusedConv.apply(x, scale, bias, w, relu, stride_z, with_stats)
