"""Whole-block eval fusion (K8): a ConvX block, or two consecutive convs,
in one kernel, with every intermediate kept on chip.

    fused_chain(x, s_in, b_in, relu0, convs, final, ds)
        the convs of one block: t = relu0?(x * s_in + b_in); per conv
        (w, s, b) in ``convs``: y = conv(t, w), and t = relu(y * s + b)
        before the next conv; then ``final`` on the last y:
        'affine'    y * s + b (the caller adds the residual itself),
        'relu'      relu(y * s + b),
        'res_id'    relu((y * s + b) + x),
        'res_conv'  relu(((y * s + b) + yd * sd) + bd), yd = conv(x, wd),
                    ``ds`` = (wd, sd, bd) the 1x1 downsample and its affine.
    fused_pair(x, s0, b0, w0, s_mid, b_mid, w1, relu0)
        conv(relu(conv(relu0?(x * s0 + b0), w0) * s_mid + b_mid), w1), raw
        (the caller applies the next affine).

Channels-last: x (B, Y, X, Z, ci), logical weights (kY, kX, kz, ci, co),
scales and biases per channel (folded eval BatchNorm), ``s_in`` / ``b_in``
and ``s0`` / ``b0`` both None for the identity.  Convs are stride-1 SAME;
padding applies to each activated conv input (an out-of-range tap reads 0,
not relu(bias)).  ``dyn_extents`` (exact shape bucketing): the true
(yt, xt, zt) of x inside its zero-padded buffer; every activated conv input
also reads 0 at or beyond them, and the chain's output is 0 there (the
pair's raw output is the conv's value everywhere).  Each intermediate is
rounded to the storage type as the per-op path's HBM round trip rounds it,
and each product and sum of an affine is rounded too (``x*s``, then
``+b``), so the plain versions (:func:`fused_chain_plain`,
:func:`fused_pair_plain`) are the per-op composition of the plain fused
conv.  Eval only: the wrappers raise when an input requires grad (the TPU
kernels have no VJP either).

Source note.  ``csrc/fused_block_mma.cu`` (bf16, on the tensor cores) and
``csrc/fused_block.cu`` (fp32, on the CUDA cores) replace the TPU kernels of
``multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py`` ``_kernel2`` (the
pair, launched by ``fused_conv2_eval``, ``MMF_FUSED_PAIR=1``) and
``_chain_kernel`` (the chain, launched by ``fused_chain_eval``,
``MMF_FUSED_CHAIN=1``), both with ``with_dyn``.  Each takes two (1,3,3)
convs, or (1,3,3), (1,3,3), (3,1,1) (the trailing conv reads a ring of the
last three rows), with the final mode, ``relu0`` and the extents as
arguments; other taps raise.  Their bounds and designs are in the .cu
headers.  bf16 (stage 1 bound by bytes, stages 2-3 by operations): an
implicit GEMM per conv (``mma.sync``) over a TX x TZ window whose input,
conv-0 output and ring stay in shared memory as bf16; at 64 channels the
weights of three convs stream through two k16 slots.  It takes co in (16, 32, 64) and
any ci % 8 == 0 whose tiles fit, and is bitwise equal to the tensor-core
per-conv path (:func:`fused_chain_per_conv`).  fp32: the same function as
fp32 FMAs, bitwise equal to the fp32 per-conv path.  The bf16 CUDA-core
instance of ``fused_block.cu`` stays reachable through the private
``tensor_cores=False`` of :func:`_launch`, bitwise equal to the CUDA-core
per-conv path: only for comparing the two on the card; the model never
passes it.  :func:`plan` gives the tiling a call takes; :func:`refusal` /
:func:`takes` say whether the kernel takes a block (its taps, widths,
final mode and a window whose tiles fit in shared memory, computed here
as the .cu plans compute it), the rule that the wrappers' checks and the
model's routing (``models.blocks.ConvX``) share.

Launch counters: ``launches["fused_chain"]``, ``["fused_pair"]``, and
``["fused_chain_dyn"]`` / ``["fused_pair_dyn"]`` for calls with extents;
``calls`` counts the call shapes they ran at: (kernel, x shape, weight
shapes, final, relu0, entry affine, dtype, extents).  A CPU call runs the
plain version and counts nothing.
"""

import collections
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from multimodal_fusion_fpn_torch.ops import fused_conv as _fc
from multimodal_fusion_fpn_torch.ops.dynamic_extent import mask_valid

launches = {name: 0 for name in ("fused_chain", "fused_pair",
                                 "fused_chain_dyn", "fused_pair_dyn")}
calls: collections.Counter = collections.Counter()

# final modes in the order of the C interface's codes
FINALS = ("raw", "affine", "relu", "res_id", "res_conv")
_TAPS = ((1, 3, 3), (1, 3, 3), (3, 1, 1))
_PTR, _INT = ctypes.c_void_p, ctypes.c_int

Conv = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _conv_plain(x, s, b, w, relu, ext):
    if ext is None:
        return _fc.fused_conv_plain(x, s, b, w, relu)
    return _fc.fused_conv_dyn_plain(x, s, b, w, relu, 1, ext)


def _conv_per_conv(x, s, b, w, relu, ext, tensor_cores=True):
    if tensor_cores:
        return _fc.fused_conv(x, s, b, w, relu, dyn_extents=ext)
    _no_grad("per-conv path (tensor_cores=False)", [x, s, b, w])
    return _fc._forward(x, s, b, w, relu, 1, False,
                        _fc._check_extents(x, ext), tensor_cores=False)


def _chain_of(conv, x, s_in, b_in, relu0, convs, final, ds, ext):
    cur, s, b, relu = x, s_in, b_in, relu0
    for w, s_post, b_post in convs:
        cur = conv(cur, s, b, w, relu, ext)
        s, b, relu = s_post, b_post, True
    out = cur * s + b
    if final == "res_id":
        out = out + x
    elif final == "res_conv":
        wd, sd, bd = ds
        out = out + conv(x, None, None, wd, False, ext) * sd + bd
    if final != "affine":
        out = torch.relu(out)
    if ext is not None:
        out = mask_valid(out, dict(zip((1, 2, 3), ext)))
    return out


def fused_chain_plain(x: torch.Tensor, s_in: Optional[torch.Tensor],
                      b_in: Optional[torch.Tensor], relu0: bool,
                      convs: Sequence[Conv], final: str,
                      ds: Optional[Conv] = None,
                      dyn_extents: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_chain`: the per-op
    composition (``fused_chain_eval(..., impl="ref")``)."""
    return _chain_of(_conv_plain, x, s_in, b_in, relu0, convs, final, ds,
                     dyn_extents)


def fused_chain_per_conv(x: torch.Tensor, s_in: Optional[torch.Tensor],
                         b_in: Optional[torch.Tensor], relu0: bool,
                         convs: Sequence[Conv], final: str,
                         ds: Optional[Conv] = None,
                         dyn_extents: Optional[Sequence[int]] = None,
                         tensor_cores: bool = True) -> torch.Tensor:
    """The same composition through the per-conv kernel
    (``fused_conv``: K1, K2 and K7 on a CUDA tensor), which the model runs
    without ``block_fusion``; the yardstick of the whole-block kernel,
    which is bitwise equal to it.  ``tensor_cores=False`` takes the bf16
    CUDA-core per-conv kernel, to which K8's bf16 CUDA-core instance
    (``_launch(..., tensor_cores=False)``) is bit-equal: only for comparing
    the two on the card."""
    conv = functools.partial(_conv_per_conv, tensor_cores=tensor_cores)
    return _chain_of(conv, x, s_in, b_in, relu0, convs, final, ds,
                     dyn_extents)


def fused_pair_plain(x: torch.Tensor, s0: Optional[torch.Tensor],
                     b0: Optional[torch.Tensor], w0: torch.Tensor,
                     s_mid: torch.Tensor, b_mid: torch.Tensor,
                     w1: torch.Tensor, relu0: bool,
                     dyn_extents: Optional[Sequence[int]] = None
                     ) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_pair`: two plain fused
    convs (``fused_conv2_eval(..., impl="ref")``)."""
    y = _conv_plain(x, s0, b0, w0, relu0, dyn_extents)
    return _conv_plain(y, s_mid, b_mid, w1, True, dyn_extents)


def fused_pair_per_conv(x: torch.Tensor, s0: Optional[torch.Tensor],
                        b0: Optional[torch.Tensor], w0: torch.Tensor,
                        s_mid: torch.Tensor, b_mid: torch.Tensor,
                        w1: torch.Tensor, relu0: bool,
                        dyn_extents: Optional[Sequence[int]] = None,
                        tensor_cores: bool = True) -> torch.Tensor:
    """The pair through the per-conv kernel (as
    :func:`fused_chain_per_conv`)."""
    y = _conv_per_conv(x, s0, b0, w0, relu0, dyn_extents, tensor_cores)
    return _conv_per_conv(y, s_mid, b_mid, w1, True, dyn_extents,
                          tensor_cores)


def _no_grad(who, tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{who}: eval only, an input requires grad (the "
                         f"kernel has no backward)")


# shared memory a block may opt in to on sm_90 (``kMaxSmem`` in the .cu
# sources), the bf16 padding of each shared row of the tensor-core kernel
# (``kPad``) and the z positions of a CUDA-core tile (``kTZ``)
_MAX_SMEM = 227 * 1024
_PAD, _CUDA_CORE_TZ = 8, 32


def _smem_fits(ci: int, co: int, n_conv: int, final: str,
               dtype: torch.dtype, mma: bool) -> bool:
    """Whether the tiles of the kernel's smallest window fit in shared
    memory at any X and Z.  The plan of the .cu sources (:func:`plan`)
    takes a window whenever that one fits: a 1 x 16 window with the
    weights streamed at 64 channels on the tensor cores
    (``csrc/fused_block_mma.cu``, ``layout``), TX = 1 on the CUDA cores
    (``csrc/fused_block.cu``, ``smem_bytes``)."""
    ky3 = n_conv == 3
    if not mma:
        tz = _CUDA_CORE_TZ
        esize = 4 if dtype == torch.float32 else 2
        return esize * (ci * 5 * (tz + 4) + co * 3 * (tz + 2)
                        + (3 * co * tz if ky3 else 0)) <= _MAX_SMEM
    ci16 = -(-ci // 16) * 16
    ldi, ldo, tx, tz = ci16 + _PAD, co + _PAD, 1, 16
    total = 2 * ci16 + 8 * co
    total += (2 * 9 * 16 * ldo if co == 64
              else (9 * ci16 + 9 * co + (3 * co if ky3 else 0)) * ldo)
    if final == "res_conv":
        total += ci16 * ldo
    if final in ("res_id", "res_conv"):
        total += tx * tz * ldi
    total += ((tx + 4) * (tz + 4) * ldi + (tx + 2) * (tz + 2) * ldo
              + (3 * tx * tz * ldo if ky3 else 0))
    return 2 * total <= _MAX_SMEM


def refusal(ci: int, co: int, taps: Sequence[Sequence[int]],
            stride_z: int = 1, training: bool = False,
            dtype: torch.dtype = torch.bfloat16, final: str = "relu",
            tensor_cores: bool = True) -> Optional[str]:
    """Why the kernel does not take a block of convs with logical taps
    ``taps`` ((kY, kX, kz) per conv), ``ci`` -> ``co`` channels at z stride
    ``stride_z`` in ``dtype`` with the final mode ``final``, or None when it
    takes it: eval only, two (1,3,3) convs or (1,3,3), (1,3,3), (3,1,1),
    ci % 8 == 0 and co % 16 == 0, co in (16, 32, 64) on the tensor cores,
    and tiles that fit in shared memory (:func:`_smem_fits`).  The one rule
    that the wrappers' checks and the model's routing (``blocks.ConvX``)
    share."""
    if training:
        return "eval only (the kernel has no backward)"
    if dtype not in _fc._DTYPES:
        return f"unsupported dtype {dtype}"
    taps = tuple(tuple(t) for t in taps)
    if stride_z != 1 or taps not in (_TAPS[:2], _TAPS):
        return (f"no kernel for taps {taps} at z stride {stride_z}: it takes "
                f"two (1,3,3) convs, or (1,3,3), (1,3,3), (3,1,1)")
    if ci % 8 or co % 16:
        return (f"kernel needs ci % 8 == 0 and co % 16 == 0, got ci={ci}, "
                f"co={co}")
    if final == "res_id" and ci != co:
        return f"res_id needs ci == co, got {ci}, {co}"
    mma = _tensor_cores(dtype, tensor_cores)
    if mma and co not in (16, 32, 64):
        return (f"the bf16 kernel (tensor cores) takes co in (16, 32, 64), "
                f"got ci={ci}, co={co}")
    if not _smem_fits(ci, co, len(taps), final, dtype, mma):
        return (f"the tiles of ci={ci}, co={co} in {dtype} do not fit in "
                f"shared memory")
    return None


def takes(ci: int, co: int, taps: Sequence[Sequence[int]],
          stride_z: int = 1, training: bool = False,
          dtype: torch.dtype = torch.bfloat16, final: str = "relu") -> bool:
    """Whether the kernel takes the block (:func:`refusal`)."""
    return refusal(ci, co, taps, stride_z, training, dtype, final) is None


def _check(who, x, s_in, b_in, convs, final, ds):
    """What the kernel takes (module note); raises ValueError otherwise."""
    if x.dtype not in _fc._DTYPES:
        raise TypeError(f"{who}: unsupported dtype {x.dtype}")
    taps = tuple(tuple(w.shape[:3]) for w, _, _ in convs)
    if x.dim() != 5 or taps not in (_TAPS[:2], _TAPS):
        raise ValueError(f"{who}: no kernel for x {tuple(x.shape)} and taps "
                         f"{taps}: it takes two (1,3,3) convs, or (1,3,3), "
                         f"(1,3,3), (3,1,1)")
    ci, co = x.shape[4], convs[0][0].shape[4]
    shapes = [(ci, co)] + [(co, co)] * (len(convs) - 1)
    if any(tuple(w.shape[3:]) != sh for (w, _, _), sh in zip(convs, shapes)):
        raise ValueError(f"{who}: weights "
                         f"{[tuple(w.shape) for w, _, _ in convs]} do not "
                         f"chain from {ci} input channels")
    why = refusal(ci, co, taps, 1, False, x.dtype, final)
    if why is not None:
        raise ValueError(f"{who}: {why}")
    if (s_in is None) != (b_in is None):
        raise ValueError(f"{who}: s_in and b_in must both be given or both "
                         f"be None")
    vecs = [("s_in", s_in, ci), ("b_in", b_in, ci)]
    for j, (_, s, b) in enumerate(convs):
        if final == "raw" and j == len(convs) - 1:
            continue
        vecs += [(f"s{j}", s, co), (f"b{j}", b, co)]
    mats = [(f"w{j}", w) for j, (w, _, _) in enumerate(convs)]
    if final == "res_conv":
        if ds is None or tuple(ds[0].shape) != (1, 1, 1, ci, co):
            raise ValueError(f"{who}: res_conv needs ds = (w (1, 1, 1, {ci}, "
                             f"{co}), sd, bd)")
        vecs += [("sd", ds[1], co), ("bd", ds[2], co)]
        mats.append(("wd", ds[0]))
    for name, t, n in vecs + [(n, w, None) for n, w in mats]:
        if t is None:
            if name in ("s_in", "b_in"):
                continue
            raise ValueError(f"{who}: {name} is missing")
        if (t.device != x.device or t.dtype != x.dtype
                or (n is not None and tuple(t.shape) != (n,))):
            raise ValueError(f"{who}: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; x is {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: x is not contiguous")


def _tensor_cores(dtype, tensor_cores=True):
    return tensor_cores and dtype == torch.bfloat16


def plan(x: torch.Tensor, n_conv: int, co: int, final: str = "relu",
         tensor_cores: bool = True) -> Tuple[int, ...]:
    """(TX, G, shared-memory bytes per block, blocks, TZ, weights streamed)
    of the kernel's tiling for input ``x``: a TX x TZ (x, z) window walking
    G rows (TX = 0: it does not fit), its weights resident in shared memory
    (0) or streamed through two k16 slots (1).  bf16 takes the tensor-core
    kernel unless ``tensor_cores`` is False."""
    B, Y, X, Z, ci = x.shape
    out = (ctypes.c_longlong * 6)()
    if _tensor_cores(x.dtype, tensor_cores):
        fn = _fc._fn("fused_block_mma", "mmf_fused_block_mma_plan",
                     [_INT] * 8 + [_PTR])
        rc = fn(n_conv, FINALS.index(final), B, Y, X, Z, ci, co,
                ctypes.addressof(out))
        if rc > 0:
            raise RuntimeError(f"fused_block: plan failed, CUDA error {rc}")
        return tuple(int(v) for v in out)
    fn = _fc._fn("fused_block", "mmf_fused_block_plan", [_INT] * 8 + [_PTR])
    fn(_fc._DTYPES[x.dtype], n_conv, B, Y, X, Z, ci, co, ctypes.addressof(out))
    return tuple(int(v) for v in out[:4]) + (32, 0)


def _launch(name, x, s_in, b_in, relu0, convs, final, ds, ext,
            tensor_cores=True):
    """The kernel on CUDA tensors that passed :func:`_check`: bf16 on the
    tensor cores (``csrc/fused_block_mma.cu``), fp32 on the CUDA cores
    (``csrc/fused_block.cu``).  ``tensor_cores=False`` takes the bf16
    CUDA-core instance: only for comparing the two on the card; the model
    never passes it."""
    B, Y, X, Z, ci = x.shape
    co = convs[0][0].shape[4]
    mma = _tensor_cores(x.dtype, tensor_cores)
    out = torch.empty((B, Y, X, Z, co), dtype=x.dtype, device=x.device)
    # bf16 weights as they are (tensor cores); fp32 for the CUDA cores
    wt = ((lambda w: w.contiguous()) if mma
          else (lambda w: w.float().contiguous()))
    ws = [wt(w) for w, _, _ in convs] + [None] * (3 - len(convs))
    sb = [(s, b) for _, s, b in convs] + [(None, None)] * (3 - len(convs))
    if final == "raw":
        sb[len(convs) - 1] = (None, None)
    wd = sd = bd = None
    if final == "res_conv":
        wd, sd, bd = wt(ds[0]), ds[1], ds[2]
    vec = lambda t: None if t is None else t.contiguous()
    dyn = None if ext is None else (ctypes.c_int * 3)(*ext)
    args = [x, vec(s_in), vec(b_in)]
    for w, (s, b) in zip(ws, sb):
        args += [w, vec(s), vec(b)]
    args += [wd, vec(sd), vec(bd), out]
    ptrs = [_fc._ptr(t) for t in args]
    tail = (None if dyn is None else ctypes.addressof(dyn), B, Y, X, Z, ci,
            co, _fc._stream(x))
    if mma:
        if any(p is not None and p % 16 for p in ptrs):
            raise ValueError(f"{name}: the bf16 kernel needs 16-byte aligned "
                             f"tensors")
        fn = _fc._fn("fused_block_mma", "mmf_fused_block_mma",
                     [_INT] * 3 + [_PTR] * 17 + [_INT] * 6 + [_PTR])
        rc = fn(len(convs), FINALS.index(final), int(relu0), *ptrs, *tail)
    else:
        fn = _fc._fn("fused_block", "mmf_fused_block",
                     [_INT] * 4 + [_PTR] * 17 + [_INT] * 6 + [_PTR])
        rc = fn(_fc._DTYPES[x.dtype], len(convs), FINALS.index(final),
                int(relu0), *ptrs, *tail)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    key = name + ("_dyn" if ext is not None else "")
    launches[key] += 1
    calls[(key, tuple(x.shape), tuple(tuple(w.shape) for w, _, _ in convs),
           final, bool(relu0), s_in is not None, str(x.dtype), ext)] += 1
    return out


def fused_chain(x: torch.Tensor, s_in: Optional[torch.Tensor],
                b_in: Optional[torch.Tensor], relu0: bool,
                convs: Sequence[Conv], final: str, ds: Optional[Conv] = None,
                dyn_extents: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The whole-block kernel on a CUDA tensor; :func:`fused_chain_plain` on
    a CPU tensor (module note)."""
    if final not in FINALS[1:]:
        raise ValueError(f"fused_chain: unknown final mode {final!r}")
    ext = _fc._check_extents(x, dyn_extents)
    _no_grad("fused_chain", [x, s_in, b_in, *(t for c in convs for t in c),
                             *(ds or ())])
    if _fc._device(x, "fused_chain") == "cpu":
        return fused_chain_plain(x, s_in, b_in, relu0, convs, final, ds, ext)
    _check("fused_chain", x, s_in, b_in, convs, final, ds)
    return _launch("fused_chain", x, s_in, b_in, relu0, convs, final, ds, ext)


def fused_pair(x: torch.Tensor, s0: Optional[torch.Tensor],
               b0: Optional[torch.Tensor], w0: torch.Tensor,
               s_mid: torch.Tensor, b_mid: torch.Tensor, w1: torch.Tensor,
               relu0: bool,
               dyn_extents: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The pair kernel on a CUDA tensor; :func:`fused_pair_plain` on a CPU
    tensor (module note)."""
    ext = _fc._check_extents(x, dyn_extents)
    _no_grad("fused_pair", [x, s0, b0, w0, s_mid, b_mid, w1])
    if _fc._device(x, "fused_pair") == "cpu":
        return fused_pair_plain(x, s0, b0, w0, s_mid, b_mid, w1, relu0, ext)
    convs = [(w0, s_mid, b_mid), (w1, None, None)]
    _check("fused_pair", x, s0, b0, convs, "raw", None)
    return _launch("fused_pair", x, s0, b0, relu0, convs, "raw", None, ext)
