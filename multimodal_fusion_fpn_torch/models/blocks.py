"""Conv blocks of the port on channels-last tensors, in eval and train mode.

Counterparts of ``multimodal_fusion_fpn_tpu/models/blocks.py``:

  * ``ConvX``: N convs with BatchNorm folded into the next conv's
    prologue (``_fused_packed``, ``blocks.py:425-678``): conv i computes
    ``conv(relu(y_{i-1} * s_{i-1} + b_{i-1}))``, then
    ``out = y * s + b (+ residual) -> ReLU`` in plain torch.
  * ``EncoderStage``: the '2plus3' stage (``blocks.py:785-902``), 3D or 2D.
  * ``ZDimReduction``: stride-2 (1,1,3) cascade + VALID (1,1,4) ``fully``
    conv (``blocks.py:905-1211``).
  * ``UpBlock2``: 2-input decoder block (``blocks.py:1224-1246``).
  * ``UpBlockFusion``: 3-input decoder block in concat mode
    (``blocks.py:1249-1279``).

Parameters keep the original project's state-dict names and torch shapes
(``convBlock.<i>.0.weight``, ``convBlock.<i>.1.running_var``,
``downsample.0.weight``, ...); 2D convs keep their 2D shapes.  Weights stay
fp32 and are cast to the compute dtype per call; the folded BN affine is
computed in fp32 and then cast.

BatchNorm in training (``_BNFold`` / ``TorchBatchNorm``,
``blocks.py:288-371``) normalises with the batch mean and the BIASED batch
variance ``E[y^2] - E[y]^2`` of the conv output y, both from fp32 sums:
the kernel's stats epilogue for a fused conv, plain sums otherwise.  It
updates ``running_mean``/``running_var`` with momentum 0.1 (flax's 0.9),
the var UNBIASED (x n/(n-1)) as torch's BatchNorm3d does, and counts
``num_batches_tracked``.

Exact shape bucketing (eval only, ``blocks.py:168-236,700-725,1135-1215``):
``forward`` takes the true extents ``ext`` = (y, x, z) of its input inside
the zero-padded buffer (None: unbucketed; an entry None: the whole axis).
Every conv's activated input reads 0 at or beyond them, as the SAME
padding of the unpadded run reads 0: the extents instance of the kernel
(K7) does it in its prologue, the plain path as ``mask_valid(affine_relu(
x))`` before the conv.  The extents advance through each conv with the
conv's own size arithmetic (a stride-2 conv takes z to (z + 1) // 2), and
a block's output is masked to its extents, so pools, projections and
residuals read zeros there.  The JAX package passes the extents down a
context stack; here they are an argument.

Which convs run a hand-written kernel when ``kernels`` is True mirrors
where the JAX package runs its Pallas kernels: the encoder stages and
projection cascades of at most 64 channels take the fused conv
(``ops.fused_conv``), except the convs whose input is narrow (ci < 8: the
first conv and 1x1x1 downsample of both stage 1s, also the narrow entry of
the chain), which take the banded conv (``ops.banded_conv``, K10, the
kernel of the JAX package's per-op blocked path ``banded_conv_blocked``;
the default fused path there computes the same conv in XLA).  K10 has no
prologue and no stats epilogue: an affine + ReLU before it runs in plain
torch, with the extents in the kernel; in training it runs through
``BandedConv`` (dw, and dx where the input needs it, through its kernels)
and the BatchNorm batch stats come from plain sums.  Stages 4-5, the
strided 1x1 downsample of the cascades, the ``fully`` convs, the decoder
and ``final1`` run the plain version (cuDNN on the card), as they run XLA
convolutions in the JAX package.

Eval block fusion (``block_fusion``, the JAX package's ``MMF_FUSED_PAIR``
/ ``MMF_FUSED_CHAIN``, read there from the environment and here passed as
an argument): "pair" runs each two consecutive kY = 1 convs of a block as
one kernel (``ops.fused_block.fused_pair``), "chain" the whole block
(``fused_chain``: its convs, the residual and the final ReLU).  Both only
in eval, where every BatchNorm affine is a constant, and only on the 3D
blocks of the fused stages; with ``kernels`` False they run their plain
versions (``ConvX._fusion``).
"""


import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_fusion_fpn_torch.ops.banded_conv import banded_conv
from multimodal_fusion_fpn_torch.ops.dynamic_extent import mask_valid
from multimodal_fusion_fpn_torch.ops.fused_block import (fused_chain,
                                                         fused_chain_plain,
                                                         fused_pair,
                                                         fused_pair_plain)
from multimodal_fusion_fpn_torch.ops.fused_conv import (affine_relu,
                                                        channel_sums,
                                                        conv3d_cl,
                                                        fused_conv)
from multimodal_fusion_fpn_torch.ops.upsample import upsample_nearest

BN_EPS = 1e-5
BN_MOMENTUM = 0.1     # torch's convention; flax's 0.9 keeps the running value
# Stages and cascades of at most this many channels take the kernels (the
# JAX package's fused Pallas lowering, ``blocks.fused_stage_bs``).
FUSED_MAX_CHANNELS = 64
# std of a unit normal truncated to [-2, 2] (flax's truncated_normal)
_TRUNC_STD = 0.87962566103423978


def xavier_normal_(w: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's conv init (``blocks.py:40-42``, flax
    ``xavier_normal``): variance 2 / (fan_in + fan_out), truncated normal
    at two standard deviations.  Drawn on the CPU, so a seed gives the same
    weights on every device."""
    rf = math.prod(w.shape[2:])
    std = math.sqrt(2.0 / ((w.shape[0] + w.shape[1]) * rf)) / _TRUNC_STD
    v = torch.empty(w.shape)
    nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    with torch.no_grad():
        w.copy_(v)


class ConvWeight(nn.Module):
    """A bias-free conv kernel in torch layout (O, I, k...)."""

    def __init__(self, ci: int, co: int, kernel: Sequence[int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci, *kernel))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        xavier_normal_(self.weight, generator)

    @property
    def taps(self) -> Tuple[int, int, int]:
        """(kY, kX, kz) of :meth:`logical`."""
        k = tuple(self.weight.shape[2:])
        return k if len(k) == 3 else (k[0], 1, k[1])

    def logical(self, dtype: torch.dtype) -> torch.Tensor:
        """(kY, kX, kz, ci, co) in ``dtype``; a 2D (kh, kw) kernel becomes
        (kh, 1, kw) for the singleton-X view of a 2D map."""
        w = self.weight
        if w.dim() == 4:
            w = w.unsqueeze(3)
        return w.permute(2, 3, 4, 1, 0).to(dtype).contiguous()


class Conv1x1(nn.Module):
    """A 1x1x1 conv with bias (``final1``): weight (O, I, 1, 1, 1)."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(co))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        xavier_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.permute(2, 3, 4, 1, 0).to(x.dtype)
        return conv3d_cl(x, w, (1, 1, 1), (0, 0, 0)) + self.bias.to(x.dtype)


class BNFold(nn.Module):
    """BatchNorm that returns its folded affine instead of applying it:
    ``s = weight / sqrt(var + eps)``, ``b = bias - mean * s``
    (``_BNFold``, ``blocks.py:288-329``), with the running stats in eval
    and the batch stats of ``y`` in training (module note).  Buffers as
    ``torch.nn.BatchNorm3d`` names them, so checkpoints load."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # scale ~ N(1, 0.02), bias 0 (blocks.py:45-46)
        v = 1.0 + 0.02 * torch.randn(self.weight.shape, generator=generator)
        with torch.no_grad():
            self.weight.copy_(v)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def folded(self, dtype: torch.dtype, y: Optional[torch.Tensor] = None,
               sums=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(s, b) in ``dtype``.  In training ``y`` is the conv output and
        ``sums`` its fp32 per-channel (sum y, sum y*y), or None for plain
        sums; the running stats are updated in place."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            s1, s2 = channel_sums(y) if sums is None else sums
            n = y.numel() // y.shape[-1]
            mean = s1 / n
            var = s2 / n - mean * mean
            with torch.no_grad():
                unbiased = var * (n / (n - 1)) if n > 1 else var
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * mean)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * unbiased)
                self.num_batches_tracked += 1
        s = self.weight * torch.rsqrt(var + BN_EPS)
        b = self.bias - mean * s
        return s.to(dtype), b.to(dtype)


Extents = Optional[Tuple[Optional[int], Optional[int], Optional[int]]]


def mask_extents(t: torch.Tensor, ext: Extents) -> torch.Tensor:
    """``t`` (B, Y, X, Z, C) zeroed at or beyond the true extents ``ext``."""
    return t if ext is None else mask_valid(t, dict(zip((1, 2, 3), ext)))


def conv_extents(ext: Extents, kernel: Sequence[int], stride_z: int = 1,
                 valid: bool = False) -> Extents:
    """The true extents after one conv: SAME (or VALID) padding, stride
    ``stride_z`` along z only (``ConvX._ext_after``)."""
    if ext is None:
        return None
    out = []
    for n, k, s in zip(ext, kernel, (1, 1, stride_z)):
        p = 0 if valid else k // 2
        out.append(None if n is None else (n + 2 * p - k) // s + 1)
    return tuple(out)


def _full(ext: Extents, t: torch.Tensor):
    """``ext`` with the whole-axis entries (None) filled from ``t``'s
    (Y, X, Z)."""
    return tuple(t.shape[1 + i] if e is None else e for i, e in enumerate(ext))


def _conv_bn(ci: int, co: int, kernel: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList([ConvWeight(ci, co, kernel), BNFold(co)])


class ConvX(nn.Module):
    """Residual conv block in eval: the convs with BN+ReLU between them,
    BN after the last, identity or 1x1(+BN) residual, final ReLU.

    Inputs are channels-last 3D, (B, Y, X, Z, C); a 2D block (2-tuple
    kernels) takes the singleton-X view (B, H, 1, W, C).  Convs are SAME
    (k//2 per axis) unless ``padding="valid"``; ``stride_z`` strides every
    conv along z and ``ds_stride_z`` the 1x1 downsample.  ``fused``: the
    block's convs may run the hand-written kernel (see the module note).
    """

    def __init__(self, ci: int, co: int, kernels: Sequence[Sequence[int]],
                 stride_z: int = 1, padding: str = "same",
                 residual: bool = True, downsample: bool = False,
                 ds_stride_z: int = 1, fused: bool = False):
        super().__init__()
        self.convBlock = nn.ModuleList(
            _conv_bn(ci if i == 0 else co, co, k)
            for i, k in enumerate(kernels))
        rank = len(kernels[0])
        self.downsample = (_conv_bn(ci, co, (1,) * rank) if downsample
                           else None)
        self.stride_z = stride_z
        self.padding = padding
        self.residual = residual
        self.ds_stride_z = ds_stride_z
        self.fused = fused

    def _conv(self, x, s, b, w, relu, stride_z, kernels, ext):
        """-> (y, sums): in training a fused conv also returns the fp32
        (sum y, sum y*y) of its stats epilogue; otherwise sums is None.
        ``ext``: the true extents of x (module note)."""
        ci = w.shape[3]
        dyn = None if ext is None else _full(ext, x)
        if kernels and self.fused and self.padding == "same":
            if ci >= 8 and self.training:
                y, s1, s2 = fused_conv(x, s, b, w, relu, stride_z,
                                       with_stats=True)
                return y, (s1, s2)
            if ci >= 8:
                return fused_conv(x, s, b, w, relu, stride_z,
                                  dyn_extents=dyn), None
            if stride_z == 1:
                return banded_conv(affine_relu(x, s, b, relu), w, dyn), None
        pad = ((0, 0, 0) if self.padding == "valid"
               else tuple(k // 2 for k in w.shape[:3]))
        t = mask_extents(affine_relu(x, s, b, relu), ext)
        return conv3d_cl(t, w, (1, 1, stride_z), pad), None

    def out_extents(self, ext: Extents) -> Extents:
        """The true extents of the block's output for input extents
        ``ext``."""
        for conv, _ in self.convBlock:
            ext = conv_extents(ext, conv.taps,
                               self.stride_z, self.padding == "valid")
        return ext

    def _fusion(self, block_fusion: Optional[str], ci: int):
        """(the fusion that applies, narrow entry): the eval fusion of the
        JAX package's ``MMF_FUSED_CHAIN`` / ``MMF_FUSED_PAIR`` applies where
        it applies there (``blocks.py:542-660``): in eval, to a 3D block of a
        fused stage at z stride 1 (not to the 2D stages or the stride-2
        cascades), the chain when at least two convs follow a narrow (ci <
        8) entry, which an identity-residual block never has."""
        if block_fusion not in (None, "pair", "chain"):
            raise ValueError(f"ConvX: unknown block_fusion {block_fusion!r}")
        if (block_fusion is None or self.training or not self.fused
                or self.stride_z != 1 or self.padding != "same"
                or self.convBlock[0][0].weight.dim() != 5):
            return None, False
        narrow = ci < 8 and not (self.residual and self.downsample is None)
        if block_fusion == "chain" and len(self.convBlock) - narrow < 2:
            return None, narrow
        return block_fusion, narrow

    def _residual(self, out, x, kernels, ext):
        """``out`` plus the block's residual of input ``x``."""
        if not self.residual:
            return out
        if self.downsample is None:
            return out + x
        conv, bn = self.downsample
        dt = x.dtype
        ds, sums = self._conv(x, None, None, conv.logical(dt), False,
                              self.ds_stride_z,
                              kernels and self.ds_stride_z == 1, ext)
        sd, bd = bn.folded(dt, ds, sums)
        return out + ds * sd + bd

    def _chain(self, x, kernels, ext, narrow):
        """The whole block in one kernel (``fused_chain``), or its plain
        version with ``kernels`` False.  A narrow entry conv runs before it
        as in the per-op path, and the chain stops at the last affine."""
        dt = x.dtype
        layers = [(conv.logical(dt), *bn.folded(dt))
                  for conv, bn in self.convBlock]
        dyn = None if ext is None else _full(ext, x)
        xin, s_in, b_in, relu0, ds = x, None, None, False, None
        if narrow:
            xin, _ = self._conv(x, None, None, layers[0][0], False, 1,
                                kernels, ext)
            _, s_in, b_in = layers[0]
            relu0, layers, final = True, layers[1:], "affine"
        elif self.downsample is not None:
            conv, bn = self.downsample
            final, ds = "res_conv", (conv.logical(dt), *bn.folded(dt))
        else:
            final = "res_id" if self.residual else "relu"
        chain = fused_chain if kernels else fused_chain_plain
        out = chain(xin, s_in, b_in, relu0, layers, final, ds, dyn)
        if final == "affine":
            out = mask_extents(
                torch.relu(self._residual(out, x, kernels, ext)), ext)
        return out

    def forward(self, x: torch.Tensor, kernels: bool = True,
                ext: Extents = None,
                block_fusion: Optional[str] = None) -> torch.Tensor:
        """``block_fusion``: None (per conv), "pair" or "chain" (the eval
        fusion of ``ops.fused_block``, where it applies: ``_fusion``)."""
        if ext is not None and self.training:
            raise ValueError("ConvX: true extents are eval-only")
        fusion, narrow = self._fusion(block_fusion, x.shape[-1])
        if fusion == "chain":
            return self._chain(x, kernels, ext, narrow)
        dt = x.dtype
        cur, s, b, e = x, None, None, ext
        n, i = len(self.convBlock), 0
        while i < n:
            conv, bn = self.convBlock[i]
            w = conv.logical(dt)
            if (fusion == "pair" and i + 1 < n and w.shape[0] == 1
                    and self.convBlock[i + 1][0].taps[0] == 1
                    and not (i == 0 and narrow)):
                # two convs in one kernel; their extents stay (stride 1)
                conv1, bn1 = self.convBlock[i + 1]
                s_mid, b_mid = bn.folded(dt)
                pair_fn = fused_pair if kernels else fused_pair_plain
                cur = pair_fn(cur, s, b, w, s_mid, b_mid, conv1.logical(dt),
                              i > 0, None if e is None else _full(e, cur))
                s, b = bn1.folded(dt)
                i += 2
                continue
            cur, sums = self._conv(cur, s, b, w, i > 0, self.stride_z,
                                   kernels, e)
            e = conv_extents(e, w.shape[:3], self.stride_z,
                             self.padding == "valid")
            s, b = bn.folded(dt, cur, sums)
            i += 1
        out = self._residual(cur * s + b, x, kernels, ext)
        return mask_extents(torch.relu(out), e)


class EncoderStage(nn.ModuleList):
    """The '2plus3' stage: (1,3,3)x2, then (1,3,3)x2 + (3,1,1), or
    (1,3)x2, (1,3)x2 + (3,1) in 2D; a 1x1+BN projection when the channel
    count changes.  3D input (B, Y, X, Z, C), 2D input (B, H, W, C)."""

    def __init__(self, ci: int, co: int, ndim: int = 3):
        if ndim == 3:
            k_a, k_b = ((1, 3, 3),) * 2, ((1, 3, 3),) * 2 + ((3, 1, 1),)
        else:
            k_a, k_b = ((1, 3),) * 2, ((1, 3),) * 2 + ((3, 1),)
        fused = co <= FUSED_MAX_CHANNELS
        super().__init__([
            ConvX(ci, co, k_a, downsample=ci != co, fused=fused),
            ConvX(co, co, k_b, fused=fused)])
        self.ndim = ndim

    def forward(self, x: torch.Tensor, kernels: bool = True,
                ext: Extents = None,
                block_fusion: Optional[str] = None) -> torch.Tensor:
        """``ext``: the true (y, x, z) of a 3D input, (h, w) of a 2D one.
        ``block_fusion``: the eval fusion of the 3D blocks (``ConvX``)."""
        if self.ndim == 2:
            x = x.unsqueeze(2)
            if ext is not None:
                ext = (ext[0], None, ext[1])
        for block in self:
            x = block(x, kernels, ext, block_fusion)
        return x.squeeze(2) if self.ndim == 2 else x


class ZDimReduction(nn.ModuleList):
    """Depth projection head: ``num_reductions`` stride-2 (1,1,3) convs with
    a strided 1x1 residual ('red'), then a VALID (1,1,final_kernel) conv
    ('fully').  The caller takes the mean over the remaining depth."""

    def __init__(self, c: int, num_reductions: int, final_kernel: int = 4):
        fully = ConvX(c, c, ((1, 1, final_kernel),), padding="valid",
                      residual=False)
        if num_reductions == 0:
            super().__init__([fully])
        else:
            red = ConvX(c, c, ((1, 1, 3),) * num_reductions, stride_z=2,
                        downsample=True, ds_stride_z=2 ** num_reductions,
                        fused=c <= FUSED_MAX_CHANNELS)
            super().__init__([red, fully])

    def forward(self, x: torch.Tensor, kernels: bool = True,
                ext: Extents = None) -> torch.Tensor:
        for block in self:
            x = block(x, kernels, ext)
            ext = block.out_extents(ext)
        return x


def refuse_dropout(dropout: Sequence[float], encoders: Sequence[str] = ("",),
                   decoder: bool = True) -> None:
    """Raise for a net in training whose spec has dropout > 0 in a slot it
    builds: the JAX package applies each block's dropout in training
    (``blocks.py:777-778``) and then runs that stage off its fused kernels;
    the port has no dropout yet (ROADMAP M8).  In eval dropout is the
    identity.  Slots 0-4 are the encoder levels, whose stages are named
    ``conv<level><suffix>`` for each suffix of ``encoders``; slots 5-8 the
    decoder blocks, which a net without a decoder does not build."""
    for slot, p in enumerate(dropout):
        if p <= 0 or (slot >= 5 and not decoder):
            continue
        stages = ", ".join(f"conv{slot + 1}{sfx}" for sfx in encoders)
        where = (f"encoder level {slot + 1} ({stages})" if slot < 5 else
                 f"decoder block up_concat{9 - slot}")
        raise NotImplementedError(
            f"dropout slot {slot} ({where}) is {p}: the port does not "
            f"apply dropout in training yet (ROADMAP M8)")


class UpBlock2(nn.Module):
    """Decoder block of the single-modality nets: nearest upsample of the
    deeper map, concat with one skip, ConvX (3,3,1)x2 with a 1x1
    projection."""

    def __init__(self, c_low: int, c_cur: int, upfactor: Sequence[int]):
        super().__init__()
        self.conv = ConvX(c_low + c_cur, c_cur, ((3, 3, 1),) * 2,
                          downsample=True)
        self.upfactor = tuple(upfactor)

    def forward(self, skip, deeper, kernels: bool = True,
                ext: Extents = None):
        """``ext``: the true extents of the skip, (y, x, None)."""
        up = upsample_nearest(deeper, self.upfactor, axes=(1, 2, 3))
        return self.conv(torch.cat([skip, up], dim=-1), kernels, ext)


class UpBlockFusion(nn.Module):
    """Decoder block fusing a 3D skip, a 2D skip and the deeper features
    (``mode='concat'``): nearest upsample of the deeper map, concat, ConvX
    (3,3,1)x2 with a 1x1 projection."""

    def __init__(self, c_low: int, c_cur: int, upfactor: Sequence[int]):
        super().__init__()
        self.conv = ConvX(c_low + 2 * c_cur, c_cur, ((3, 3, 1),) * 2,
                          downsample=True)
        self.upfactor = tuple(upfactor)

    def forward(self, skip3d, skip2d, deeper, kernels: bool = True,
                ext: Extents = None):
        """``ext``: the true extents of the skips, (y, x, None)."""
        up = upsample_nearest(deeper, self.upfactor, axes=(1, 2, 3))
        return self.conv(torch.cat([skip3d, skip2d, up], dim=-1), kernels,
                         ext)
