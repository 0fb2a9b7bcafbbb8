"""Conv blocks of the port, in eval mode, on channels-last tensors.

Counterparts of ``multimodal_fusion_fpn_tpu/models/blocks.py``:

  * ``ConvX``: N convs with BatchNorm folded into the next conv's
    prologue (``_fused_packed``, ``blocks.py:425-678``): conv i computes
    ``conv(relu(y_{i-1} * s_{i-1} + b_{i-1}))``, then
    ``out = y * s + b (+ residual) -> ReLU`` in plain torch.
  * ``EncoderStage``: the '2plus3' stage (``blocks.py:785-902``), 3D or 2D.
  * ``ZDimReduction``: stride-2 (1,1,3) cascade + VALID (1,1,4) ``fully``
    conv (``blocks.py:905-1211``).
  * ``UpBlockFusion``: 3-input decoder block in concat mode
    (``blocks.py:1249-1279``).

Parameters keep the original project's state-dict names and torch shapes
(``convBlock.<i>.0.weight``, ``convBlock.<i>.1.running_var``,
``downsample.0.weight``, ...); 2D convs keep their 2D shapes.  Weights stay
fp32 and are cast to the compute dtype per call; the folded BN affine is
computed in fp32 and then cast.  Training is not ported: a BatchNorm in
training mode raises.

Which convs run the hand-written kernel (``ops.fused_conv``) when
``kernels`` is True mirrors where the JAX package runs its Pallas kernel:
the encoder stages and projection cascades of at most 64 channels, except
the convs whose input is narrow (ci < 8: the first conv and 1x1
downsample of both stage 1s, which the JAX package computes with XLA).
Stages 4-5, the strided 1x1 downsample of the cascades, the ``fully``
convs, the decoder and ``final1`` run the plain version (cuDNN on the
card), as they run XLA convolutions in the JAX package.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_fusion_fpn_torch.ops.fused_conv import (affine_relu,
                                                        conv3d_cl,
                                                        fused_conv)
from multimodal_fusion_fpn_torch.ops.upsample import upsample_nearest

BN_EPS = 1e-5
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
    """Eval BatchNorm that returns its folded affine instead of applying
    it: ``s = weight / sqrt(running_var + eps)``, ``b = bias -
    running_mean * s`` (``_BNFold``, ``blocks.py:288-329``).  Buffers as
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

    def folded(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet; call .eval()")
        s = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        b = self.bias - self.running_mean * s
        return s.to(dtype), b.to(dtype)


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

    def _conv(self, x, s, b, w, relu, stride_z, kernels):
        ci = w.shape[3]
        if kernels and self.fused and ci >= 8 and self.padding == "same":
            return fused_conv(x, s, b, w, relu, stride_z)
        pad = ((0, 0, 0) if self.padding == "valid"
               else tuple(k // 2 for k in w.shape[:3]))
        return conv3d_cl(affine_relu(x, s, b, relu), w, (1, 1, stride_z),
                         pad)

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        dt = x.dtype
        cur, s, b = x, None, None
        for i, (conv, bn) in enumerate(self.convBlock):
            cur = self._conv(cur, s, b, conv.logical(dt), i > 0,
                             self.stride_z, kernels)
            s, b = bn.folded(dt)
        out = cur * s + b
        if self.residual:
            if self.downsample is not None:
                conv, bn = self.downsample
                ds = self._conv(x, None, None, conv.logical(dt), False,
                                self.ds_stride_z,
                                kernels and self.ds_stride_z == 1)
                sd, bd = bn.folded(dt)
                out = out + ds * sd + bd
            else:
                out = out + x
        return torch.relu(out)


class EncoderStage(nn.ModuleList):
    """The '2plus3' stage: (1,3,3)x2, then (1,3,3)x2 + (3,1,1), or
    (1,3)x2, (1,3)x2 + (3,1) in 2D; a 1x1+BN projection when the channel
    count changes.  3D input (B, Y, X, Z, C), 2D input (B, H, W, C)."""

    def __init__(self, ci: int, co: int, ndim: int = 3):
        if ndim == 3:
            k_a, k_b = ((1, 3, 3),) * 2, ((1, 3, 3),) * 2 + ((3, 1, 1),)
        else:
            k_a, k_b = ((1, 3),) * 2, ((1, 3),) * 2 + ((3, 1),)
        fused = co <= 64
        super().__init__([
            ConvX(ci, co, k_a, downsample=ci != co, fused=fused),
            ConvX(co, co, k_b, fused=fused)])
        self.ndim = ndim

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if self.ndim == 2:
            x = x.unsqueeze(2)
        for block in self:
            x = block(x, kernels)
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
                        fused=c <= 64)
            super().__init__([red, fully])

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        for block in self:
            x = block(x, kernels)
        return x


class UpBlockFusion(nn.Module):
    """Decoder block fusing a 3D skip, a 2D skip and the deeper features
    (``mode='concat'``): nearest upsample of the deeper map, concat, ConvX
    (3,3,1)x2 with a 1x1 projection."""

    def __init__(self, c_low: int, c_cur: int, upfactor: Sequence[int]):
        super().__init__()
        self.conv = ConvX(c_low + 2 * c_cur, c_cur, ((3, 3, 1),) * 2,
                          downsample=True)
        self.upfactor = tuple(upfactor)

    def forward(self, skip3d, skip2d, deeper, kernels: bool = True):
        up = upsample_nearest(deeper, self.upfactor, axes=(1, 2, 3))
        return self.conv(torch.cat([skip3d, skip2d, up], dim=-1), kernels)
