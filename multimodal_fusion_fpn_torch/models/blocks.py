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
  * ``UpBlockFusion``: 3-input decoder block, its two skips concatenated
    or added (``blocks.py:1249-1279``).
  * ``UpConv``: the decoder's transposed conv with ``is_deconv``
    (``_up``, ``blocks.py:1214-1220``), in place of the nearest upsample.

Parameters keep the original project's state-dict names and torch shapes
(``convBlock.<i>.0.weight``, ``convBlock.<i>.1.running_var``,
``downsample.0.weight``, ``up.weight`` as ``ConvTranspose3d`` keeps it,
...); 2D convs keep their 2D shapes.  Weights stay fp32 and are cast to
the compute dtype per call; the folded BN affine is computed in fp32 and
then cast.

Without BatchNorm (the ini's ``is-batchnorm=false``, ``bn=False``) each
conv of a block, the downsample's included, carries a bias
(``convBlock.<i>.0.bias``, ``use_bias=not self.use_bn``, ``blocks.py:
727,756,1078,1095``) and its fold into the next conv's prologue is scale
1 and that bias (``_affine``), in training too: no batch stats, no running
stats.  Such a stage is not ``fused`` (``fused_stage_bs:262``,
``ZDimReduction._fused_bs:1145``): its convs run the plain version (cuDNN
on the card), its pools still the kernel, with the first-max backward.

BatchNorm in training (``_BNFold`` / ``TorchBatchNorm``,
``blocks.py:288-371``) normalises with the batch mean and the BIASED batch
variance ``E[y^2] - E[y]^2`` of the conv output y, both from fp32 sums:
the kernel's stats epilogue for a fused conv, plain sums otherwise.  It
updates ``running_mean``/``running_var`` with momentum 0.1 (flax's 0.9),
the var UNBIASED (x n/(n-1)) as torch's BatchNorm3d does, and counts
``num_batches_tracked``.  On a process mesh (``parallel.comm.sharded``)
the sums and the count are the global batch's: the sums are all-reduced,
differentiably, over the space group (the replica's whole width) or, with
synced data parallelism, over the world, before the mean and var are
formed, in every stage alike.

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
projection cascades of at most 64 channels with BatchNorm (``fused``) take
the fused conv (``ops.fused_conv``), except the convs whose input is
narrow (ci < 8: the first conv and 1x1x1 downsample of both stage 1s, also
the narrow entry of the chain), which take the banded conv
(``ops.banded_conv``, K10, the kernel of the JAX package's per-op blocked
path ``banded_conv_blocked``; the default fused path there computes the
same conv in XLA).  A conv goes to a kernel only where that kernel takes
its widths, dtype and gradient (each module's ``takes``, the predicate
its wrapper's check also applies: K1, K2 and K7 need ci % 8 == 0 and
co % 16 == 0, their backward ci % 16 == 0, K10 co in {1, 16, 32, 64},
K8 its shared-memory plan); a conv it refuses runs the plain version, as
the convs of a wider stage do.  The JAX package has no such rule: its
Pallas kernels take any width of at most 64 channels.  K10 has no
prologue and no stats epilogue: an affine + ReLU before it runs in plain
torch, with the extents in the kernel; in training it runs through
``BandedConv`` (dw, and dx where the input needs it, through its kernels)
and the BatchNorm batch stats come from plain sums.  Stages 4-5, the
strided 1x1 downsample of the cascades, the ``fully`` convs, the decoder
and ``final1`` run the plain version (cuDNN on the card), as they run XLA
convolutions in the JAX package.

Dropout (``blocks.py:777-778``): a block with ``dropout`` > 0 drops
elements of its output after the final ReLU in training, keeping each with
probability 1 - p and scaling the kept ones by 1 / (1 - p), as flax's
``nn.Dropout``; in eval it is the identity.  The masks come from the
``torch.Generator`` that :func:`dropout_generator` installs (the train step
does, from its ``generator`` argument); a training forward through a
dropout block without one raises.  On a process mesh the mask is drawn
for the global batch (the global rows under synced data parallelism, the
whole width under the space axis) and each rank keeps its rows and
columns, as one process draws it for the whole batch.  A stage with dropout > 0 leaves the
kernels in eval and in training, as the JAX package takes it off its fused
lowering (``fused_stage_bs``, ``blocks.py:262``): its convs run the plain
version, and the pool after it the first-max backward (``reduce_window``
there).

Eval block fusion (``block_fusion``, the JAX package's ``MMF_FUSED_PAIR``
/ ``MMF_FUSED_CHAIN``, read there from the environment and here passed as
an argument): "pair" runs each two consecutive kY = 1 convs of a block as
one kernel (``ops.fused_block.fused_pair``), "chain" the whole block
(``fused_chain``: its convs, the residual and the final ReLU).  Both only
in eval, where every BatchNorm affine is a constant, and only on the 3D
blocks of the fused stages; with ``kernels`` False they run their plain
versions (``ConvX._fusion``).

The space axis (``parallel.comm.sharded`` with a space group): each rank
holds its columns of the width, X of a 3D block and W (the z axis of the
singleton-X view) of a 2D one, and every conv reads its neighbours'
columns through a halo exchange (``parallel.comm.halo_x``), as the JAX
package routes it (``ConvX._conv``).  The 3D fused convs keep the kernels
on each shard: a conv with kX = 3 (K1, K10) computes its prologue in torch,
exchanges the activated columns, runs the kernel with an identity
prologue on the (X/M + 2)-wide slab and crops it (``_fused_op_sharded``,
``fused_conv.py:877-890``); the BatchNorm sums then come from the cropped
output (``_stats_of``, ``:1204-1209``); a conv with kX = 1 (K2, the
strided cascade, the 1x1x1 convs) needs no halo and keeps its prologue
(``:892-897``).  The 2D stages run per op (cuDNN), as a space mesh takes
the JAX package's fused 2D stages off (``blocks.py:823-825,1148-1152``),
and so does every other conv: a halo of k // 2 and no padding along the
width.  The zoo models refuse extents and block fusion under the space
axis (``models.zoo``).
"""


import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_fpn_torch.ops.banded_conv import banded_conv
from multimodal_fusion_fpn_torch.ops.banded_conv import \
    takes as banded_conv_takes
from multimodal_fusion_fpn_torch.ops.dynamic_extent import mask_valid
from multimodal_fusion_fpn_torch.ops.fused_block import (fused_chain,
                                                         fused_chain_plain,
                                                         fused_pair,
                                                         fused_pair_plain)
from multimodal_fusion_fpn_torch.ops.fused_block import \
    takes as fused_block_takes
from multimodal_fusion_fpn_torch.ops.fused_conv import (affine_relu,
                                                        channel_sums,
                                                        conv3d_cl,
                                                        fused_conv)
from multimodal_fusion_fpn_torch.ops.fused_conv import \
    takes as fused_conv_takes
from multimodal_fusion_fpn_torch.ops.upsample import upsample_nearest
from multimodal_fusion_fpn_torch.parallel.comm import (all_reduce_sum,
                                                      halo_x, shards,
                                                      space_group)

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
    """A conv kernel in torch layout (O, I, k...), with a bias (O,) when
    ``bias`` (the convs of a block without BatchNorm)."""

    def __init__(self, ci: int, co: int, kernel: Sequence[int],
                 bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci, *kernel))
        self.bias = nn.Parameter(torch.empty(co)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        xavier_normal_(self.weight, generator)
        if self.bias is not None:
            # zero for a 3D conv, N(0, 1) for a 2D one
            # (``conv_bias_init_for_rank``, ``blocks.py:49-52``)
            v = (torch.zeros(self.bias.shape) if self.weight.dim() == 5
                 else torch.randn(self.bias.shape, generator=generator))
            with torch.no_grad():
                self.bias.copy_(v)

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


class UpConv(nn.Module):
    """The decoder's transposed conv with kernel = stride = the up factor
    and a bias (``_up`` with ``is_deconv``, ``blocks.py:1214-1220``):
    weight (I, O, kY, kX, kz) as ``torch.nn.ConvTranspose3d`` keeps it, on
    channels-last tensors.  Each input position writes its own
    kY x kX x kz block of the output, so there is no overlap and no
    padding; it runs the plain version (cuDNN on the card)."""

    def __init__(self, ci: int, co: int, upfactor: Sequence[int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ci, co, *upfactor))
        self.bias = nn.Parameter(torch.empty(co))
        self.upfactor = tuple(upfactor)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # xavier kernel, bias N(0, 1) (``blocks.py:1216-1218``)
        xavier_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.copy_(torch.randn(self.bias.shape, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3),
                               self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=self.upfactor)
        return y.permute(0, 2, 3, 4, 1).contiguous()


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
            group = shards().total
            if group is not None:
                # a process mesh: the global batch's sums; the shards are
                # equal (parallel.mesh.shard_batch), so the global count
                # is n times the group's size
                s1, s2 = all_reduce_sum(torch.stack([s1, s2]),
                                        group).unbind(0)
                n *= group.size
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


# the generators of the dropout masks, innermost last (dropout_generator)
_DROPOUT_GENERATORS: List[torch.Generator] = []


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator):
    """Draw the dropout masks of the forwards inside from ``generator``
    (on the device of the activations)."""
    _DROPOUT_GENERATORS.append(generator)
    try:
        yield generator
    finally:
        _DROPOUT_GENERATORS.pop()


def dropout_mask(shape: Tuple[int, ...], keep_prob: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(``keep_prob``) keep mask of ``shape`` (bool), drawn from
    ``generator`` on its device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < keep_prob


def dropout(x: torch.Tensor, p: float, training: bool,
            col_axis: int = 2) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: in training each element kept with
    probability 1 - p and scaled by 1 / (1 - p), the others 0; the identity
    in eval or at p = 0.  ``col_axis``: the axis the space axis splits."""
    if not training or p <= 0.0:
        return x
    if not _DROPOUT_GENERATORS:
        raise RuntimeError(
            f"dropout {p} in training needs a generator: pass one to the "
            "train step, or run the forward inside "
            "blocks.dropout_generator(...)")
    keep_prob = 1.0 - p
    # on a process mesh the global batch's mask, this rank's rows and
    # columns of it
    shape, index = list(x.shape), [slice(None)] * x.dim()
    layout = shards()
    for axis, group in ((0, layout.rows), (col_axis, layout.cols)):
        if group is not None:
            n = x.shape[axis]
            shape[axis] = n * group.size
            index[axis] = slice(group.rank * n, (group.rank + 1) * n)
    keep = dropout_mask(tuple(shape), keep_prob,
                        _DROPOUT_GENERATORS[-1])[tuple(index)]
    return torch.where(keep.to(x.device), x / keep_prob, torch.zeros(
        (), dtype=x.dtype, device=x.device))


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


def _conv_bn(ci: int, co: int, kernel: Sequence[int],
             bn: bool) -> nn.ModuleList:
    """[conv, BatchNorm], or [conv with a bias] without BatchNorm."""
    if not bn:
        return nn.ModuleList([ConvWeight(ci, co, kernel, bias=True)])
    return nn.ModuleList([ConvWeight(ci, co, kernel), BNFold(co)])


def _affine(layer: nn.ModuleList, dtype: torch.dtype,
            y: Optional[torch.Tensor] = None,
            sums=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, b) in ``dtype`` that follow a ``_conv_bn`` layer's conv: its
    BatchNorm folded (:meth:`BNFold.folded`), or, without BatchNorm,
    scale 1 and the conv's bias (no batch stats in training)."""
    if len(layer) == 2:
        return layer[1].folded(dtype, y, sums)
    bias = layer[0].bias
    return torch.ones(bias.shape, dtype=dtype, device=bias.device), \
        bias.to(dtype)


def _crop(y: torch.Tensor, h: int, axis: int) -> torch.Tensor:
    """``y`` without ``h`` columns at each end of ``axis``, contiguous."""
    if not h:
        return y
    return y.narrow(axis, h, y.shape[axis] - 2 * h).contiguous()


class ConvX(nn.Module):
    """Residual conv block: the convs with BN+ReLU between them, BN after
    the last, identity or 1x1(+BN) residual, final ReLU; without BatchNorm
    (``bn`` False) each conv has a bias in its place.

    Inputs are channels-last 3D, (B, Y, X, Z, C); a 2D block (2-tuple
    kernels) takes the singleton-X view (B, H, 1, W, C).  Convs are SAME
    (k//2 per axis) unless ``padding="valid"``; ``stride_z`` strides every
    conv along z and ``ds_stride_z`` the 1x1 downsample.  ``fused``: the
    block is one the JAX package lowers to its Pallas kernels, and its
    convs run the hand-written kernels where those take them (see the
    module note).  ``dropout``: the rate of the dropout after the final
    ReLU (training).
    """

    def __init__(self, ci: int, co: int, kernels: Sequence[Sequence[int]],
                 stride_z: int = 1, padding: str = "same",
                 residual: bool = True, downsample: bool = False,
                 ds_stride_z: int = 1, fused: bool = False,
                 dropout: float = 0.0, bn: bool = True):
        super().__init__()
        self.convBlock = nn.ModuleList(
            _conv_bn(ci if i == 0 else co, co, k, bn)
            for i, k in enumerate(kernels))
        rank = len(kernels[0])
        self.downsample = (_conv_bn(ci, co, (1,) * rank, bn) if downsample
                           else None)
        self.stride_z = stride_z
        self.padding = padding
        self.residual = residual
        self.ds_stride_z = ds_stride_z
        self.fused = fused
        self.dropout = float(dropout)

    @property
    def _col_axis(self) -> int:
        """The axis the space axis splits: X of a 3D block's (B, Y, X, Z,
        C), W of a 2D block's singleton-X view (B, H, 1, W, C)."""
        return 3 if self.convBlock[0][0].weight.dim() == 4 else 2

    def _conv(self, x, s, b, w, relu, stride_z, kernels, ext):
        """-> (y, sums): in training a fused conv also returns the fp32
        (sum y, sum y*y) of its stats epilogue; otherwise sums is None.
        ``ext``: the true extents of x (module note).  Under the space
        axis the conv reads ``h`` halo columns on each side (module
        note)."""
        ci, co, taps = w.shape[3], w.shape[4], tuple(w.shape[:3])
        dyn = None if ext is None else _full(ext, x)
        cols, axis = space_group(), self._col_axis
        h = 0 if cols is None else w.shape[axis - 1] // 2
        # a space mesh runs the 2D stages per op (blocks.py:823-825)
        if (kernels and self.fused and self.padding == "same"
                and not (cols is not None and axis == 3)):
            # which gradients the backward computes, if it runs
            grad = torch.is_grad_enabled()
            x_grad = grad and any(t is not None and t.requires_grad
                                  for t in (x, s, b))
            backward = x_grad or (grad and w.requires_grad)
            if ci >= 8 and fused_conv_takes(ci, co, taps, stride_z, backward,
                                            x.dtype):
                if h:
                    # the activated columns exchanged, the kernel with an
                    # identity prologue on the slab (fused_conv.py:877-890)
                    t = halo_x(affine_relu(x, s, b, relu), h, cols, axis)
                    return _crop(fused_conv(t, None, None, w, False,
                                            stride_z), h, axis), None
                if self.training:
                    y, s1, s2 = fused_conv(x, s, b, w, relu, stride_z,
                                           with_stats=True)
                    return y, (s1, s2)
                return fused_conv(x, s, b, w, relu, stride_z,
                                  dyn_extents=dyn), None
            if ci < 8 and banded_conv_takes(ci, co, taps, stride_z, x_grad,
                                            x.dtype):
                t = halo_x(affine_relu(x, s, b, relu), h, cols, axis)
                return _crop(banded_conv(t, w, dyn), h, axis), None
        pad = [0, 0, 0] if self.padding == "valid" else [k // 2
                                                        for k in taps]
        pad[axis - 1] -= h
        t = mask_extents(affine_relu(x, s, b, relu), ext)
        return conv3d_cl(halo_x(t, h, cols, axis), w, (1, 1, stride_z),
                         pad), None

    def out_extents(self, ext: Extents) -> Extents:
        """The true extents of the block's output for input extents
        ``ext``."""
        for layer in self.convBlock:
            ext = conv_extents(ext, layer[0].taps,
                               self.stride_z, self.padding == "valid")
        return ext

    def _fusion(self, block_fusion: Optional[str], x: torch.Tensor):
        """(the fusion that applies, narrow entry): the eval fusion of the
        JAX package's ``MMF_FUSED_CHAIN`` / ``MMF_FUSED_PAIR`` applies where
        it applies there (``blocks.py:542-660``): in eval, to a 3D block of a
        fused stage at z stride 1 (not to the 2D stages or the stride-2
        cascades), the chain when at least two convs follow a narrow (ci <
        8) entry, which an identity-residual block never has, and the
        kernel takes them (``ops.fused_block.takes``; else per conv)."""
        if block_fusion not in (None, "pair", "chain"):
            raise ValueError(f"ConvX: unknown block_fusion {block_fusion!r}")
        ci = x.shape[-1]
        if (block_fusion is None or self.training or not self.fused
                or self.stride_z != 1 or self.padding != "same"
                or self.convBlock[0][0].weight.dim() != 5):
            return None, False
        narrow = ci < 8 and not (self.residual and self.downsample is None)
        if block_fusion == "chain":
            convs = [layer[0] for layer in self.convBlock][int(narrow):]
            co = convs[0].weight.shape[0]
            if len(convs) < 2 or not fused_block_takes(
                    co if narrow else ci, co, [c.taps for c in convs], 1,
                    False, x.dtype, self._chain_final(narrow)):
                return None, narrow
        return block_fusion, narrow

    def _chain_final(self, narrow: bool) -> str:
        """The chain's final mode (``ops.fused_block``)."""
        if narrow:
            return "affine"
        if self.downsample is not None:
            return "res_conv"
        return "res_id" if self.residual else "relu"

    def _residual(self, out, x, kernels, ext):
        """``out`` plus the block's residual of input ``x``."""
        if not self.residual:
            return out
        if self.downsample is None:
            return out + x
        dt = x.dtype
        ds, sums = self._conv(x, None, None,
                              self.downsample[0].logical(dt), False,
                              self.ds_stride_z,
                              kernels and self.ds_stride_z == 1, ext)
        sd, bd = _affine(self.downsample, dt, ds, sums)
        return out + ds * sd + bd

    def _chain(self, x, kernels, ext, narrow):
        """The whole block in one kernel (``fused_chain``), or its plain
        version with ``kernels`` False.  A narrow entry conv runs before it
        as in the per-op path, and the chain stops at the last affine."""
        dt = x.dtype
        layers = [(layer[0].logical(dt), *_affine(layer, dt))
                  for layer in self.convBlock]
        dyn = None if ext is None else _full(ext, x)
        xin, s_in, b_in, relu0, ds = x, None, None, False, None
        final = self._chain_final(narrow)
        if narrow:
            xin, _ = self._conv(x, None, None, layers[0][0], False, 1,
                                kernels, ext)
            _, s_in, b_in = layers[0]
            relu0, layers = True, layers[1:]
        elif final == "res_conv":
            ds = (self.downsample[0].logical(dt), *_affine(self.downsample,
                                                           dt))
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
        fusion, narrow = self._fusion(block_fusion, x)
        if fusion == "chain":
            return self._chain(x, kernels, ext, narrow)
        dt = x.dtype
        cur, s, b, e = x, None, None, ext
        n, i = len(self.convBlock), 0
        while i < n:
            layer = self.convBlock[i]
            w = layer[0].logical(dt)
            if (fusion == "pair" and i + 1 < n and w.shape[0] == 1
                    and self.convBlock[i + 1][0].taps[0] == 1
                    and not (i == 0 and narrow)
                    and fused_block_takes(
                        cur.shape[-1], w.shape[4],
                        (w.shape[:3], self.convBlock[i + 1][0].taps), 1,
                        False, dt, "raw")):
                # two convs in one kernel; their extents stay (stride 1)
                nxt = self.convBlock[i + 1]
                s_mid, b_mid = _affine(layer, dt)
                pair_fn = fused_pair if kernels else fused_pair_plain
                cur = pair_fn(cur, s, b, w, s_mid, b_mid,
                              nxt[0].logical(dt), i > 0,
                              None if e is None else _full(e, cur))
                s, b = _affine(nxt, dt)
                i += 2
                continue
            cur, sums = self._conv(cur, s, b, w, i > 0, self.stride_z,
                                   kernels, e)
            e = conv_extents(e, w.shape[:3], self.stride_z,
                             self.padding == "valid")
            s, b = _affine(layer, dt, cur, sums)
            i += 1
        out = self._residual(cur * s + b, x, kernels, ext)
        return dropout(mask_extents(torch.relu(out), e), self.dropout,
                       self.training, self._col_axis)


class EncoderStage(nn.ModuleList):
    """The '2plus3' stage: (1,3,3)x2, then (1,3,3)x2 + (3,1,1), or
    (1,3)x2, (1,3)x2 + (3,1) in 2D; a 1x1+BN projection when the channel
    count changes.  3D input (B, Y, X, Z, C), 2D input (B, H, W, C).
    ``fused``: the JAX package lowers the stage to its Pallas kernels (at
    most 64 channels, BatchNorm and no dropout, ``blocks.fused_stage_bs``);
    ``bn`` False: conv biases in place of BatchNorm."""

    def __init__(self, ci: int, co: int, ndim: int = 3,
                 dropout: float = 0.0, bn: bool = True):
        if ndim == 3:
            k_a, k_b = ((1, 3, 3),) * 2, ((1, 3, 3),) * 2 + ((3, 1, 1),)
        else:
            k_a, k_b = ((1, 3),) * 2, ((1, 3),) * 2 + ((3, 1),)
        fused = co <= FUSED_MAX_CHANNELS and dropout <= 0.0 and bn
        super().__init__([
            ConvX(ci, co, k_a, downsample=ci != co, fused=fused,
                  dropout=dropout, bn=bn),
            ConvX(co, co, k_b, fused=fused, dropout=dropout, bn=bn)])
        self.ndim = ndim
        self.fused = fused

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
    ('fully').  The caller takes the mean over the remaining depth.  The
    cascade is ``fused`` as the JAX package's ``_fused_bs`` has it (at
    most 64 channels and BatchNorm)."""

    def __init__(self, c: int, num_reductions: int, final_kernel: int = 4,
                 bn: bool = True):
        fully = ConvX(c, c, ((1, 1, final_kernel),), padding="valid",
                      residual=False, bn=bn)
        if num_reductions == 0:
            super().__init__([fully])
        else:
            red = ConvX(c, c, ((1, 1, 3),) * num_reductions, stride_z=2,
                        downsample=True, ds_stride_z=2 ** num_reductions,
                        fused=c <= FUSED_MAX_CHANNELS and bn, bn=bn)
            super().__init__([red, fully])

    def forward(self, x: torch.Tensor, kernels: bool = True,
                ext: Extents = None) -> torch.Tensor:
        for block in self:
            x = block(x, kernels, ext)
            ext = block.out_extents(ext)
        return x


def _up(deeper: torch.Tensor, up: Optional[UpConv],
        upfactor: Sequence[int]) -> torch.Tensor:
    """The deeper map upsampled: nearest, or through ``up`` (deconv)."""
    if up is None:
        return upsample_nearest(deeper, upfactor, axes=(1, 2, 3))
    return up(deeper)


class UpBlock2(nn.Module):
    """Decoder block of the single-modality nets: the deeper map upsampled
    (nearest, or with ``deconv`` a transposed conv to ``c_cur`` channels,
    ``up``), concat with one skip, ConvX (3,3,1)x2 with a 1x1
    projection."""

    def __init__(self, c_low: int, c_cur: int, upfactor: Sequence[int],
                 dropout: float = 0.0, bn: bool = True,
                 deconv: bool = False):
        super().__init__()
        self.up = UpConv(c_low, c_cur, upfactor) if deconv else None
        c_up = c_cur if deconv else c_low
        self.conv = ConvX(c_cur + c_up, c_cur, ((3, 3, 1),) * 2,
                          downsample=True, dropout=dropout, bn=bn)
        self.upfactor = tuple(upfactor)

    def forward(self, skip, deeper, kernels: bool = True,
                ext: Extents = None):
        """``ext``: the true extents of the skip, (y, x, None)."""
        up = _up(deeper, self.up, self.upfactor)
        return self.conv(torch.cat([skip, up], dim=-1), kernels, ext)


class UpBlockFusion(nn.Module):
    """Decoder block fusing a 3D skip, a 2D skip and the deeper features:
    the deeper map upsampled as in :class:`UpBlock2`, concatenated with
    both skips (``mode='concat'``) or with their sum (``'add'``), ConvX
    (3,3,1)x2 with a 1x1 projection."""

    def __init__(self, c_low: int, c_cur: int, upfactor: Sequence[int],
                 dropout: float = 0.0, bn: bool = True,
                 deconv: bool = False, mode: str = "concat"):
        super().__init__()
        if mode not in ("concat", "add"):
            raise ValueError(f"Unknown feature fusion mode: {mode}")
        self.up = UpConv(c_low, c_cur, upfactor) if deconv else None
        c_up = c_cur if deconv else c_low
        c_skips = 2 * c_cur if mode == "concat" else c_cur
        self.conv = ConvX(c_skips + c_up, c_cur, ((3, 3, 1),) * 2,
                          downsample=True, dropout=dropout, bn=bn)
        self.upfactor = tuple(upfactor)
        self.mode = mode

    def forward(self, skip3d, skip2d, deeper, kernels: bool = True,
                ext: Extents = None):
        """``ext``: the true extents of the skips, (y, x, None)."""
        up = _up(deeper, self.up, self.upfactor)
        skips = ([skip3d, skip2d] if self.mode == "concat"
                 else [skip3d + skip2d])
        return self.conv(torch.cat(skips + [up], dim=-1), kernels, ext)
