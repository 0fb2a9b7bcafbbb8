"""The model zoo of the port: the 8 ``--model`` architectures of the JAX
package (``multimodal_fusion_fpn_tpu/models/zoo.py:67-310``).

| name                      | backbone                     | head      |
|---------------------------|------------------------------|-----------|
| FPN                       | ModifiedUnet3D               | sigmoid   |
| FPNRegression             | ModifiedUnet3D               | linear    |
| FPNClassification         | ModifiedUnet3D bottleneck    | softmax   |
| FPNHybridFusion           | ModifiedUnet3D2D(levels=5)   | sigmoid   |
| FPNHybridFusionRegression | ModifiedUnet3D2D(levels=5)   | linear    |
| FPN2D                     | ModifiedUnet2D(levels=5)     | sigmoid   |
| FPNLateFusion             | 3D and 2D nets, 1x1x1 fusion | sigmoid   |
| FPNLateFusionRegression   | same                         | linear    |

Each model takes the batch dict in the original project's layout and
returns ``{'prediction': ...}`` in that layout (:mod:`.layouts`), in eval
or train mode (BatchNorm batch stats).  ``kernels`` chooses the
hand-written kernels (True) or their plain PyTorch versions (False);
nothing switches it automatically.  ``block_fusion`` (None, "pair" or
"chain") is the eval block fusion of the JAX package's ``MMF_FUSED_PAIR``
/ ``MMF_FUSED_CHAIN`` (``blocks.ConvX``), which applies to the 3D encoder
stages.

Exact shape bucketing: the reserved batch keys ``__valid_image__`` (the
true (D, H, W) of the zero-padded ``image``) and ``__valid_enface__`` (the
true (H, W) of the en-face map) carry the true extents
(``zoo.py:51-64``).  They are read on the host as integers; the
segmentation models then evaluate over the true extents inside the padded
buffers (eval only).  ``FPNClassification`` ignores them, as the JAX
package's does (ROADMAP Queue 3: its prediction then depends on the
padding).
"""

import os
from typing import Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.arch_config import (ArchSpec,
                                                            load_arch_spec)
from multimodal_fusion_fpn_torch.models.blocks import Conv1x1, ConvWeight
from multimodal_fusion_fpn_torch.models.fusion import (ModifiedUnet3D2D,
                                                       align_2d_skip)
from multimodal_fusion_fpn_torch.models.layouts import (enface_to_device,
                                                        seg_from_device,
                                                        volume_to_device)
from multimodal_fusion_fpn_torch.models.unet2d import ModifiedUnet2D
from multimodal_fusion_fpn_torch.models.unet3d import ModifiedUnet3D
from multimodal_fusion_fpn_torch.ops.dynamic_extent import \
    linear_resize_dynamic
from multimodal_fusion_fpn_torch.ops.fused_conv import conv3d_cl
from multimodal_fusion_fpn_torch.ops.interpolate import linear_resize
from multimodal_fusion_fpn_torch.registry import get_factory_adder

add_class, model_factory = get_factory_adder()


def interpolate_from_crop(crop: str) -> Optional[str]:
    """The feature-alignment mode from the crop flag (original project
    ``fusion_nets.py:100-108,173-178``)."""
    interpolate = "2d" if "relative_2d" in crop else None
    if "max" in crop and interpolate is not None:
        interpolate += "_max"
    return interpolate


def _ints(v):
    """A host sequence of ints from a list, array or tensor."""
    return [int(e) for e in (v.tolist() if hasattr(v, "tolist") else v)]


def bucket_extents(batch):
    """(ext3d, ext2d) from the reserved keys: the volume's true (D, H, W)
    in the device order (y, x, z) = (D, W, H), the en-face map's (H, W);
    None where a key is absent."""
    ext3d = ext2d = None
    if batch.get("__valid_image__") is not None:
        d, h, w = _ints(batch["__valid_image__"])
        ext3d = (d, w, h)
    if batch.get("__valid_enface__") is not None:
        ext2d = tuple(_ints(batch["__valid_enface__"]))
    return ext3d, ext2d


class _ZooModel(nn.Module):
    """What every zoo model keeps: its compute dtype and the batch key of
    its en-face modality; the sigmoid head of the segmentation models,
    which the Regression variants drop."""

    def __init__(self, fusion_modality: Optional[str], dtype: torch.dtype):
        super().__init__()
        self.fusion_modality = fusion_modality
        self.dtype = dtype

    def last_activation(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x)

    def volume(self, batch) -> torch.Tensor:
        return volume_to_device(batch["image"].to(self.dtype))

    def enface(self, batch) -> torch.Tensor:
        return enface_to_device(batch[self.fusion_modality].to(self.dtype))


@add_class
class FPN(_ZooModel):
    """The 3D net alone; it reads ``image`` and ``__valid_image__`` only."""

    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 fusion_modality: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(fusion_modality, dtype)
        self.resensnet = ModifiedUnet3D(spec, n_classes)

    def forward(self, batch, kernels: bool = True,
                block_fusion: Optional[str] = None):
        ext3d, _ = bucket_extents(batch)
        seg = self.resensnet(self.volume(batch), kernels, ext3d,
                             block_fusion)
        return {"prediction": self.last_activation(seg_from_device(seg))}


@add_class
class FPNRegression(FPN):
    def last_activation(self, x):
        return x


@add_class
class FPNClassification(_ZooModel):
    """The 3D encoder's stage-5 output, a bias-free 1x1x1 conv
    (``one_one``), the mean over (Y, X, Z) and a softmax over the classes:
    (B, n_classes).  It ignores the extents (module note)."""

    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 fusion_modality: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(fusion_modality, dtype)
        self.resensnet = ModifiedUnet3D(spec, n_classes, classification=True)
        self.one_one = ConvWeight(spec.channels[4], n_classes, (1, 1, 1))

    def forward(self, batch, kernels: bool = True,
                block_fusion: Optional[str] = None):
        feats = self.resensnet(self.volume(batch), kernels, None,
                               block_fusion)
        pred = conv3d_cl(feats, self.one_one.logical(feats.dtype), (1, 1, 1),
                         (0, 0, 0))
        pred = pred.mean(dim=(1, 2, 3), dtype=torch.float32).to(pred.dtype)
        return {"prediction": torch.softmax(pred, dim=-1)}


@add_class
class FPNHybridFusion(_ZooModel):
    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 fusion_modality: str = "slo",
                 interpolate: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(fusion_modality, dtype)
        self.resensnet = ModifiedUnet3D2D(spec, n_classes, interpolate)

    def forward(self, batch, kernels: bool = True,
                block_fusion: Optional[str] = None):
        oct, enface = self.volume(batch), self.enface(batch)
        ext3d, ext2d = bucket_extents(batch)
        if ext3d is not None or ext2d is not None:
            # a modality the bucketing left unpadded is whole (ROADMAP
            # Queue 3: the JAX package aligns its skips to the padded
            # shape then)
            ext3d = ext3d or tuple(oct.shape[1:4])
            ext2d = ext2d or tuple(enface.shape[1:3])
        seg = self.resensnet(oct, enface, kernels, ext3d, ext2d,
                             block_fusion)
        return {"prediction": self.last_activation(seg_from_device(seg))}


@add_class
class FPNHybridFusionRegression(FPNHybridFusion):
    def last_activation(self, x):
        return x


@add_class
class FPN2D(_ZooModel):
    """The en-face net alone, its sigmoid prediction resized to the mask's
    shape when the batch has a mask of another shape; under bucketing from
    the true (H, W) inside the padded map, so the prediction comes out at
    the mask's (unpadded) shape (``zoo.py:157-196``)."""

    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 fusion_modality: str = "slo",
                 dtype: torch.dtype = torch.float32):
        super().__init__(fusion_modality, dtype)
        self.resensnet = ModifiedUnet2D(spec, n_classes)

    def forward(self, batch, kernels: bool = True,
                block_fusion: Optional[str] = None):
        _, ext2d = bucket_extents(batch)
        seg = torch.sigmoid(seg_from_device(
            self.resensnet(self.enface(batch), kernels, ext2d)))
        mask = batch.get("mask")
        if mask is not None and ext2d is not None:
            tgt = tuple(mask.shape[2:])
            seg = linear_resize_dynamic(seg, (ext2d[0], None, ext2d[1]), tgt,
                                        axes=(2, 3, 4), out_pads=tgt)
        elif mask is not None and seg.shape != mask.shape:
            seg = linear_resize(seg, mask.shape[2:], axes=(2, 3, 4))
        return {"prediction": seg}


@add_class
class FPNLateFusion(_ZooModel):
    """The 3D net without ``final1`` (``resensnet3d``) beside the en-face
    net's features (``resensnet2d``), the latter aligned to the former's
    (Y, X) by ``interpolate`` (over the true extents under bucketing, a
    modality left unpadded taking its static shape), concatenated, and a
    1x1x1 conv with bias (``fusion_module``, input width 2 * channels[0]).
    ``output_features`` also returns the concatenated features, detached,
    as ``out_features`` (B, 2 * channels[0], Y, 1, X)."""

    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 fusion_modality: str = "slo",
                 interpolate: Optional[str] = None,
                 output_features: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(fusion_modality, dtype)
        self.interpolate = interpolate
        self.output_features = output_features
        self.resensnet3d = ModifiedUnet3D(spec, n_classes, use_1x1=False)
        self.resensnet2d = ModifiedUnet2D(spec, n_classes,
                                          output_features=True)
        self.fusion_module = Conv1x1(2 * spec.channels[0], n_classes)

    def forward(self, batch, kernels: bool = True,
                block_fusion: Optional[str] = None):
        ext3d, ext2d = bucket_extents(batch)
        f3 = self.resensnet3d(self.volume(batch), kernels, ext3d,
                              block_fusion)
        f2 = self.resensnet2d(self.enface(batch), kernels, ext2d)[:, :, :, 0]
        if ext3d is not None or ext2d is not None:
            ext3d = ext3d or tuple(f3.shape[1:4])
            ext2d = ext2d or tuple(f2.shape[1:3])
        cat = torch.cat([f3, align_2d_skip(f2, f3.shape[1:4],
                                           self.interpolate, ext2d, ext3d)],
                        dim=-1)
        seg = seg_from_device(self.fusion_module(cat))
        out = {"prediction": self.last_activation(seg)}
        if self.output_features:
            out["out_features"] = seg_from_device(cat.detach())
        return out


@add_class
class FPNLateFusionRegression(FPNLateFusion):
    def last_activation(self, x):
        return x


def build_model(config, spec: Optional[ArchSpec] = None,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> nn.Module:
    """A zoo model in eval mode on ``device`` from a parsed config with
    ``model``, ``crop``, ``fusion_modality``, ``number_of_outputs`` and
    optionally ``arch_config`` and ``output_features`` (the CLI flags of
    ``train.py``), with the JAX package's keyword rules (``zoo.py:
    287-310``): ``interpolate`` for the hybrid and late-fusion families
    only, ``output_features`` for the late-fusion family when the config
    asks for it."""
    if config.model not in model_factory:
        raise NotImplementedError(f"model {config.model!r} is not ported; "
                                  f"ported: {sorted(model_factory)}")
    if spec is None:
        arch_ini = getattr(config, "arch_config", None)
        if arch_ini:
            spec = load_arch_spec(
                os.path.splitext(os.path.basename(arch_ini))[0],
                search_dir=os.path.dirname(os.path.abspath(arch_ini)))
        else:
            spec = load_arch_spec()
    kwargs = dict(spec=spec, n_classes=config.number_of_outputs, dtype=dtype)
    if config.fusion_modality is not None:
        kwargs["fusion_modality"] = config.fusion_modality
    if config.model in ("FPNHybridFusion", "FPNHybridFusionRegression",
                        "FPNLateFusion", "FPNLateFusionRegression"):
        kwargs["interpolate"] = interpolate_from_crop(config.crop)
    if (config.model in ("FPNLateFusion", "FPNLateFusionRegression")
            and getattr(config, "output_features", False)):
        kwargs["output_features"] = True
    return model_factory[config.model](**kwargs).to(device).eval()
