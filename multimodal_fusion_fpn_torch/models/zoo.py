"""Model zoo of the port: ``FPNHybridFusion`` for now
(``multimodal_fusion_fpn_tpu/models/zoo.py:40-46,122-148,287``).

The model takes the batch dict in the original project's layout and
returns ``{'prediction': sigmoid(logits)}`` in that layout
(:mod:`.layouts`), in eval or train mode (BatchNorm batch stats).
``kernels`` chooses the hand-written kernels (True) or their plain PyTorch
versions (False); nothing switches it automatically.  ``block_fusion``
(None, "pair" or "chain") is the eval block fusion of the JAX package's
``MMF_FUSED_PAIR`` / ``MMF_FUSED_CHAIN`` (``blocks.ConvX``).

Exact shape bucketing: the reserved batch keys ``__valid_image__`` (the
true (D, H, W) of the zero-padded ``image``) and ``__valid_enface__`` (the
true (H, W) of the en-face map) carry the true extents
(``zoo.py:51-64``).  They are read on the host as integers; the model then
evaluates over the true extents inside the padded buffers (eval only).
"""

import os
from typing import Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.arch_config import (ArchSpec,
                                                            load_arch_spec)
from multimodal_fusion_fpn_torch.models.fusion import ModifiedUnet3D2D
from multimodal_fusion_fpn_torch.models.layouts import (enface_to_device,
                                                        seg_from_device,
                                                        volume_to_device)
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


@add_class
class FPNHybridFusion(nn.Module):
    def __init__(self, spec: ArchSpec, n_classes: int = 1,
                 fusion_modality: str = "slo",
                 interpolate: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fusion_modality = fusion_modality
        self.dtype = dtype
        self.resensnet = ModifiedUnet3D2D(spec, n_classes, interpolate)

    def forward(self, batch, kernels: bool = True,
                block_fusion: Optional[str] = None):
        oct = volume_to_device(batch["image"].to(self.dtype))
        enface = enface_to_device(batch[self.fusion_modality].to(self.dtype))
        ext3d, ext2d = bucket_extents(batch)
        if ext3d is not None or ext2d is not None:
            # a modality the bucketing left unpadded is whole (ROADMAP
            # Queue 3: the JAX package aligns its skips to the padded
            # shape then)
            ext3d = ext3d or tuple(oct.shape[1:4])
            ext2d = ext2d or tuple(enface.shape[1:3])
        seg = seg_from_device(self.resensnet(oct, enface, kernels, ext3d,
                                             ext2d, block_fusion))
        return {"prediction": torch.sigmoid(seg)}


def build_model(config, spec: Optional[ArchSpec] = None,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> nn.Module:
    """A zoo model in eval mode on ``device`` from a parsed config with
    ``model``, ``crop``, ``fusion_modality``, ``number_of_outputs`` and
    optionally ``arch_config`` (the CLI flags of ``train.py``)."""
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
    kwargs = dict(spec=spec, n_classes=config.number_of_outputs,
                  interpolate=interpolate_from_crop(config.crop), dtype=dtype)
    if config.fusion_modality is not None:
        kwargs["fusion_modality"] = config.fusion_modality
    return model_factory[config.model](**kwargs).to(device).eval()
