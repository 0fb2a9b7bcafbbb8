"""Model zoo of the port: ``FPNHybridFusion`` for now
(``multimodal_fusion_fpn_tpu/models/zoo.py:40-46,122-148,287``).

The model takes the batch dict in the original project's layout and
returns ``{'prediction': sigmoid(logits)}`` in that layout
(:mod:`.layouts`), in eval or train mode (BatchNorm batch stats).
``kernels`` chooses the hand-written kernels (True) or their plain PyTorch
versions (False); nothing switches it automatically.
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

    def forward(self, batch, kernels: bool = True):
        oct = volume_to_device(batch["image"].to(self.dtype))
        enface = enface_to_device(batch[self.fusion_modality].to(self.dtype))
        seg = seg_from_device(self.resensnet(oct, enface, kernels))
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
