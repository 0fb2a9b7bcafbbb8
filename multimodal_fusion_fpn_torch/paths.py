"""Deterministic run-directory naming: the port's copy of
``multimodal_fusion_fpn_tpu/paths.py``.

Byte-identical to the original project's naming scheme
(its ``utils.py:107-154``) — training and evaluation derive
the experiment directory from the flag set, so reruns are idempotent and
eval finds training's checkpoints with no extra bookkeeping — but
expressed as rule tables:

    <models_path>/<dataset[_mask]>/<split>/<ratio[_mul]>[/<cv-idx>]/<name>

where <name> = MODEL[_epochs][_lr]_crop[-fusionmod][__weights][-suffix].
"""

import os
from pathlib import Path
from typing import Callable, List, Tuple


def _weights_tag(config) -> str:
    stem = Path(config.model_weights).stem
    if stem == "last":
        # Disambiguate warm-starts from a terminal last.ckpt by its
        # run-directory name.
        stem = Path(config.model_weights).parent.stem + ".ckpt"
    return stem


# Leaf-name rules: (applies?, rendered fragment), concatenated onto the
# model name in order.  Defaults (40 epochs, lr 0.01) are omitted from
# the name; ``legacy_path`` reproduces historical names (no lr tag,
# suffix glued without the dash).
_NAME_RULES: List[Tuple[Callable, Callable]] = [
    (lambda c: c.epochs != 40,
     lambda c: f"_{c.epochs}"),
    (lambda c: not c.legacy_path and c.learning_rate != 0.01,
     lambda c: f"_{c.learning_rate}"),
    (lambda c: c.crop is not None,
     lambda c: f"_{c.crop}"),
    (lambda c: c.fusion_modality is not None and c.use_complementary,
     lambda c: f"-{c.fusion_modality}"),
    (lambda c: c.model_weights is not None,
     lambda c: f"__{_weights_tag(c)}"),
    (lambda c: bool(c.suffix),
     lambda c: c.suffix if c.legacy_path else f"-{c.suffix}"),
]


def run_name(config) -> str:
    """The leaf directory name encoding model + hyperparameters."""
    fragments = [render(config)
                 for applies, render in _NAME_RULES if applies(config)]
    return config.model + "".join(fragments)


def _dataset_dir(config) -> str:
    name = config.training_dataset
    if name == "vrc" and config.mask_variant != "vs_proj":
        name += f"_{config.mask_variant}"
    return name


def _ratio_dir(config) -> str:
    if config.multiplier != 20:
        return f"{config.data_ratio}_mul-{config.multiplier}"
    return str(config.data_ratio)


def run_segments(config, split_name: str, idx=None) -> List[str]:
    segments = [_dataset_dir(config), split_name, _ratio_dir(config)]
    if idx is not None:
        segments.append(str(idx))
    segments.append(run_name(config))
    return segments


def get_model_path(config, split_path, idx=None, return_split_name=False):
    split_name = Path(split_path).stem
    model_path = os.path.join(config.models_path,
                              *run_segments(config, split_name, idx))
    if return_split_name:
        return model_path, split_name
    return model_path
