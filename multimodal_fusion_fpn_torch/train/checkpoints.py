"""Checkpoints of the port: ``torch.save`` files in the original project's
Lightning layout, ``{"state_dict": {"model.<name>": tensor}}``, which
``validate_ensemble.py`` globs as ``epoch=*.ckpt``
(``multimodal_fusion_fpn_tpu/train/checkpoints.py:40-50,114-133``).

:func:`load_checkpoint` reads that layout as the JAX package's
``import_torch_checkpoint`` does: the ``state_dict`` entry or the file
itself, with or without the ``model.`` prefix, the legacy root
``resensenet`` renamed ``resensnet``.  Given the model's own state dict it
loads strictly: the same keys and shapes, except that the orphan
``resensnet3d.final1.*`` that late-fusion checkpoints carry (the original
project builds the 3D branch with ``final1`` and then turns it off) is
dropped when the model has no such key.  The JAX package's own flax
msgpack checkpoints are not read here.
"""

import glob
import os
from os.path import join
from typing import Dict, List, Mapping, Optional

import torch

# reference parameters that no forward uses (torch_import.py:119-123)
_KNOWN_UNUSED_PREFIXES = ("resensnet3d.final1.",)


def _strip(key: str) -> str:
    key = key[len("model."):] if key.startswith("model.") else key
    return key.replace("resensenet", "resensnet")


def load_checkpoint(path: str,
                    template: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The state dict of the ``.ckpt`` at ``path`` (on the CPU), held
    strictly against ``template`` (e.g. ``model.state_dict()``) when one is
    given: a missing or extra key or another shape raises ``ValueError``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    state = {_strip(k): v for k, v in state.items()}
    if template is None:
        return state
    state = {k: v for k, v in state.items()
             if k in template or not k.startswith(_KNOWN_UNUSED_PREFIXES)}
    missing = sorted(set(template) - set(state))
    extra = sorted(set(state) - set(template))
    if missing or extra:
        raise ValueError(f"{path}: missing={missing[:5]} extra={extra[:5]}")
    for k, v in template.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"{path}: shape mismatch at {k}: "
                             f"{tuple(v.shape)} vs {tuple(state[k].shape)}")
    return state


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor]
                    ) -> None:
    """Write ``state_dict`` in the Lightning layout that
    :func:`load_checkpoint` reads (through a temporary file, so a reader
    never sees half of one)."""
    tmp = path + ".tmp"
    torch.save({"state_dict": {f"model.{k}": v.detach().cpu()
                               for k, v in state_dict.items()}}, tmp)
    os.replace(tmp, path)


def find_topk_checkpoints(model_dir: str) -> List[str]:
    return sorted(glob.glob(join(model_dir, "epoch=*.ckpt")))
