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

The trainer's files share the layout: the top-5 ``epoch={e}-{monitor}=
{value:.4f}.ckpt`` of :class:`TopKCheckpointer` (``checkpoints.py:52-111``),
and ``last.ckpt`` and ``resume.ckpt``, which also hold ``optimizer`` (the
optimizer's ``state_dict()``), ``step`` and, in ``resume.ckpt``,
``next_epoch``, ``best`` (NaN for none) and ``patience_left`` (-1 for
none), the keys that the JAX trainer writes (``trainer.py:281-296``,
``train.py:143-150``).  :func:`load_checkpoint` reads the weights of any
of them; :func:`load_training_state` the rest.
"""

import glob
import os
from os.path import join
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
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


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    **extra: Any) -> None:
    """Write ``state_dict`` in the Lightning layout that
    :func:`load_checkpoint` reads, with the ``extra`` top-level entries
    (``optimizer``, ``step``, ...), through a temporary file, so a reader
    never sees half of one."""
    tmp = path + ".tmp"
    torch.save({"state_dict": {f"model.{k}": v.detach().cpu()
                               for k, v in state_dict.items()}, **extra},
               tmp)
    os.replace(tmp, path)


def load_training_state(path: str) -> Dict[str, Any]:
    """The entries of a ``last.ckpt`` or ``resume.ckpt`` besides the
    weights: ``optimizer`` (for ``optimizer.load_state_dict``), ``step``
    and, in ``resume.ckpt``, ``next_epoch``, ``best`` and
    ``patience_left``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in ckpt.items() if k != "state_dict"}


class TopKCheckpointer:
    """Keep the ``save_top_k`` best checkpoints by the monitored value
    (``mode`` "max" or "min"), named ``epoch={e}-{monitor}={value:.4f}.ckpt``
    in ``dirpath``."""

    def __init__(self, dirpath: str, monitor: str = "Dice",
                 mode: str = "max", save_top_k: int = 5):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.saved: List[Tuple[float, str]] = []
        os.makedirs(dirpath, exist_ok=True)

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def restore(self) -> int:
        """Rebuild the ledger from the checkpoints on disk (their names
        carry the values), pruning to the best ``save_top_k``: a crash
        between a save and its prune leaves one file too many."""
        self.saved = []
        pat = join(self.dirpath, f"epoch=*-{self.monitor}=*.ckpt")
        for path in sorted(glob.glob(pat)):
            stem = os.path.basename(path)[:-len(".ckpt")]
            try:
                value = float(stem.split(f"{self.monitor}=")[1])
            except (IndexError, ValueError):
                continue
            self.saved.append((value, path))
        if len(self.saved) > self.save_top_k:
            self.saved.sort(key=lambda t: t[0],
                            reverse=(self.mode == "max"))
            for _, path in self.saved[self.save_top_k:]:
                if os.path.exists(path):
                    os.remove(path)
            self.saved = self.saved[:self.save_top_k]
        return len(self.saved)

    def update(self, epoch: int, value: float,
               state_dict: Mapping[str, torch.Tensor]) -> Optional[str]:
        """Save this epoch's weights when they rank among the best
        ``save_top_k`` (a NaN value never does), removing the worst kept
        one beyond that; the path written, or None."""
        if np.isnan(value):
            return None
        path = join(self.dirpath,
                    f"epoch={epoch}-{self.monitor}={value:.4f}.ckpt")
        if len(self.saved) < self.save_top_k:
            save_checkpoint(path, state_dict)
            self.saved.append((value, path))
            return path
        worst = min(range(len(self.saved)),
                    key=lambda i: self.saved[i][0] if self.mode == "max"
                    else -self.saved[i][0])
        worst_value, worst_path = self.saved[worst]
        if not self._better(value, worst_value):
            return None
        save_checkpoint(path, state_dict)
        if os.path.exists(worst_path):
            os.remove(worst_path)
        self.saved[worst] = (value, path)
        return path


def find_topk_checkpoints(model_dir: str) -> List[str]:
    return sorted(glob.glob(join(model_dir, "epoch=*.ckpt")))
