"""Weights of the port: conversion from the JAX package's trees, and a
seeded init.

``state_dict_from_jax`` is the inverse of
``multimodal_fusion_fpn_tpu/train/torch_import.py:map_state_dict``, with
its own copy of the name table: flax ``conv{i}`` / ``bn{i}`` /
``ds_conv`` / ``ds_bn`` inside a block become ``convBlock.<i>.0`` /
``convBlock.<i>.1`` / ``downsample.0`` / ``downsample.1``; encoder stage
``block<j>`` becomes ``<j>``; projection ``red`` / ``fully`` become
``0`` / ``1`` (``fully`` is ``0`` at level 5, which has no cascade); a
decoder block's ``conv`` and ``up`` (its transposed conv with
``is_deconv``) keep their names.  Kernels go from (k..., I, O) to
(O, I, k...), and a conv's ``bias`` (a block without BatchNorm) keeps its
name; the transposed conv's kernel goes from flax's (k..., I, O) to
``torch.nn.ConvTranspose3d``'s (I, O, k...) flipped in every tap axis
(flax does not flip it, torch's transposed conv does).  BN ``scale`` /
``bias`` / ``mean`` / ``var`` become ``weight`` / ``bias`` /
``running_mean`` / ``running_var``, and ``num_batches_tracked`` is 0.  The
JAX package's own import (``train/torch_import.py``) has no entry for
``up`` (ROADMAP, "Reference faults").  The root of a path
(``resensnet``, ``resensnet3d``, ``resensnet2d``) is kept as it is; a conv
at the model's top level (``one_one``, ``fusion_module``) keeps its name.
"""

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_CONVX_SUB = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convx_sub(name: str) -> str:
    if name in _CONVX_SUB:
        return _CONVX_SUB[name]
    for kind, idx in (("conv", "0"), ("bn", "1")):
        if name.startswith(kind) and name[len(kind):].isdigit():
            return f"convBlock.{name[len(kind):]}.{idx}"
    raise KeyError(name)


def _module_key(path) -> str:
    """Flax module path (without the leaf) -> torch module prefix."""
    if len(path) == 1:
        return path[0]
    root, mod, rest = path[0], path[1], path[2:]
    if mod == "final1" and not rest:
        return f"{root}.final1"
    if mod.startswith("zdimRed"):
        level = int(mod[len("zdimRed"):])
        seq = "0" if (rest[0] == "red" or level == 5) else "1"
        return f"{root}.{mod}.{seq}.{_convx_sub(rest[1])}"
    if mod.startswith("up_concat"):
        if rest[0] == "up":
            return f"{root}.{mod}.up"
        return f"{root}.{mod}.conv.{_convx_sub(rest[1])}"
    if mod.startswith("conv"):
        return f"{root}.{mod}.{rest[0][len('block'):]}.{_convx_sub(rest[1])}"
    raise KeyError("/".join(path))


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """JAX (params, batch_stats) trees of numpy arrays -> the port's state
    dict (fp32 tensors, reference names)."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        key, leaf = _module_key(path[:-1]), path[-1]
        a = np.asarray(v, np.float32)
        if leaf == "kernel" and path[-2] == "up":
            # (k..., I, O) -> (I, O, k...), each tap axis flipped
            taps = tuple(range(a.ndim - 2))
            out[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(
                np.flip(a, taps).transpose((a.ndim - 2, a.ndim - 1) + taps)))
        elif leaf == "kernel":  # (k..., I, O) -> (O, I, k...)
            perm = (a.ndim - 1, a.ndim - 2) + tuple(range(a.ndim - 2))
            out[key + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(a.transpose(perm)))
        elif path[-2].startswith("bn") or path[-2] == "ds_bn":
            out[f"{key}.{_BN_LEAF[leaf]}"] = torch.from_numpy(a.copy())
            out[f"{key}.num_batches_tracked"] = torch.tensor(0)
        else:  # a conv bias
            out[f"{key}.{leaf}"] = torch.from_numpy(a.copy())
    for path, v in _flatten(batch_stats):
        key = _module_key(path[:-1])
        out[f"{key}.{_BN_LEAF[path[-1]]}"] = torch.from_numpy(
            np.asarray(v, np.float32).copy())
    return out


def init_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Re-initialise ``model`` from ``seed`` (the JAX package's init rules,
    drawn from a CPU ``torch.Generator``, so the same seed gives the same
    weights on any device) and return a copy of its state dict."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
