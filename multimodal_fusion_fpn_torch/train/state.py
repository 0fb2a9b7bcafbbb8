"""Training state (``multimodal_fusion_fpn_tpu/train/state.py``).  The JAX
package threads immutable (params, batch_stats, opt_state) trees through
the step; here the model holds the parameters and BatchNorm buffers and
the optimizer its momentum, both updated in place."""

import dataclasses
from typing import Mapping, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> TrainState:
    """A fresh state at step 0; ``state_dict`` (e.g. converted from the
    JAX package's trees) replaces the model's weights first."""
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return TrainState(step=0, model=model, optimizer=optimizer)
