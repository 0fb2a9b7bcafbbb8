"""The optimizer (``multimodal_fusion_fpn_tpu/train/optim.py``): SGD with
coupled weight decay and classical momentum, ``buf = m*buf + (g + wd*p);
p -= lr*buf``.  That is ``torch.optim.SGD`` itself, the optimizer of the
original project, and the rule of the JAX package's optax chain."""

from typing import Iterable

import torch


def sgd(params: Iterable[torch.nn.Parameter], learning_rate: float,
        momentum: float = 0.9,
        weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           weight_decay=weight_decay)
