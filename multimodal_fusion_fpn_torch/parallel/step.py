"""The data-parallel train step: the twin of
``multimodal_fusion_fpn_tpu/parallel/step.py``, with the signature and the
return of ``train.step.make_train_step``.  Each rank runs the step on its
rows of the global batch (``mesh.shard_batch``); the two BatchNorm
semantics are the JAX package's:

  * ``bn_sync=True``: the single-device step on the global batch
    (``step.py:42-48``).  Inside ``comm.synced`` the BatchNorm sums, the
    Dice sums and the BCE mean are all-reduced differentiably, so every
    rank computes the global loss; each rank's gradient is then the group's
    size times its share, and the mean all-reduce of the gradients is the
    global gradient.  Dropout draws the global batch's mask and each rank
    keeps its rows.  The metrics are the global ones: the per-sample Dice
    all-gathered in rank order and the global BCE, per micro-batch.
  * ``bn_sync=False``: Lightning ``strategy='dp'`` with per-replica
    BatchNorm (``per_shard``, ``step.py:68-117``): each rank normalises with
    its own batch statistics and computes its own loss; the gradients,
    the loss and its parts are averaged over the ranks (``:89-93``), and
    after the step the running mean and var are too (``:96``; not DDP's
    broadcast of rank 0's buffers).  The Dice values are all-gathered
    tiled and the BCE averaged (``:101-103``).  Every rank draws the same
    local dropout mask from the same generator, as the JAX shards share
    their key (``:111-116``).

Accumulation runs the micro-batch loop inside each rank; a stacked batch
is sharded on its axis 1.  The gradients are reduced once per step, after
the last backward, so every rank takes the same optimizer step from the
same gradients and the parameters stay bit-identical on the ranks.
"""

import contextlib
from typing import Callable, Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.blocks import dropout_generator
from multimodal_fusion_fpn_torch.parallel.comm import (all_gather,
                                                       all_reduce_mean_,
                                                       synced)
from multimodal_fusion_fpn_torch.parallel.mesh import Mesh
from multimodal_fusion_fpn_torch.train.state import TrainState
from multimodal_fusion_fpn_torch.train.step import (check_state,
                                                    model_batch,
                                                    run_micro_batches,
                                                    train_metrics)


def make_dp_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                       criterion: Callable, mesh: Mesh, bn_sync: bool = True,
                       compute_train_metrics: bool = True,
                       accum_steps: int = 1, device="cuda") -> Callable:
    """``step(state, batch, kernels=True, generator=None) -> aux`` as
    ``make_train_step``'s, over this rank's shard ``batch``; the aux holds
    the global loss, parts and metrics on every rank (module note)."""
    group = mesh.data

    def metrics_from(out, b):
        m = train_metrics(out, b, compute_train_metrics)
        if bn_sync and m:
            m["Dice"] = all_gather(m["Dice"], group)
            all_reduce_mean_([m["BCE"]], group)
        return m

    def step(state: TrainState, batch, kernels: bool = True,
             generator: Optional[torch.Generator] = None):
        check_state(state, model, optimizer)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        b = model_batch(batch, device)
        with contextlib.ExitStack() as ctx:
            if generator is not None:
                ctx.enter_context(dropout_generator(generator))
            if bn_sync:
                ctx.enter_context(synced(group))
            loss, parts, metrics = run_micro_batches(
                model, criterion, b, kernels, accum_steps, metrics_from)
        all_reduce_mean_([p.grad for p in model.parameters()
                          if p.grad is not None], group)
        if not bn_sync:
            scalars = [loss, *parts.values()]
            if metrics:
                scalars.append(metrics["BCE"])
                metrics["Dice"] = all_gather(metrics["Dice"], group)
            all_reduce_mean_(scalars, group)
        optimizer.step()
        if not bn_sync:
            with torch.no_grad():
                all_reduce_mean_([buf for buf in model.buffers()
                                  if buf.is_floating_point()], group)
        state.step += 1
        return {"loss": loss, "parts": parts, "metrics": metrics}

    return step
