"""The train step on the process mesh: the twin of
``multimodal_fusion_fpn_tpu/parallel/step.py``, with the signature and the
return of ``train.step.make_train_step``.  Each rank runs the step on its
rows and its X columns of the global batch (``mesh.shard_batch``); the two
BatchNorm semantics are the JAX package's:

  * ``bn_sync=True``: the single-device step on the global batch
    (``step.py:42-48``).  Inside ``comm.sharded`` the BatchNorm sums, the
    Dice sums and the BCE mean are all-reduced differentiably over the
    world, so every rank computes the global loss.  Dropout draws the
    global batch's mask and each rank keeps its rows and columns.  The
    metrics are the global ones: the per-sample Dice summed over the space
    group and all-gathered over data in rank order, and the global BCE,
    per micro-batch.
  * ``bn_sync=False``: Lightning ``strategy='dp'`` with per-replica
    BatchNorm (``per_shard``, ``step.py:68-117``): each data replica
    normalises with its own batch statistics, summed over its space group
    (the replica's whole width), and computes its own loss; the gradients,
    the loss and its parts are averaged over the replicas (``:89-93``),
    and after the step the running mean and var are too (``:96``; not
    DDP's broadcast of rank 0's buffers).  The Dice values are
    all-gathered tiled and the BCE averaged (``:101-103``).  Every replica
    draws the same local dropout mask from the same generator, as the JAX
    shards share their key (``:111-116``).  With a space axis this is what
    the JAX step computes wherever it runs: its ``shard_map`` splits the
    batch over ``data`` only, so each data shard runs on its whole width
    (FPN2D's per-op 2D stages on a declared ``data=N,space=M`` mesh; the
    JAX package's fused lowering of the 3D stages raises there, nesting
    one ``shard_map`` in another, ROADMAP Queue 3).

Under the space axis each rank's gradient is its columns' share of its
loss's gradient times the size of the group its loss is reduced over
(``comm``), so the mean all-reduce of the gradients over the world is, in
both modes, the global gradient (synced) or the mean of the replicas'
gradients (per replica).

Accumulation runs the micro-batch loop inside each rank; a stacked batch
is sharded on its axis 1 and its last axis.  The gradients are reduced
once per step, after the last backward, so every rank takes the same
optimizer step from the same gradients and the parameters stay
bit-identical on the ranks.

Before the first forward the step checks that every level of the pyramid
splits evenly over the space axis (``mesh.check_widths``).
"""

import contextlib
from typing import Callable, Optional

import torch
from torch import nn

from multimodal_fusion_fpn_torch.models.blocks import dropout_generator
from multimodal_fusion_fpn_torch.models.unet3d import POOLS_3D
from multimodal_fusion_fpn_torch.parallel.comm import (Shards, all_gather,
                                                       all_reduce_mean_,
                                                       sharded)
from multimodal_fusion_fpn_torch.parallel.mesh import Mesh, check_widths
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
    rows = mesh.data if bn_sync else None
    cols = mesh.space if mesh.space.size > 1 else None
    layout = Shards(rows=rows, cols=cols,
                    total=mesh.world if rows and cols else rows or cols)
    # the X windows of the pyramid's pools (the 2D nets' W windows agree)
    windows = [w[1] for w in POOLS_3D]

    def metrics_from(out, b):
        m = train_metrics(out, b, compute_train_metrics)
        if bn_sync and m:
            m["Dice"] = all_gather(m["Dice"], group)
            all_reduce_mean_([m["BCE"]], group)
        return m

    def step(state: TrainState, batch, kernels: bool = True,
             generator: Optional[torch.Generator] = None):
        check_state(state, model, optimizer)
        check_widths(batch, mesh, windows, ("image", "slo", "faf"))
        model.train()
        optimizer.zero_grad(set_to_none=True)
        b = model_batch(batch, device)
        with contextlib.ExitStack() as ctx:
            if generator is not None:
                ctx.enter_context(dropout_generator(generator))
            if rows or cols:
                ctx.enter_context(sharded(layout))
            loss, parts, metrics = run_micro_batches(
                model, criterion, b, kernels, accum_steps, metrics_from)
        all_reduce_mean_([p.grad for p in model.parameters()
                          if p.grad is not None], mesh.world)
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
