"""The ranks' side of ``tests/test_torch_parallel.py``: one function that
each of two spawned processes runs (``torch_dp_launch.spawn``, gloo over a
``FileStore``, one torch thread), importing torch and the port only.

Rank r reads the parent's inputs from ``inputs.pt`` in ``out`` and writes
what the tests compare to ``rank{r}.pt`` there:

  * "per_replica" / "synced": one ``make_dp_train_step`` of FPN2D at
    ``tiny_spec`` in float64 from the parent's weights on its rows of the
    B=2 batch (data=2): the aux, the state dict after the step;
  * "hybrid": FPNHybridFusion at ``tiny_spec`` in float64, a synced step
    at data=2, and (rank 0 alone, no collective) ``make_train_step`` on the
    global batch from the same weights;
  * "dropout": FPN2D with dropout in every slot, a synced step at data=2
    and the single-process step on the global batch from the same
    generator seed (rank 0); a per-replica step and (rank 0) the mean of
    the single-process gradients of each shard from that seed;
  * "accum": per-replica ``accum_steps=2`` at data=1 (each rank its own
    one-rank group) and ``make_train_step(accum_steps=2)`` on the same
    stacked batch; then at data=2;
  * "entry": ``train.run`` with ``--mesh data=2`` on the CPU, rank 0 in
    the parent's run directory and rank 1 in an empty one.
"""

import contextlib
import copy
import io
import os

import numpy as np
import torch
import torch.distributed as dist

from multimodal_fusion_fpn_torch import losses, train
from multimodal_fusion_fpn_torch.config import make_config
from multimodal_fusion_fpn_torch.models.arch_config import ArchSpec
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.parallel.mesh import make_mesh, shard_batch
from multimodal_fusion_fpn_torch.parallel.step import make_dp_train_step
from multimodal_fusion_fpn_torch.train.optim import sgd
from multimodal_fusion_fpn_torch.train.state import create_train_state
from multimodal_fusion_fpn_torch.train.step import make_train_step


def criterion():
    return losses.Mix({"Dice Loss": losses.dice_loss_joint(),
                       "BCE loss": losses.bce_loss()})


def cfg(name):
    return make_config(model=name, crop="relative_2d_max",
                       fusion_modality="slo")


def fresh(name, spec, sd):
    """A float64 model of ``name`` from ``sd``, its SGD(0.1) and state."""
    model = build_model(cfg(name), spec=spec, device="cpu",
                        dtype=torch.float64).double()
    opt = sgd(model.parameters(), 0.1)
    return model, opt, create_train_state(model, opt, sd)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _result(model, aux, grads=False):
    out = {"aux": aux, "sd": copy.deepcopy(model.state_dict())}
    if grads:
        out["grads"] = {k: p.grad.clone()
                        for k, p in model.named_parameters()}
    return out


def dp_step(name, spec, sd, batch, mesh, bn_sync, accum_steps=1,
            seed=None, stacked=False):
    model, opt, state = fresh(name, spec, sd)
    step = make_dp_train_step(model, opt, criterion(), mesh,
                              bn_sync=bn_sync, accum_steps=accum_steps,
                              device="cpu")
    aux = step(state, shard_batch(batch, mesh, stacked=stacked),
               generator=None if seed is None else _gen(seed))
    return _result(model, aux, grads=True)


def single_step(name, spec, sd, batch, accum_steps=1, seed=None):
    model, opt, state = fresh(name, spec, sd)
    step = make_train_step(model, opt, criterion(), accum_steps=accum_steps,
                           device="cpu")
    aux = step(state, batch, generator=None if seed is None else _gen(seed))
    return _result(model, aux, grads=True)


def shard_grads(name, spec, sd, batch, seed):
    """The mean over the two shards of the single-process gradients of each
    shard, every shard's dropout drawn from ``seed``."""
    grads = []
    for r in range(2):
        rows = {k: v[r:r + 1] for k, v in batch.items()}
        grads.append(single_step(name, spec, sd, rows, seed=seed)["grads"])
    return {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}


def ranks(rank, out):
    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    spec = ArchSpec(inp["channels"])
    dspec = ArchSpec(inp["channels"], dropout=(0.2,) * 9)
    mesh = make_mesh("data=2", device="cpu")
    # every rank makes every group, in the same order
    ones = [dist.new_group([r]) for r in range(2)]
    mesh1 = make_mesh("data=1", group=ones[rank], device="cpu")
    b, hb = inp["batch"], inp["hybrid_batch"]
    res = {}
    for mode, sync in (("per_replica", False), ("synced", True)):
        res[mode] = dp_step("FPN2D", spec, inp["sd"], b, mesh, sync)

    res["hybrid"] = {"dp": dp_step("FPNHybridFusion", spec, inp["hybrid_sd"],
                                   hb, mesh, True)}
    dsd = inp["sd"]
    res["dropout"] = {
        "synced": dp_step("FPN2D", dspec, dsd, b, mesh, True, seed=5),
        "per_replica": dp_step("FPN2D", dspec, dsd, b, mesh, False, seed=5)}

    stacked = {k: np.stack([v, inp["batch2"][k]]) for k, v in b.items()}
    res["accum"] = {
        "data1": dp_step("FPN2D", spec, inp["sd"], stacked, mesh1, False,
                         accum_steps=2, stacked=True),
        "data2": dp_step("FPN2D", spec, inp["sd"], stacked, mesh, False,
                         accum_steps=2, stacked=True)}
    if rank == 0:
        # the single-process references, no collective
        res["hybrid"]["single"] = single_step("FPNHybridFusion", spec,
                                              inp["hybrid_sd"], hb)
        res["dropout"]["single"] = single_step("FPN2D", dspec, dsd, b,
                                               seed=5)
        res["dropout"]["shard_grads"] = shard_grads("FPN2D", dspec, dsd, b, 5)
        res["accum"]["single"] = single_step("FPN2D", spec, inp["sd"],
                                             stacked, accum_steps=2)

    cwd = inp["run_cwd"][rank]
    prev = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:
            info = train.run(inp["argv"] + ["--mesh", "data=2"],
                             device="cpu")
    finally:
        os.chdir(prev)
    res["entry"] = {"info": info, "stdout": log.getvalue()}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
