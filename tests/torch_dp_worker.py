"""The ranks' side of ``tests/test_torch_parallel.py``: the functions that
the spawned processes run (``torch_dp_launch.spawn``, gloo over a
``FileStore``, one torch thread), importing torch and the port only.
:func:`ranks` runs on two processes, :func:`halo_ranks` on three.

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
    the parent's run directory and rank 1 in an empty one; "entry_space"
    the same with ``--mesh data=1,space=2``;
  * "space": the same steps at ``data=1,space=2``, each rank on its half
    of the en-face width: FPN2D synced and per replica, the hybrid synced,
    FPN2D with dropout synced (seed 5), and per-replica accumulation.

:func:`halo_ranks` holds ``comm.halo_x`` (h = 1 and 2, along X and along
the z axis of the singleton-X view) and ``comm.across_cols`` (a linear
resize of the width) over the three ranks and over ranks 0 and 1, forward
and backward, against the whole tensor padded (or resized) and sliced;
every rank draws every rank's cotangent from one seed.
"""

import contextlib
import copy
import io
import os

import numpy as np
import torch
import torch.distributed as dist

from multimodal_fusion_fpn_torch import losses, train
from multimodal_fusion_fpn_torch.ops.interpolate import linear_resize
from multimodal_fusion_fpn_torch.parallel import comm
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

    space = make_mesh("data=1,space=2", device="cpu")
    res["space"] = {
        "synced": dp_step("FPN2D", spec, inp["sd"], b, space, True),
        "per_replica": dp_step("FPN2D", spec, inp["sd"], b, space, False),
        "hybrid": dp_step("FPNHybridFusion", spec, inp["hybrid_sd"], hb,
                          space, True),
        "dropout": dp_step("FPN2D", dspec, dsd, b, space, True, seed=5),
        "accum": dp_step("FPN2D", spec, inp["sd"], stacked, space, False,
                         accum_steps=2, stacked=True)}

    for name, mesh_spec in (("entry", "data=2"),
                            ("entry_space", "data=1,space=2")):
        prev = os.getcwd()
        os.chdir(inp["run_cwd"][name][rank])
        try:
            with contextlib.redirect_stdout(io.StringIO()) as log:
                info = train.run(inp["argv"] + ["--mesh", mesh_spec],
                                 device="cpu")
        finally:
            os.chdir(prev)
        res[name] = {"info": info, "stdout": log.getvalue()}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _cotangents(shape, n, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen, dtype=torch.float64).to(device)
            for _ in range(n)]


def _halo_case(group, h, axis, seed, device="cpu"):
    """(forward error, backward error) of ``halo_x`` on this rank's shard
    of a seeded tensor on ``device`` against the zero-padded whole
    sliced."""
    n, s, w = group.size, group.rank, 4
    shape = [2, 3, 5, 3, 2]
    shape[axis] = n * w
    whole = torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64).to(device).requires_grad_()
    mine = whole.detach().narrow(axis, s * w, w).clone().requires_grad_()
    out = comm.halo_x(mine, h, group, axis)
    zeros = whole.new_zeros([h if i == axis else d
                             for i, d in enumerate(shape)])
    padded = torch.cat([zeros, whole, zeros], dim=axis)
    refs = [padded.narrow(axis, r * w, w + 2 * h) for r in range(n)]
    gs = _cotangents(refs[0].shape, n, seed + 1, device)
    sum(torch.sum(ref * g) for ref, g in zip(refs, gs)).backward()
    out.backward(gs[s])
    return ((out - refs[s]).abs().max().item(),
            (mine.grad - whole.grad.narrow(axis, s * w, w)).abs().max().item())


def _across_case(group, seed):
    """The same for ``across_cols`` of a linear resize that takes the
    width from 4 to 6 columns per rank (and the height from 5 to 3)."""
    n, s = group.size, group.rank
    gen = torch.Generator().manual_seed(seed)
    whole = torch.randn((2, 5, 4 * n, 1, 3), generator=gen,
                        dtype=torch.float64, requires_grad=True)
    mine = whole.detach().narrow(2, s * 4, 4).clone().requires_grad_()
    with comm.sharded(comm.Shards(cols=group, total=group)):
        out = comm.across_cols(linear_resize, mine, (3, 6, 1), (1, 2, 3), 2)
    ref = linear_resize(whole, (3, 6 * n, 1), (1, 2, 3))
    gs = _cotangents(out.shape, n, seed + 1)
    sum(torch.sum(ref.narrow(2, r * 6, 6) * g)
        for r, g in enumerate(gs)).backward()
    out.backward(gs[s])
    return ((out - ref.narrow(2, s * 6, 6)).abs().max().item(),
            (mine.grad - whole.grad.narrow(2, s * 4, 4)).abs().max().item())


def halo_ranks(rank, out, device="cpu"):
    """:func:`halo_ranks` of the module note, over the world and, in a
    world of three, over ranks 0 and 1, on ``device`` (on the card: CUDA
    tensors through gloo, staged through the host); writes
    ``halo{rank}.pt``, {(case, ranks, h, axis): (forward error, backward
    error)}."""
    world = dist.get_world_size()
    groups = [make_mesh(f"space={world}", device=device).space]
    if world == 3:
        pair = dist.new_group([0, 1])
        if rank < 2:
            groups.append(make_mesh("space=2", group=pair,
                                    device=device).space)
    res = {}
    for group in groups:
        for h in (1, 2):
            for axis in (2, 3):
                res[("halo", group.size, h, axis)] = _halo_case(
                    group, h, axis, 10 * h + axis, device)
        if device == "cpu":
            res[("across", group.size, 0, 2)] = _across_case(group, 7)
    torch.save(res, os.path.join(out, f"halo{rank}.pt"))
