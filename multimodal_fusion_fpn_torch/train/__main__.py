"""Training entry point of the port: the twin of the JAX package's
``train.py``, with its CLI and the logic of its ``run`` (``train.py:
39-212``).

    python -m multimodal_fusion_fpn_torch.train \\
        --training-dataset hrf_fusion --model FPNHybridFusion \\
        --crop relative_2d_max --fusion-modality slo --version V ...

The split comes from the dataset's split file or ``--split-name``; a list
of splits trains those of ``--split-indices`` in turn.  The run directory
is ``paths.get_model_path``'s; a run that finds ``last.ckpt`` there exits
0.  ``run.sh`` is copied into it; ``--data-ratio`` keeps the first part of
the training ids.  The training loader shuffles and drops the last partial
batch, the validation loader draws no random transforms.  The optimizer
is SGD (momentum 0.9, weight decay 1e-4).  The weights start from the
port's seeded init (``weights.init_state_dict(model, --seed)``), or from
the port ``.ckpt`` of ``--model-weights``; ``--exec-test`` builds the model
and returns; ``--resume`` continues from ``resume.ckpt`` exactly (weights,
BatchNorm stats, optimizer, step, the early-stopping ledger).  The run
writes the top-5 ``epoch=*.ckpt``, ``curves.json``, ``curves.svg``,
``images/`` and, once complete, ``last.ckpt`` with the optimizer; then it
removes ``resume.ckpt``.  ``--precision bf16`` computes in bf16 with fp32
weights.

The process mesh (``train.py:72-80``): with ``--mesh data=N`` or
``--mesh data=N,space=M``, or without ``--mesh`` when torchrun's
``WORLD_SIZE`` is above 1 (then ``data=WORLD_SIZE``), the run is one rank
of N*M processes, each on its rows and its en-face columns of every batch
(``parallel``):

    torchrun --nproc-per-node N*M -m multimodal_fusion_fpn_torch.train \
        --mesh data=N,space=M [--bn-sync] ...

``--bn-sync`` normalises with the global batch's statistics; without it
each rank normalises with its own (the original project's per-replica
BatchNorm).  The backend is the initialised process group's, else nccl on
the card (one card per rank) and gloo on the CPU (``parallel.mesh.
init_mesh``).  Rank r computes on ``cuda:LOCAL_RANK``.  Rank 0 alone writes
the run directory, and validates on the whole width (the JAX trainer
validates sharded, with the same numbers); the standard output of the
other ranks is discarded.  A mesh whose size is not the number of
processes is refused before a process group is made, and widths that do
not split evenly over ``space`` at every level before the first step
(``parallel.mesh.check_widths``).  The run never spreads over the visible
cards by itself.

:func:`run` trains on the card (``device="cuda"``) through the kernels, or
on the CPU when the caller passes ``device="cpu"``; ``kernels=False`` runs
the plain versions on the card.
"""

import contextlib
import json
import os
import shutil
import sys
import time
from os.path import join
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

from multimodal_fusion_fpn_torch import paths as path_utils
from multimodal_fusion_fpn_torch.config import parse_config, pretty_print
from multimodal_fusion_fpn_torch.data.loader import DataLoader
from multimodal_fusion_fpn_torch.models.zoo import build_model
from multimodal_fusion_fpn_torch.parallel.mesh import init_mesh, shard_state
from multimodal_fusion_fpn_torch.train.checkpoints import (
    load_checkpoint, load_training_state, save_checkpoint)
from multimodal_fusion_fpn_torch.train.configs import data_config_factory
from multimodal_fusion_fpn_torch.train.optim import sgd
from multimodal_fusion_fpn_torch.train.state import create_train_state
from multimodal_fusion_fpn_torch.train.trainer import Trainer
from multimodal_fusion_fpn_torch.utils import print_net_info
from multimodal_fusion_fpn_torch.weights import init_state_dict


def main(config, data_config, model_path, training_file_list,
         validation_file_list, device="cuda", kernels=True, t_start=None,
         mesh=None):
    """One split's run (``train.py:39-153``), on this rank of ``mesh``
    when there is one; returns its info (see :func:`run`), or None under
    ``--exec-test``."""
    t_start = time.perf_counter() if t_start is None else t_start
    print(model_path)
    print("torch", torch.__version__, "device", device)

    print("===> Building model")
    dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
    model = build_model(config, dtype=dtype, device=device)

    print("===> Loading datasets")
    print("Train data:", data_config.paths["oct"])
    data_transform, data_transform_val = data_config.get_transforms()
    train_data = data_config.train_data(training_file_list, data_transform)
    val_data = data_config.val_data(validation_file_list, data_transform_val)

    batch_size = config.batch_size or data_config.batch_size
    train_loader = DataLoader(train_data, batch_size=batch_size,
                              shuffle=True, drop_last=True,
                              num_workers=config.threads, seed=config.seed)
    val_loader = DataLoader(val_data, batch_size=config.val_batch_size,
                            shuffle=False, drop_last=False,
                            num_workers=min(2, config.threads),
                            seed=config.seed, transform_rng=False)

    criterion = data_config.get_criterion()
    optimizer = sgd(model.parameters(), config.learning_rate, momentum=0.9,
                    weight_decay=1e-4)
    state = create_train_state(model, optimizer,
                               init_state_dict(model, config.seed))
    print_net_info(model)

    if config.model_weights is not None:
        print("Loading pretrained model from", config.model_weights)
        model.load_state_dict(load_checkpoint(config.model_weights,
                                              model.state_dict()))

    if config.exec_test:
        print(model)
        print("Testing mode enabled. Skipping training.")
        return None

    trainer = Trainer(
        model, optimizer, criterion,
        metrics_train=data_config.metrics_train,
        metrics_val=data_config.metrics_val,
        metametrics=data_config.meta_metric_val,
        model_path=model_path,
        epochs=config.epochs,
        virtual_batch_size=config.virtual_batch_size,
        monitor=data_config.monitor,
        monitor_mode=data_config.monitor_mode,
        early_stopping=config.early_stopping,
        seed=config.seed, device=device, kernels=kernels,
        mesh=mesh, bn_sync=config.bn_sync)

    start_epoch, early_state = 0, None
    resume_path = join(model_path, "resume.ckpt")
    if getattr(config, "resume", False) and Path(resume_path).exists():
        # exact epoch-boundary resume: the per-step dropout generators and
        # the loader's per-epoch draws make the rest of the run the
        # uninterrupted run's
        print("Resuming from", resume_path)
        model.load_state_dict(load_checkpoint(resume_path,
                                              model.state_dict()))
        extra = load_training_state(resume_path)
        optimizer.load_state_dict(extra["optimizer"])
        state.step = int(extra["step"])
        start_epoch = int(extra["next_epoch"])
        best = float(extra["best"])
        pl = int(extra["patience_left"])
        early_state = {"best": None if np.isnan(best) else best,
                       "patience_left": None if pl < 0 else pl}
        print(f"Resumed at epoch {start_epoch} (step {state.step})")
    if mesh is not None:
        shard_state(model, optimizer, mesh)

    print("===> Begin training")
    t_fit = time.perf_counter()
    trainer.fit(state, train_loader, val_loader, start_epoch=start_epoch,
                early_state=early_state)
    t_fit = time.perf_counter() - t_fit

    if trainer.interrupted:
        print("Training interrupted")
    elif mesh is None or mesh.rank == 0:
        print("===> Saving last model")
        save_checkpoint(join(model_path, "last.ckpt"), model.state_dict(),
                        optimizer=optimizer.state_dict(),
                        step=int(state.step))
        if Path(resume_path).exists():
            os.remove(resume_path)
    if torch.device(device).type != "cpu":
        torch.cuda.synchronize(device)
    return {"model_path": model_path, "interrupted": trainer.interrupted,
            "seconds": time.perf_counter() - t_start, "fit": t_fit,
            "timing": dict(trainer.timing), "images": trainer.images,
            "steps": trainer.steps, "eval_forwards": trainer.eval_forwards,
            "losses": list(trainer.losses), "step": int(state.step)}


def train_with_split(config, data_config, split, idx, split_path,
                     device="cuda", kernels=True, t_start=None, mesh=None):
    model_path = path_utils.get_model_path(config, split_path, idx)
    writer = mesh is None or mesh.rank == 0
    if writer:
        Path(model_path).mkdir(exist_ok=True, parents=True)
    print(model_path)

    if Path(join(model_path, "last.ckpt")).exists():
        print("Model already trained. Skipping.")
        sys.exit(0)

    if writer:
        if os.path.exists(config.file_to_copy):
            shutil.copy2(config.file_to_copy, model_path)
        Path(join(model_path, "images")).mkdir(exist_ok=True, parents=True)

    train_ids, val_ids = split["train"], split["val"]
    if config.data_ratio < 1.0:
        print("Using only", config.data_ratio * 100,
              "% of the training data.")
        train_ids = train_ids[:int(len(train_ids) * config.data_ratio)]

    print("Number of training samples:", len(train_ids))
    print("Number of validation samples:", len(val_ids))
    return main(config, data_config, model_path, train_ids, val_ids,
                device=device, kernels=kernels, t_start=t_start, mesh=mesh)


def run(argv=None, device="cuda", kernels: bool = True):
    """Train what ``argv`` names (see the module note).  Returns the info
    of the last split trained: {"model_path", "interrupted", "seconds"
    (from the call to ``last.ckpt``), "fit" (the epoch loop's seconds),
    "timing" (the trainer's split of them: "load", "step", "debug", "val",
    "save"), "images" and "steps" trained, "eval_forwards" (validation and
    debug strips), "losses" (each step's), "step"}; None under
    ``--exec-test``.  Under a mesh every rank returns its info, and ranks
    other than 0 print nothing; a process group this call made is torn
    down at its end."""
    owned = not dist.is_initialized()
    try:
        t_start = time.perf_counter()
        config = parse_config(argv)
        mesh = None
        if config.mesh or int(os.environ.get("WORLD_SIZE", 1)) > 1:
            mesh = init_mesh(config.mesh, device=device)
            device = mesh.device
        with contextlib.ExitStack() as stack:
            if mesh is not None and mesh.rank != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _run(config, mesh, device, kernels, t_start)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _run(config, mesh, device, kernels, t_start):
    if mesh is not None:
        print("Process mesh:", mesh.axes, "backend", mesh.world.backend)
    print(pretty_print(config))
    np.random.seed(config.seed)

    data_config = data_config_factory[config.training_dataset](config)

    split_name = config.split_name
    if split_name is not None:
        split_parent = Path(data_config.paths["split"]).parent
        if not split_name.endswith(".json"):
            split_name += ".json"
        split_path = str(split_parent / split_name)
        data_config.paths["split"] = split_path
    else:
        split_path = data_config.paths["split"]

    with open(split_path, "r") as fp:
        splits = json.load(fp)
    print("Split:", Path(split_path).stem)

    info = None
    if isinstance(splits, dict):
        print("Only one split, ignoring split indices."
              " Regular training setting.")
        info = train_with_split(config, data_config, splits, None,
                                split_path, device, kernels, t_start, mesh)
    elif isinstance(splits, list):
        print(f"Multiple splits ({len(splits)}), using split indices."
              " Training in a cross-validation setting.")
        for idx, split in enumerate(splits):
            if idx not in config.split_indices:
                continue
            print("Running {} out of {} splits.".format(idx,
                                                        len(splits) - 1))
            info = train_with_split(config, data_config, split, idx,
                                    split_path, device, kernels,
                                    time.perf_counter(), mesh)
    return info


if __name__ == "__main__":
    run()
