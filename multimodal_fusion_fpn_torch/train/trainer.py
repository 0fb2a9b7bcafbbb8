"""The training runtime: the port's copy of ``multimodal_fusion_fpn_tpu/
train/trainer.py`` (``Trainer``, ``:31-296``).

  * the epoch loop, with ``loader.set_epoch`` (the loader reshuffles and
    draws its transforms per (seed, epoch, position));
  * ``virtual_batch_size`` micro-batches per optimizer step
    (``make_train_step(accum_steps=...)``), the epoch's last partial
    window still stepped, as the original project's Lightning loop does;
  * the dropout masks of each step drawn from a ``torch.Generator`` seeded
    from (seed, epoch, step in the epoch), as the JAX trainer folds its
    ``PRNGKey(seed)``: an interrupted and resumed run draws the masks of
    the uninterrupted one;
  * the training metrics kept on the device and fetched once per metric
    per epoch (``_drain_metrics``);
  * validation every epoch through the eval step (``make_eval_step``) and
    the host streaming metrics;
  * the monitor from the metametrics, else from the raw validation
    results; the top-k checkpoints, early stopping, ``curves.json`` /
    ``curves.svg``, ``resume.ckpt`` every epoch, throttled debug strips
    under ``images/``.

Batches are copied to the device one step ahead (``utils.device_prefetch``)
while the host keeps its numpy copy for the metrics and the strips.
``timing`` gathers the seconds of the loop: waiting for the loader
("load"), the train steps up to the epoch's last fetch ("step"), the debug
strips ("debug"), validation ("val") and the checkpoints and curves
("save"); ``images`` counts the images trained on.

The process mesh (``mesh``, ``bn_sync``: ``trainer.py:42,58-66``): every
rank loads the same global batch from the same seeded loader and keeps its
rows and en-face columns of each micro-batch (``parallel.mesh.
shard_batch``; stacking sharded micro-batches is sharding the stacked
window on its axis 1 and its last axis), and the steps,
the epoch-tail ones included, are ``parallel.step.make_dp_train_step``'s.
Rank 0 alone validates (with the replicated state, as the JAX trainer
does, on the whole width where the JAX trainer validates sharded) and
writes the checkpoints, ``resume.ckpt``, the curves and the strips; it
broadcasts the validation results, so the top-k ledger and
early stopping agree on every rank.  (The entry point discards the
standard output of the other ranks.)
"""

import os
import time
from os.path import join
from typing import Dict, Optional

import numpy as np
import torch

from multimodal_fusion_fpn_torch.parallel.comm import broadcast_
from multimodal_fusion_fpn_torch.parallel.mesh import shard_batch
from multimodal_fusion_fpn_torch.parallel.step import make_dp_train_step
from multimodal_fusion_fpn_torch.train.checkpoints import (TopKCheckpointer,
                                                           save_checkpoint)
from multimodal_fusion_fpn_torch.train.state import TrainState
from multimodal_fusion_fpn_torch.train.step import (MODEL_KEYS,
                                                    make_eval_step,
                                                    make_train_step)
from multimodal_fusion_fpn_torch.utils import (MonitorLearning,
                                               device_prefetch,
                                               tree_to_device)
from multimodal_fusion_fpn_torch.viz import CurvePlotter, debug_batch


def step_seed(seed: int, epoch: int, step_in_epoch: int) -> int:
    """The seed of the dropout generator of one step."""
    return int(np.random.SeedSequence([seed, epoch, step_in_epoch])
               .generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    def __init__(self, model, optimizer, criterion,
                 metrics_train: Dict, metrics_val: Dict, metametrics: Dict,
                 model_path: str,
                 epochs: int = 40,
                 virtual_batch_size: int = 1,
                 monitor: str = "Dice", monitor_mode: str = "max",
                 save_top_k: int = 5,
                 early_stopping: Optional[int] = None,
                 seed: int = 1234,
                 save_debug_images: bool = True,
                 device="cuda", kernels: bool = True,
                 mesh=None, bn_sync: bool = True):
        self.model = model
        self.optimizer = optimizer
        self.criterion = criterion
        self.metrics_train = metrics_train or {}
        self.metrics_val = metrics_val or {}
        self.metametrics = metametrics or {}
        self.model_path = model_path
        self.epochs = epochs
        self.vbs = max(1, virtual_batch_size)
        self.monitor = monitor
        self.monitor_mode = monitor_mode
        self.early_stopping = early_stopping
        self.seed = seed
        self.save_debug_images = save_debug_images
        self.device = torch.device(device)
        self.kernels = kernels
        self.mesh = mesh
        self.bn_sync = bn_sync
        self.rank0 = mesh is None or mesh.rank == 0

        self.train_step = self._make_step(self.vbs)
        # epoch-tail steps (fewer micro-batches), made when first needed
        self._tail_steps = {self.vbs: self.train_step}
        self.eval_step = make_eval_step(model, self.device)
        self.checkpointer = (TopKCheckpointer(
            model_path, monitor=monitor, mode=monitor_mode,
            save_top_k=save_top_k) if self.rank0 else None)
        self.curves = CurvePlotter(model_path,
                                   list(self.metrics_train.keys()),
                                   list(self.metrics_val.keys()))
        self.monitor_learning = MonitorLearning()
        self.interrupted = False
        self.timing: Dict[str, float] = {}
        self.images = 0
        self.steps = 0
        self.eval_forwards = 0
        self.losses = []
        if save_debug_images and self.rank0:
            os.makedirs(join(model_path, "images"), exist_ok=True)

    # ------------------------------------------------------------------
    def _tick(self, part: str, t0: float) -> float:
        now = time.perf_counter()
        self.timing[part] = self.timing.get(part, 0.0) + now - t0
        return now

    def _make_step(self, accum_steps: int):
        if self.mesh is not None:
            return make_dp_train_step(
                self.model, self.optimizer, self.criterion, self.mesh,
                bn_sync=self.bn_sync, accum_steps=accum_steps,
                device=self.device)
        return make_train_step(self.model, self.optimizer, self.criterion,
                               accum_steps=accum_steps, device=self.device)

    def _tail_step(self, n: int):
        if n not in self._tail_steps:
            self._tail_steps[n] = self._make_step(n)
        return self._tail_steps[n]

    def _transfer(self, batch, shard: bool = False):
        """(the host batch, its model keys on the device: with ``shard``,
        this rank's rows under a mesh)."""
        mb = {k: batch[k] for k in MODEL_KEYS if k in batch}
        if shard and self.mesh is not None:
            mb = shard_batch(mb, self.mesh)
        return batch, tree_to_device(mb, self.device)

    def _transfer_shard(self, batch):
        return self._transfer(batch, shard=True)

    def _run_step(self, state, payload, epoch, step_in_epoch, accum_len):
        gen = torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, epoch, step_in_epoch))
        step = (self.train_step if accum_len == self.vbs
                else self._tail_step(accum_len))
        self.steps += 1
        return step(state, payload, kernels=self.kernels, generator=gen)

    def _drain_metrics(self, pending: Dict) -> None:
        """The epoch's per-step metric tensors to the host, one fetch per
        metric."""
        for k, chunks in pending.items():
            if chunks:
                vals = torch.cat([torch.atleast_1d(c.float())
                                  for c in chunks]).cpu().numpy()
                self.metrics_train[k].extend_values(vals)

    def _debug_strip(self, host_batch) -> None:
        if not self.rank0:
            return
        try:
            out = self.eval_step(host_batch, kernels=self.kernels)
            self.eval_forwards += 1
            dbg = dict(host_batch)
            dbg["prediction"] = out["prediction"].float().cpu().numpy()
            debug_batch(dbg, join(self.model_path, "images"))
        except Exception as exc:  # observability must not stop a run
            print("debug_batch failed:", exc)

    def _train_epoch(self, state: TrainState, loader, epoch: int):
        loader.set_epoch(epoch)
        pending = []
        pending_metrics = {k: [] for k in self.metrics_train}
        losses = []
        step_in_epoch = 0

        def flush(micro_batches):
            n = len(micro_batches)
            payload = (micro_batches[0] if n == 1 else
                       {k: torch.stack([mb[k] for mb in micro_batches])
                        for k in micro_batches[0]})
            return self._run_step(state, payload, epoch, step_in_epoch, n)

        def collect(aux):
            losses.append(aux["loss"])
            for k in self.metrics_train:
                if k in aux["metrics"]:
                    pending_metrics[k].append(aux["metrics"][k])

        t = time.perf_counter()
        for host, mb in device_prefetch(iter(loader),
                                        transfer=self._transfer_shard):
            t = self._tick("load", t)
            self.images += len(next(host[k] for k in MODEL_KEYS
                                    if k in host))
            if self.vbs > 1:
                pending.append((mb, host))
                if len(pending) < self.vbs:
                    t = self._tick("step", t)
                    continue
                display = pending[-1][1]
                aux = flush([p[0] for p in pending])
                pending = []
            else:
                display = host
                aux = self._run_step(state, mb, epoch, step_in_epoch, 1)
            step_in_epoch += 1
            collect(aux)
            t = self._tick("step", t)
            if (self.save_debug_images
                    and self.monitor_learning.is_save_time()):
                self._debug_strip(display)
                t = self._tick("debug", t)

        if pending:
            # the partial accumulation window at the epoch's end
            collect(flush([p[0] for p in pending]))
        self._drain_metrics(pending_metrics)
        if losses:
            self.losses += torch.stack([v.float() for v in losses]
                                       ).cpu().tolist()
        self._tick("step", t)

    def _val_epoch(self, state: TrainState, loader) -> Dict[str, float]:
        """The validation results: rank 0's, broadcast under a mesh."""
        results = self._validate(loader) if self.rank0 else None
        if self.mesh is not None:
            keys = list(self.metrics_val)
            vals = torch.tensor([results[k] for k in keys] if self.rank0
                                else [0.0] * len(keys), dtype=torch.float64,
                                device=self.device)
            broadcast_([vals], self.mesh.world)
            results = dict(zip(keys, vals.tolist()))
        return results

    def _validate(self, loader) -> Dict[str, float]:
        for metric in self.metrics_val.values():
            metric.reset()
        for host, mb in device_prefetch(iter(loader),
                                        transfer=self._transfer):
            out = self.eval_step(mb, kernels=self.kernels)
            self.eval_forwards += 1
            host_out = {"prediction": out["prediction"].float().cpu().numpy()}
            for metric in self.metrics_val.values():
                metric.update(host, host_out)
        results = {k: float(m.get()) for k, m in self.metrics_val.items()}
        for metric in self.metrics_val.values():
            metric.reset()
        return results

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, train_loader, val_loader,
            start_epoch: int = 0, early_state=None) -> TrainState:
        """The epoch loop from ``start_epoch``; ``early_state`` ({"best",
        "patience_left"}) continues the early-stopping ledger of an
        interrupted run (exact resume at an epoch boundary)."""
        best = None
        patience_left = self.early_stopping
        if early_state is not None:
            best = early_state.get("best")
            patience_left = early_state.get("patience_left", patience_left)
        if start_epoch > 0 and self.rank0:
            self.checkpointer.restore()
            self.curves.load(upto=start_epoch)
        try:
            for epoch in range(start_epoch, self.epochs):
                self._train_epoch(state, train_loader, epoch)

                train_results = {k: float(m.get())
                                 for k, m in self.metrics_train.items()}
                for k, m in self.metrics_train.items():
                    m.reset()
                    self.curves.append(f"{k} (train)", train_results[k])

                t = time.perf_counter()
                val_results = self._val_epoch(state, val_loader)
                t = self._tick("val", t)
                for k, v in val_results.items():
                    self.curves.append(f"{k} (val)", v)
                if self.rank0:
                    self.curves.save()

                # metametrics publish the monitor (the original project's
                # only path to 'Dice'); else the raw validation results
                meta_results = {str(k): mm.get(val_results)
                                for k, mm in self.metametrics.items()}
                monitor_value = meta_results.get(
                    self.monitor, val_results.get(self.monitor, np.nan))
                print(f"[epoch {epoch}] train={train_results} "
                            f"val={val_results}")

                if self.rank0:
                    self.checkpointer.update(epoch, monitor_value,
                                             self.model.state_dict())

                if self.early_stopping is not None:
                    improved = (best is None
                                or (monitor_value > best
                                    if self.monitor_mode == "max"
                                    else monitor_value < best))
                    if improved:
                        best = monitor_value
                        patience_left = self.early_stopping
                    else:
                        patience_left -= 1
                        if patience_left <= 0:
                            print(f"Early stopping at epoch {epoch}")
                            self._tick("save", t)
                            break
                self._save_resume(state, epoch, best, patience_left)
                self._tick("save", t)
        except KeyboardInterrupt:
            self.interrupted = True
            print("Training interrupted")
        return state

    def _save_resume(self, state: TrainState, epoch: int, best,
                     patience_left) -> None:
        """The epoch-boundary ``resume.ckpt`` (``--resume`` reads it; the
        entry point removes it once the run completes); rank 0's."""
        if not self.rank0:
            return
        save_checkpoint(
            join(self.model_path, "resume.ckpt"), self.model.state_dict(),
            optimizer=self.optimizer.state_dict(), step=int(state.step),
            next_epoch=epoch + 1,
            best=float("nan") if best is None else float(best),
            patience_left=-1 if patience_left is None else int(
                patience_left))
