"""Threaded prefetching data loader: the port's copy of
``multimodal_fusion_fpn_tpu/data/loader.py``, which gives the same batches
in the same order.

It stands in for the original project's ``torch.utils.data.DataLoader``
(its ``train.py:79-95``): a thread pool decodes and transforms examples
ahead of the step (numpy/scipy release the GIL in the hot paths), and
batches are collated into stacked numpy arrays, which the caller moves to
the device.

Determinism: example ``i`` of epoch ``e`` uses
``np.random.Generator(seed, e, i)`` regardless of thread scheduling —
stronger reproducibility than the original project's per-worker seeding
(its ``train.py:30-34``).  Record loading is stateless
(``dataset.load_record``); the reference's serve-N-patches-per-loaded-
image behavior is reproduced by block-mapping positions to load indices
plus a per-thread record memo (see ``__iter__`` / ``_cached_record``).
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np


def default_collate(examples):
    """Stack a list of example dicts into a batch dict (torch
    ``default_collate`` analogue: arrays are stacked, scalars become
    arrays, strings become lists)."""
    batch = {}
    for key in examples[0]:
        vals = [e[key] for e in examples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = list(vals)
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0,
                 seed: int = 1234,
                 collate_fn: Callable = default_collate,
                 prefetch_batches: int = 2,
                 transform_rng: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.collate_fn = collate_fn
        self.prefetch_batches = max(1, prefetch_batches)
        self.transform_rng = transform_rng
        self.epoch = 0
        self._local = threading.local()

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _fetch(self, position: int, index: int):
        rng = np.random.default_rng([self.seed, self.epoch, position]) \
            if self.transform_rng else None
        record = self._cached_record(int(index))
        return self.dataset.get_example(int(index), rng, record=record)

    def _cached_record(self, index: int):
        """Per-thread memo of the last loaded raw record.  With
        ``patches_from_single_image > 1`` consecutive positions map to
        the same index (see ``__iter__``), so the memo turns N patches
        into one disk load; a miss just reloads (records are
        deterministic, so caching is purely an IO optimization)."""
        memo = getattr(self._local, "memo", None)
        if memo is not None and memo[0] == index:
            return memo[1]
        record = self.dataset.load_record(index)
        self._local.memo = (index, record)
        return record

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                [self.seed, self.epoch]).permutation(n)
        else:
            order = np.arange(n)

        # Reference patch-reuse semantics
        # (abstract_dataloader.py:94-101): each loaded image serves
        # ``patches_from_single_image`` consecutive examples.  Map each
        # position's load-index to the first position of its block.
        k = int(getattr(self.dataset, "patches_from_single_image", 1) or 1)
        if k > 1:
            order = order[(np.arange(n) // k) * k]

        n_batches = len(self)
        if self.num_workers <= 0:
            for b in range(n_batches):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                examples = [self._fetch(b * self.batch_size + j, i)
                            for j, i in enumerate(idxs)]
                yield self.collate_fn(examples)
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.prefetch_batches
            futures = {}

            def submit_batch(b):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                futures[b] = [
                    pool.submit(self._fetch, b * self.batch_size + j, i)
                    for j, i in enumerate(idxs)]

            for b in range(min(window, n_batches)):
                submit_batch(b)
            for b in range(n_batches):
                if b + window < n_batches:
                    submit_batch(b + window)
                examples = [f.result() for f in futures.pop(b)]
                yield self.collate_fn(examples)
