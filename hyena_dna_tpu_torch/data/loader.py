"""Deterministic, resumable batch loader (a copy of `hyena_dna_tpu/data/loader.py`).

Every sample is a function of (seed, epoch, index): the epoch's order is
`np.random.default_rng((seed, epoch)).permutation(n)` when shuffling, and
each item's augmentation generator is `default_rng((seed, epoch, index))`.
A resume therefore needs only {epoch, batches_served}: `load_state_dict`
makes the next iteration skip the batches already served, in O(1).
A background thread builds up to `PREFETCH` batches ahead while the caller
computes. The batches are numpy (tuples or dicts stacked per field); the
trainer moves them to its device.

Several processes: with `process_count` > 1 each takes the strided share
`order[process_index::process_count][:n // process_count]` of the epoch's
order (the JAX loader's split, a DistributedSampler without padding: the
ragged tail is dropped so every process serves as many batches). The
trainer passes the rank's data-axis coordinate and size, so the seq ranks
of one data group read the same rows, and batch i of the processes, each
of `batch_size` rows, holds together the rows of batch i of one process
serving `process_count * batch_size` rows, in another order.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np

PREFETCH = 2  # batches the producer thread builds ahead of the consumer


def _collate(samples):
    """Stack a list of per-sample pytrees (tuples of arrays / dicts)."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _collate([s[k] for s in samples]) for k in first}
    return np.stack(samples)


class DataLoader:
    """Deterministic shuffled batch iterator with O(1) resume state."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.batches_served = 0  # within the current epoch
        self._resume_pending = False  # only fast-forward after load_state_dict

    # --- fault tolerance ---------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "batches_served": self.batches_served, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch = int(state["epoch"])
        self.batches_served = int(state["batches_served"])
        self.seed = int(state.get("seed", self.seed))
        self._resume_pending = self.batches_served > 0

    # --- iteration ---------------------------------------------------------
    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            order = np.arange(n)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count][:n // self.process_count]
        return order

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _make_batch(self, order: np.ndarray, batch_idx: int):
        lo = batch_idx * self.batch_size
        idxs = order[lo : lo + self.batch_size]
        samples = []
        for i in idxs:
            rng = np.random.default_rng((self.seed, self.epoch, int(i)))
            samples.append(self.dataset.__getitem__(int(i), rng=rng))
        return _collate(samples)

    def __iter__(self) -> Iterator:
        order = self._epoch_order()
        nbatches = len(self)
        # fast-forward ONLY on an explicit resume; an abandoned partial
        # iteration (e.g. a step-bounded tuning loop) restarts the epoch
        if self._resume_pending:
            start = self.batches_served
            self._resume_pending = False
        else:
            start = 0
        self.batches_served = start

        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            try:
                for b in range(start, nbatches):
                    if stop.is_set():
                        return
                    q.put(self._make_batch(order, b))
                q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                self.batches_served += 1
                yield batch
        finally:
            stop.set()
            # drain so the producer can exit
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        # epoch finished
        self.epoch += 1
        self.batches_served = 0
