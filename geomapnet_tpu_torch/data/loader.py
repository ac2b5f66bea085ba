"""Batch loader: fixed-shape numpy batches with background prefetch.

A copy of :class:`geomapnet_tpu.data.loader.Loader`
(tests/test_torch_import_isolation.py pins the copy to the original). It
replaces the reference's torch DataLoader + ``safe_collate`` (upstream
common/train.py:55-62, 180-188):

- **fixed shapes**: the trailing partial batch is dropped for training
  (``drop_last=True``) and padded to the full batch size for evaluation,
  with the pad count reported so callers discard those rows;
- **corrupt-sample tolerance**: samples whose image failed to decode are
  skipped and replaced by the next index, the moral equivalent of
  ``safe_collate`` dropping Nones without changing the batch shape;
- **overlap**: a background thread prefetches the next batch while the device
  computes, and with ``num_workers > 1`` samples within a batch are fetched
  by a thread pool. Datasets exposing ``fetch_many(indices)`` get whole-batch
  fetch requests instead, so they can batch their decodes. A consumer that
  stops early (``close()`` of the iterator, as a ``break`` does) stops the
  thread too: it finishes the batch in hand and exits, where the original
  stays blocked on its queue (or, if the files go away, probes forward
  through every remaining sample);
- **process sharding**: with ``process_count > 1`` every process (a rank
  of :mod:`geomapnet_tpu_torch.parallel`) draws the same seeded
  permutation, truncates it to a multiple of ``process_count`` and takes
  ``order[p::P]``, so all processes see the same batch count and the
  rank-ordered concatenation of their batches is the global batch. With
  ``rows`` (the port's addition, for gradient accumulation over several
  ranks) a process loads those rows of each such global batch instead of
  its own block (:func:`geomapnet_tpu_torch.parallel.microbatch_rows`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

__all__ = ["Loader"]


class Loader:
    """Iterate fixed-shape (images, poses) batches over an indexable dataset.

    :param dataset: object with ``__len__`` and ``__getitem__`` returning
        ``(imgs, poses)`` numpy arrays (imgs may be None for corrupt samples)
    :param batch_size: static batch size
    :param shuffle: reshuffle each epoch
    :param drop_last: drop the ragged tail (train) vs pad it (eval)
    :param seed: seed of the shuffle order
    :param prefetch: number of batches to stage in the background thread
    :param num_workers: intra-batch fetch parallelism (1 = serial); passed on
        to the dataset's ``fetch_many`` when it has one
    :param process_index / process_count: this process's disjoint strided
        slice of every epoch's permutation
    :param rows: with ``process_count > 1`` and ``drop_last``, the rows of
        each global batch (``process_count * batch_size`` rows, the
        processes' default batches in process order) this process loads;
        None loads its own block
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 7,
        prefetch: int = 2,
        num_workers: int = 1,
        process_index: int = 0,
        process_count: int = 1,
        rows=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))
        self._pool: ThreadPoolExecutor | None = None
        # multi-process sharding of the host pipeline: every process draws
        # the same seeded permutation and takes a disjoint strided slice, so
        # per-process batches are the per-rank shards of a global batch
        self.process_index = process_index
        self.process_count = process_count
        self.rows = None if rows is None else np.asarray(rows, np.int64)
        if self.rows is not None:
            if not drop_last:
                raise ValueError("rows regroups full global batches only "
                                 "(drop_last=True)")
            if len(self.rows) != batch_size:
                raise ValueError(f"{len(self.rows)} rows for a local batch "
                                 f"of {batch_size}")

    def _local_len(self) -> int:
        n = len(self.dataset)
        if self.process_count > 1:
            # truncate to a multiple of process_count so every process sees
            # the SAME local length — unequal lengths would give processes
            # different batch counts and deadlock the collective at the
            # epoch tail
            n = (n // self.process_count)
        return n

    def __len__(self) -> int:
        n = self._local_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, index: int):
        """Fetch a sample, skipping forward past corrupt entries."""
        n = len(self.dataset)
        for probe in range(n):
            imgs, poses = self.dataset[(index + probe) % n]
            if imgs is not None:
                return imgs, poses
        raise RuntimeError("all samples in the dataset failed to load")

    def _fetch_samples(self, idx: np.ndarray) -> list:
        """Fetch one sample per index, preserving order.

        Prefers the dataset's own batched path (``fetch_many``), then a
        thread pool, then serial. Corrupt samples (None images) are
        substituted by probing forward from the next index.
        """
        if hasattr(self.dataset, "fetch_many"):
            samples = self.dataset.fetch_many(
                [int(i) for i in idx], num_workers=self.num_workers
            )
        elif self.num_workers > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    self.num_workers, thread_name_prefix="loader"
                )
            samples = list(
                self._pool.map(self.dataset.__getitem__, (int(i) for i in idx))
            )
        else:
            samples = [self.dataset[int(i)] for i in idx]
        return [
            s if s[0] is not None else self._fetch(int(i) + 1)
            for i, s in zip(idx, samples)
        ]

    def _make_batch(self, idx: np.ndarray, pad: int):
        samples = self._fetch_samples(idx)
        imgs = np.stack([s[0] for s in samples])
        poses = np.stack([s[1] for s in samples])
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
            poses = np.concatenate([poses, np.repeat(poses[-1:], pad, axis=0)])
        return imgs, poses, pad

    def _batches(self) -> Iterator[tuple[np.ndarray, int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.process_count > 1:
            # equal-length disjoint strided slices of the shared permutation
            # (tail dropped so all processes agree on the batch count)
            P = self.process_count
            n_even = len(order) - len(order) % P
            if self.rows is None:
                order = order[:n_even][self.process_index::P]
            else:
                # the global batches as the processes' default batches
                # concatenate (row p * bs + j is process p's row j), then
                # this process's rows of each
                bs = self.batch_size
                nb = n_even // P // bs
                glob = order[:nb * bs * P].reshape(nb, bs, P).transpose(
                    0, 2, 1).reshape(nb, P * bs)
                order = glob[:, self.rows].reshape(-1)
        bs = self.batch_size
        n_full = len(order) // bs
        for b in range(n_full):
            yield order[b * bs:(b + 1) * bs], 0
        tail = len(order) - n_full * bs
        if tail and not self.drop_last:
            yield order[n_full * bs:], bs - tail

    def __iter__(self):
        """Yields (images, poses, n_padded) with background prefetch."""
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        SENTINEL = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for idx, pad in self._batches():
                    if stop.is_set() or not put(self._make_batch(idx, pad)):
                        return
            except BaseException as e:  # surfaced in the consumer
                put(e)
                return
            put(SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
