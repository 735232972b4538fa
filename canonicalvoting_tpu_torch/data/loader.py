"""Background-prefetch data loader.

The port's counterpart of ``canonicalvoting_tpu/data/loader.py`` (the
upstream ``torch.utils.data.DataLoader(num_workers=10)``, train_joint.py:211).
Two worker modes:

  * "process" (the default for num_workers >= 2): a persistent pool of
    worker processes runs ``__getitem__`` and ``collate_fn`` for whole
    batches. PLY parsing, label math, quantization and the pyramid build
    are GIL-bound NumPy and Python, so both must fan out. The pool starts
    with ``forkserver``: the parent has torch's threads (and maybe a CUDA
    context) running, and a fork of a threaded process can deadlock. The
    dataset and the collate function travel by pickle, so they must be
    picklable (a module-level function or a ``functools.partial`` of one,
    not a lambda). The pool is created once and reused across epochs.
  * "thread": a thread pool over items, the collate in the producer thread;
    enough for precomputed items (``ListDataset``).

A producer thread keeps ``PREFETCH`` finished batches ahead of the training
step. Workers never touch the card: batches come back as NumPy, and the
main process uploads them (``data/collate.py:upload_batch``).
"""

from __future__ import annotations

import atexit
import multiprocessing
import pickle
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np

PREFETCH = 2  # finished batches kept ahead of the training step

_WORKER_DS = None
_WORKER_COLLATE = None


def _pool_init(ds, collate):
    global _WORKER_DS, _WORKER_COLLATE
    _WORKER_DS = ds
    _WORKER_COLLATE = collate


def _pool_collate_batch(chunk):
    return _WORKER_COLLATE([_WORKER_DS[int(i)] for i in chunk])


class _LoaderError:
    """A worker's exception, carried to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = True, num_workers: int = 4,
                 drop_last: bool = False, seed: int = 0,
                 workers_mode: str = "auto"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        if workers_mode == "auto":
            workers_mode = "process" if self.num_workers >= 2 else "thread"
        if workers_mode not in ("process", "thread"):
            raise ValueError(f"workers_mode must be 'auto', 'process' or "
                             f"'thread', got {workers_mode!r}")
        self.workers_mode = workers_mode
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None:
            try:
                pickle.dumps((self.dataset, self.collate_fn))
            except Exception as e:
                raise TypeError(
                    "process workers need a picklable dataset and collate_fn "
                    f"(a module-level function or a functools.partial): {e}"
                ) from e
            ctx = multiprocessing.get_context("forkserver")
            self._pool = ctx.Pool(self.num_workers, initializer=_pool_init,
                                  initargs=(self.dataset, self.collate_fn))
            atexit.register(self.close)
        return self._pool

    def close(self):
        """Stop the worker processes (a later epoch starts new ones)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        self.close()

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield [int(i) for i in chunk]

    def __iter__(self) -> Iterator:
        batches = list(self._batches())
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = object()

        def worker():
            tp = None
            try:
                if self.workers_mode == "process":
                    batch_iter = self._ensure_pool().imap(
                        _pool_collate_batch, batches, chunksize=1)
                else:
                    tp = ThreadPoolExecutor(max_workers=self.num_workers)
                    item_iter = tp.map(self.dataset.__getitem__,
                                       [i for chunk in batches for i in chunk])
                    batch_iter = (self.collate_fn([next(item_iter) for _ in chunk])
                                  for chunk in batches)
                for batch in batch_iter:
                    q.put(batch)
            except BaseException as e:  # noqa: BLE001
                # raised in the consumer: swallowed in this thread it would
                # end the epoch early with no error
                q.put(_LoaderError(e))
            finally:
                if tp is not None:
                    tp.shutdown(wait=False)
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, _LoaderError):
                raise item.error
            yield item


class ListDataset:
    """Wrap a list of precomputed items as a dataset."""

    def __init__(self, items: Sequence):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]
