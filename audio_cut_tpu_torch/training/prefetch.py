"""Host-side batch prefetch for the training loop.

Counterpart of ``audio_cut_tpu/training/prefetch.py``. The synthetic batch
generator (``training/sep_data.py``) is numpy on the host. This wrapper runs
N generator instances on producer threads feeding a bounded queue, so batch
synthesis overlaps the device step: the step's kernels run asynchronously
on the card while the queue refills. It overlaps only as far as the
producers' numpy releases the interpreter lock while the train loop issues
its launches from Python; ``train_separator`` measures each step's wait for
a batch.

Threads hold no torch state: they only build numpy arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]


class PrefetchBatches:
    """Iterator yielding batches produced by ``make_iter(seed)`` instances on
    background threads.

    make_iter: called once per thread with a distinct integer seed; must
        return an infinite iterator of (mix, vocal) numpy batches.
    threads: number of producer threads (>= 1). With k threads the steady
        batch rate is about k / (seconds per generated batch).
    depth: bounded queue size (backpressure, so producers never run far
        ahead of training).

    Producers are daemon threads: the process may exit mid-run without
    joining them (training budgets by wall-clock, not epochs).
    """

    def __init__(self, make_iter: Callable[[int], Iterator[Batch]],
                 threads: int = 2, depth: int = 4, base_seed: int = 0):
        if threads < 1:
            raise ValueError("threads must be >= 1")
        self._q: "queue.Queue[Batch]" = queue.Queue(maxsize=max(depth, threads))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._threads = []
        for i in range(threads):
            t = threading.Thread(
                target=self._produce, args=(make_iter, base_seed + i),
                daemon=True, name=f"batch-prefetch-{i}")
            t.start()
            self._threads.append(t)

    def _produce(self, make_iter, seed: int) -> None:
        # a generator exception must reach the train loop, not die silently
        # in a daemon thread: with every producer dead the consumer's
        # blocking get() would wait out the run's whole --max-minutes budget
        try:
            it = make_iter(seed)
            while not self._stop.is_set():
                batch = next(it)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # noqa: BLE001 - re-raised by __next__
            self._error = exc
            self._stop.set()

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        while True:
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("batch prefetch producer died") from self._error
                if self._stop.is_set():
                    raise StopIteration

    def close(self) -> None:
        self._stop.set()
