"""Threaded prefetching batch loader; the port's copy of
``simpledepthestimation_tpu/data/loader.py``.

A thread pool decodes and augments samples while the card runs the previous
step, with a bounded queue of collated batches. Each sample is preprocessed
with a generator keyed on (seed, epoch, dataset index), so a batch does not
depend on the thread that made it, nor on where a run was resumed. With
``pin_memory`` the collator writes each batch into page-locked host memory,
which the runtime copies to the card without blocking.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.pin_memory = pin_memory
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _sample(self, idx: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, int(idx)])
        )
        return self.dataset.get_sample(idx, rng)

    def __iter__(self) -> Iterator[dict]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()
        err: list = []
        stop = threading.Event()  # set when the consumer abandons the iterator

        def put(item) -> bool:
            """Bounded put that aborts when the consumer is gone (a consumer
            breaking out of the loop early — e.g. PreciseBN taking N batches —
            must not leave this thread blocked on a full queue forever)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    indices = list(self.sampler)
                    batches = [
                        indices[i : i + self.batch_size]
                        for i in range(0, len(indices), self.batch_size)
                    ]
                    if self.drop_last:
                        batches = [b for b in batches if len(b) == self.batch_size]
                    # map keeps order; chunks pipeline across the pool
                    pending = []
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        futs = [pool.submit(self._sample, i) for i in batch_idx]
                        pending.append(futs)
                        # bound in-flight decode work to ~2 batches beyond the queue
                        while len(pending) > 2:
                            done = pending.pop(0)
                            samples = [f.result() for f in done]
                            if not put(self.dataset.batch_collator(samples, pin_memory=self.pin_memory)):
                                return
                    for done in pending:
                        samples = [f.result() for f in done]
                        if not put(self.dataset.batch_collator(samples, pin_memory=self.pin_memory)):
                            return
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                # stop-aware put: delivered when the consumer is still
                # draining; abandoned harmlessly when it is gone
                put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            stop.set()
            thread.join()
