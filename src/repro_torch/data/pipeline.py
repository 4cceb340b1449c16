"""Data pipeline built ON the actor runtime (paper §6.1, Fig 9).

Port of ``repro/data/pipeline.py`` on the port's threaded runtime; it
yields the same numpy batches as the reference, bit for bit.

The paper's claim: OneFlow needs no DALI-style plugin — pipelining falls out
of giving the data-loading actors 2 out-registers each. We reproduce that
literally: loader -> preprocess -> stage(H2D) actors on separate OS threads
with register quotas, feeding the training loop through the req/ack protocol
(back-pressure included: a slow consumer stalls the loader instead of
unbounded buffering).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.runtime.actor import ActorSpec
from repro_torch.runtime.threaded import ThreadedRuntime


class SyntheticLM:
    """Synthetic token stream: deterministic, seeded, zipf-ish marginals."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab, self.batch, self.seq = vocab_size, batch, seq_len
        self.rng = np.random.default_rng(seed)

    def __call__(self, index: int) -> np.ndarray:
        # zipf-flavored ids, clipped to the vocab (cheap but non-uniform)
        z = self.rng.zipf(1.3, size=(self.batch, self.seq + 1))
        return (z % self.vocab).astype(np.int32)


def _augment(tokens: np.ndarray) -> np.ndarray:
    """Stand-in preprocessing (shift/copy) with real CPU cost."""
    return np.ascontiguousarray(tokens)


class ActorDataPipeline:
    """loader -> preprocess -> stage actor chain with register quotas.

    Iterating yields ready batches; the chain runs ahead by exactly
    ``buffers`` batches (the out-register quota), overlapping data work with
    the consumer's compute — Fig 6/Fig 9 behavior on real OS threads.
    """

    def __init__(self, source: Callable[[int], np.ndarray], num_batches: int,
                 buffers: int = 2, preprocess: Callable = _augment):
        self.source = source
        self.num_batches = num_batches
        self.buffers = buffers
        self.preprocess = preprocess
        self._thread: Optional[threading.Thread] = None
        self._build()

    def _build(self) -> None:
        """Persistent actor chain: built once, re-run per epoch. Actors reset
        at the start of each run; the loader's ``on_epoch`` hook rewinds the
        batch counter so every epoch replays the same stream."""
        self.out_q: "queue.Queue" = queue.Queue(maxsize=max(1, self.buffers))
        self._counter = [0]

        def load():
            i = self._counter[0]
            self._counter[0] += 1
            return self.source(i)

        def sink(x):
            self.out_q.put(x)  # bounded queue: blocking = back-pressure
            return 0

        def rewind(_ctx):
            self._counter[0] = 0

        specs = [
            ActorSpec("loader", load, (), out_regs=self.buffers, thread=0,
                      max_fires=self.num_batches, on_epoch=rewind),
            ActorSpec("preprocess", self.preprocess, ("loader",),
                      out_regs=self.buffers, thread=1),
            ActorSpec("stage", sink, ("preprocess",), out_regs=1, thread=2),
        ]
        self.rt = ThreadedRuntime(specs)

    def __iter__(self) -> Iterator[np.ndarray]:
        # a fresh output queue per epoch (sink reads the attribute at call
        # time), so an abandoned iteration can't leak stale batches
        self.out_q = queue.Queue(maxsize=max(1, self.buffers))
        self._thread = threading.Thread(
            target=lambda rt=self.rt: rt.run(timeout=3600), daemon=True)
        self._thread.start()
        for _ in range(self.num_batches):
            yield self.out_q.get()
        self._thread.join(timeout=10.0)

    @property
    def peak_buffered(self) -> int:
        return max(a.peak_regs_in_use for a in self.rt.by_name.values())


class SyncDataPipeline:
    """Baseline without actor prefetch (load+preprocess inline)."""

    def __init__(self, source, num_batches: int, preprocess=_augment):
        self.source, self.n, self.pre = source, num_batches, preprocess

    def __iter__(self):
        for i in range(self.n):
            yield self.pre(self.source(i))
