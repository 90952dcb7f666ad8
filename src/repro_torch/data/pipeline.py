"""Data pipeline: deterministic synthetic LM source + rt_3D prefetcher
(the port of `repro.data.pipeline`).

The source generates token streams with the Init pseudo-protocol's
splitmix32 counter PRNG, keyed by (seed, step, position): fully
deterministic and *seekable*, which is what makes the trainer's `replay`
error-handler verb exact — re-running step k reproduces its batch bit for
bit with no pipeline state.  Its batches are the reference's, bit for
bit (NumPy int32).

The `Prefetcher` realizes the ControlPULP `rt_3D` integration (paper
§3.2): a descriptor describes the periodic (batch, seq) transfer and the
prefetcher keeps `lookahead` batches in flight ahead of the consumer —
the host (the 'manager core') is out of the per-step loop.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.core import NdTransfer, RtConfig, TensorDim
from repro_torch.core.backend import splitmix32


@dataclass
class SyntheticLMSource:
    """Deterministic synthetic token batches."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        n = self.global_batch * self.seq_len
        base = np.uint64(self.seed) * np.uint64(0x1000003) + \
            np.uint64(step) * np.uint64(n)
        ctr = (np.arange(n, dtype=np.uint64) + base) % (1 << 32)
        bits = splitmix32(ctr.astype(np.uint32))
        tokens = (bits % np.uint32(self.vocab_size)).astype(np.int32)
        return {"tokens": tokens.reshape(self.global_batch, self.seq_len)}

    def descriptor(self) -> NdTransfer:
        """The rt_3D transfer shape: batch rows of seq tokens (int32)."""
        row = self.seq_len * 4
        return NdTransfer(
            src_addr=0, dst_addr=0, inner_length=row,
            dims=(TensorDim(row, row, self.global_batch),))


class Prefetcher:
    """rt_3D-style autonomous prefetch: keeps `lookahead` batches ready.

    `put_fn` (default: identity) models the host→device transfer — the
    trainer's moves each array of a batch to its device as a tensor.
    """

    def __init__(self, source, start_step: int = 0, lookahead: int = 2,
                 put_fn: Optional[Callable] = None) -> None:
        self.source = source
        self.lookahead = max(1, lookahead)
        self.put_fn = put_fn or (lambda x: x)
        self.rt = RtConfig(period=1, num_launches=0)
        self._queue: collections.deque = collections.deque()
        self._next = start_step
        self._fill()

    def _fill(self) -> None:
        while len(self._queue) < self.lookahead:
            step = self._next
            self._queue.append((step, self.put_fn(self.source.batch(step))))
            self._next += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._queue.popleft()
        self._fill()
        return step, batch

    def seek(self, step: int) -> None:
        """Exact replay/restart support: reposition the stream."""
        self._queue.clear()
        self._next = step
        self._fill()


def make_pipeline(vocab_size: int, seq_len: int, global_batch: int,
                  seed: int = 0, start_step: int = 0,
                  put_fn: Optional[Callable] = None) -> Prefetcher:
    src = SyntheticLMSource(vocab_size, seq_len, global_batch, seed)
    return Prefetcher(src, start_step=start_step, put_fn=put_fn)
