"""Paged-KV block allocator: free list, refcounts, HOST swap slots.

The accounting half of the continuous-batching scheduler — pure host
bookkeeping with no byte movement.  Every allocation decision it makes
turns into descriptor traffic built by `serve.kvcache`
(`gather_descriptors` / `span_append_descriptors` / `swap_descriptors`)
and dispatched by `serve.sched.front.ServeFrontDoor`, so the pool it
manages is literally the engine's HBM space.

One *block* is one physical page id covering both pools (the K page at
``block * page_bytes`` and the V page at ``pool_bytes + block *
page_bytes`` — the `PagedKVDMA` convention).  One *swap slot* is one
block's worth of HOST backing store (``2 * page_bytes``).

The ``low_watermark`` is the admission headroom: the scheduler refuses
to admit or resume a request if doing so would leave fewer than
``low_watermark`` free blocks, and preempts (swap-out) once the free
pool dips to the watermark — decode growth of already-running requests
is what the reserve is *for*, so growth allocations may consume it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class AllocStats:
    """Lifetime counters (never reset; the leak check uses the gauges
    on the allocator itself, not these)."""

    allocated: int = 0          # blocks handed out
    freed: int = 0              # blocks returned
    failures: int = 0           # alloc() calls refused for exhaustion
    preemptions: int = 0        # scheduler-recorded swap-out decisions
    swapped_out: int = 0        # blocks evicted to HOST slots
    swapped_in: int = 0         # blocks restored from HOST slots
    peak_used: int = 0


@dataclass
class BlockAllocator:
    """Free-list + refcount allocator over ``n_blocks`` pool blocks and
    ``n_swap_slots`` HOST swap slots."""

    n_blocks: int
    n_swap_slots: int = 0
    low_watermark: int = 0
    stats: AllocStats = field(default_factory=AllocStats)

    def __post_init__(self) -> None:
        if self.n_blocks <= 0:
            raise ValueError("BlockAllocator needs n_blocks >= 1")
        if not 0 <= self.low_watermark < self.n_blocks:
            raise ValueError(f"low_watermark {self.low_watermark} must be "
                             f"in [0, {self.n_blocks})")
        # LIFO stacks, seeded so first allocations come out ascending
        self._free: List[int] = list(range(self.n_blocks))[::-1]
        self._ref = [0] * self.n_blocks
        self._swap_free: List[int] = list(range(self.n_swap_slots))[::-1]

    # -- gauges -------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def free_swap_slots(self) -> int:
        return len(self._swap_free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def above_watermark(self, n: int) -> bool:
        """Would allocating ``n`` blocks keep the free pool at or above
        the low watermark?  (The admission / swap-in guard.)"""
        return len(self._free) - n >= self.low_watermark

    # -- pool blocks --------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks (refcount 1 each); `MemoryError` if the free
        list is short — callers check `can_alloc` first and treat the
        raise as a bug."""
        if n > len(self._free):
            self.stats.failures += 1
            raise MemoryError(f"KV pool exhausted: want {n}, "
                              f"have {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.stats.allocated += n
        self.stats.peak_used = max(self.stats.peak_used, self.used_blocks)
        return out

    def incref(self, blocks) -> None:
        """Share blocks (prefix sharing / fork); pairs with `decref`."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"incref on free block {b}")
            self._ref[b] += 1

    def decref(self, blocks) -> None:
        """Drop one reference per block; a block returns to the free list
        when its count reaches zero."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"decref on free block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                self.stats.freed += 1

    # -- HOST swap slots ----------------------------------------------------

    def can_alloc_swap(self, n: int) -> bool:
        return len(self._swap_free) >= n

    def alloc_swap(self, n: int) -> List[int]:
        if n > len(self._swap_free):
            raise MemoryError(f"swap space exhausted: want {n}, "
                              f"have {len(self._swap_free)} free")
        return [self._swap_free.pop() for _ in range(n)]

    def free_swap(self, slots) -> None:
        for s in slots:
            if not 0 <= s < self.n_swap_slots or s in self._swap_free:
                raise ValueError(f"bad swap slot free: {s}")
            self._swap_free.append(s)

    # -- invariants ---------------------------------------------------------

    def leaked(self) -> List[int]:
        """Block ids still referenced — empty at drain iff no leak."""
        return [b for b, r in enumerate(self._ref) if r > 0]

    def check(self) -> None:
        """Structural invariants, cheap enough to run per test: the free
        list and the referenced set partition the pool exactly."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate block on the free list")
        held = {b for b, r in enumerate(self._ref) if r > 0}
        if free & held:
            raise AssertionError(f"blocks both free and held: "
                                 f"{sorted(free & held)}")
        if len(free) + len(held) != self.n_blocks:
            raise AssertionError(
                f"{self.n_blocks - len(free) - len(held)} blocks "
                f"unaccounted for")
        swap = set(self._swap_free)
        if len(swap) != len(self._swap_free):
            raise AssertionError("duplicate swap slot on the free list")
