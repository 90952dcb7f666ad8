"""Constrained-random multi-engine collective programs.

The scalar-oracle differential idea of `generator`/`harness`, lifted to
the fabric: a seeded program picks an engine count, a collective op, a
dtype, an awkward message size, a channel count, and per-rank fault
sites; the fabric executes it as descriptor traffic across N engines on
one contended `MemSystem`, and the result is differenced byte-for-byte
against the pure-NumPy schedule mirror.  A second run on the same warm
fabric then checks the plan-cache replay path: identical bytes and
identical backoff-free cycles (a cached plan must lower to exactly the
traffic a fresh lowering produces).

Everything derives from ``default_rng(SeedSequence([0xC011, seed]))`` —
same seed, same program, so ``--replay`` works here too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import ErrorPolicy, FaultSite
from repro_torch.dist.fabric import (CollectiveFabric, numpy_allgather,
                                     numpy_alltoall, numpy_halving_allreduce,
                                     numpy_ring_allreduce)

_OPS = ("ring", "halving", "allgather", "alltoall")
_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint8,
           np.float16)


@dataclass
class CollectiveProgram:
    """One seeded fabric workload (see module docstring)."""

    seed: int
    world: int
    op: str
    dtype: str
    nelems: int
    channels: int
    max_burst: Optional[int]
    fault_sites: Dict[int, List[FaultSite]] = field(default_factory=dict)
    mem_seed: int = 0

    @property
    def num_rows(self) -> int:
        # descriptor rows per run, op-dependent; close enough for totals
        n = self.world
        if n == 1:
            return 1
        if self.op in ("ring", "halving"):
            return 2 * (n - 1) * n
        if self.op == "allgather":
            return n * n
        return n * n            # alltoall

    def describe(self) -> str:
        lines = [
            f"collective program seed={self.seed}",
            f"  op={self.op} world={self.world} channels={self.channels}",
            f"  payload: {self.nelems} x {self.dtype}"
            + (f" max_burst={self.max_burst}" if self.max_burst else ""),
        ]
        for rank, sites in sorted(self.fault_sites.items()):
            for s in sites:
                lines.append(
                    f"  rank {rank} fault @burst {s.index}: {s.kind}"
                    + (f" hits={s.hits}" if s.kind == "transient" else "")
                    + (f" stall={s.stall_cycles}" if s.kind == "stall"
                       else ""))
        return "\n".join(lines)


@dataclass
class CollectiveDivergence:
    program: CollectiveProgram
    phase: str          # "result" | "replay" | "cycles" | "crash"
    detail: str

    def __str__(self) -> str:
        return (f"collective divergence (seed {self.program.seed}, "
                f"{self.program.op} world={self.program.world} "
                f"{self.program.nelems}x{self.program.dtype}) "
                f"[{self.phase}]: {self.detail}")


def generate_collective_program(seed: int) -> CollectiveProgram:
    rng = np.random.default_rng(np.random.SeedSequence([0xC011, seed]))
    world = int(rng.choice([1, 2, 4], p=[0.2, 0.3, 0.5]))
    op = str(_OPS[int(rng.integers(0, len(_OPS)))])
    dtype = _DTYPES[int(rng.integers(0, len(_DTYPES)))]
    # size mix biased toward awkward values: primes, odd counts, and
    # non-multiples of every world size, plus the occasional big vector
    kind = int(rng.choice(3, p=[0.5, 0.3, 0.2]))
    if kind == 0:
        nelems = int(rng.integers(1, 130))
    elif kind == 1:
        nelems = int(rng.integers(100, 2049))
    else:
        nelems = int(rng.integers(2048, 16385))
    channels = int(rng.choice([1, 2]))
    max_burst = int(rng.choice([64, 256, 1024])) \
        if rng.random() < 0.7 else None

    fault_sites: Dict[int, List[FaultSite]] = {}
    if rng.random() < 0.4:
        approx_bursts = max(4, 2 * world)
        for _ in range(int(rng.integers(1, 4))):
            rank = int(rng.integers(0, world))
            kind = str(rng.choice(["transient", "stall"], p=[0.6, 0.4]))
            site = FaultSite(
                index=int(rng.integers(0, 4 * approx_bursts)),
                kind=kind,
                hits=int(rng.integers(1, 3)) if kind == "transient" else 1,
                stall_cycles=int(rng.integers(5, 51))
                if kind == "stall" else 0)
            fault_sites.setdefault(rank, []).append(site)

    return CollectiveProgram(
        seed=seed, world=world, op=op, dtype=np.dtype(dtype).name,
        nelems=nelems, channels=channels, max_burst=max_burst,
        fault_sites=fault_sites, mem_seed=int(rng.integers(0, 1 << 31)))


def _shards(program: CollectiveProgram) -> List[np.ndarray]:
    rng = np.random.default_rng(program.mem_seed)
    dt = np.dtype(program.dtype)
    if np.issubdtype(dt, np.floating):
        return [rng.standard_normal(program.nelems).astype(dt)
                for _ in range(program.world)]
    hi = min(int(np.iinfo(dt).max), 100)
    return [rng.integers(0, hi, program.nelems).astype(dt)
            for _ in range(program.world)]


def _reference(program: CollectiveProgram,
               shards: List[np.ndarray]) -> List[np.ndarray]:
    if program.op == "ring":
        return numpy_ring_allreduce(shards)
    if program.op == "halving":
        return numpy_halving_allreduce(shards)
    if program.op == "allgather":
        return numpy_allgather(shards)
    return numpy_alltoall(shards)


def _region_bytes(program: CollectiveProgram) -> int:
    nbytes = program.nelems * np.dtype(program.dtype).itemsize
    # allgather needs aux + world copies; round generously to pow2
    need = 4096 + nbytes * (program.world + 2)
    size = 1 << 14
    while size < need:
        size <<= 1
    return size


def _run_once(fab: CollectiveFabric, program: CollectiveProgram,
              shards: List[np.ndarray]):
    if program.op in ("ring", "halving"):
        return fab.allreduce(shards, algo=program.op)
    if program.op == "allgather":
        return fab.allgather(shards)
    return fab.alltoall(shards)


def check_collective_program(program: CollectiveProgram
                             ) -> Optional[CollectiveDivergence]:
    """Run the program twice (cold, then plan-cache warm) and difference
    both runs against the NumPy mirror.  Returns None on agreement."""
    shards = _shards(program)
    ref = _reference(program, shards)
    # faults must be recoverable: replay policy with headroom for the
    # generated transient hit counts
    policy = ErrorPolicy(action="replay", max_replays=3)
    try:
        fab = CollectiveFabric(
            program.world, region_bytes=_region_bytes(program),
            channels=program.channels, error_policy=policy,
            fault_sites=program.fault_sites, max_burst=program.max_burst)
        out1, trace1 = _run_once(fab, program, shards)
    except Exception as e:        # noqa: BLE001 — any crash is a finding
        return CollectiveDivergence(program, "crash",
                                    f"{type(e).__name__}: {e}")
    for rank, (got, want) in enumerate(zip(out1, ref)):
        if got.tobytes() != want.tobytes():
            bad = int(np.flatnonzero(
                got.reshape(-1) != want.reshape(-1))[0])
            return CollectiveDivergence(
                program, "result",
                f"rank {rank} differs from NumPy mirror at element {bad}: "
                f"got {got.reshape(-1)[bad]!r} want "
                f"{want.reshape(-1)[bad]!r}")
    # warm replay: plan cache hits, identical bytes, identical
    # backoff-free cycles (fault sites were consumed in run 1)
    try:
        out2, trace2 = _run_once(fab, program, shards)
    except Exception as e:        # noqa: BLE001
        return CollectiveDivergence(program, "crash",
                                    f"warm replay {type(e).__name__}: {e}")
    for rank, (got, want) in enumerate(zip(out2, ref)):
        if got.tobytes() != want.tobytes():
            return CollectiveDivergence(
                program, "replay",
                f"rank {rank}: warm plan-cache replay diverges from the "
                f"cold run's bytes")
    c1 = sum(p.cycles - p.backoff_cycles for p in trace1.phases)
    c2 = sum(p.cycles - p.backoff_cycles for p in trace2.phases)
    if c1 != c2:
        return CollectiveDivergence(
            program, "cycles",
            f"backoff-free cycles changed under plan-cache replay: "
            f"cold {c1}, warm {c2}")
    return None


def shrink_collective_program(program: CollectiveProgram,
                              divergence: CollectiveDivergence
                              ) -> Tuple[CollectiveProgram,
                                         CollectiveDivergence]:
    """Greedy structural shrink: smaller payload, fewer ranks, fewer
    fault sites — keeping the program divergent at every step."""
    cur, cur_d = program, divergence

    def attempt(cand: CollectiveProgram) -> bool:
        nonlocal cur, cur_d
        d = check_collective_program(cand)
        if d is not None:
            cur, cur_d = cand, d
            return True
        return False

    import dataclasses
    # payload first — halve until it stops reproducing
    while cur.nelems > 1:
        if not attempt(dataclasses.replace(cur,
                                           nelems=max(1, cur.nelems // 2))):
            break
    for world in (2, 1):
        if cur.world > world:
            sites = {r: s for r, s in cur.fault_sites.items() if r < world}
            attempt(dataclasses.replace(cur, world=world,
                                        fault_sites=sites))
    if cur.fault_sites:
        attempt(dataclasses.replace(cur, fault_sites={}))
    if cur.channels > 1:
        attempt(dataclasses.replace(cur, channels=1))
    if cur.max_burst is not None:
        attempt(dataclasses.replace(cur, max_burst=None))
    return cur, cur_d
