"""`CollectiveFabric`: ML collectives as descriptor traffic across N
iDMA engines sharing one contended memory system (the port of
`repro.dist.fabric`, host NumPy as the reference is).

This is the XDMA / DMA-Latte shape from PAPERS.md expressed over this
repo's engine: each rank owns one `IDMAEngine` (all built from one
`EngineSpec` via `core.spec.build_engines`, so they share a `MemoryMap`,
a `PlanCache`, and the *same* endpoint `MemSystem` objects), and a
collective is a schedule of phases, each phase one `DescriptorBatch`
per rank, lowered through the engine's normal plan-cache pipeline and
timed by ONE `simulate_channels` call whose channels contend for the
shared endpoints by object identity.

Completion is interrupt-driven, not polled: after a phase's functional
drain, each participating engine's `IrqController` receives a
`CompletionEvent`; the fabric's registered `on_complete` handlers count
ranks down and — when the last rank's interrupt fires — run the phase's
reduction hook and pull the *next* phase from the schedule generator.
The driver loop never inspects engine state between phases; the next
phase exists only because the completion interrupts pushed it.

Memory layout: the single shared protocol space is split into one
region per rank (``region_bytes`` each).  A rank's input/result vector
lives at the region base; receive scratch (reduce phases) and gather
output live in an aux area above it.  All transfers are pulls: rank r
reads from a peer's region into its own, so per-phase writes land only
in the writer's region and sequential functional execution of the ranks
is equivalent to the parallel hardware semantics.

Reduction arithmetic happens *between* phases (the hook), chunk-wise on
the shared buffer, in exactly the order the mirrored NumPy references
(`numpy_ring_allreduce` / `numpy_halving_allreduce`) use — so byte
identity against the reference holds for every dtype, including
non-associative floats.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import simulator as sim
from repro_torch.core.backend import FaultInjector, TransferError
from repro_torch.core.descriptor import (DescriptorBatch, Protocol,
                                         concat_batches)
from repro_torch.core.engine import ErrorPolicy
from repro_torch.core.frontend import CompletionEvent
from repro_torch.core.spec import (BackendSpec, ChannelSpec, EngineSpec,
                                   IrqSpec, build_engines)

#: aux-area alignment: a multiple of every protocol page size the
#: legalizer uses, so rank/aux bases never change burst cut structure
#: (also what lets the plan cache share captures across ranks — region
#: bases are congruent mod the plan-signature residue modulus)
_ALIGN = 4096


def _align_up(n: int) -> int:
    return -(-int(n) // _ALIGN) * _ALIGN


def _chunk_offsets(nelems: int, parts: int) -> List[int]:
    """Element offsets of an n-way split: balanced, exact, and aligned to
    element boundaries (non-divisible sizes give chunks differing by one
    element, never a torn element)."""
    return [(i * nelems) // parts for i in range(parts + 1)]


def fabric_spec(world: int = 4, *, region_bytes: int = 1 << 20,
                channels: int = 1, bus_width: int = 8,
                n_outstanding: int = 2,
                error_policy: Optional[ErrorPolicy] = None,
                plan_cache: int = 64) -> EngineSpec:
    """The default per-rank engine spec of a collective fabric: an
    HBM-class shared endpoint (latency 100, 64 outstanding) with a
    deliberately small per-engine request window (``n_outstanding``), so
    one engine cannot saturate the endpoint alone — the multi-engine
    speedup the paper's §V claims comes from overlapping the latency of
    several engines against the same memory system."""
    return EngineSpec(
        name=f"collective_fabric_x{world}",
        backend=BackendSpec(bus_width=bus_width, protocols=(Protocol.HBM,),
                            error_policy=error_policy or ErrorPolicy()),
        channels=ChannelSpec(count=channels),
        irq=IrqSpec(vectors=1),
        sim_config=sim.EngineConfig(bus_width=bus_width,
                                    n_outstanding=n_outstanding),
        src_system=sim.HBM,
        dst_system=sim.HBM,
        plan_cache=plan_cache,
        mem_spaces=((Protocol.HBM, world * int(region_bytes)),),
    )


@dataclass
class PhaseTrace:
    """One collective phase: its contended multi-channel timing result
    plus the per-channel streams (kept for the serial-replay baseline)."""

    name: str
    cycles: int
    backoff_cycles: int
    bytes_moved: int
    streams: List[DescriptorBatch] = field(default_factory=list)
    stream_beats: List[Optional[np.ndarray]] = field(default_factory=list)
    result: Optional[sim.ChannelSimResult] = None


@dataclass
class CollectiveTrace:
    """The phase-by-phase record of one collective operation."""

    op: str
    world: int
    phases: List[PhaseTrace] = field(default_factory=list)

    @property
    def total_cycles(self) -> int:
        """Phase-barriered makespan: phases run back to back (each phase
        needs the previous one's data), channels within a phase overlap."""
        return sum(p.cycles for p in self.phases)

    @property
    def total_bytes(self) -> int:
        return sum(p.bytes_moved for p in self.phases)


class CollectiveFabric:
    """N iDMA engines + one shared memory system = a collective fabric.

    ``fault_sites`` maps rank → `backend.FaultSite` list; burst ordinals
    are drain-global per rank *across the whole collective* (the cursor
    resets once per operation, not per phase), so a site index names one
    physical burst slot of the schedule.  The error verbs of the spec's
    `ErrorPolicy` apply per rank (replay recovers transients in place;
    abort posts the rank's error interrupt and propagates).
    """

    def __init__(self, world: int, *, region_bytes: int = 1 << 20,
                 channels: int = 1, spec: Optional[EngineSpec] = None,
                 plan_cache=None, error_policy: Optional[ErrorPolicy] = None,
                 fault_sites: Optional[Dict[int, Sequence]] = None,
                 max_burst: Optional[int] = 256,
                 sanitize: bool = False) -> None:
        if world < 1:
            raise ValueError("collective fabric needs world >= 1")
        if spec is None:
            spec = fabric_spec(world, region_bytes=int(region_bytes),
                               channels=channels, error_policy=error_policy)
        if len(spec.mem_spaces) != 1:
            raise ValueError("fabric spec needs exactly one shared space")
        # fabric traffic is cut into short bursts on purpose: against a
        # high-latency endpoint (HBM: 100 cycles) short bursts make each
        # engine latency-bound, and the multi-engine win comes from
        # overlapping those latencies — the paper's N-engines-one-port
        # scaling argument.  None = let the legalizer pick page bursts.
        self.max_burst = max_burst
        self.world = world
        self.region_bytes = spec.mem_spaces[0][1] // world
        self.spec = spec
        self.channels = spec.channels.count
        self.proto = spec.mem_spaces[0][0]
        self.engines = build_engines(spec, world, plan_cache=plan_cache)
        self.mem = self.engines[0].mem
        for rank, sites in dict(fault_sites or {}).items():
            self.engines[rank].fault_injector = FaultInjector(sites)
        for rank, eng in enumerate(self.engines):
            eng.on_complete(self._completion_handler(rank))
        #: opt-in phase-schedule certification (`repro_torch.sanitize`): every
        #: phase's rank→batch map is swept for cross-engine hazards
        #: (H006 — two engines touching overlapping bytes with no
        #: intra-phase ordering) before any byte moves; a flagged phase
        #: raises `SanitizeError`.  Per-phase reports accumulate on
        #: ``sanitize_reports`` (one per phase, in schedule order).
        self.sanitize = bool(sanitize)
        self.sanitize_reports: List[object] = []
        # phase-advance state driven by the completion interrupts
        self._pending: Optional[set] = None
        self._schedule = None
        self._hook = None
        self._next = None
        self._tid = 0

    # -- region layout ----------------------------------------------------

    def _base(self, rank: int) -> int:
        return rank * self.region_bytes

    def _require(self, need: int, op: str) -> None:
        if need > self.region_bytes:
            raise ValueError(
                f"{op}: needs {need} B per region, fabric regions are "
                f"{self.region_bytes} B — build the fabric with "
                f"region_bytes >= {need}")

    def _write(self, addr: int, arr: np.ndarray) -> None:
        self.mem.write(self.proto, addr,
                       np.ascontiguousarray(arr).reshape(-1).view(np.uint8))

    def _read(self, addr: int, nbytes: int, dtype, shape) -> np.ndarray:
        raw = np.array(self.mem.read(self.proto, addr, nbytes))
        return raw.view(dtype).reshape(shape)

    def _batch(self, src, dst, lengths) -> DescriptorBatch:
        k = self.channels
        if k > 1:
            # byte-slice each transfer into ~k contiguous pieces (cut on
            # max_burst boundaries so the burst structure is unchanged)
            # — gives the round-robin channel split actual rows to deal
            s2, d2, l2 = [], [], []
            for s, d, ln in zip(src, dst, lengths):
                ln = int(ln)
                piece = -(-ln // k)
                if self.max_burst:
                    piece = -(-piece // self.max_burst) * self.max_burst
                off = 0
                while off < ln:
                    step = min(piece, ln - off)
                    s2.append(int(s) + off)
                    d2.append(int(d) + off)
                    l2.append(step)
                    off += step
            src, dst, lengths = s2, d2, l2
        return DescriptorBatch.from_arrays(
            np.asarray(src, dtype=np.int64),
            np.asarray(dst, dtype=np.int64),
            np.asarray(lengths, dtype=np.int64),
            max_burst=self.max_burst,
            src_protocol=self.proto, dst_protocol=self.proto)

    # -- interrupt-driven phase engine ------------------------------------

    def _completion_handler(self, rank: int):
        def handler(vector, events) -> None:
            pending = self._pending
            if pending is None or rank not in pending:
                return
            if any(ev.status == "done" for ev in events):
                pending.discard(rank)
                if not pending:
                    # the LAST rank's completion interrupt advances the
                    # collective: reduce, then pull the next phase
                    self._phase_complete()
        return handler

    def _phase_complete(self) -> None:
        hook, self._hook = self._hook, None
        if hook is not None:
            hook()
        try:
            self._next = next(self._schedule)
        except StopIteration:
            self._next = None

    def _lower_rank(self, eng, batch: DescriptorBatch):
        """Lower one rank's phase batch through the engine's plan-cache
        pipeline, split across the spec's submission channels."""
        k = self.channels
        if k == 1:
            parts = [batch]
        else:
            parts = [batch.select(np.arange(c, len(batch), k))
                     for c in range(k)]
        beats_ok = eng.sim_config.bus_width == eng.bus_width
        lowered, streams, beats = [], [], []
        for part in parts:
            if not len(part):
                continue
            lps = [lp for lp in eng._lower_ports(part) if len(lp.batch)]
            if not lps:
                continue
            lowered.extend(lps)
            streams.append(concat_batches([lp.batch for lp in lps]))
            if beats_ok and all(lp.beats is not None for lp in lps):
                beats.append(lps[0].beats if len(lps) == 1 else
                             np.concatenate([lp.beats for lp in lps]))
            else:
                beats.append(None)
        return lowered, streams, beats

    def _run(self, op: str, schedule) -> CollectiveTrace:
        """Drive a phase schedule: per phase, one contended
        `simulate_channels` over every rank's lowered streams, the
        functional drains, then interrupt delivery — which (via the
        registered handlers) runs the reduction hook and fetches the
        next phase.  ``schedule`` yields ``(name, {rank: batch}, hook)``.
        """
        trace = CollectiveTrace(op=op, world=self.world)
        self._schedule = schedule
        for eng in self.engines:   # drain-global fault ordinals per op
            eng._burst_cursor = 0
        try:
            self._next = None
            self._phase_advance_first()
            cur = self._next
            while cur is not None:
                name, subs, self._hook = cur
                if self.sanitize:
                    from repro_torch.sanitize import SanitizeError, check_phase
                    report = check_phase(
                        {r: b for r, b in subs.items()
                         if b is not None and len(b)},
                        pipeline=self.spec.midend)
                    self.sanitize_reports.append((name, report))
                    if not report.clean:
                        raise SanitizeError(report)
                ranks: List[int] = []
                streams: List[DescriptorBatch] = []
                beats: List[Optional[np.ndarray]] = []
                lowered: Dict[int, list] = {}
                counts: Dict[int, int] = {}
                for r in sorted(subs):
                    batch = subs[r]
                    if batch is None or not len(batch):
                        continue
                    eng = self.engines[r]
                    lps, sts, bts = self._lower_rank(eng, batch)
                    if not sts:
                        continue
                    lowered[r] = lps
                    counts[r] = len(batch)
                    eng.stats.submitted += len(batch)
                    for s, b in zip(sts, bts):
                        ranks.append(r)
                        streams.append(s)
                        beats.append(b)
                if not streams:
                    # an empty phase (tiny vectors) still completes: run
                    # the hook and let the schedule advance
                    self._pending = set()
                    self._phase_complete()
                    cur = self._next
                    continue
                cfg = self.spec.effective_sim_config
                result = sim.simulate_channels(
                    streams, cfg,
                    (self.spec.src_system, self.spec.dst_system),
                    already_legal=True, beats=beats)
                # functional drains (error verbs + per-rank fault sites)
                backoff = 0
                rank_cycle: Dict[int, int] = {}
                for i, r in enumerate(ranks):
                    wend = result.burst_wend[i] if result.burst_wend else []
                    cyc = max(wend) if len(wend) else 0
                    rank_cycle[r] = max(rank_cycle.get(r, 0), int(cyc))
                for r in sorted(lowered):
                    eng = self.engines[r]
                    eng._drain_backoff = 0
                    try:
                        eng._run_ports(lowered[r])
                    except TransferError:
                        eng.stats.backoff_cycles += eng._drain_backoff
                        self._tid += 1
                        eng.irq.post(CompletionEvent(
                            tid=self._tid, count=counts[r], channel=0,
                            cycle=rank_cycle.get(r, 0), status="error",
                            bytes_moved=0))
                        eng.irq.flush()
                        raise
                    backoff += eng._drain_backoff
                    eng.stats.backoff_cycles += eng._drain_backoff
                # interrupt delivery — completions push the next phase
                self._pending = set(lowered)
                moved = {r: 0 for r in lowered}
                for s, r in zip(streams, ranks):
                    moved[r] += int(s.total_bytes)
                for r in sorted(lowered):
                    eng = self.engines[r]
                    self._tid += 1
                    eng.stats.completed += counts[r]
                    eng.irq.post(CompletionEvent(
                        tid=self._tid, count=counts[r], channel=0,
                        cycle=rank_cycle[r], status="done",
                        bytes_moved=moved[r]))
                    eng.irq.flush()
                if self._pending:
                    raise RuntimeError(
                        f"phase {name!r}: ranks {sorted(self._pending)} "
                        f"never delivered their completion interrupt")
                trace.phases.append(PhaseTrace(
                    name=name,
                    cycles=int(result.aggregate.cycles) + backoff,
                    backoff_cycles=backoff,
                    bytes_moved=sum(moved.values()),
                    streams=streams, stream_beats=beats, result=result))
                cur = self._next
        finally:
            self._pending = None
            self._schedule = None
            self._hook = None
            self._next = None
        return trace

    def _phase_advance_first(self) -> None:
        try:
            self._next = next(self._schedule)
        except StopIteration:
            self._next = None

    # -- baselines / raw transport ----------------------------------------

    def serial_cycles(self, trace: CollectiveTrace) -> int:
        """The single-engine baseline: every phase's streams re-timed
        back to back through ONE channel of one engine (same endpoint
        models, same legalized bursts).  The multi-engine speedup gate in
        the reference's ``benchmarks/collective_sweep.py`` is
        ``serial_cycles / trace.total_cycles``."""
        cfg = self.spec.effective_sim_config
        total = 0
        for ph in trace.phases:
            for s, b in zip(ph.streams, ph.stream_beats):
                total += int(sim.simulate_batch(
                    s, cfg, self.spec.src_system, self.spec.dst_system,
                    already_legal=True, beats=b).cycles)
        return total

    def transport(self, batches: Sequence[DescriptorBatch]
                  ) -> CollectiveTrace:
        """Raw one-phase transport: ``batches[r]`` is rank r's traffic.
        With ``world == 1`` and one channel this is cycle-identical to
        `simulate_batch` over the legalized batch (property-tested)."""
        if len(batches) > self.world:
            raise ValueError(f"{len(batches)} batches for world "
                             f"{self.world}")

        def schedule():
            yield ("transport", dict(enumerate(batches)), None)

        return self._run("transport", schedule())

    # -- collectives -------------------------------------------------------

    def _stage(self, arrays: Sequence[np.ndarray], op: str
               ) -> Tuple[List[np.ndarray], np.dtype, int, int, int]:
        arrs = [np.ascontiguousarray(a) for a in arrays]
        if len(arrs) != self.world:
            raise ValueError(f"{op}: {len(arrs)} shards for world "
                             f"{self.world}")
        if any(a.dtype != arrs[0].dtype or a.shape != arrs[0].shape
               for a in arrs):
            raise ValueError(f"{op}: shards must share shape and dtype")
        self._require(arrs[0].nbytes, op)
        for r, a in enumerate(arrs):
            self._write(self._base(r), a)
        dt = arrs[0].dtype
        return arrs, dt, arrs[0].size, dt.itemsize, arrs[0].nbytes

    def allreduce(self, shards: Sequence[np.ndarray], algo: str = "ring"
                  ) -> Tuple[List[np.ndarray], CollectiveTrace]:
        """Elementwise-sum allreduce: ``shards[r]`` is rank r's input;
        every rank's result is the sum over ranks.  ``algo``: ``"ring"``
        (bandwidth-optimal, 2(n-1) phases) or ``"halving"`` (recursive
        halving/doubling, 2·log2(n) phases; non-power-of-two worlds fall
        back to ring).  Returns (per-rank results, trace)."""
        if algo not in ("ring", "halving"):
            raise ValueError(f"unknown allreduce algo {algo!r}")
        arrs, dt, nelems, isz, nbytes = self._stage(shards, "allreduce")
        aux = _align_up(nbytes)
        shape = arrs[0].shape
        if self.world == 1:
            return [arrs[0].copy()], CollectiveTrace("allreduce", 1)
        use_halving = (algo == "halving"
                       and self.world & (self.world - 1) == 0)
        # scratch high-water: half the vector (first halving phase) or
        # one ring chunk
        peak = (nelems - nelems // 2) * isz if use_halving \
            else max(isz, -(-nbytes // self.world) + isz)
        self._require(aux + peak, "allreduce")
        sched = (self._halving_schedule(nelems, isz, dt, aux) if use_halving
                 else self._ring_schedule(nelems, isz, dt, aux))
        trace = self._run(f"allreduce[{algo}]", sched)
        out = [self._read(self._base(r), nbytes, dt, shape)
               for r in range(self.world)]
        return out, trace

    def _ring_schedule(self, nelems: int, isz: int, dtype, aux: int):
        n = self.world
        offs = [o * isz for o in _chunk_offsets(nelems, n)]
        for s in range(n - 1):          # reduce-scatter: pull + add
            subs: Dict[int, DescriptorBatch] = {}
            meta = []
            for r in range(n):
                c = (r - 1 - s) % n
                peer = (r - 1) % n
                ln = offs[c + 1] - offs[c]
                if ln == 0:
                    continue
                subs[r] = self._batch([self._base(peer) + offs[c]],
                                      [self._base(r) + aux], [ln])
                meta.append((r, offs[c], ln))

            def hook(meta=meta, dtype=dtype):
                buf = self.mem.space(self.proto)
                for r, off, ln in meta:
                    d0 = self._base(r)
                    own = buf[d0 + off:d0 + off + ln].view(dtype)
                    own += buf[d0 + aux:d0 + aux + ln].view(dtype)

            yield (f"reduce_scatter[{s}]", subs, hook)
        for s in range(n - 1):          # allgather: pull finished chunks
            subs = {}
            for r in range(n):
                c = (r - s) % n
                peer = (r - 1) % n
                ln = offs[c + 1] - offs[c]
                if ln == 0:
                    continue
                subs[r] = self._batch([self._base(peer) + offs[c]],
                                      [self._base(r) + offs[c]], [ln])
            yield (f"ring_gather[{s}]", subs, None)

    def _halving_schedule(self, nelems: int, isz: int, dtype, aux: int):
        n = self.world
        lo = [0] * n
        hi = [nelems] * n
        dist = n >> 1
        while dist >= 1:                # recursive-halving reduce-scatter
            subs: Dict[int, DescriptorBatch] = {}
            meta = []
            lo0, hi0 = list(lo), list(hi)
            for r in range(n):
                p = r ^ dist
                mid = lo0[r] + (hi0[r] - lo0[r]) // 2
                keep_lo, keep_hi = (mid, hi0[r]) if r & dist \
                    else (lo0[r], mid)
                lo[r], hi[r] = keep_lo, keep_hi
                ln = (keep_hi - keep_lo) * isz
                if ln == 0:
                    continue
                off = keep_lo * isz
                subs[r] = self._batch([self._base(p) + off],
                                      [self._base(r) + aux], [ln])
                meta.append((r, off, ln))

            def hook(meta=meta, dtype=dtype):
                buf = self.mem.space(self.proto)
                for r, off, ln in meta:
                    d0 = self._base(r)
                    own = buf[d0 + off:d0 + off + ln].view(dtype)
                    own += buf[d0 + aux:d0 + aux + ln].view(dtype)

            yield (f"halving_reduce[d={dist}]", subs, hook)
            dist >>= 1
        dist = 1
        while dist < n:                 # recursive-doubling allgather
            subs = {}
            lo0, hi0 = list(lo), list(hi)
            for r in range(n):
                p = r ^ dist
                ln = (hi0[p] - lo0[p]) * isz
                lo[r] = min(lo0[r], lo0[p])
                hi[r] = max(hi0[r], hi0[p])
                if ln == 0:
                    continue
                off = lo0[p] * isz
                subs[r] = self._batch([self._base(p) + off],
                                      [self._base(r) + off], [ln])
            yield (f"doubling_gather[d={dist}]", subs, None)
            dist <<= 1

    def allgather(self, shards: Sequence[np.ndarray]
                  ) -> Tuple[List[np.ndarray], CollectiveTrace]:
        """Ring allgather: every rank ends with the (world, *shape)
        stack of all shards.  Returns (per-rank results, trace)."""
        arrs, dt, nelems, isz, nbytes = self._stage(shards, "allgather")
        n = self.world
        aux = _align_up(nbytes)
        self._require(aux + n * nbytes, "allgather")

        def schedule():
            subs = {r: self._batch([self._base(r)],
                                   [self._base(r) + aux + r * nbytes],
                                   [nbytes])
                    for r in range(n)} if nbytes else {}
            yield ("local_copy", subs, None)
            for s in range(1, n):
                subs = {}
                for r in range(n):
                    c = (r - s) % n
                    peer = (r - 1) % n
                    if nbytes == 0:
                        continue
                    subs[r] = self._batch(
                        [self._base(peer) + aux + c * nbytes],
                        [self._base(r) + aux + c * nbytes], [nbytes])
                yield (f"ring_gather[{s}]", subs, None)

        trace = self._run("allgather", schedule())
        shape = (n,) + arrs[0].shape
        out = [self._read(self._base(r) + aux, n * nbytes, dt, shape)
               for r in range(n)]
        return out, trace

    def alltoall(self, shards: Sequence[np.ndarray]
                 ) -> Tuple[List[np.ndarray], CollectiveTrace]:
        """All-to-all: each rank's (flattened) shard splits into world
        chunks, chunk j going to rank j; rank r ends with the
        concatenation of chunk r from every rank (a 1-D array).
        Returns (per-rank results, trace)."""
        arrs, dt, nelems, isz, nbytes = self._stage(shards, "alltoall")
        n = self.world
        offs = [o * isz for o in _chunk_offsets(nelems, n)]
        aux = _align_up(nbytes)
        peak = max(offs[r + 1] - offs[r] for r in range(n)) * n
        self._require(aux + peak, "alltoall")

        def schedule():
            subs: Dict[int, DescriptorBatch] = {}
            for r in range(n):
                ln = offs[r + 1] - offs[r]
                if ln == 0:
                    continue
                subs[r] = self._batch(
                    [self._base(j) + offs[r] for j in range(n)],
                    [self._base(r) + aux + j * ln for j in range(n)],
                    [ln] * n)
            yield ("alltoall", subs, None)

        trace = self._run("alltoall", schedule())
        out = []
        for r in range(n):
            ln = offs[r + 1] - offs[r]
            out.append(self._read(self._base(r) + aux, n * ln, dt,
                                  (n * ln // isz,)))
        return out, trace


# -- mirrored NumPy references (tests + differential oracle) ---------------

def numpy_ring_allreduce(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Pure-NumPy mirror of the fabric's ring allreduce: same chunking,
    same phase-barriered accumulation order — byte-identical to the
    descriptor-lowered result for every dtype (and equal to a plain
    ``sum`` for exact dtypes)."""
    n = len(arrays)
    shape = arrays[0].shape
    data = [np.ascontiguousarray(a).ravel().copy() for a in arrays]
    if n == 1:
        return [data[0].reshape(shape)]
    offs = _chunk_offsets(data[0].size, n)
    for s in range(n - 1):
        recv = [(r, (r - 1 - s) % n,
                 data[(r - 1) % n][offs[(r - 1 - s) % n]:
                                   offs[(r - 1 - s) % n + 1]].copy())
                for r in range(n)]
        for r, c, seg in recv:
            data[r][offs[c]:offs[c + 1]] += seg
    for s in range(n - 1):
        recv = [(r, (r - s) % n,
                 data[(r - 1) % n][offs[(r - s) % n]:
                                   offs[(r - s) % n + 1]].copy())
                for r in range(n)]
        for r, c, seg in recv:
            data[r][offs[c]:offs[c + 1]] = seg
    return [d.reshape(shape) for d in data]


def numpy_halving_allreduce(arrays: Sequence[np.ndarray]
                            ) -> List[np.ndarray]:
    """Pure-NumPy mirror of the fabric's recursive halving/doubling
    allreduce (power-of-two worlds; others mirror the ring)."""
    n = len(arrays)
    if n & (n - 1):
        return numpy_ring_allreduce(arrays)
    shape = arrays[0].shape
    data = [np.ascontiguousarray(a).ravel().copy() for a in arrays]
    if n == 1:
        return [data[0].reshape(shape)]
    nelems = data[0].size
    lo = [0] * n
    hi = [nelems] * n
    dist = n >> 1
    while dist >= 1:
        lo0, hi0 = list(lo), list(hi)
        recv = []
        for r in range(n):
            p = r ^ dist
            mid = lo0[r] + (hi0[r] - lo0[r]) // 2
            keep_lo, keep_hi = (mid, hi0[r]) if r & dist else (lo0[r], mid)
            lo[r], hi[r] = keep_lo, keep_hi
            recv.append((r, keep_lo, keep_hi,
                         data[p][keep_lo:keep_hi].copy()))
        for r, a, b, seg in recv:
            data[r][a:b] += seg
        dist >>= 1
    dist = 1
    while dist < n:
        lo0, hi0 = list(lo), list(hi)
        recv = []
        for r in range(n):
            p = r ^ dist
            recv.append((r, lo0[p], hi0[p], data[p][lo0[p]:hi0[p]].copy()))
            lo[r] = min(lo0[r], lo0[p])
            hi[r] = max(hi0[r], hi0[p])
        for r, a, b, seg in recv:
            data[r][a:b] = seg
        dist <<= 1
    return [d.reshape(shape) for d in data]


def numpy_allgather(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    stacked = np.stack([np.ascontiguousarray(a) for a in arrays])
    return [stacked.copy() for _ in arrays]


def numpy_alltoall(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    n = len(arrays)
    flat = [np.ascontiguousarray(a).ravel() for a in arrays]
    offs = _chunk_offsets(flat[0].size, n)
    return [np.concatenate([flat[j][offs[r]:offs[r + 1]]
                            for j in range(n)]) for r in range(n)]
