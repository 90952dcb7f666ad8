"""IDMAEngine — compose front-end(s), mid-end chain, back-end(s) (Fig. 1).

Engines are preferably *built from specs* (`core.spec.EngineSpec` via
``build_engine``, or a named preset like ``pulp_cluster()``); the kwarg
constructor here is the legacy shim.  The engine owns:
  * a mid-end chain — typed `core.spec.MidendStage` pipeline stages
    rewriting `DescriptorBatch`es on the vectorized plane (plus the
    deprecated object-level callables rewriting descriptor lists),
  * one or more back-end ports (address-boundary-distributed, MemPool
    style, when more than one),
  * N submission channels with an asynchronous control plane
    (`submit_async` / `dispatch_batch` → `poll` → `wait_all`) backed by
    per-channel queues and completion records; the synchronous `submit`
    is a thin enqueue-then-drain adapter,
  * an error handler with the paper's three verbs: continue / abort /
    replay (§2.3),
  * both execution fabrics: the *functional* one (bytes move through
    `core.backend`) and the *timing* one (`core.simulator` — concurrent
    channels share endpoints via `simulate_channels`).

It also exposes `plan_nd_copy`, the bridge used by the Pallas kernel layer:
a `tensor_nd` plan legalized into TPU-tile terms (grid + block shapes),
which `kernels/copy_engine` consumes to build its `BlockSpec`s.
"""

from __future__ import annotations

import bisect
import dataclasses
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import simulator as sim
from .backend import (ExecHints, FaultInjector, MemoryMap, PageFault,
                      TransferError, execute_batch)
from .descriptor import (DescriptorBatch, NdTransfer, Transfer1D,
                         concat_batches)
from .frontend import CompletionEvent, IrqController
from .legalizer import legalize_batch, legalize_tile
from .midend import mp_dist_batch, mp_split_batch, tensor_nd_batch
from .plan import PlanCache

Descriptor = Union[Transfer1D, NdTransfer]


@dataclass
class LoweredPort:
    """One back-end port's legalized burst stream plus the captured-plan
    artifacts that let both fabrics skip recomputation on replayed
    submissions: `prechecked` marks streams whose legality was gated by
    `check_legal_batch` at plan capture, `beats` feeds the timing model,
    `hints` the functional back-end."""

    batch: DescriptorBatch
    prechecked: bool = False
    beats: Optional[np.ndarray] = None
    hints: Optional[ExecHints] = None


@dataclass
class ErrorPolicy:
    """Paper §2.3 error handler, extended with the virtual-memory verbs:
    on a failing burst (or a page fault during lowering) the engine
    pauses, reports the offender, and the policy chooses one of
    continue / abort / replay / pin / retry.

    The two virtual-memory verbs act on *page faults* raised by a
    translating mid-end stage (`repro_torch.core.vm.TranslateStage`):
    ``"pin"`` maps the faulting page on demand through the page table's
    pin allocator and re-lowers; ``"retry"`` invokes the engine's
    ``page_fault_handler`` (the OS model) and re-lowers, up to
    ``max_replays`` attempts per page.  On ordinary execution faults
    both degrade to the replay verb.

    ``replay_backoff`` models the retry penalty of a real error handler
    (re-arbitrating the port, re-fetching the burst, a fault-handler
    round trip).  The penalty is *exponential* in the per-burst (or
    per-page) attempt number — ``replay_backoff << attempt`` cycles,
    deterministically capped at ``backoff_cap`` — accumulated on the
    drain's timing and surfaced on `ChannelSimResult.backoff_cycles`
    (and folded into ``total_cycles``); the functional byte movement is
    unaffected.

    Every field is validated eagerly at construction — a typo must fail
    the instantiation, not surface as undefined behaviour deep inside
    the drain loop of the first failing transfer."""

    #: the paper's three error-handler verbs (§2.3) + the VM fault verbs
    VERBS = ("continue", "abort", "replay", "pin", "retry")

    action: str = "replay"
    max_replays: int = 3
    replay_backoff: int = 0       # base cycles per replayed burst
    backoff_cap: int = 1 << 16    # deterministic exponential-backoff cap

    def __post_init__(self) -> None:
        if self.action not in self.VERBS:
            raise ValueError(
                f"unknown error-policy action {self.action!r}: the "
                f"handler verbs are {', '.join(map(repr, self.VERBS))}")
        if self.max_replays < 0:
            raise ValueError(
                f"max_replays must be >= 0, got {self.max_replays}")
        if self.replay_backoff < 0:
            raise ValueError(
                f"replay_backoff must be >= 0, got {self.replay_backoff}")
        if self.backoff_cap < 1:
            raise ValueError(
                f"backoff_cap must be >= 1, got {self.backoff_cap}")

    def backoff_for(self, attempt: int) -> int:
        """Penalty cycles of the ``attempt``-th retry (0-based) of one
        burst/page: ``replay_backoff * 2**attempt``, capped."""
        if self.replay_backoff <= 0:
            return 0
        return min(self.replay_backoff << min(attempt, 62),
                   self.backoff_cap)


@dataclass
class EngineStats:
    submitted: int = 0
    completed: int = 0
    bytes_moved: int = 0
    bursts: int = 0
    errors: int = 0
    replays: int = 0
    #: per-verb error-handler invocation counts (fault-storm visibility)
    continues: int = 0
    aborts: int = 0
    pins: int = 0
    retries: int = 0
    #: page faults seen (raised by translation, or dropped by continue)
    page_faults: int = 0
    #: error-handler retry/stall penalty cycles accumulated across drains
    #: (`ErrorPolicy.backoff_for` per attempt, plus injected stalls)
    backoff_cycles: int = 0
    #: submissions that could not be served by a configured plan cache
    #: (multi-back-end split, or an unsigned custom pipeline stage) —
    #: a silently-bypassing engine now shows up in its own stats
    plan_bypasses: int = 0


@dataclass
class CompletionRecord:
    """Submission-queue completion record (Benz et al. 2025 style):
    one record per `submit_async`/`dispatch_batch` call, covering
    `count` consecutive transfer ids starting at `tid`.  A sharded
    dispatch flips to "done" only once every shard (`pending` queue
    items) has drained; an "error" is terminal."""

    tid: int
    count: int = 1
    channel: int = -1            # -1: sharded across channels
    status: str = "pending"      # "pending" | "done" | "error"
    bytes_moved: int = 0
    pending: int = 1             # queue items not yet drained
    #: pages the continue verb dropped while lowering this submission's
    #: shards, as (space name, vpn) in first-occurrence order — the
    #: faulted-page bitmap of a partially completed transfer
    faulted_pages: Tuple = ()

    def covers(self, tid: int) -> bool:
        return self.tid <= tid < self.tid + self.count


class IDMAEngine:
    """A concrete iDMAE instance.

    The preferred construction path is declarative: compose an
    `core.spec.EngineSpec` and call ``build_engine(spec)`` (or one of the
    named presets — ``build_engine(pulp_cluster())``).  This kwarg
    constructor is kept as a thin legacy shim; the composition it
    describes is available as an equivalent spec via the ``spec``
    property.

    ``pipeline`` is the typed mid-end chain (`core.spec.MidendStage`
    objects rewriting `DescriptorBatch` → `DescriptorBatch`): it stays on
    the vectorized path and remains plan-cacheable.  ``midends`` is the
    deprecated object-level chain (``List[Transfer1D]`` callables) — it
    forces the object bridge and can never be plan-cached, so combining
    it with ``plan_cache=`` is a construction error.
    """

    def __init__(
        self,
        mem: Optional[MemoryMap] = None,
        midends: Sequence[Callable[[List[Transfer1D]], List[Transfer1D]]] = (),
        num_backends: int = 1,
        backend_boundary: int = 0,
        bus_width: int = 8,
        error_policy: Optional[ErrorPolicy] = None,
        sim_config: Optional[sim.EngineConfig] = None,
        src_system: sim.MemSystem = sim.SRAM,
        dst_system: sim.MemSystem = sim.SRAM,
        num_channels: int = 1,
        channel_scheme: str = "round_robin",
        channel_boundary: int = 0,
        plan_cache: Optional[PlanCache] = None,
        pipeline: Sequence[object] = (),
        irq: Optional[object] = None,
        sanitize: Union[bool, str] = False,
    ) -> None:
        if num_backends > 1 and backend_boundary <= 0:
            raise ValueError("multi-back-end engines need backend_boundary")
        if num_channels < 1:
            raise ValueError("num_channels must be >= 1")
        if channel_scheme == "address" and channel_boundary <= 0:
            raise ValueError("address channel scheme needs channel_boundary")
        if midends and plan_cache is not None:
            # Silently bypassing the cache on every submission is the trap
            # this used to be; a spec pipeline is the cacheable expression
            # of the same composition.
            raise ValueError(
                "plan_cache= cannot be combined with object-level midends=:"
                " legacy List[Transfer1D] callables are not plan-cacheable"
                " and would bypass the cache on every submission. Express"
                " the chain as core.spec.MidendStage pipeline stages"
                " (pipeline=/EngineSpec.midend), or drop the plan cache.")
        if midends:
            warnings.warn(
                "object-level midends= callables are deprecated: they force"
                " the per-object descriptor bridge off the vectorized path;"
                " use core.spec.MidendStage pipeline stages instead",
                DeprecationWarning, stacklevel=2)
        self.mem = mem
        self.midends = list(midends)
        self.pipeline = tuple(pipeline)
        self.num_backends = num_backends
        self.backend_boundary = backend_boundary
        self.bus_width = bus_width
        self.error_policy = error_policy or ErrorPolicy()
        self.sim_config = sim_config or sim.EngineConfig(
            bus_width=bus_width,
            num_midends=len(self.midends) + len(self.pipeline))
        self.src_system = src_system
        self.dst_system = dst_system
        self.num_channels = num_channels
        self.channel_scheme = channel_scheme
        self.channel_boundary = channel_boundary
        #: opt-in compile-once / replay-many submission pipeline: when set,
        #: structurally repeated submissions skip the mid-end/legalizer
        #: entirely (plan capture → address rebind; see `core.plan`).
        #: Spec pipelines are plannable (per-stage structural signatures);
        #: multi-back-end splits and unsigned custom stages are not —
        #: those engines bypass the cache per submission, counted in
        #: ``stats.plan_bypasses``.
        self.plan_cache = plan_cache
        self._plannable = (not self.midends and num_backends == 1 and
                           all(getattr(st, "signature", lambda: None)()
                               is not None for st in self.pipeline))
        #: the `EngineSpec` this engine was built from (`build_engine`),
        #: or a lazily derived snapshot for kwarg-built engines
        self._spec = None
        self.stats = EngineStats()
        self._next_id = 1
        self._last_completed = 0
        self._fail_at: Optional[int] = None  # fault injection for tests
        # per-channel submission queues of (first_tid, channel, payload);
        # payload is a Descriptor or a DescriptorBatch shard
        self._queues: List[List[Tuple[int, int, object]]] = [
            [] for _ in range(num_channels)]
        self._records: List[CompletionRecord] = []   # ascending first tid
        self._record_starts: List[int] = []          # parallel, for bisect
        self._rr = 0                                 # round-robin cursor
        #: timing result of the last `wait_all` drain
        self.last_channel_result: Optional[sim.ChannelSimResult] = None
        #: completion-interrupt front-end (MSI-X style): `wait_all` marks
        #: records by *delivering* completion events through this
        #: controller in `simulate_channels` event order; `poll` stays as
        #: the register-read adapter over the records it marks.  `irq` is
        #: a `core.spec.IrqSpec` (duck-typed here to avoid the circular
        #: spec import) or None for immediate per-event delivery.
        self.irq_spec = irq
        vectors = getattr(irq, "vectors", 0) or num_channels
        self.irq = IrqController(
            num_vectors=vectors,
            coalesce_count=getattr(irq, "coalesce_count", 1),
            coalesce_cycles=getattr(irq, "coalesce_cycles", 0))
        self.irq.register(self._irq_complete)
        #: opt-in static sanitizer (`repro_torch.sanitize`): when truthy,
        #: every `wait_all` sweeps the queued programs for hazards before
        #: the drain touches memory, and plan-cache hits are audited
        #: against a from-scratch lowering.  ``"raise"`` (or ``True``) raises
        #: `SanitizeError` on an error-severity finding; ``"warn"`` emits
        #: a warning and drains anyway.
        if sanitize not in (False, True, "raise", "warn"):
            raise ValueError(
                f"sanitize must be False, True, 'raise' or 'warn', "
                f"got {sanitize!r}")
        self.sanitize = "raise" if sanitize is True else sanitize
        #: sanitizer reports of this engine's drains / plan audits (only
        #: populated when `sanitize` is enabled)
        self.sanitize_reports: List[object] = []
        #: verification fault-injection hook (`backend.FaultInjector`):
        #: seeded deterministic fault sites consulted by the drain loop,
        #: indexed by drain-global burst ordinal
        self.fault_injector: Optional[FaultInjector] = None
        self._burst_cursor = 0       # drain-global burst ordinal
        self._drain_backoff = 0      # replay/stall penalty of this drain
        #: whether any pipeline stage rewrites address values (VA→PA):
        #: routes page faults and post-rebind value application
        self._has_translate = any(getattr(st, "translates", False)
                                  for st in self.pipeline)
        #: the OS model of the ``retry`` verb: ``handler(fault, attempt)``
        #: is invoked on every page fault the retry/replay policy absorbs
        #: (typically it maps the page); None leaves recovery to `pin`
        #: or to exhaustion
        self.page_fault_handler: Optional[
            Callable[[PageFault, int], None]] = None
        #: pages dropped by the continue verb during the most recent
        #: `_lower_ports` call, as (space name, vpn)
        self._last_lower_faults: List[Tuple[str, int]] = []

    @property
    def spec(self) -> "EngineSpec":
        """The `core.spec.EngineSpec` this engine realizes — the one it
        was built from (`build_engine`), or an equivalent snapshot derived
        from the legacy kwargs."""
        if self._spec is None:
            from .spec import spec_of
            self._spec = spec_of(self)
        return self._spec

    # -- front-end interface ------------------------------------------------

    def submit(self, transfer: Descriptor) -> int:
        """Synchronous submission — a thin adapter over the asynchronous
        queue: enqueue one descriptor, then drain (`wait_all`)."""
        tid = self.submit_async(transfer)
        self.wait_all()
        return tid

    def submit_async(self, transfer: Descriptor,
                     channel: Optional[int] = None) -> int:
        """Enqueue a descriptor on a channel's submission queue and return
        its transfer id immediately — nothing moves until `wait_all`.

        Channel selection is round-robin unless `channel` pins one (the
        core-private front-end case: one channel per PE).
        """
        tid = self._next_id
        self._next_id += 1
        transfer = dataclasses.replace(transfer, transfer_id=tid)
        if channel is None:
            channel = self._rr
            self._rr = (self._rr + 1) % self.num_channels
        elif not 0 <= channel < self.num_channels:
            raise ValueError(f"channel {channel} out of range "
                             f"(engine has {self.num_channels})")
        self.stats.submitted += 1
        self._queues[channel].append((tid, channel, transfer))
        self._add_record(CompletionRecord(tid=tid, channel=channel))
        return tid

    def dispatch_batch(self, batch: DescriptorBatch) -> List[int]:
        """Shard a `DescriptorBatch` across the channel submission queues
        via `mp_dist_batch` (round-robin, or by destination-address window
        when the engine was built with ``channel_scheme="address"``).

        The batched analogue of `submit_async`: ids are assigned in bulk,
        one completion record covers the whole dispatch, and the rows move
        on the next `wait_all`.
        """
        n = len(batch)
        if n == 0:
            return []
        ids = list(range(self._next_id, self._next_id + n))
        self._next_id += n
        batch = dataclasses.replace(
            batch, transfer_id=np.arange(ids[0], ids[0] + n, dtype=np.int64))
        if self.num_channels == 1:
            shards = [batch]
        elif self.channel_scheme == "address":
            shards = mp_dist_batch(batch, self.num_channels,
                                   scheme="address",
                                   boundary=self.channel_boundary,
                                   which="dst")
        else:
            shards = mp_dist_batch(batch, self.num_channels,
                                   scheme=self.channel_scheme)
        enqueued = 0
        for c, shard in enumerate(shards):
            if len(shard):
                self._queues[c].append((int(shard.transfer_id[0]), c, shard))
                enqueued += 1
        self.stats.submitted += n
        self._add_record(CompletionRecord(tid=ids[0], count=n,
                                          pending=max(enqueued, 1)))
        return ids

    def poll(self, tid: int) -> str:
        """Completion-record lookup: ``"pending"``, ``"done"`` or
        ``"error"``.  Raises `KeyError` for an id never submitted."""
        rec = self._record_for(tid)
        if rec is None:
            raise KeyError(f"unknown transfer id {tid}")
        return rec.status

    def _sanitize_verdict(self, report) -> None:
        """Apply the configured ``sanitize`` mode to one report."""
        if report.clean:
            return
        if self.sanitize == "warn":
            warnings.warn(report.format(), RuntimeWarning, stacklevel=3)
            return
        from repro_torch.sanitize import SanitizeError
        raise SanitizeError(report)

    def _drain_order(self, schedule: Optional[Union[str, int]]
                     ) -> List[Tuple[int, int, object]]:
        """Functional drain order over the queued items.

        ``None`` is the production order: a min-head-tid merge across the
        channel FIFOs, i.e. items sorted by first transfer id.  The
        adversarial schedules (``"reverse"``, or an int seed for a random
        pick per step) permute only the *cross-channel* interleaving —
        each channel's own FIFO order is invariant, which is exactly the
        ordering guarantee the hardware gives and the sanitizer models.
        """
        if schedule is None:
            return sorted((it for q in self._queues for it in q),
                          key=lambda it: it[0])
        heads = [list(q) for q in self._queues]
        cursors = [0] * len(heads)
        rng = (np.random.default_rng(schedule)
               if isinstance(schedule, (int, np.integer))
               and not isinstance(schedule, bool) else None)
        if rng is None and schedule != "reverse":
            raise ValueError(
                f"schedule must be None, 'reverse' or an int seed, "
                f"got {schedule!r}")
        items: List[Tuple[int, int, object]] = []
        remaining = sum(len(h) for h in heads)
        while remaining:
            ready = [c for c, h in enumerate(heads) if cursors[c] < len(h)]
            if rng is not None:
                c = int(ready[rng.integers(len(ready))])
            else:   # "reverse": serve the channel with the largest head tid
                c = max(ready, key=lambda c: heads[c][cursors[c]][0])
            items.append(heads[c][cursors[c]])
            cursors[c] += 1
            remaining -= 1
        return items

    def wait_all(self, schedule: Optional[Union[str, int]] = None,
                 tie_seed: Optional[int] = None) -> sim.ChannelSimResult:
        """Drain every channel queue: run the timing fabric over the
        concurrent per-channel streams (`simulate_channels`, shared
        `src_system`/`dst_system` endpoints), then execute the functional
        fabric and *deliver* the completions.

        Completion is interrupt-driven: each drained submission posts a
        `CompletionEvent` carrying its last write-end cycle from the
        timing result, events are posted to the engine's `IrqController`
        in `simulate_channels` event order (cycle, then tid), the
        controller coalesces them per `IrqSpec` and fires the registered
        callbacks (`on_complete`), and the engine's own handler marks the
        completion records the `poll` adapter reads.  Coalescing batches
        delivery only — cycles, bytes and record outcomes are identical
        under any `IrqSpec` (property-tested).

        Functional drain order: queue items (single descriptors, or one
        shard of a `dispatch_batch`) ordered by first transfer id, each
        item FIFO internally.  As on real multi-channel hardware, rows of
        a *sharded* dispatch interleave across channels with no
        cross-channel byte-ordering guarantee — don't dispatch overlapping
        transfers to different channels and rely on their order.

        Returns the multi-channel timing result (also kept on
        `last_channel_result`), with the error handler's accumulated
        replay backoff / injected stalls on ``backoff_cycles``.  On a
        `TransferError` with the "abort" policy, the failing submission's
        record flips to ``"error"``, its error event (and every completion
        before it) is delivered, undrained items stay queued, and the
        error propagates.

        ``schedule`` permutes the cross-channel service order of the
        functional drain (`None` — first-tid order, the default;
        ``"reverse"`` — largest head tid first; an ``int`` — a seeded
        random channel pick per step).  Per-channel FIFO order is always
        preserved, so programs with no cross-channel hazards produce
        byte-identical memory under every schedule — the differential
        contract `repro_torch.verify` checks against the sanitizer's
        verdict.
        ``tie_seed`` is forwarded to `simulate_channels` (timing-only
        heap tie-breaking, never functional).
        """
        if self.sanitize and any(self._queues):
            from repro_torch.sanitize import check_engine
            report = check_engine(self)
            self.sanitize_reports.append(report)
            self._sanitize_verdict(report)
        items = self._drain_order(schedule)
        if not items:
            return sim.ChannelSimResult(
                per_channel=[], aggregate=sim.SimResult(0, 0, 0, 0, 0))

        # -- lower every queued payload exactly once ----------------------
        # every payload runs the same lowering pipeline (mid-ends,
        # mp_split/mp_dist, legalizer — or a captured-plan rebind) for
        # both fabrics; the per-back-end ports of one payload are merged
        # back into the channel stream (exact for num_backends == 1).
        # Plan-lowered payloads carry precomputed beat counts, which feed
        # the channel model whenever a whole channel stream has them.
        lowered: Dict[int, List[LoweredPort]] = {}
        spans: Dict[int, List[Tuple[int, int, int]]] = {}
        streams = []
        stream_beats = []
        beats_ok = self.sim_config.bus_width == self.bus_width
        # reset the drain's penalty accumulator *before* lowering: the
        # pin/retry fault loop charges its backoff here
        self._drain_backoff = 0
        #: per-item lowering outcome: a terminal fault to re-raise at the
        #: item's drain position, and the pages continue-mode dropped
        fault_at: Dict[int, TransferError] = {}
        lower_faults: Dict[int, Tuple] = {}
        for c, q in enumerate(self._queues):
            parts: List[LoweredPort] = []
            off = 0
            for tid0, _, payload in q:
                try:
                    lps = self._lower_ports(payload)
                except TransferError as err:
                    fault_at[tid0] = err
                    lps = []
                if self._last_lower_faults:
                    lower_faults[tid0] = tuple(self._last_lower_faults)
                lowered[tid0] = lps
                count = sum(len(lp.batch) for lp in lps)
                if count:       # burst span in channel c's stream
                    spans.setdefault(tid0, []).append((c, off, count))
                    off += count
                parts.extend(lps)
            nonempty = [lp for lp in parts if len(lp.batch)]
            streams.append(concat_batches([lp.batch for lp in nonempty]))
            if beats_ok and nonempty and \
                    all(lp.beats is not None for lp in nonempty):
                stream_beats.append(
                    nonempty[0].beats if len(nonempty) == 1 else
                    np.concatenate([lp.beats for lp in nonempty]))
            else:
                stream_beats.append(None)
        result = sim.simulate_channels(
            streams, self.sim_config, (self.src_system, self.dst_system),
            already_legal=True, beats=stream_beats, tie_seed=tie_seed)
        self.last_channel_result = result

        def span_cycle(tid0: int) -> int:
            """Completion cycle of one queue item: the last write-end of
            its burst span(s) in the channel streams."""
            cyc = 0
            for c, lo, cnt in spans.get(tid0, ()):
                wend = result.burst_wend[c]
                cyc = max(cyc, max(wend[lo:lo + cnt]))
            return cyc

        # continue-mode page drops are page faults too — count them once
        # per payload (the partial-apply dedup scope)
        self.stats.page_faults += sum(
            len(pages) for pages in lower_faults.values())

        # -- functional fabric: drain in submission (tid) order -----------
        for q in self._queues:
            q.clear()
        self._burst_cursor = 0
        events: List[CompletionEvent] = []
        rec_cycle: Dict[int, int] = {}
        try:
            for k, (tid0, channel, payload) in enumerate(items):
                rec = self._record_for(tid0)
                before = self.stats.bytes_moved
                try:
                    lowering_fault = fault_at.get(tid0)
                    if lowering_fault is not None:
                        raise lowering_fault
                    self._run_ports(lowered[tid0])
                    if isinstance(payload, DescriptorBatch):
                        count = len(payload)
                        last = int(payload.transfer_id[-1])
                    else:
                        count = 1
                        last = tid0
                except TransferError:
                    if rec is not None:
                        first = rec.status != "error"
                        rec.status = "error"     # terminal
                        rec.pending -= 1
                        rec.bytes_moved += self.stats.bytes_moved - before
                        pages = lower_faults.get(tid0)
                        if pages:
                            rec.faulted_pages = rec.faulted_pages + pages
                        cyc = max(rec_cycle.get(rec.tid, 0),
                                  span_cycle(tid0))
                        if first:   # one interrupt per record: a later
                            # shard of an already-errored dispatch must
                            # not re-raise the vector
                            events.append(CompletionEvent(
                                tid=rec.tid, count=rec.count,
                                channel=rec.channel, cycle=cyc,
                                status="error", bytes_moved=rec.bytes_moved))
                    for it in items[k + 1:]:    # failed item is consumed
                        self._queues[it[1]].append(it)
                    raise
                if rec is not None:
                    rec.pending -= 1
                    rec.bytes_moved += self.stats.bytes_moved - before
                    pages = lower_faults.get(tid0)
                    if pages:
                        rec.faulted_pages = rec.faulted_pages + pages
                    cyc = max(rec_cycle.get(rec.tid, 0), span_cycle(tid0))
                    rec_cycle[rec.tid] = cyc
                    if rec.pending <= 0 and rec.status != "error":
                        events.append(CompletionEvent(
                            tid=rec.tid, count=rec.count,
                            channel=rec.channel, cycle=cyc, status="done",
                            bytes_moved=rec.bytes_moved))
                self.stats.completed += count
                self._last_completed = last
        finally:
            # interrupt delivery — also on the abort path, so the error
            # event and every completion before it reach the callbacks
            result.backoff_cycles = self._drain_backoff
            self.stats.backoff_cycles += self._drain_backoff
            for ev in sorted(events, key=lambda e: (e.cycle, e.tid)):
                self.irq.post(ev)
            self.irq.flush()
        return result

    def on_complete(self, callback) -> None:
        """Register a completion-interrupt handler: ``callback(vector,
        events)`` is invoked by `wait_all`'s drain with coalesced
        `CompletionEvent` batches in completion order (`IrqSpec`
        thresholds decide the batching)."""
        self.irq.register(callback)

    def _irq_complete(self, vector: int, events) -> None:
        """The engine's own interrupt handler: flip delivered records to
        their terminal state (the `poll` adapter reads these)."""
        for ev in events:
            rec = self._record_for(ev.tid)
            if rec is not None and ev.status == "done" \
                    and rec.status != "error":
                rec.status = "done"

    def _add_record(self, rec: CompletionRecord) -> None:
        self._records.append(rec)
        self._record_starts.append(rec.tid)

    def _record_for(self, tid: int) -> Optional[CompletionRecord]:
        i = bisect.bisect_right(self._record_starts, tid) - 1
        if i >= 0 and self._records[i].covers(tid):
            return self._records[i]
        return None

    def submit_batch(self, batch: DescriptorBatch) -> List[int]:
        """Submit every row of a `DescriptorBatch` (batched doorbell).

        Timing-only engines (no memory map) take the vectorized fast path:
        ids are assigned in bulk with no per-row descriptor objects.
        Mem-backed engines dispatch the batch across the channel queues
        and drain once — one timing simulation and one completion record
        for the whole batch, not one per row.
        """
        n = len(batch)
        if self.mem is None:
            ids = list(range(self._next_id, self._next_id + n))
            self._next_id += n
            self.stats.submitted += n
            self.stats.completed += n
            if n:
                self._last_completed = ids[-1]
                self._add_record(CompletionRecord(
                    tid=ids[0], count=n, status="done", pending=0))
            return ids
        ids = self.dispatch_batch(batch)
        self.wait_all()
        return ids

    def run_functional(self, transfer: Union[Descriptor, DescriptorBatch]
                       ) -> None:
        """Execute a descriptor (or whole batch) on the *functional*
        fabric only: full lowering (plan cache / pipeline / legalizer)
        and byte movement, but no timing simulation, submission queues
        or completion records.  The oracle / serving fast path (cf.
        ``PagedKVDMA(timing=False)``); ``stats.bursts``/``bytes_moved``
        are updated, transfer ids are not assigned."""
        self._run(transfer)

    def last_completed_id(self) -> int:
        return self._last_completed

    def inject_fault(self, burst_index: Optional[int]) -> None:
        self._fail_at = burst_index

    # -- pipeline ------------------------------------------------------------

    def lower_batch(self, transfer: Union[Descriptor, DescriptorBatch]
                    ) -> List[DescriptorBatch]:
        """Descriptor (or whole batch) → per-back-end legalized burst
        batches (no execution) — thin adapter over `_lower_ports`, so a
        configured plan cache serves this path too."""
        return [lp.batch for lp in self._lower_ports(transfer)]

    def _lower_ports(self, transfer: Union[Descriptor, DescriptorBatch]
                     ) -> List[LoweredPort]:
        """The lowering pipeline, wrapped in the page-fault handler loop.

        Engines without a translating stage lower exactly once.  With
        one, a `PageFault` raised during lowering runs the policy verb —
        ``pin`` maps the page on demand, ``retry``/``replay`` invoke the
        ``page_fault_handler`` — and re-lowers, bounded per faulting page
        by ``max_replays`` (fault storms terminate: every page either
        gets mapped or exhausts its attempts and aborts).  The
        ``continue`` verb never raises here — the stage's partial apply
        drops unmapped rows, reported via ``_last_lower_faults``.
        """
        self._last_lower_faults = []
        if not self._has_translate:
            return self._lower_ports_once(transfer)
        attempts: Dict[Tuple[str, int], int] = {}
        while True:
            try:
                return self._lower_ports_once(transfer)
            except PageFault as err:
                self._handle_page_fault(err, attempts)

    def _handle_page_fault(self, err: PageFault,
                           attempts: Dict[Tuple[str, int], int]) -> None:
        """Run the error-policy verb for one lowering-time page fault;
        returns to re-lower, or raises on abort/exhaustion."""
        policy = self.error_policy
        self.stats.errors += 1
        self.stats.page_faults += 1
        action = policy.action
        if action in ("abort", "continue"):
            # continue-mode lowering drops faulted rows via the partial
            # hooks; a PageFault escaping means the stage has no partial
            # path — terminal either way
            self.stats.aborts += 1
            raise err
        key = (str(err.space), err.vpn)
        n = attempts.get(key, 0) + 1
        attempts[key] = n
        # pin gets max_replays + 1 attempts (one pin is always allowed —
        # a *second* fault on a pinned page means the pin failed);
        # retry/replay get max_replays handler round trips
        bound = policy.max_replays + 1 if action == "pin" \
            else policy.max_replays
        if n > bound:
            self.stats.aborts += 1
            raise err
        self._drain_backoff += policy.backoff_for(n - 1)
        if action == "pin":
            self.stats.pins += 1
            err.pin()
        elif action == "retry":
            self.stats.retries += 1
            if self.page_fault_handler is not None:
                self.page_fault_handler(err, n)
        else:                                   # replay
            self.stats.replays += 1
            if self.page_fault_handler is not None:
                self.page_fault_handler(err, n)

    def _apply_value_stages(self, legal: DescriptorBatch,
                            plan) -> LoweredPort:
        """Apply the pipeline's value stages (VA→PA) to a plan-replayed
        batch: captured plans live on the virtual plane (`capture_plan`
        runs ``apply_structure`` only), so every replay re-translates
        against the *current* page table.  Beat counts survive
        translation (pa ≡ va mod page size, and the bus width divides
        the page size); continue-mode drops subset them and invalidate
        the grouping hints."""
        beats, hints = plan.beats, plan.hints
        for stage in self.pipeline:
            if not getattr(stage, "translates", False):
                continue
            if self.error_policy.action == "continue" and \
                    hasattr(stage, "rebind_values_partial"):
                legal, keep, faults = stage.rebind_values_partial(legal)
                if faults:
                    self._last_lower_faults.extend(faults)
                    if beats is not None:
                        beats = beats[keep]
                    hints = None
            else:
                legal = stage.rebind_values(legal)
        return LoweredPort(legal, prechecked=True, beats=beats,
                           hints=hints)

    def _lower_ports_once(self, transfer: Union[Descriptor,
                                                DescriptorBatch]
                          ) -> List[LoweredPort]:
        """One lowering pass, plan-cache first.

        With a `plan_cache` configured (and a plannable engine: single
        back-end, every pipeline stage structurally signed), a submission
        whose structural signature was seen before never touches the
        mid-end or legalizer — the captured plan is rebound to this
        submission's addresses, and the frozen beat counts / execution
        hints ride along for the two fabrics.  Spec pipelines are part of
        the capture (and of the signature, via per-stage signatures), so
        a custom ND → split → dist composition replays like any built-in
        lowering.  Everything else takes `_lower_uncached`, counted in
        ``stats.plan_bypasses``.
        """
        pc = self.plan_cache
        if pc is not None:
            if self._plannable:
                if self.sanitize:
                    # audit the hit (if any) *before* serving it: rebind
                    # the frozen plan to this submission's addresses and
                    # compare against a from-scratch lowering (P0xx)
                    from repro_torch.sanitize import audit_replay
                    report = audit_replay(pc, transfer,
                                          bus_width=self.bus_width,
                                          pipeline=self.pipeline)
                    if report is not None:
                        self.sanitize_reports.append(report)
                        self._sanitize_verdict(report)
                if isinstance(transfer, NdTransfer):
                    legal, plan = pc.replay_nd(transfer,
                                               bus_width=self.bus_width,
                                               pipeline=self.pipeline)
                else:
                    if isinstance(transfer, Transfer1D):
                        transfer = DescriptorBatch.from_transfers([transfer])
                    legal, plan = pc.replay_batch(transfer,
                                                  bus_width=self.bus_width,
                                                  pipeline=self.pipeline)
                if self._has_translate:
                    return [self._apply_value_stages(legal, plan)]
                return [LoweredPort(legal, prechecked=True,
                                    beats=plan.beats, hints=plan.hints)]
            pc.stats.bypasses += 1
            self.stats.plan_bypasses += 1
        return [LoweredPort(b) for b in self._lower_uncached(transfer)]

    def _lower_uncached(self, transfer: Union[Descriptor, DescriptorBatch]
                        ) -> List[DescriptorBatch]:
        """Descriptor (or whole batch) → per-back-end legalized burst
        batches (no execution).

        The whole mid-end → mp_split → mp_dist → legalizer pipeline runs on
        the structure-of-arrays plane: spec pipeline stages rewrite the
        batch directly; legacy object-level mid-end callables (if any) are
        bridged through the adapter converters afterwards.
        """
        if isinstance(transfer, DescriptorBatch):
            batch = transfer
        elif isinstance(transfer, NdTransfer):
            batch = tensor_nd_batch(transfer)
        else:
            batch = DescriptorBatch.from_transfers([transfer])
        for stage in self.pipeline:
            if self.error_policy.action == "continue" and \
                    hasattr(stage, "apply_partial"):
                batch, faults = stage.apply_partial(batch)
                if faults:
                    self._last_lower_faults.extend(faults)
            else:
                batch = stage.apply(batch)
        if self.midends:
            ones = batch.to_transfers()
            for me in self.midends:
                ones = me(ones)
            batch = DescriptorBatch.from_transfers(ones)
        if self.num_backends > 1:
            split = mp_split_batch(batch, self.backend_boundary, which="dst")
            ports = mp_dist_batch(split, self.num_backends, scheme="address",
                                  boundary=self.backend_boundary, which="dst")
        else:
            ports = [batch]
        return [legalize_batch(p, bus_width=self.bus_width) for p in ports]

    def lower(self, transfer: Descriptor) -> List[List[Transfer1D]]:
        """Object-API adapter over `lower_batch` (functional path, tests)."""
        return [p.to_transfers() for p in self.lower_batch(transfer)]

    def _run(self, transfer: Union[Descriptor, DescriptorBatch]) -> None:
        """Functional execution of one descriptor/batch (adapter over
        `_lower_ports` + `_run_ports` for callers outside `wait_all`).
        Fault-injection ordinals restart at 0 per call (each call is its
        own one-item drain)."""
        self._burst_cursor = 0
        self._run_ports(self._lower_ports(transfer))

    def _stuck_state(self) -> str:
        """One-line queue/channel state for the drain progress guard."""
        depths = ", ".join(f"ch{c}={len(q)}" for c, q in
                           enumerate(self._queues))
        return (f"queue depths [{depths}], stats={self.stats}, "
                f"error_policy={self.error_policy.action!r}")

    def _run_ports(self, ports: List[LoweredPort]) -> None:
        """Run lowered per-port burst batches through the vectorized
        back-end (`execute_batch`) — the data plane never materializes
        `Transfer1D` objects.  Plan-lowered ports skip the per-call
        legality check (gated once at capture) and reuse the frozen
        grouping hints.

        The paper's error-handler verbs are expressed over burst indices:
        `TransferError.index` names the offender inside the still-pending
        tail, so continue skips exactly it, replay re-issues from it, and
        duplicate identical bursts can never be mis-credited.  The drain
        loop is guarded: if the error handler stops advancing `done`
        (e.g. a malformed `TransferError` with a negative index on an
        inconsistent queue), it raises `RuntimeError` with the stuck
        channel/queue state instead of spinning forever."""
        if self.mem is None:
            return
        inj = self.fault_injector
        for lp in ports:
            port = lp.batch
            n = len(port)
            base = self._burst_cursor   # drain-global ordinal of burst 0
            self._burst_cursor += n
            self.stats.bursts += n
            if inj is not None and n:
                self._drain_backoff += inj.take_stalls(base, base + n)
            done = 0
            replays = 0
            no_progress = 0
            progress_limit = max(3, self.error_policy.max_replays + 1)
            while done < n:
                before_done = done
                fail = None
                if self._fail_at is not None and \
                        done <= self._fail_at < n:
                    fail = self._fail_at - done
                if inj is not None:
                    hit = inj.next_fault(base + done, base + n)
                    if hit is not None:
                        rel = hit - base - done
                        if fail is None or rel < fail:
                            fail = rel
                pending = port.select(np.s_[done:]) if done else port
                try:
                    moved = execute_batch(
                        pending, self.mem, bus_width=self.bus_width,
                        fail_at=fail, check=not lp.prechecked,
                        hints=lp.hints if done == 0 else None)
                    self.stats.bytes_moved += moved
                    done = n
                except TransferError as err:
                    self.stats.errors += 1
                    idx = done + err.index      # port-absolute offender
                    err.index = idx
                    self.stats.bytes_moved += int(
                        port.length[done:idx].sum())
                    action = self.error_policy.action
                    if action == "abort":
                        self.stats.aborts += 1
                        raise
                    if action == "continue":
                        self.stats.continues += 1
                        self._fail_at = None
                        done = idx + 1          # skip the offending burst
                    else:     # replay family: replay / pin / retry — the
                        # VM verbs act like replay on execution faults
                        replays += 1
                        self.stats.replays += 1
                        if replays > self.error_policy.max_replays:
                            self.stats.aborts += 1
                            raise
                        self._fail_at = None    # fault cleared on replay
                        self._drain_backoff += \
                            self.error_policy.backoff_for(replays - 1)
                        done = idx              # re-issue the same burst
                if done <= before_done:
                    no_progress += 1
                    if no_progress > progress_limit:
                        raise RuntimeError(
                            f"drain loop stuck at burst {done}/{n} after "
                            f"{no_progress} no-progress iterations; "
                            + self._stuck_state())
                else:
                    no_progress = 0

    # -- timing fabric ---------------------------------------------------------

    def simulate(self, transfer: Descriptor) -> sim.SimResult:
        """Cycle model of this engine executing `transfer` (single port) or
        the max over ports (multi-back-end: ports run in parallel)."""
        ports = self._lower_ports(transfer)
        beats_ok = self.sim_config.bus_width == self.bus_width
        results = [
            sim.simulate_batch(lp.batch, self.sim_config, self.src_system,
                               self.dst_system, already_legal=True,
                               beats=lp.beats if beats_ok else None)
            for lp in ports if len(lp.batch)
        ]
        if not results:
            return sim.SimResult(0, 0, 0, self.sim_config.launch_latency, 0)
        total_bytes = sum(r.useful_bytes for r in results)
        worst = max(results, key=lambda r: r.cycles)
        merged = sim.SimResult(
            cycles=worst.cycles,
            useful_bytes=total_bytes,
            bus_beats=sum(r.bus_beats for r in results),
            first_read_req=min(r.first_read_req for r in results),
            n_bursts=sum(r.n_bursts for r in results),
        )
        return merged.with_width(self.sim_config.bus_width)


# --------------------------------------------------------------------------
# Pallas bridge — descriptor plans for the TPU fabric
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TilePlan:
    """A legalized 2-D tile walk for the TPU copy fabric.

    grid      — number of tiles along each of the two dims,
    tile      — VMEM tile shape (sublane/lane legal),
    shape     — the full (rows, cols) array shape,
    n_buffers — outstanding-transaction analogue (double/triple buffering).
    """

    shape: Tuple[int, int]
    tile: Tuple[int, int]
    grid: Tuple[int, int]
    n_buffers: int
    itemsize: int

    @property
    def vmem_bytes(self) -> int:
        return self.tile[0] * self.tile[1] * self.itemsize * self.n_buffers


def plan_nd_copy(shape: Tuple[int, int], itemsize: int,
                 requested_tile: Optional[Tuple[int, int]] = None,
                 n_buffers: int = 2,
                 vmem_budget: int = 8 * 1024 * 1024) -> TilePlan:
    """tensor_ND + legalizer for the TPU fabric: choose a legal VMEM tile
    and grid covering `shape`.  The per-buffer budget already accounts for
    multi-buffering (NAx ≡ n_buffers)."""
    rows, cols = shape
    want = requested_tile or (min(rows, 512), min(cols, 1024))
    tile = legalize_tile(want, itemsize,
                         vmem_budget=max(vmem_budget // max(n_buffers, 1), 1))
    tr = min(tile[0], _ceil_mult(rows, _sub(itemsize)))
    tc = min(tile[1], _ceil_mult(cols, 128))
    tile = (tr, tc)
    grid = (-(-rows // tile[0]), -(-cols // tile[1]))
    return TilePlan(shape=shape, tile=tile, grid=grid,
                    n_buffers=n_buffers, itemsize=itemsize)


def _sub(itemsize: int) -> int:
    from .legalizer import sublane_multiple
    return sublane_multiple(itemsize)


def _ceil_mult(x: int, m: int) -> int:
    return (x + m - 1) // m * m
