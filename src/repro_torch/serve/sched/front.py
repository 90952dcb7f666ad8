"""`ServeFrontDoor` — the continuous-batching serving loop.

Each step turns the scheduler's `StepPlan` into descriptor traffic on
ONE `IDMAEngine` and drains it in two phases:

* **move drain** — swap-outs (HBM→HOST), swap-ins (HOST→HBM), prefill
  chunk appends (VMEM staging→HBM) and per-request decode gathers
  (HBM→VMEM), all dispatched together so eviction traffic contends with
  serving traffic across the engine's channels in `simulate_channels`;
* **append drain** — after sampling, one row-append per surviving
  decode request (the new token's KV row).

The two-phase shape keeps every drain free of cross-channel hazards
(nothing written in a drain is read in the same drain), so the step is
byte-deterministic under *any* channel schedule, and ``sanitize=True``
certifies it: every drain is swept by `repro_torch.sanitize` before a
byte moves, and every plan-cache hit is audited against a fresh
lowering.

Completion is interrupt-driven by default: the engine's `IrqController`
delivers `CompletionEvent`s during the drain, the front door maps each
transfer id back to its (kind, request) tag, and `Scheduler.notify`
advances the state machine — "KV move done → request runnable".
``completion="poll"`` instead walks the pending tids through the
`engine.poll` register-read adapter after each drain; both modes drive
identical schedules (tested).

Time is **simulated engine cycles**: each drain advances the clock by
its `ChannelSimResult.total_cycles`, plus a fixed per-step
``step_overhead_cycles`` modeling the model-compute phase.  Poisson
arrivals, latency percentiles and tokens/s in the reference's
`benchmarks.serve_bench` are all measured on this clock, so that
benchmark is deterministic.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import (BackendSpec, ChannelSpec, EngineConfig,
                              EngineSpec, FrontendSpec, IrqSpec, MemoryMap,
                              PlanCache, Protocol, VMEM_ENDPOINT,
                              build_engine, concat_batches)
from repro_torch.core.simulator import HBM as HBM_SYSTEM
from ..kvcache import (KVLayout, gather_descriptors,
                       span_append_descriptors, swap_descriptors)
from .alloc import BlockAllocator
from .sched import ReqState, Scheduler, ServeRequest


def serve_spec(num_channels: int = 2,
               irq: Optional[IrqSpec] = None) -> EngineSpec:
    """The front door's engine composition: async descriptor doorbells,
    HBM/VMEM/HOST ports (pool, staging/gather, swap space), edge_ai
    timing endpoints."""
    return EngineSpec(
        name="serve_front",
        frontend=FrontendSpec(kind="desc", word_bits=64, doorbell="async"),
        backend=BackendSpec(bus_width=8,
                            protocols=(Protocol.HBM, Protocol.VMEM,
                                       Protocol.HOST)),
        channels=ChannelSpec(count=num_channels),
        sim_config=EngineConfig(bus_width=8, n_outstanding=32,
                                buffer_beats=32),
        src_system=HBM_SYSTEM,
        dst_system=VMEM_ENDPOINT,
        irq=irq if irq is not None else IrqSpec(),
    )


@dataclass
class StepMetrics:
    step: int
    cycles: int
    decode_tokens: int
    prefill_rows: int
    batch: int                      # active requests this step
    swap_out: int = 0
    swap_in: int = 0


@dataclass
class ServeMetrics:
    """Aggregated closed-loop counters (`ServeFrontDoor.metrics`)."""

    steps: int = 0
    cycles: int = 0
    decode_tokens: int = 0
    prefill_rows: int = 0
    per_step: List[StepMetrics] = field(default_factory=list)

    def tokens_per_mcycle(self) -> float:
        return self.decode_tokens / (self.cycles / 1e6) if self.cycles \
            else 0.0


class ServeFrontDoor:
    """Dynamic-batch serving over one paged-KV pool.

    ``model`` supplies the KV bytes and consumes them back (`HashLM`,
    or the PyTorch `StepLM` binding); ``layout`` sizes the HBM pool
    (``layout.n_pages`` blocks).  Per-request VMEM staging/gather
    regions are sized for ``max_running`` concurrent requests of up to
    ``max_seq_len`` tokens.
    """

    def __init__(self, model, layout: KVLayout, *,
                 max_seq_len: Optional[int] = None,
                 max_running: int = 8, prefill_chunk: int = 16,
                 low_watermark: int = 0, n_swap_slots: Optional[int] = None,
                 num_channels: int = 2, completion: str = "irq",
                 irq: Optional[IrqSpec] = None,
                 plan_cache: int = 256, spec: Optional[EngineSpec] = None,
                 step_overhead_cycles: int = 1000,
                 sanitize: bool = False) -> None:
        if completion not in ("irq", "poll"):
            raise ValueError(f"completion must be 'irq' or 'poll', "
                             f"got {completion!r}")
        self.model = model
        self.layout = layout
        self.max_seq_len = max_seq_len if max_seq_len is not None \
            else layout.n_pages * layout.page_size
        if n_swap_slots is None:
            n_swap_slots = 2 * layout.n_pages
        self.completion = completion
        self.step_overhead_cycles = step_overhead_cycles

        self.alloc = BlockAllocator(layout.n_pages,
                                    n_swap_slots=n_swap_slots,
                                    low_watermark=low_watermark)
        self.sched = Scheduler(self.alloc, layout.page_size,
                               max_running=max_running,
                               prefill_chunk=prefill_chunk)

        # per-slot VMEM regions: [gather-K | gather-V | stage-K | stage-V]
        pages_per_req = -(-self.max_seq_len // layout.page_size)
        self._gather_bytes = pages_per_req * layout.page_bytes
        self._stage_bytes = max(prefill_chunk, 1) * layout.row_bytes
        self._slot_stride = 2 * self._gather_bytes + 2 * self._stage_bytes
        mem = MemoryMap.create({
            Protocol.HBM: 2 * layout.pool_bytes,
            Protocol.VMEM: max_running * self._slot_stride,
            Protocol.HOST: n_swap_slots * 2 * layout.page_bytes,
        })
        if spec is None:
            spec = serve_spec(num_channels, irq=irq)
        self.plan_cache = PlanCache(capacity=plan_cache)
        self.engine = build_engine(spec, mem=mem,
                                   plan_cache=self.plan_cache,
                                   sanitize=sanitize)
        if completion == "irq":
            self.engine.on_complete(self._on_irq)

        self.clock = 0
        self.metrics = ServeMetrics()
        self._pending: Dict[int, Tuple[str, ServeRequest,
                                       Optional[int]]] = {}
        self._arrivals: List[Tuple[int, int, ServeRequest]] = []
        self._arrival_seq = 0

    # -- VMEM slot addressing ------------------------------------------------

    def _gk(self, slot: int) -> int:
        return slot * self._slot_stride

    def _gv(self, slot: int) -> int:
        return self._gk(slot) + self._gather_bytes

    def _sk(self, slot: int) -> int:
        return self._gv(slot) + self._gather_bytes

    def _sv(self, slot: int) -> int:
        return self._sk(slot) + self._stage_bytes

    # -- submission ----------------------------------------------------------

    def submit(self, req: ServeRequest, at_cycle: Optional[int] = None
               ) -> None:
        """Enqueue a request; it enters the scheduler's arrival queue
        once the simulated clock reaches ``at_cycle`` (default: now)."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(f"request {req.rid} can reach {total} tokens "
                             f"but max_seq_len is {self.max_seq_len}")
        req.arrival_cycle = self.clock if at_cycle is None \
            else max(at_cycle, self.clock)
        heapq.heappush(self._arrivals,
                       (req.arrival_cycle, self._arrival_seq, req))
        self._arrival_seq += 1

    # -- completion delivery -------------------------------------------------

    def _complete(self, tid: int) -> None:
        kind, req, arg = self._pending.pop(tid)
        self.sched.notify(kind, req, arg)

    def _on_irq(self, vector: int, events) -> None:
        for ev in events:
            if ev.status == "done" and ev.tid in self._pending:
                self._complete(ev.tid)

    def _poll_pending(self) -> None:
        """Register-read completion: walk outstanding tids in id order
        through the `poll` adapter (the pre-irq front-end contract)."""
        for tid in sorted(self._pending):
            if self.engine.poll(tid) == "done":
                self._complete(tid)

    def _dispatch(self, batch, kind: str, req: ServeRequest,
                  arg: Optional[int] = None) -> None:
        ids = self.engine.dispatch_batch(batch)
        self._pending[ids[0]] = (kind, req, arg)

    # -- traffic builders ----------------------------------------------------

    def _stage_rows(self, req: ServeRequest, start: int, end: int) -> None:
        """Write the model's K/V rows for positions [start, end) into
        the request's VMEM staging region."""
        vmem = self.engine.mem.spaces[Protocol.VMEM]
        n = (end - start) * self.layout.row_bytes
        for which, base in (("k", self._sk(req.slot)),
                            ("v", self._sv(req.slot))):
            rows = self.model.kv_rows(req.seed, req.tokens, start, end,
                                      which)
            vmem[base:base + n] = rows.reshape(-1)

    def _dispatch_append(self, req: ServeRequest, start: int, end: int,
                         kind: str, arg: Optional[int] = None) -> None:
        self._stage_rows(req, start, end)
        self._dispatch(span_append_descriptors(
            self.layout, req.blocks, start, end,
            stage_k=self._sk(req.slot), stage_v=self._sv(req.slot)),
            kind, req, arg)

    def _dispatch_gather(self, req: ServeRequest) -> None:
        lay = self.layout
        n = self.sched.pages_for(len(req.tokens))
        table = np.asarray(req.blocks[:n], dtype=np.int64)[None, :]
        self._dispatch(concat_batches([
            gather_descriptors(lay, table, n * lay.page_size,
                               pool_base=0, dst_base=self._gk(req.slot)),
            gather_descriptors(lay, table, n * lay.page_size,
                               pool_base=lay.pool_bytes,
                               dst_base=self._gv(req.slot)),
        ]), "gather", req)

    def _gathered_bytes(self, req: ServeRequest
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """The request's valid contiguous K/V images out of its gather
        region: exactly ``len(tokens)`` rows — the tail of the last
        gathered page holds whatever its previous tenant wrote and is
        never part of the model contract."""
        vmem = self.engine.mem.spaces[Protocol.VMEM]
        n = len(req.tokens) * self.layout.row_bytes
        gk, gv = self._gk(req.slot), self._gv(req.slot)
        return vmem[gk:gk + n], vmem[gv:gv + n]

    # -- the serving step ----------------------------------------------------

    def _drain(self) -> int:
        res = self.engine.wait_all()
        if self.completion == "poll":
            self._poll_pending()
        return res.total_cycles

    def step(self) -> Optional[StepMetrics]:
        """One scheduler step; returns its metrics, or None when there
        was nothing to do (drained and no arrival due)."""
        # idle fast-forward: jump the clock to the next arrival
        if self.sched.drained():
            if not self._arrivals:
                return None
            self.clock = max(self.clock, self._arrivals[0][0])
        while self._arrivals and self._arrivals[0][0] <= self.clock:
            _, _, req = heapq.heappop(self._arrivals)
            self.sched.submit(req)

        plan = self.sched.plan_step()
        for req in plan.admitted:
            self.model.on_admit(req)

        # -- move drain: swaps + prefill chunks + decode gathers
        for req in plan.swap_out:
            self._dispatch(swap_descriptors(self.layout, req.blocks,
                                            req.swap_slots, "out"),
                           "swap_out", req)
        for req in plan.swap_in:
            self._dispatch(swap_descriptors(self.layout, req.blocks,
                                            req.swap_slots, "in"),
                           "swap_in", req)
        for req, start, end in plan.prefill:
            self._dispatch_append(req, start, end, "prefill", end)
        for req in plan.decode:
            self._dispatch_gather(req)
        cycles = self._drain()

        # -- sample + append drain
        gathered = [self._gathered_bytes(r) for r in plan.decode]
        toks = self.model.next_tokens(plan.decode, gathered)
        appends = 0
        for req, tok in zip(plan.decode, toks):
            req.output.append(tok)
            req.tokens.append(tok)
            done = (len(req.output) >= req.max_new_tokens
                    or tok in req.stop_tokens
                    or tok == getattr(self.model, "eos_token", None))
            if done:
                self.model.release(req)
                self.sched.finish(req)
            else:
                t = len(req.tokens) - 1
                self._dispatch_append(req, t, t + 1, "append")
                appends += 1
        if appends:
            cycles += self._drain()
        if plan.any_traffic:
            cycles += self.step_overhead_cycles
        elif not self.sched.drained():
            raise RuntimeError(
                "scheduler livelock: no traffic planned but requests "
                "remain (pool too small for the admission guard?)")
        self.clock += cycles
        for req in plan.decode:
            if req.first_token_cycle < 0:
                req.first_token_cycle = self.clock
            if req.state is ReqState.FINISHED and req.finish_cycle < 0:
                req.finish_cycle = self.clock

        m = StepMetrics(step=self.metrics.steps, cycles=cycles,
                        decode_tokens=len(plan.decode),
                        prefill_rows=sum(e - s for _, s, e in plan.prefill),
                        batch=len(self.sched.active),
                        swap_out=len(plan.swap_out),
                        swap_in=len(plan.swap_in))
        self.metrics.steps += 1
        self.metrics.cycles += cycles
        self.metrics.decode_tokens += m.decode_tokens
        self.metrics.prefill_rows += m.prefill_rows
        self.metrics.per_step.append(m)
        return m

    def run(self, max_steps: int = 1_000_000) -> ServeMetrics:
        """Serve until every submitted request finishes."""
        for _ in range(max_steps):
            if self.step() is None and not self._arrivals:
                break
        else:
            raise RuntimeError(f"not drained after {max_steps} steps")
        self.check_drained()
        return self.metrics

    # -- invariants ----------------------------------------------------------

    def check_drained(self) -> None:
        """Zero-leak gate: every block and swap slot back on the free
        lists, no in-flight tags, scheduler empty."""
        if not self.sched.drained():
            raise AssertionError("scheduler not drained")
        if self._pending:
            raise AssertionError(f"{len(self._pending)} completions "
                                 f"never delivered")
        leaks = self.alloc.leaked()
        if leaks:
            raise AssertionError(f"leaked KV blocks: {leaks}")
        if self.alloc.free_blocks != self.alloc.n_blocks:
            raise AssertionError(
                f"free list short: {self.alloc.free_blocks}"
                f"/{self.alloc.n_blocks}")
        if self.alloc.free_swap_slots != self.alloc.n_swap_slots:
            raise AssertionError(
                f"swap slots leaked: {self.alloc.free_swap_slots}"
                f"/{self.alloc.n_swap_slots}")
        self.alloc.check()
