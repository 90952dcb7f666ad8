"""Continuous-batching scheduler: admission, eviction, step planning.

Pure decision logic over the `BlockAllocator` — no descriptor is built
here.  `ServeFrontDoor` (front.py) turns each `StepPlan` into engine
traffic and feeds completions back through `Scheduler.notify`, so the
state machine advances on **completion interrupts** ("KV move done →
request runnable"), not on inline assumptions about when bytes land.

Request lifecycle::

    WAITING ──admit──> PREFILL ──chunks done──> RUNNING ──stop/EOS──> FINISHED
                                                   │  ▲
                                       preemption  │  │ swap-in done
                                                   ▼  │
                                  SWAPPING_OUT ─> SWAPPED ─> SWAPPING_IN

Policies (all deterministic):

* **FCFS admission** — arrivals queue in order; a request is admitted
  when a batch slot is free and allocating its prompt blocks keeps the
  free pool at or above the allocator's low watermark.
* **Resume-first** — swapped requests (FCFS by preemption step) take
  priority over new admissions; while the swap queue's head cannot be
  resumed, no new request is admitted (no starvation of preempted work).
* **LIFO preemption** — when decode growth exhausts the pool (or the
  free pool dips to the watermark), the *youngest* running request is
  preempted: its blocks are swapped to HOST slots and freed only when
  the swap-out traffic **completes** (the interrupt is the free).
* **Chunked prefill** — a prompt enters the batch `prefill_chunk` rows
  per step, so long prompts don't head-of-line-block decode traffic.
"""

from __future__ import annotations

import bisect
import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from .alloc import BlockAllocator


class ReqState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    SWAPPING_OUT = "swapping_out"
    SWAPPED = "swapped"
    SWAPPING_IN = "swapping_in"
    FINISHED = "finished"


@dataclass(eq=False)
class ServeRequest:
    """One request plus its scheduler-owned runtime state.

    ``tokens`` is the full history (prompt + generated); the paged-KV
    invariant is that a RUNNING request has exactly ``len(tokens)`` rows
    resident in its blocks."""

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    seed: int = 0
    arrival_cycle: int = 0

    # runtime (scheduler/front-door owned)
    state: ReqState = ReqState.WAITING
    tokens: List[int] = field(default_factory=list)
    output: List[int] = field(default_factory=list)
    blocks: List[int] = field(default_factory=list)
    swap_slots: List[int] = field(default_factory=list)
    slot: int = -1                  # front-door VMEM staging/gather slot
    prefill_pos: int = 0            # prompt rows already appended
    first_token_cycle: int = -1
    finish_cycle: int = -1
    preemptions: int = 0
    swap_step: int = -1             # step of the last preemption


@dataclass
class StepPlan:
    """One step's batch composition, in dispatch order."""

    admitted: List[ServeRequest] = field(default_factory=list)
    swap_out: List[ServeRequest] = field(default_factory=list)
    swap_in: List[ServeRequest] = field(default_factory=list)
    prefill: List[Tuple[ServeRequest, int, int]] = field(
        default_factory=list)
    decode: List[ServeRequest] = field(default_factory=list)
    stalled: List[ServeRequest] = field(default_factory=list)

    @property
    def any_traffic(self) -> bool:
        return bool(self.swap_out or self.swap_in or self.prefill
                    or self.decode)


@dataclass
class SchedStats:
    admitted: int = 0
    finished: int = 0
    stall_steps: int = 0            # (request, step) growth stalls


class Scheduler:
    """Admission/eviction over a `BlockAllocator` and a fixed number of
    batch slots (the front door's per-slot VMEM regions)."""

    def __init__(self, alloc: BlockAllocator, page_size: int,
                 max_running: int = 8, prefill_chunk: int = 16) -> None:
        if max_running < 1:
            raise ValueError("max_running must be >= 1")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.alloc = alloc
        self.page_size = page_size
        self.max_running = max_running
        self.prefill_chunk = prefill_chunk
        self.stats = SchedStats()
        self.waiting: Deque[ServeRequest] = deque()
        self.active: List[ServeRequest] = []     # PREFILL + RUNNING
        self.swapped: List[ServeRequest] = []    # sorted (swap_step, rid)
        self.finished: List[ServeRequest] = []
        self.swapping: Dict[int, ServeRequest] = {}   # rid → in-flight swap
        self._slots = list(range(max_running))[::-1]
        self._step = 0

    # -- helpers ------------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def drained(self) -> bool:
        return not (self.waiting or self.active or self.swapped
                    or self.swapping)

    # -- submission ---------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        worst = self.pages_for(len(req.prompt) + req.max_new_tokens)
        if worst > self.alloc.n_blocks - self.alloc.low_watermark:
            raise ValueError(
                f"request {req.rid} can grow to {worst} blocks but the "
                f"pool only ever offers "
                f"{self.alloc.n_blocks - self.alloc.low_watermark}")
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        req.state = ReqState.WAITING
        req.tokens = list(req.prompt)
        self.waiting.append(req)

    # -- step planning ------------------------------------------------------

    def _preempt_one(self, plan: StepPlan,
                     spare: Optional[ServeRequest] = None) -> bool:
        """Swap out the youngest RUNNING request (LIFO); ``spare`` is
        never picked unless it is the only candidate.  Returns False when
        there is no victim or no swap space (callers then stall)."""
        victim = None
        for req in reversed(self.active):
            if req.state is ReqState.RUNNING and req is not spare:
                victim = req
                break
        if victim is None and spare is not None \
                and spare.state is ReqState.RUNNING:
            victim = spare
        if victim is None:
            return False
        keep = self.pages_for(len(victim.tokens))
        if not self.alloc.can_alloc_swap(keep):
            return False
        # blocks past pages_for(len(tokens)) were grown for a token that
        # was never appended — they hold no rows; free them now instead
        # of swapping garbage pages
        if len(victim.blocks) > keep:
            self.alloc.decref(victim.blocks[keep:])
            victim.blocks = victim.blocks[:keep]
        victim.swap_slots = self.alloc.alloc_swap(len(victim.blocks))
        victim.state = ReqState.SWAPPING_OUT
        victim.preemptions += 1
        victim.swap_step = self._step
        self.active.remove(victim)
        self._slots.append(victim.slot)
        victim.slot = -1
        self.swapping[victim.rid] = victim
        self.alloc.stats.preemptions += 1
        self.alloc.stats.swapped_out += len(victim.blocks)
        plan.swap_out.append(victim)
        if victim is spare and victim in plan.stalled:
            plan.stalled.remove(victim)
        return True

    def plan_step(self) -> StepPlan:
        """Compose one step: grow (preempting on exhaustion), resume,
        admit, then schedule prefill chunks and decode rows."""
        self._step += 1
        plan = StepPlan()
        alloc = self.alloc
        # blocks already on their way back: this step's planned swap-outs
        # free their blocks at completion, so preemption decisions must
        # not double-evict for a deficit that is already covered
        incoming = 0

        # 1. decode growth — the next token of a RUNNING request lands at
        #    position len(tokens); grow its block list when that position
        #    spills past the allocated pages.  A grower that cannot get a
        #    block stalls this step (its victim's blocks only free when
        #    the swap-out *completes*) and retries next step.
        for req in list(self.active):
            if req.state is not ReqState.RUNNING:
                continue
            if len(req.tokens) // self.page_size < len(req.blocks):
                continue
            if alloc.can_alloc(1):
                req.blocks += alloc.alloc(1)
            else:
                plan.stalled.append(req)
                self.stats.stall_steps += 1
                if incoming == 0 and self._preempt_one(plan, spare=req):
                    incoming += len(plan.swap_out[-1].blocks)
                if req.state is not ReqState.RUNNING:
                    continue

        # watermark trigger: keep the free pool above the admission
        # reserve by evicting the youngest running request early, before
        # hard exhaustion forces growth stalls
        while alloc.free_blocks + incoming < alloc.low_watermark and \
                any(r.state is ReqState.RUNNING for r in self.active):
            if not self._preempt_one(plan):
                break
            incoming += len(plan.swap_out[-1].blocks)

        # 2. swap-ins, FCFS by preemption step — strictly ahead of new
        #    admissions
        while self.swapped and self._slots:
            req = self.swapped[0]
            need = self.pages_for(len(req.tokens))
            if not (alloc.can_alloc(need) and alloc.above_watermark(need)):
                break
            self.swapped.pop(0)
            req.blocks = alloc.alloc(need)
            req.slot = self._slots.pop()
            req.state = ReqState.SWAPPING_IN
            self.swapping[req.rid] = req
            alloc.stats.swapped_in += need
            plan.swap_in.append(req)

        # 3. admissions — blocked while preempted work cannot resume
        while self.waiting and self._slots and not self.swapped:
            req = self.waiting[0]
            need = self.pages_for(len(req.prompt))
            if not (alloc.can_alloc(need) and alloc.above_watermark(need)):
                break
            self.waiting.popleft()
            req.blocks = alloc.alloc(need)
            req.slot = self._slots.pop()
            req.state = ReqState.PREFILL
            self.active.append(req)
            self.stats.admitted += 1
            plan.admitted.append(req)

        # 4. prefill chunks + 5. decode rows
        stalled = set(id(r) for r in plan.stalled)
        for req in self.active:
            if req.state is ReqState.PREFILL:
                end = min(req.prefill_pos + self.prefill_chunk,
                          len(req.prompt))
                plan.prefill.append((req, req.prefill_pos, end))
            elif req.state is ReqState.RUNNING and id(req) not in stalled:
                plan.decode.append(req)
        return plan

    # -- completion-driven transitions --------------------------------------

    def notify(self, kind: str, req: ServeRequest,
               arg: Optional[int] = None) -> None:
        """A completion interrupt for one of this request's KV moves.

        ``swap_out`` — eviction landed in HOST: *now* the blocks free;
        ``swap_in`` — restore landed: the request is runnable again;
        ``prefill`` — a prompt chunk landed (``arg`` = new prefill_pos);
        ``gather`` / ``append`` — decode traffic, no state change."""
        if kind == "swap_out":
            assert req.state is ReqState.SWAPPING_OUT
            self.alloc.decref(req.blocks)
            req.blocks = []
            req.state = ReqState.SWAPPED
            del self.swapping[req.rid]
            # FCFS by preemption step; rid breaks same-drain ties so the
            # resume order is identical under irq and poll delivery
            bisect.insort(self.swapped, req,
                          key=lambda r: (r.swap_step, r.rid))
        elif kind == "swap_in":
            assert req.state is ReqState.SWAPPING_IN
            self.alloc.free_swap(req.swap_slots)
            req.swap_slots = []
            req.state = ReqState.RUNNING
            del self.swapping[req.rid]
            self.active.append(req)
        elif kind == "prefill":
            assert req.state is ReqState.PREFILL and arg is not None
            req.prefill_pos = arg
            if req.prefill_pos == len(req.prompt):
                req.state = ReqState.RUNNING
        elif kind not in ("gather", "append"):
            raise ValueError(f"unknown completion kind {kind!r}")

    def finish(self, req: ServeRequest) -> None:
        """Terminal transition: release blocks and the batch slot."""
        assert req.state is ReqState.RUNNING
        self.alloc.decref(req.blocks)
        req.blocks = []
        self._slots.append(req.slot)
        req.slot = -1
        req.state = ReqState.FINISHED
        self.active.remove(req)
        self.finished.append(req)
        self.stats.finished += 1
