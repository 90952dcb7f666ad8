"""Serve-family programs for the constrained-random exerciser.

One program is a seeded trace of requests (ragged prompts, mixed
temperatures, per-request stop tokens, staggered arrivals) pushed
through a deliberately starved `ServeFrontDoor` pool, so admission,
decode growth, watermark preemption, DMA-expressed swap-out/swap-in and
interrupt-driven resumption all fire.  Three contracts are checked:

* **token identity** — every request's output equals the sequential
  one-request-at-a-time oracle (`oracle_generate`); any descriptor-plane
  corruption (bad swap restore, stale gather, staging overlap) flips
  tokens because the `HashLM` model is byte-coupled to the pool;
* **allocator invariants** — at drain: zero leaked blocks, free lists
  full, refcounts and free-list partition clean (`check_drained`);
* **completion equivalence** — the interrupt-driven run and the
  register-poll twin produce the identical schedule (tokens, steps,
  simulated cycles, preemption/swap counts).

Divergences shrink by dropping requests, then trimming generation
lengths and prompts, preserving the divergence kind.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.kvcache import KVLayout
from repro_torch.serve.sched import (HashLM, ServeFrontDoor, ServeRequest,
                                     oracle_generate)
from .harness import Divergence

_VOCAB = 64


@dataclass(frozen=True)
class ReqSpec:
    """One immutable request in a serve program (`ServeRequest` is
    mutated by a run, so each run materializes fresh ones)."""

    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    temperature: float
    stop_tokens: Tuple[int, ...]
    seed: int
    arrival_gap: int                # cycles after the previous arrival


@dataclass
class ServeProgram:
    """One seeded serve-family program."""

    seed: int
    n_pages: int
    page_size: int
    low_watermark: int
    max_running: int
    prefill_chunk: int
    num_channels: int
    completion: str                 # primary run; the twin runs the other
    requests: Tuple[ReqSpec, ...]
    family: str = "serve"
    fault_sites: List = field(default_factory=list)

    @property
    def max_seq_len(self) -> int:
        return (self.n_pages - self.low_watermark) * self.page_size

    @property
    def num_rows(self) -> int:
        """Upper bound on KV rows the trace can write (prompt + worst
        generation), the closest analogue of a batch row count."""
        return sum(len(r.prompt) + r.max_new_tokens for r in self.requests)

    def layout(self) -> KVLayout:
        return KVLayout(n_pages=self.n_pages, page_size=self.page_size,
                        n_kv_heads=2, head_dim=4, itemsize=4)  # 32 B rows

    def describe(self) -> str:
        lines = [
            f"serve program seed={self.seed}",
            f"  pool: {self.n_pages} pages x {self.page_size} rows, "
            f"watermark={self.low_watermark}, max_running="
            f"{self.max_running}, prefill_chunk={self.prefill_chunk}, "
            f"channels={self.num_channels}, completion={self.completion}",
        ]
        for r in self.requests:
            lines.append(
                f"  req {r.rid}: prompt={len(r.prompt)} "
                f"max_new={r.max_new_tokens} temp={r.temperature:g} "
                f"stops={list(r.stop_tokens)} seed={r.seed} "
                f"+{r.arrival_gap}cyc")
        return "\n".join(lines)


def generate_serve_program(seed: int) -> ServeProgram:
    """Constrained-random serve trace: the pool is sized so the request
    mix oversubscribes it (preemption pressure), every request
    individually fits the admission guard, and the HOST swap space
    (2x pool, the front door's default) can absorb any eviction set."""
    rng = np.random.default_rng(seed ^ 0x5E12)
    page_size = int(rng.choice([4, 8]))
    n_pages = int(rng.integers(8, 17))
    low_watermark = int(rng.integers(0, 3))
    max_running = int(rng.integers(3, 8))
    prefill_chunk = int(rng.choice([4, 8, 16]))
    num_channels = int(rng.integers(1, 5))
    completion = "irq" if seed % 2 == 0 else "poll"
    max_total = (n_pages - low_watermark) * page_size

    n_reqs = int(rng.integers(6, 17))
    reqs = []
    for rid in range(n_reqs):
        total = int(rng.integers(4, max_total + 1))
        plen = int(rng.integers(2, max(3, total - 1)))
        max_new = max(1, total - plen)
        stops = tuple(map(int, rng.choice(
            _VOCAB, size=rng.integers(0, 3), replace=False))) \
            if rng.random() < 0.3 else ()
        reqs.append(ReqSpec(
            rid=rid,
            prompt=tuple(map(int, rng.integers(0, _VOCAB, plen))),
            max_new_tokens=max_new,
            temperature=float(rng.choice([0.0, 0.0, 0.6, 1.1])),
            stop_tokens=stops,
            seed=int(rng.integers(0, 1 << 31)),
            arrival_gap=int(rng.integers(0, 800)),
        ))
    return ServeProgram(seed=seed, n_pages=n_pages, page_size=page_size,
                        low_watermark=low_watermark,
                        max_running=max_running,
                        prefill_chunk=prefill_chunk,
                        num_channels=num_channels, completion=completion,
                        requests=tuple(reqs))


def _materialize(program: ServeProgram) -> List[ServeRequest]:
    return [ServeRequest(rid=r.rid, prompt=list(r.prompt),
                         max_new_tokens=r.max_new_tokens,
                         temperature=r.temperature,
                         stop_tokens=r.stop_tokens, seed=r.seed)
            for r in program.requests]


def _run_front(program: ServeProgram, completion: str):
    """One front-door run; returns (reqs, front door) — `run()` already
    enforces `check_drained`."""
    model = HashLM(program.layout().row_bytes, vocab=_VOCAB)
    fd = ServeFrontDoor(model, program.layout(),
                        max_seq_len=program.max_seq_len,
                        max_running=program.max_running,
                        prefill_chunk=program.prefill_chunk,
                        low_watermark=program.low_watermark,
                        num_channels=program.num_channels,
                        completion=completion)
    reqs = _materialize(program)
    at = 0
    for spec, req in zip(program.requests, reqs):
        at += spec.arrival_gap
        fd.submit(req, at_cycle=at)
    fd.run()
    return reqs, fd


def check_serve_program(program: ServeProgram) -> Optional[Divergence]:
    """Token identity vs the sequential oracle, allocator invariants at
    drain, and irq-vs-poll schedule equivalence."""
    try:
        reqs, fd = _run_front(program, program.completion)
    except Exception as e:  # crash/leak/livelock — all divergences
        return Divergence("serve-crash",
                          f"{program.completion} run raised "
                          f"{type(e).__name__}: {e}", program)

    model = HashLM(program.layout().row_bytes, vocab=_VOCAB)
    for r in reqs:
        want = oracle_generate(model, r.seed, list(r.prompt),
                               r.max_new_tokens, r.temperature,
                               r.stop_tokens)
        if r.output != want:
            return Divergence(
                "serve-tokens",
                f"req {r.rid}: front door {r.output} != oracle {want}",
                program)

    leaks = fd.alloc.leaked()
    if leaks or fd.alloc.free_blocks != fd.alloc.n_blocks:
        return Divergence(
            "serve-leak",
            f"leaked={leaks} free={fd.alloc.free_blocks}"
            f"/{fd.alloc.n_blocks}", program)

    twin_mode = "poll" if program.completion == "irq" else "irq"
    try:
        twin_reqs, twin = _run_front(program, twin_mode)
    except Exception as e:
        return Divergence("serve-crash",
                          f"{twin_mode} twin raised "
                          f"{type(e).__name__}: {e}", program)
    a = ([r.output for r in reqs], fd.metrics.steps, fd.metrics.cycles,
         fd.alloc.stats.preemptions, fd.alloc.stats.swapped_out)
    b = ([r.output for r in twin_reqs], twin.metrics.steps,
         twin.metrics.cycles, twin.alloc.stats.preemptions,
         twin.alloc.stats.swapped_out)
    if a != b:
        return Divergence(
            "serve-completion",
            f"{program.completion} vs {twin_mode}: "
            f"(outputs,steps,cycles,preempt,swaps) {a[1:]} != {b[1:]}"
            f"{'' if a[0] == b[0] else ' AND outputs differ'}", program)
    return None


def shrink_serve_program(program: ServeProgram, divergence: Divergence,
                         budget: int = 200):
    """Greedy shrink: drop requests, then halve generation lengths, then
    halve prompts — keeping the divergence kind."""
    best_p, best_d = program, divergence
    tries = 0

    def still_fails(cand: ServeProgram) -> Optional[Divergence]:
        nonlocal tries
        tries += 1
        if not cand.requests:
            return None
        d = check_serve_program(cand)
        return d if d is not None and d.kind == best_d.kind else None

    changed = True
    while changed and tries < budget:
        changed = False
        for i in range(len(best_p.requests)):
            cand = dataclasses.replace(
                best_p, requests=best_p.requests[:i]
                + best_p.requests[i + 1:])
            d = still_fails(cand)
            if d is not None:
                best_p, best_d = cand, d
                changed = True
                break
        if changed or tries >= budget:
            continue
        for i, r in enumerate(best_p.requests):
            smaller = []
            if r.max_new_tokens > 1:
                smaller.append(dataclasses.replace(
                    r, max_new_tokens=max(1, r.max_new_tokens // 2)))
            if len(r.prompt) > 2:
                smaller.append(dataclasses.replace(
                    r, prompt=r.prompt[:max(2, len(r.prompt) // 2)]))
            for small in smaller:
                cand = dataclasses.replace(
                    best_p, requests=best_p.requests[:i] + (small,)
                    + best_p.requests[i + 1:])
                d = still_fails(cand)
                if d is not None:
                    best_p, best_d = cand, d
                    changed = True
                    break
            if changed:
                break
    return best_p, best_d
