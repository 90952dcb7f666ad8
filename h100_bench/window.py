"""The measured window: a closed loop of batches through
`ServeEngine.generate`, its steps timed on the host clock.

The engine's `_prefill` and `_decode` are wrapped, as
`repro_torch.launch.profile_serve.run_generate` wraps them: each call is
timed to a `torch.cuda.synchronize()`.  A decode call starts right after
the engine has the previous step's tokens on the host (its `.tolist()`),
so the start of decode call k is when the batch's k-th token arrived,
and the return of `generate` when its last did.  The window closes at
the first of those step boundaries past its length: a batch cut there
keeps the tokens it has, and the loop does not wait for it to end.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.serve import Request, ServeEngine


class Closed(Exception):
    """The window's time ran out at a step boundary."""


@dataclass
class Step:
    kind: str                  # "prefill" | "decode"
    batch: int                 # index of the batch in the window
    seconds: float             # host clock, to a synchronize
    profiled: bool
    # a prefill's prompt lengths; a decode call's rows still serving, each
    # by its own tokens before the new one
    prompt_lens: List[int] = field(default_factory=list)
    contexts: List[int] = field(default_factory=list)


@dataclass
class Batch:
    requests: List[Request]
    start: float
    width: int                 # the padded prompt length
    token_times: List[float] = field(default_factory=list)
    finished: bool = False     # ran to its end inside the window


@dataclass
class Result:
    start: float
    end: float
    batches: List[Batch]
    steps: List[Step]

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Hooks:
    """Calls at the edges of steps, for the traced run: `prefill_start`,
    `decode_start` (with the decode call's index in its batch) and
    `generate_end`; each says whether the step it opens is profiled."""

    def prefill_start(self, batch: int) -> bool:
        return False

    def prefill_end(self, batch: int) -> None:
        pass

    def decode_start(self, batch: int, k: int) -> bool:
        return False

    def decode_end(self, batch: int, k: int) -> None:
        pass

    def generate_end(self, batch: int) -> None:
        pass


def run(engine: ServeEngine, next_batch: Callable[[], List[Request]],
        seconds: float, hooks: Optional[Hooks] = None,
        sync: Callable[[], None] = torch.cuda.synchronize,
        max_batches: Optional[int] = None,
        capture: Optional[Callable] = None) -> Result:
    """Batches from `next_batch` until `seconds` have passed (or, where
    `max_batches` is given, until that many batches have ended).
    `capture(batch, k, requests, logits)`, where given, sees the logits of
    every step inside its timing (k = 0 the prefill's, k the decode call's
    index in its batch)."""
    hooks = hooks or Hooks()
    clock = time.perf_counter
    prefill, decode = engine._prefill, engine._decode
    batches: List[Batch] = []
    steps: List[Step] = []
    state = {"k": 0}
    sync()
    start = clock()
    deadline = start + seconds

    def timed_prefill(tokens, *args, **kw):
        b = len(batches) - 1
        profiled = hooks.prefill_start(b)
        t0 = clock()
        out = prefill(tokens, *args, **kw)
        if capture is not None:
            capture(b, 0, batches[b].requests, out[0])
        sync()
        steps.append(Step("prefill", b, clock() - t0, profiled,
                          prompt_lens=[len(r.prompt)
                                       for r in batches[b].requests]))
        hooks.prefill_end(b)
        state["k"] = 0
        return out

    def timed_decode(caches, tokens, pos):
        now = clock()
        batch = batches[-1]
        batch.token_times.append(now)
        if now >= deadline:
            raise Closed
        state["k"] += 1
        k = state["k"]
        profiled = hooks.decode_start(len(batches) - 1, k)
        live = [len(r.prompt) + k for r in batch.requests
                if r.max_new_tokens > k]
        t0 = clock()
        out = decode(caches, tokens, pos)
        if capture is not None:
            capture(len(batches) - 1, k, batch.requests, out[0])
        sync()
        steps.append(Step("decode", len(batches) - 1, clock() - t0,
                          profiled, contexts=live))
        hooks.decode_end(len(batches) - 1, k)
        return out

    engine._prefill, engine._decode = timed_prefill, timed_decode
    end = None
    try:
        while end is None:
            t = clock()
            if t >= deadline:
                end = t
                break
            reqs = next_batch()
            batches.append(Batch(reqs, clock(),
                                 max(len(r.prompt) for r in reqs)))
            try:
                engine.generate(reqs)
            except Closed:
                end = batches[-1].token_times[-1]
                hooks.generate_end(len(batches) - 1)
                break
            t = clock()
            batches[-1].token_times.append(t)
            batches[-1].finished = True
            hooks.generate_end(len(batches) - 1)
            if t >= deadline or len(batches) == max_batches:
                end = t
    finally:
        engine._prefill, engine._decode = prefill, decode
    return Result(start, end, batches, steps)
