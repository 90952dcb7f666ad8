"""Training-loop fault tolerance: the software mirror of the engine's
`ErrorPolicy` verbs (a copy of `repro.dist.fault`, which has no jax).

The backend recovers *burst*-level faults (replay a burst, skip it,
abort the transfer); this module applies the same three verbs one level
up, to *training steps*: a `StepFault` under ``policy="replay"`` reruns
the step, ``"continue"`` skips it, ``"abort"`` propagates.  A
`NodeFailure` is never absorbed here — the trainer catches it, restores
the latest checkpoint, and reseeks the data pipeline (the
checkpoint-elastic path).

`FaultInjector` is the test/bench harness side: it trips a configured
fault exactly once per configured step, so a replayed step succeeds on
its second attempt just like a transient burst error does under the
backend's replay verb.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

__all__ = ["FaultConfig", "FaultStats", "FaultInjector", "NodeFailure",
           "StepFault", "guarded_step"]


class StepFault(Exception):
    """A recoverable per-step fault (the step itself can be retried)."""


class NodeFailure(Exception):
    """A lost worker: the step cannot be retried in place; the trainer
    must restore from the last checkpoint and reseek the pipeline."""


@dataclass
class FaultConfig:
    """How the training loop reacts to a `StepFault`: ``replay`` reruns
    the step (up to ``max_replays`` attempts per step), ``continue``
    skips it, ``abort`` raises."""

    policy: str = "replay"
    max_replays: int = 3

    def __post_init__(self) -> None:
        if self.policy not in ("replay", "continue", "abort"):
            raise ValueError(f"unknown fault policy {self.policy!r}")


@dataclass
class FaultStats:
    """Counters the trainer exposes as ``trainer.stats``."""

    replays: int = 0
    skipped: int = 0
    node_failures: int = 0


@dataclass
class FaultInjector:
    """Deterministic fault source for tests and benchmarks: raises on
    each step in ``fail_steps`` exactly once (``kind="step"`` →
    `StepFault`, ``kind="node"`` → `NodeFailure`), then lets the retried
    step through."""

    fail_steps: Sequence[int] = ()
    kind: str = "step"
    _armed: set = field(default_factory=set, repr=False)

    def __post_init__(self) -> None:
        if self.kind not in ("step", "node"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        self._armed = set(int(s) for s in self.fail_steps)

    def check(self, step: int) -> None:
        if step in self._armed:
            self._armed.discard(step)
            if self.kind == "node":
                raise NodeFailure(f"injected node failure at step {step}")
            raise StepFault(f"injected step fault at step {step}")


def guarded_step(raw_step: Callable, cfg: Optional[FaultConfig],
                 stats: FaultStats,
                 injector: Optional[FaultInjector] = None) -> Callable:
    """Wrap a ``raw_step(state, batch) -> (state, metrics)`` with the
    fault policy.  The wrapper signature is ``fn(state, batch, step)``;
    a skipped step (``continue``) returns ``(state, {})`` unchanged; a
    `NodeFailure` always propagates to the trainer's restore path."""
    cfg = cfg or FaultConfig()

    def fn(state, batch, step: int) -> Tuple[object, dict]:
        attempts = 0
        while True:
            try:
                if injector is not None:
                    injector.check(step)
                return raw_step(state, batch)
            except NodeFailure:
                raise
            except StepFault:
                if cfg.policy == "abort":
                    raise
                if cfg.policy == "continue":
                    stats.skipped += 1
                    return state, {}
                attempts += 1
                if attempts > max(1, cfg.max_replays):
                    raise
                stats.replays += 1

    return fn
