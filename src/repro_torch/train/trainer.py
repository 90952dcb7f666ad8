"""Trainer: the loop that ties pipeline + step + checkpoints + faults
(the port of `repro.train.trainer`).

Failure semantics follow the paper's error handler verbs: `replay`
re-runs a failed step (the deterministic, seekable pipeline makes the
replay exact), `continue` skips the batch, `abort` raises.  A node
failure restores the latest complete checkpoint into a new, uninitialized
state on the device and reseeks the pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.data import make_pipeline
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.fault import (FaultConfig, FaultInjector, FaultStats,
                                    NodeFailure, guarded_step)
from repro_torch.kernels.runtime import resolve_device
from .train_step import TrainState, init_train_state, make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    fault: FaultConfig = field(default_factory=FaultConfig)


class Trainer:
    """Trains `cfg` on the synthetic pipeline's batches, on the card
    unless `device` says otherwise.  The weights are drawn from
    `tcfg.seed`, as are the batches."""

    def __init__(self, cfg: ArchConfig, rcfg: RunConfig,
                 tcfg: TrainerConfig,
                 seq_len: int = 128, global_batch: int = 8,
                 step_fn: Optional[Callable] = None,
                 injector: Optional[FaultInjector] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        self.cfg = cfg
        self.rcfg = rcfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.stats = FaultStats()
        self.pipeline = make_pipeline(cfg.vocab_size, seq_len, global_batch,
                                      seed=tcfg.seed, put_fn=self._put)
        raw_step = step_fn or make_train_step(
            cfg, rcfg, total_steps=tcfg.total_steps)
        self._guarded = guarded_step(raw_step, tcfg.fault, self.stats,
                                     injector)
        self.history: List[Dict] = []

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def init_or_restore(self) -> TrainState:
        if self.tcfg.checkpoint_dir:
            info = ckpt.latest(self.tcfg.checkpoint_dir)
            if info is not None:
                like = init_train_state(self.tcfg.seed, self.cfg, self.rcfg,
                                        self.device, init=False)
                state = ckpt.restore(info.path, like)
                self.pipeline.seek(int(state["step"]))
                return state
        return init_train_state(self.tcfg.seed, self.cfg, self.rcfg,
                                self.device)

    def run(self, state: Optional[TrainState] = None,
            max_steps: Optional[int] = None) -> TrainState:
        state = state if state is not None else self.init_or_restore()
        start = int(state["step"])
        self.pipeline.seek(start)
        end = min(self.tcfg.total_steps,
                  start + (max_steps or self.tcfg.total_steps))
        for step, batch in self.pipeline:
            if step >= end:
                break
            try:
                state, metrics = self._guarded(state, batch, step)
            except NodeFailure:
                self.stats.node_failures += 1
                state = None            # the lost state, freed first
                state = self.init_or_restore()
                self.pipeline.seek(int(state["step"]))
                continue
            self.history.append(
                {k: float(v) for k, v in metrics.items()
                 if np.ndim(v) == 0})
            if self.tcfg.checkpoint_dir and \
                    (step + 1) % self.tcfg.checkpoint_every == 0:
                ckpt.save(state, self.tcfg.checkpoint_dir, step + 1)
                ckpt.prune(self.tcfg.checkpoint_dir,
                           self.tcfg.keep_checkpoints)
        return state
