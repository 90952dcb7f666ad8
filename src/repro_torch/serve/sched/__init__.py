"""Continuous-batching serve scheduler (the vLLM-class front door; the
port of `repro.serve.sched`).

* `alloc`  — `BlockAllocator`: paged-KV free list, refcounts, HOST swap
  slots, admission watermark;
* `sched`  — `Scheduler` + `ServeRequest`: FCFS admission, LIFO
  preemption on exhaustion, chunked prefill, completion-driven state
  transitions;
* `model`  — the model byte-contract: `HashLM` (deterministic numpy
  reference) and `oracle_generate` (the sequential one-request oracle);
* `front`  — `ServeFrontDoor`: turns step plans into descriptor traffic
  on one `IDMAEngine`, interrupt-driven completion;
* `steplm` — `StepLM`: the port's prefill/decode step functions bound to
  the dynamic batch.

`alloc`, `sched`, `model` and `front` are copies of the reference's
(host NumPy over `repro_torch.core`); `steplm` is rewritten in PyTorch.
"""

from .alloc import AllocStats, BlockAllocator
from .front import ServeFrontDoor, ServeMetrics, StepMetrics, serve_spec
from .model import HashLM, oracle_generate
from .sched import (ReqState, SchedStats, Scheduler, ServeRequest,
                    StepPlan)
from .steplm import StepLM

__all__ = [
    "AllocStats", "BlockAllocator", "HashLM", "ReqState", "SchedStats",
    "Scheduler", "ServeFrontDoor", "ServeMetrics", "ServeRequest",
    "StepLM", "StepMetrics", "StepPlan", "oracle_generate", "serve_spec",
]
