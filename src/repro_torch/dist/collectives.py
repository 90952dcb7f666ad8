"""Collective communication entry points (the port of
`repro.dist.collectives`).

Two layers live here:

* **Analytic plans/costs** (`ring_allreduce_plan`, `allreduce_cycles`,
  `allreduce_seconds`, `alltoall_plan`) — closed-form descriptor
  schedules and cycle estimates for sizing studies (the roofline and
  launch-planner paths).  These never simulate; a 1 GiB / 256-device
  allreduce costs microseconds to *estimate*.

* **The simulated fabric** (re-exported from `.fabric`) — real
  descriptor traffic across N engines on one contended `MemSystem`,
  byte-accurate and cycle-timed.  `tests/test_torch_collectives.py`
  holds this layer against the reference.

* **`compressed_psum`** — the int8-compressed sum over a mesh dim on
  `torch.distributed`.

Module import is numpy-only (`compressed_psum` imports torch when
called).
"""

from __future__ import annotations

import math
from typing import List

from repro_torch.core.descriptor import Transfer1D

from .fabric import (CollectiveFabric, CollectiveTrace, PhaseTrace,
                     fabric_spec, numpy_allgather, numpy_alltoall,
                     numpy_halving_allreduce, numpy_ring_allreduce)

__all__ = [
    "BUS_WIDTH_BYTES", "LINK_LATENCY_CYCLES", "CLOCK_HZ",
    "ring_allreduce_plan", "allreduce_cycles", "allreduce_seconds",
    "alltoall_plan",
    "CollectiveFabric", "CollectiveTrace", "PhaseTrace", "fabric_spec",
    "numpy_ring_allreduce", "numpy_halving_allreduce", "numpy_allgather",
    "numpy_alltoall", "compressed_psum",
]

#: analytic link model: one iDMA channel moving 8 B/cycle with a fixed
#: per-phase hop latency, clocked at 1.25 GHz (HBM-class fabric)
BUS_WIDTH_BYTES = 8
LINK_LATENCY_CYCLES = 100
CLOCK_HZ = 1.25e9

#: analytic plans split ring chunks into <= 64 KiB descriptor pieces
#: (the legalizer's burst-friendly sweet spot)
_MAX_PIECE = 1 << 16


def _chunk_byte_offsets(nbytes: int, world: int) -> List[int]:
    return [(i * nbytes) // world for i in range(world + 1)]


def _pieces(src: int, dst: int, length: int) -> List[Transfer1D]:
    out = []
    off = 0
    while off < length:
        ln = min(_MAX_PIECE, length - off)
        out.append(Transfer1D(src_addr=src + off, dst_addr=dst + off,
                              length=ln))
        off += ln
    return out


def ring_allreduce_plan(nbytes: int, world: int) -> List[List[Transfer1D]]:
    """The per-step descriptor lists of a ring allreduce, from rank 0's
    point of view: ``world - 1`` reduce-scatter steps pulling the
    rotating chunk from the left neighbour, then ``world - 1`` allgather
    steps.  ``2 * (world - 1)`` steps total; step ``s`` moves
    ``~nbytes / world`` bytes split into burst-friendly pieces."""
    if world < 2:
        return []
    offs = _chunk_byte_offsets(nbytes, world)
    steps: List[List[Transfer1D]] = []
    for s in range(world - 1):              # reduce-scatter
        c = (-1 - s) % world
        steps.append(_pieces(offs[c], offs[c], offs[c + 1] - offs[c]))
    for s in range(world - 1):              # allgather
        c = (-s) % world
        steps.append(_pieces(offs[c], offs[c], offs[c + 1] - offs[c]))
    return steps


def allreduce_cycles(nbytes: int, world: int) -> int:
    """Analytic ring-allreduce cost: ``2 (n-1)`` serialized phases, each
    ``ceil(chunk / bus) + hop latency`` cycles.  Doubling ``nbytes``
    asymptotically doubles the cost (the bandwidth term dominates)."""
    if world < 2 or nbytes <= 0:
        return 0
    offs = _chunk_byte_offsets(nbytes, world)
    total = 0
    for s in range(world - 1):
        c = (-1 - s) % world
        total += math.ceil((offs[c + 1] - offs[c]) / BUS_WIDTH_BYTES)
        total += LINK_LATENCY_CYCLES
    for s in range(world - 1):
        c = (-s) % world
        total += math.ceil((offs[c + 1] - offs[c]) / BUS_WIDTH_BYTES)
        total += LINK_LATENCY_CYCLES
    return total


def allreduce_seconds(nbytes: int, world: int) -> float:
    """`allreduce_cycles` at the fabric clock — the roofline's comms
    term."""
    return allreduce_cycles(nbytes, world) / CLOCK_HZ


def alltoall_plan(nbytes: int, world: int) -> List[List[Transfer1D]]:
    """Rank 0's all-to-all traffic (``nbytes`` per peer) spread over
    ``world // 2`` engine ports: ``world - 1`` peer transfers, dealt
    round-robin across the port lists."""
    nports = max(world // 2, 1)
    ports: List[List[Transfer1D]] = [[] for _ in range(nports)]
    for j in range(1, world):
        ports[(j - 1) % nports].append(
            Transfer1D(src_addr=j * nbytes, dst_addr=j * nbytes,
                       length=nbytes))
    return ports


def compressed_psum(x, axis_name: str, mesh):
    """int8-compressed sum of ``x`` over the ``axis_name`` dim of
    ``mesh``: symmetric per-tensor quantization (scale max|x| / 127,
    round half to even, clip to ±127), dequantization, then an
    `all_reduce` over the dim's group; returns a new tensor.  As in the
    reference, the sum runs on the *dequantized* tensor in ``x.dtype``,
    so the wire payload is ``x``'s size, not a quarter of it; only the
    values carry the quantization error (~1% relative)."""
    import torch
    import torch.distributed as dist

    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(x.dtype) * scale
    dist.all_reduce(deq, group=mesh.get_group(axis_name))
    return deq
