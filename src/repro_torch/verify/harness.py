"""Differential harness: engine batch path vs independent scalar oracle.

Every generated `Program` is executed four ways:

1. **base**   — `build_engine(spec)` with the plan cache off: the
   vectorized data plane (`execute_batch`), the event-driven timing
   fabric (`simulate_channels`) and the interrupt completion front-end;
2. **cached** — the same engine with a plan cache: the compile-once /
   replay-many descriptor pipeline (capture → rebind) must be
   byte- and cycle-identical to the uncached lowering;
3. **irq'd**  — the base engine under a different `IrqSpec` (heavier
   coalescing, fewer vectors): interrupt delivery batches callbacks but
   must never change cycles, bytes or record outcomes;
4. **oracle** — an independent scalar mirror of the control plane built
   on the scalar `execute` back-end, with its own `FaultInjector`
   instance; round cycle counts for single-channel programs come from
   `simulate_reference`, the paper-faithful scalar timing model.

The first check that fails produces a `Divergence` whose ``kind`` names
the broken equivalence; the shrinker preserves that kind while reducing
the program.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import (DescriptorBatch, FaultInjector, IrqSpec,
                              MemoryMap, NdTransfer, Protocol, TransferError,
                              build_engine, execute, legalize_batch,
                              mp_dist_batch, mp_split_batch,
                              simulate_reference, tensor_nd_batch)

from repro_torch.core.descriptor import GENERATOR_PROTOCOLS

from .generator import Program, fill_mem

#: the alternate interrupt shape run 3 uses — deliberately different from
#: every `IrqSpec` the generator emits on run 1
ALT_IRQ = IrqSpec(coalesce_count=4, coalesce_cycles=48, vectors=2)


@dataclass
class EngineRun:
    """Observable outcome of one full program execution."""

    spaces: Dict[Protocol, bytes]
    #: (bursts, bytes_moved, errors, replays, backoff_cycles)
    stats: Tuple[int, int, int, int, int]
    #: per completion record: (tid, count, status, bytes_moved)
    records: List[Tuple[int, int, str, int]]
    #: per failed drain round: (kind, index, src, dst, length)
    errors: List[Tuple]
    #: per drain round: backoff cycles
    round_backoff: List[int]
    #: per drain round: per-channel cycle counts (engine runs only)
    channel_cycles: List[Tuple[int, ...]] = field(default_factory=list)
    #: per drain round: aggregate cycles (engine runs only)
    round_cycles: List[int] = field(default_factory=list)
    #: delivered interrupt events as (tid, count, status, bytes) in
    #: delivery order (engine runs only)
    events: List[Tuple[int, int, str, int]] = field(default_factory=list)
    #: per drain round: `simulate_reference` cycles (oracle, 1-channel
    #: programs only; None when not applicable)
    ref_cycles: List[Optional[int]] = field(default_factory=list)


@dataclass
class Divergence:
    """One broken equivalence, carrying the program that exposed it."""

    kind: str
    detail: str
    program: Program

    def __str__(self) -> str:
        return (f"DIVERGENCE [{self.kind}] {self.detail}\n"
                f"{self.program.describe()}")


def _err_key(e: TransferError) -> Tuple:
    b = e.burst
    return (e.kind, e.index, b.src_addr, b.dst_addr, b.length)


def _enqueue(engine, program: Program) -> None:
    for sub in program.submissions:
        payload = sub.materialize()
        if sub.kind == "batch":
            engine.dispatch_batch(payload)
        else:
            engine.submit_async(payload)


def run_engine(program: Program, plan_cache=False,
               irq_override: Optional[IrqSpec] = None,
               schedule=None, tie_seed: Optional[int] = None) -> EngineRun:
    """Execute the program on a real engine; drain to completion, one
    `wait_all` round per propagated error.

    ``schedule``/``tie_seed`` forward to `IDMAEngine.wait_all` — the
    adversarial drain permutation and timing tie-break the sanitizer's
    differential contract is validated under (`repro_torch.verify.adversary`).
    """
    spec = program.spec
    if irq_override is not None:
        spec = dataclasses.replace(spec, irq=irq_override)
    engine = build_engine(spec, plan_cache=plan_cache)
    fill_mem(engine.mem, program.mem_seed)
    engine.fault_injector = FaultInjector(program.fault_sites)
    events: List[Tuple[int, int, str, int]] = []
    engine.on_complete(lambda vec, evs: events.extend(
        (ev.tid, ev.count, ev.status, ev.bytes_moved) for ev in evs))
    _enqueue(engine, program)

    errors: List[Tuple] = []
    round_backoff: List[int] = []
    round_cycles: List[int] = []
    channel_cycles: List[Tuple[int, ...]] = []
    guard = sum(len(q) for q in engine._queues) + 2
    while any(engine._queues):
        guard -= 1
        if guard < 0:
            raise RuntimeError(
                f"drain did not converge for seed {program.seed}")
        try:
            res = engine.wait_all(schedule=schedule, tie_seed=tie_seed)
        except TransferError as err:
            errors.append(_err_key(err))
            res = engine.last_channel_result
        round_backoff.append(res.backoff_cycles)
        round_cycles.append(res.aggregate.cycles)
        channel_cycles.append(tuple(r.cycles for r in res.per_channel))

    return EngineRun(
        spaces={p: engine.mem.spaces[p].tobytes()
                for p in engine.mem.spaces},
        stats=(engine.stats.bursts, engine.stats.bytes_moved,
               engine.stats.errors, engine.stats.replays,
               engine.stats.backoff_cycles),
        records=[(r.tid, r.count, r.status, r.bytes_moved)
                 for r in engine._records],
        errors=errors,
        round_backoff=round_backoff,
        round_cycles=round_cycles,
        channel_cycles=channel_cycles,
        events=events,
    )


# --------------------------------------------------------------------------
# Scalar oracle
# --------------------------------------------------------------------------

@dataclass
class _Rec:
    tid: int
    count: int
    channel: int
    status: str = "pending"
    bytes_moved: int = 0
    pending: int = 1


def run_oracle(program: Program) -> EngineRun:
    """Independent scalar mirror of the engine's control plane.

    Lowering reuses the shared descriptor-plane functions (mid-end
    stages, `mp_split`/`mp_dist`, `legalize_batch`) — the planes under
    differential test are the *data* plane (scalar `execute` vs
    `execute_batch`), the *timing* plane (`simulate_reference` vs
    `simulate_channels`), the plan cache and the interrupt front-end.
    The error-handler verb loop is replayed burst-by-burst with an
    independent `FaultInjector` built from the same seeded sites.
    """
    spec = program.spec
    policy = spec.backend.error_policy
    bw = spec.backend.bus_width
    nch = spec.channels.count
    cfg = spec.effective_sim_config
    mem = MemoryMap.create(dict(spec.mem_spaces))
    fill_mem(mem, program.mem_seed)
    inj = FaultInjector(program.fault_sites)

    def lower(payload) -> List[Tuple[DescriptorBatch, DescriptorBatch]]:
        """Mirror of the engine's uncached lowering; returns per port
        (legalized, pre-legalization) batch pairs — the pre-legalization
        rows are what `simulate_reference` legalizes itself, so its
        per-descriptor launch accounting matches the engine stream's
        ``owner`` grouping."""
        if isinstance(payload, DescriptorBatch):
            batch = payload
        elif isinstance(payload, NdTransfer):
            batch = tensor_nd_batch(payload)
        else:
            batch = DescriptorBatch.from_transfers([payload])
        for stage in spec.midend:
            batch = stage.apply(batch)
        if spec.backend.num_ports > 1:
            split = mp_split_batch(batch, spec.backend.boundary,
                                   which="dst")
            ports = mp_dist_batch(split, spec.backend.num_ports,
                                  scheme="address",
                                  boundary=spec.backend.boundary,
                                  which="dst")
        else:
            ports = [batch]
        return [(legalize_batch(p, bus_width=bw), p) for p in ports]

    # -- control plane: assign ids, shard, queue --------------------------
    next_id = 1
    rr = 0
    items: List[Tuple[int, int, object]] = []
    records: List[_Rec] = []
    for sub in program.submissions:
        payload = sub.materialize()
        if sub.kind == "batch":
            n = len(payload)
            tid0 = next_id
            next_id += n
            payload = dataclasses.replace(
                payload,
                transfer_id=np.arange(tid0, tid0 + n, dtype=np.int64))
            if nch == 1:
                shards = [payload]
            elif spec.channels.scheme == "address":
                shards = mp_dist_batch(payload, nch, scheme="address",
                                       boundary=spec.channels.boundary,
                                       which="dst")
            else:
                shards = mp_dist_batch(payload, nch,
                                       scheme=spec.channels.scheme)
            enq = 0
            for c, shard in enumerate(shards):
                if len(shard):
                    items.append((int(shard.transfer_id[0]), c, shard))
                    enq += 1
            records.append(_Rec(tid=tid0, count=n, channel=-1,
                                pending=max(enq, 1)))
        else:
            tid = next_id
            next_id += 1
            payload = dataclasses.replace(payload, transfer_id=tid)
            c = rr
            rr = (rr + 1) % nch
            items.append((tid, c, payload))
            records.append(_Rec(tid=tid, count=1, channel=c))

    def rec_for(tid: int) -> _Rec:
        for r in records:
            if r.tid <= tid < r.tid + r.count:
                return r
        raise KeyError(tid)

    stats = {"bursts": 0, "bytes": 0, "errors": 0, "replays": 0,
             "backoff": 0}
    errors: List[Tuple] = []
    round_backoff: List[int] = []
    ref_cycles: List[Optional[int]] = []

    items.sort(key=lambda it: it[0])
    while items:
        lowered = [(tid0, c, lower(payload))
                   for tid0, c, payload in items]

        # cycle oracle: single-channel streams replay on the scalar
        # reference timing model, fed the *pre-legalization* descriptors
        # (it legalizes per descriptor itself, so its launch accounting
        # matches the engine stream's owner grouping).  Restrictions:
        # `simulate_reference` models generator read latency with a
        # whole-stream flag — `simulate_channels` deliberately refines
        # this per burst — so mixed Init/memory streams are skipped, as
        # are configs whose sim bus width differs from the data plane's.
        if nch == 1 and cfg.bus_width == bw:
            stream = []
            for _, _, ports in lowered:
                for _, pre in ports:
                    stream.extend(pre.to_transfers())
            kinds = {t.src_protocol in GENERATOR_PROTOCOLS
                     for t in stream}
            if len(kinds) <= 1:
                ref = simulate_reference(stream, cfg, spec.src_system,
                                         spec.dst_system)
                ref_cycles.append(ref.cycles)
            else:
                ref_cycles.append(None)
        else:
            ref_cycles.append(None)

        backoff = 0
        cursor = 0
        failed = False
        for k, (tid0, c, ports) in enumerate(lowered):
            rec = rec_for(tid0)
            before = stats["bytes"]
            try:
                for port, _ in ports:
                    transfers = port.to_transfers()
                    n = len(transfers)
                    base = cursor
                    cursor += n
                    stats["bursts"] += n
                    if n:
                        backoff += inj.take_stalls(base, base + n)
                    lens = [t.length for t in transfers]
                    done = 0
                    replays = 0
                    while done < n:
                        fail = None
                        hit = inj.next_fault(base + done, base + n)
                        if hit is not None:
                            fail = hit - base - done
                        try:
                            moved = execute(transfers[done:], mem,
                                            bus_width=bw, fail_at=fail)
                            stats["bytes"] += moved
                            done = n
                        except TransferError as err:
                            stats["errors"] += 1
                            idx = done + err.index
                            err.index = idx
                            stats["bytes"] += sum(lens[done:idx])
                            if policy.action == "abort":
                                raise
                            if policy.action == "continue":
                                done = idx + 1
                            else:
                                replays += 1
                                stats["replays"] += 1
                                if replays > policy.max_replays:
                                    raise
                                backoff += policy.backoff_for(replays - 1)
                                done = idx
            except TransferError as err:
                rec.status = "error"
                rec.pending -= 1
                rec.bytes_moved += stats["bytes"] - before
                errors.append(_err_key(err))
                items = items[k + 1:]
                failed = True
                break
            rec.pending -= 1
            rec.bytes_moved += stats["bytes"] - before
            if rec.pending <= 0 and rec.status != "error":
                rec.status = "done"
        if not failed:
            items = []
        stats["backoff"] += backoff
        round_backoff.append(backoff)

    return EngineRun(
        spaces={p: mem.spaces[p].tobytes() for p in mem.spaces},
        stats=(stats["bursts"], stats["bytes"], stats["errors"],
               stats["replays"], stats["backoff"]),
        records=[(r.tid, r.count, r.status, r.bytes_moved)
                 for r in records],
        errors=errors,
        round_backoff=round_backoff,
        ref_cycles=ref_cycles,
    )


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------

def _first_byte_diff(a: bytes, b: bytes) -> int:
    view_a = np.frombuffer(a, dtype=np.uint8)
    view_b = np.frombuffer(b, dtype=np.uint8)
    return int(np.flatnonzero(view_a != view_b)[0])

def _cmp(kind: str, what: str, a, b, program: Program
         ) -> Optional[Divergence]:
    if a != b:
        return Divergence(kind, f"{what}: {a!r} != {b!r}", program)
    return None


def _cmp_spaces(kind: str, who: str, a: Dict[Protocol, bytes],
                b: Dict[Protocol, bytes], program: Program
                ) -> Optional[Divergence]:
    for proto in a:
        if a[proto] != b[proto]:
            off = _first_byte_diff(a[proto], b[proto])
            return Divergence(
                kind, f"{who}: {proto} bytes diverge at offset {off:#x}",
                program)
    return None


def check_program(program: Program) -> Optional[Divergence]:
    """Run all four executions and return the first broken equivalence
    (or None: the program passed)."""
    base = run_engine(program, plan_cache=False)
    cached = run_engine(program, plan_cache=64)
    irqd = run_engine(program, plan_cache=False, irq_override=ALT_IRQ)
    oracle = run_oracle(program)

    # 1. engine vs scalar oracle: bytes, accounting, verbs, records
    d = (_cmp_spaces("bytes", "engine-vs-oracle", base.spaces,
                     oracle.spaces, program)
         or _cmp("stats", "engine-vs-oracle stats "
                 "(bursts,bytes,errors,replays,backoff)",
                 base.stats, oracle.stats, program)
         or _cmp("records", "engine-vs-oracle completion records",
                 base.records, oracle.records, program)
         or _cmp("errors", "engine-vs-oracle propagated errors",
                 base.errors, oracle.errors, program)
         or _cmp("backoff", "engine-vs-oracle per-round backoff",
                 base.round_backoff, oracle.round_backoff, program))
    if d:
        return d

    # 2. timing: scalar reference model (single-channel programs whose
    #    round streams are homogeneous in source kind; see run_oracle)
    if program.spec.channels.count == 1:
        pairs = [(cc[0] if cc else 0, rc)
                 for cc, rc in zip(base.channel_cycles, oracle.ref_cycles)
                 if rc is not None]
        d = _cmp("cycles-ref", "simulate_channels vs simulate_reference",
                 [p[0] for p in pairs], [p[1] for p in pairs], program)
        if d:
            return d

    # 3. plan cache on/off: full identity
    d = (_cmp_spaces("cache-bytes", "cache-on-vs-off", base.spaces,
                     cached.spaces, program)
         or _cmp("cache-stats", "cache-on-vs-off stats", base.stats,
                 cached.stats, program)
         or _cmp("cache-records", "cache-on-vs-off records", base.records,
                 cached.records, program)
         or _cmp("cache-cycles", "cache-on-vs-off round cycles",
                 (base.round_cycles, base.channel_cycles,
                  base.round_backoff),
                 (cached.round_cycles, cached.channel_cycles,
                  cached.round_backoff), program)
         or _cmp("cache-errors", "cache-on-vs-off errors", base.errors,
                 cached.errors, program))
    if d:
        return d

    # 4. interrupt shape: delivery batching must be observationally inert
    d = (_cmp_spaces("irq-bytes", "irq-shape", base.spaces, irqd.spaces,
                     program)
         or _cmp("irq-cycles", "irq-shape round cycles",
                 (base.round_cycles, base.channel_cycles,
                  base.round_backoff),
                 (irqd.round_cycles, irqd.channel_cycles,
                  irqd.round_backoff), program)
         or _cmp("irq-records", "irq-shape records", base.records,
                 irqd.records, program)
         or _cmp("irq-events", "irq-shape delivered events",
                 sorted(base.events), sorted(irqd.events), program))
    if d:
        return d

    # 5. interrupt coverage: exactly one terminal event per record, with
    #    the record's terminal status and (for completions) its bytes
    want_events = sorted(
        (tid, count, status, bytes_moved)
        for tid, count, status, bytes_moved in base.records)
    got_events = sorted(
        (tid, count, status,
         bytes_moved if status == "done" else
         dict((r[0], r[3]) for r in base.records)[tid])
        for tid, count, status, bytes_moved in base.events)
    return _cmp("events", "interrupt events vs completion records",
                want_events, got_events, program)
