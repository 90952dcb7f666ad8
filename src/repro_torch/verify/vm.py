"""Differential ``vm`` family: virtual-memory mid-end vs scalar oracle.

Programs submit descriptor batches whose addresses are *virtual*: the
engine under test lowers them through a `TranslateStage` (vectorized
page split + TLB-cached table walk), runs the page-fault verb loop of
`ErrorPolicy` (``pin``/``retry``/``replay``/``continue``/``abort``) and
executes the translated bursts.  The oracle re-derives everything with
scalar code: a per-row boundary-split loop, a direct page-table walk per
segment, and a verb loop that mirrors `IDMAEngine._handle_page_fault`
event by event — then executes through the scalar ``execute`` back-end.

Generated programs deliberately include:

* random page tables (per-seed page size, permuted frames, an optional
  untranslated OBI space riding in the same batches);
* deliberately unmapped pages on both ports (fault bait — cranked up by
  ``storm=True``, the CI fault-storm smoke knob);
* mid-drain remap / unmap / invalidate ops between submission rounds
  (TLB shootdown + plan-cache epoch revalidation);
* linked scatter-gather list and MoE expert-routing gather batches
  built by the `core.vm` helpers, submitted by VA;
* structurally-identical follow-up submissions shifted by whole pages,
  so the error-policy verbs also fire on *plan-cache-hit* lowerings
  (compared byte-for-byte against the cold path).

Three executions per program: engine with the plan cache off, engine
with the cache on (full identity required, including cycles), and the
scalar oracle (bytes, stats, records incl. the faulted-page bitmap,
propagated errors, per-round backoff).  Page faults propagate with the
legalized burst index under the cached path and the pre-legalization
segment index under the cold path, so propagated faults are compared by
``(kind, space, vpn)`` — the faulting *page* — rather than burst
coordinates.  Timing-reference and interrupt-shape equivalences are
covered by the other families and are not re-checked here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (DescriptorBatch, MemoryMap, Protocol, Transfer1D,
                              TransferError, build_engine, execute,
                              legalize_batch, mp_dist_batch)
from repro_torch.core.descriptor import CODE_PROTO, PROTO_CODE
from repro_torch.core.engine import ErrorPolicy
from repro_torch.core.spec import BackendSpec, ChannelSpec, EngineSpec
from repro_torch.core.vm import (PageTable, TranslateStage,
                                 expert_gather_batch, read_sg_list,
                                 sg_gather_batch, write_sg_list)

from .generator import fill_mem
from .harness import Divergence, _cmp, _cmp_spaces

__all__ = ["VmProgram", "VmRound", "VmSub", "check_vm_program",
           "generate_vm_program", "run_vm_engine", "run_vm_oracle",
           "shrink_vm_program"]

# -- address-space layout (units of one page) ------------------------------
#
#   frames  0..15   source pool        (vpns 0..15, all but 14/15 mapped)
#   frames 16..55   destination pool   (vpns 16..55, holes = fault bait)
#   frames 56..87   page-fault handler reserve (retry/replay verb maps)
#   frames 88..95   remap spares (mid-drain remap ops)
#   frames 96..127  pin window (pin-on-demand allocator)
N_PAGES = 128
SRC_LO, SRC_HI = 0, 16
DST_LO, DST_HI = 16, 56
HANDLER_LO, HANDLER_HI = 56, 88
SPARE_LO, SPARE_HI = 88, 96
PIN_LO, PIN_COUNT = 96, 32


@dataclass
class VmSub:
    """One control-plane submission, rows stored as plain columns.

    ``kind`` — ``"batch"`` (`dispatch_batch`) or ``"single"``
    (`submit_async` of row 0); ``label`` records how the rows were
    built (``rows`` / ``sg`` / ``moe`` / ``repeat``) for `describe`.
    Protocols are stored as descriptor-plane codes.
    """

    kind: str
    label: str
    src: Tuple[int, ...]
    dst: Tuple[int, ...]
    length: Tuple[int, ...]
    src_proto: Tuple[int, ...]
    dst_proto: Tuple[int, ...]

    def materialize(self):
        if self.kind == "single":
            return Transfer1D(
                src_addr=self.src[0], dst_addr=self.dst[0],
                length=self.length[0],
                src_protocol=CODE_PROTO[self.src_proto[0]],
                dst_protocol=CODE_PROTO[self.dst_proto[0]])
        return DescriptorBatch.from_arrays(
            src_addr=np.asarray(self.src, dtype=np.int64),
            dst_addr=np.asarray(self.dst, dtype=np.int64),
            length=np.asarray(self.length, dtype=np.int64),
            src_proto=np.asarray(self.src_proto, dtype=np.uint8),
            dst_proto=np.asarray(self.dst_proto, dtype=np.uint8))

    @property
    def num_rows(self) -> int:
        return 1 if self.kind == "single" else len(self.src)


@dataclass
class VmRound:
    """Page-table ops applied before one enqueue+drain round."""

    ops: Tuple[Tuple, ...]
    subs: Tuple[VmSub, ...]


@dataclass
class VmProgram:
    """One seeded vm-family program (see module docstring)."""

    seed: int
    action: str
    max_replays: int
    replay_backoff: int
    backoff_cap: int
    channels: int
    page: int
    tlb_capacity: int
    use_obi: bool
    #: initial AXI4 table image as (vpn, ppn) pairs
    init_map: Tuple[Tuple[int, int], ...]
    #: retry/replay verb decisions: faultable vpn -> ppn, or None (refuse)
    handler_map: Dict[int, Optional[int]]
    rounds: Tuple[VmRound, ...]
    family: str = "vm"
    mem_seed: int = 0
    fault_sites: List = field(default_factory=list)

    @property
    def submissions(self) -> List[VmSub]:
        return [s for rnd in self.rounds for s in rnd.subs]

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.submissions)

    def policy(self) -> ErrorPolicy:
        return ErrorPolicy(action=self.action, max_replays=self.max_replays,
                           replay_backoff=self.replay_backoff,
                           backoff_cap=self.backoff_cap)

    def make_table(self) -> PageTable:
        """A fresh page table per run — pins and handler maps mutate it."""
        table = PageTable({Protocol.AXI4: self.page},
                          pin_windows={Protocol.AXI4: (PIN_LO, PIN_COUNT)})
        for vpn, ppn in self.init_map:
            table.map(Protocol.AXI4, vpn, ppn)
        return table

    def make_spec(self) -> EngineSpec:
        spaces: List[Tuple[Protocol, int]] = [
            (Protocol.AXI4, N_PAGES * self.page)]
        if self.use_obi:
            spaces.append((Protocol.OBI, 32 << 10))
        stage = TranslateStage(self.make_table(),
                               tlb_capacity=self.tlb_capacity)
        return EngineSpec(
            name=f"vm_{self.seed}",
            midend=(stage,),
            backend=BackendSpec(protocols=tuple(p for p, _ in spaces),
                                bus_width=8, error_policy=self.policy()),
            channels=ChannelSpec(count=self.channels),
            mem_spaces=tuple(spaces))

    def describe(self) -> str:
        lines = [
            f"vm program seed={self.seed}",
            f"  policy: {self.action} max_replays={self.max_replays}"
            f" backoff={self.replay_backoff}/{self.backoff_cap}"
            f" channels={self.channels} page={self.page}"
            f" tlb={self.tlb_capacity} obi={self.use_obi}",
            f"  table: {len(self.init_map)} mapped, handler="
            + "{" + ", ".join(
                f"{v}:{p if p is not None else 'refuse'}"
                for v, p in sorted(self.handler_map.items())) + "}",
        ]
        for i, rnd in enumerate(self.rounds):
            lines.append(f"  round {i}: ops={list(rnd.ops)!r}")
            for sub in rnd.subs:
                lines.append(f"    {sub.kind}/{sub.label} "
                             f"rows={sub.num_rows}")
                for k in range(sub.num_rows):
                    lines.append(
                        f"      {CODE_PROTO[sub.src_proto[k]].name}"
                        f" {sub.src[k]:#x} -> "
                        f"{CODE_PROTO[sub.dst_proto[k]].name}"
                        f" {sub.dst[k]:#x} len={sub.length[k]}")
        return "\n".join(lines)


def _apply_ops(table: PageTable, ops: Sequence[Tuple]) -> None:
    for op in ops:
        if op[0] == "map" or op[0] == "remap":
            table.map(Protocol.AXI4, op[1], op[2])
        elif op[0] == "unmap":
            table.unmap(Protocol.AXI4, op[1])
        else:                                    # ("invalidate",)
            table.invalidate()


# --------------------------------------------------------------------------
# Engine execution
# --------------------------------------------------------------------------

@dataclass
class VmRun:
    """Observable outcome of one vm-program execution."""

    spaces: Dict[Protocol, bytes]
    #: (bursts, bytes, errors, replays, backoff,
    #:  continues, aborts, pins, retries, page_faults)
    stats: Tuple[int, ...]
    #: per record: (tid, count, status, bytes_moved, faulted_pages)
    records: List[Tuple]
    #: per propagated fault: (kind, space, vpn) — the faulting page
    errors: List[Tuple]
    round_backoff: List[int]
    round_cycles: List[int] = field(default_factory=list)
    channel_cycles: List[Tuple[int, ...]] = field(default_factory=list)


def _vm_err_key(err: TransferError) -> Tuple:
    """Propagated page faults are compared by faulting page: the burst
    index (and the burst's span) differ between the cold path (raises on
    the pre-legalization segment) and the plan-replay path (raises on
    the legalized burst), but the page is the same."""
    return (err.kind, getattr(err, "space", None), getattr(err, "vpn", None))


def run_vm_engine(program: VmProgram, plan_cache=False) -> VmRun:
    """Execute the program on a real engine, one drain per round, with
    the program's table ops applied to the live stage between rounds."""
    spec = program.make_spec()
    stage = spec.midend[0]
    engine = build_engine(spec, plan_cache=plan_cache)
    fill_mem(engine.mem, program.mem_seed)
    if program.action in ("retry", "replay"):
        hm = program.handler_map

        def handler(fault, attempt):
            ppn = hm.get(fault.vpn)
            if ppn is not None:
                fault.table.map(fault.space, fault.vpn, ppn)

        engine.page_fault_handler = handler

    errors: List[Tuple] = []
    round_backoff: List[int] = []
    round_cycles: List[int] = []
    channel_cycles: List[Tuple[int, ...]] = []
    for rnd in program.rounds:
        _apply_ops(stage.table, rnd.ops)
        for sub in rnd.subs:
            payload = sub.materialize()
            if sub.kind == "batch":
                engine.dispatch_batch(payload)
            else:
                engine.submit_async(payload)
        guard = sum(len(q) for q in engine._queues) + 2
        while any(engine._queues):
            guard -= 1
            if guard < 0:
                raise RuntimeError(
                    f"vm drain did not converge for seed {program.seed}")
            try:
                res = engine.wait_all()
            except TransferError as err:
                errors.append(_vm_err_key(err))
                res = engine.last_channel_result
            round_backoff.append(res.backoff_cycles)
            round_cycles.append(res.aggregate.cycles)
            channel_cycles.append(tuple(r.cycles for r in res.per_channel))

    st = engine.stats
    return VmRun(
        spaces={p: engine.mem.spaces[p].tobytes()
                for p in engine.mem.spaces},
        stats=(st.bursts, st.bytes_moved, st.errors, st.replays,
               st.backoff_cycles, st.continues, st.aborts, st.pins,
               st.retries, st.page_faults),
        records=[(r.tid, r.count, r.status, r.bytes_moved,
                  tuple(r.faulted_pages)) for r in engine._records],
        errors=errors,
        round_backoff=round_backoff,
        round_cycles=round_cycles,
        channel_cycles=channel_cycles)


# --------------------------------------------------------------------------
# Scalar oracle
# --------------------------------------------------------------------------

class _VmFault(Exception):
    """Terminal lowering fault inside the oracle: carries the engine's
    error key and the backoff charged before giving up."""

    def __init__(self, key: Tuple, backoff: int) -> None:
        super().__init__(str(key))
        self.key = key
        self.backoff = backoff


@dataclass
class _Rec:
    tid: int
    count: int
    channel: int
    status: str = "pending"
    bytes_moved: int = 0
    pending: int = 1
    faulted_pages: Tuple = ()


def run_vm_oracle(program: VmProgram) -> VmRun:
    """Independent scalar mirror: per-row boundary-split loop, direct
    table walk per segment, and a verb loop replaying the engine's
    `_handle_page_fault` decisions event by event."""
    policy = program.policy()
    action = policy.action
    page = program.page
    shift = page.bit_length() - 1
    axi = PROTO_CODE[Protocol.AXI4]
    nch = program.channels
    bw = 8
    table = program.make_table()
    spaces: List[Tuple[Protocol, int]] = [(Protocol.AXI4, N_PAGES * page)]
    if program.use_obi:
        spaces.append((Protocol.OBI, 32 << 10))
    mem = MemoryMap.create(dict(spaces))
    fill_mem(mem, program.mem_seed)

    def split_rows(rows) -> List[Tuple[int, int, int, int, int]]:
        """Scalar page split: cut each row at the union of both ports'
        page boundaries (only the translated AXI4 space constrains)."""
        segs = []
        for (src, dst, length, sp, dp) in rows:
            ps = page if sp == axi else 0
            pd = page if dp == axi else 0
            off = 0
            while off < length:
                step = length - off
                if ps:
                    step = min(step, ps - ((src + off) % ps))
                if pd:
                    step = min(step, pd - ((dst + off) % pd))
                segs.append((src + off, dst + off, step, sp, dp))
                off += step
        return segs

    def first_fault(segs):
        """(index, va, vpn, seg) of the first unmapped access, scanning
        segments in order with the source port before the destination —
        the sort order `TranslateStage._raise_first` uses."""
        for i, (s, d, length, sp, dp) in enumerate(segs):
            for addr, code in ((s, sp), (d, dp)):
                if code != axi:
                    continue
                vpn = addr >> shift
                if table.walk(Protocol.AXI4, vpn) is None:
                    return i, addr, vpn, (s, d, length)
        return None

    def xlate(addr: int, code: int) -> int:
        if code != axi:
            return addr
        ppn = table.walk(Protocol.AXI4, addr >> shift)
        return (ppn << shift) | (addr & (page - 1))

    def lower_item(rows, stats) -> Tuple[List, Tuple, int]:
        """Mirror of `_lower_ports` for one queue item: returns the
        translated segments, the continue-dropped pages and the backoff
        charged; raises `_VmFault` on abort/exhaustion."""
        if action == "continue":
            keep, pages, seen = [], [], set()
            for seg in split_rows(rows):
                bad = []
                for addr, code in ((seg[0], seg[3]), (seg[1], seg[4])):
                    if code == axi and \
                            table.walk(Protocol.AXI4, addr >> shift) is None:
                        bad.append((Protocol.AXI4.name, addr >> shift))
                if bad:
                    for key in bad:
                        if key not in seen:
                            seen.add(key)
                            pages.append(key)
                else:
                    keep.append(seg)
            stats["page_faults"] += len(pages)
            return keep, tuple(pages), 0

        attempts: Dict[int, int] = {}
        backoff = 0
        while True:
            segs = split_rows(rows)
            hit = first_fault(segs)
            if hit is None:
                return segs, (), backoff
            i, va, vpn, _seg = hit
            stats["errors"] += 1
            stats["page_faults"] += 1
            key = ("page-fault", Protocol.AXI4, vpn)
            if action == "abort":
                stats["aborts"] += 1
                raise _VmFault(key, backoff)
            n = attempts.get(vpn, 0) + 1
            attempts[vpn] = n
            bound = policy.max_replays + 1 if action == "pin" \
                else policy.max_replays
            if n > bound:
                stats["aborts"] += 1
                raise _VmFault(key, backoff)
            backoff += policy.backoff_for(n - 1)
            if action == "pin":
                stats["pins"] += 1
                table.pin(Protocol.AXI4, vpn)
            else:
                stats["retries" if action == "retry"
                      else "replays"] += 1
                ppn = program.handler_map.get(vpn)
                if ppn is not None:
                    table.map(Protocol.AXI4, vpn, ppn)

    def rows_of(payload):
        if isinstance(payload, Transfer1D):
            return [(payload.src_addr, payload.dst_addr, payload.length,
                     PROTO_CODE[payload.src_protocol],
                     PROTO_CODE[payload.dst_protocol])]
        return [(int(payload.src_addr[i]), int(payload.dst_addr[i]),
                 int(payload.length[i]), int(payload.src_proto[i]),
                 int(payload.dst_proto[i])) for i in range(len(payload))]

    stats = {"bursts": 0, "bytes": 0, "errors": 0, "replays": 0,
             "backoff": 0, "continues": 0, "aborts": 0, "pins": 0,
             "retries": 0, "page_faults": 0}
    records: List[_Rec] = []
    errors: List[Tuple] = []
    round_backoff: List[int] = []
    next_id = 1
    rr = 0

    def rec_for(tid: int) -> _Rec:
        for r in records:
            if r.tid <= tid < r.tid + r.count:
                return r
        raise KeyError(tid)

    for rnd in program.rounds:
        _apply_ops(table, rnd.ops)
        items: List[Tuple[int, int, object]] = []
        for sub in rnd.subs:
            payload = sub.materialize()
            if sub.kind == "batch":
                n = len(payload)
                tid0 = next_id
                next_id += n
                payload = dataclasses.replace(
                    payload,
                    transfer_id=np.arange(tid0, tid0 + n, dtype=np.int64))
                shards = [payload] if nch == 1 else \
                    mp_dist_batch(payload, nch, scheme="round_robin")
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
                c = rr
                rr = (rr + 1) % nch
                items.append((tid, c, payload))
                records.append(_Rec(tid=tid, count=1, channel=c))

        items.sort(key=lambda it: it[0])
        while items:
            backoff = 0
            fault_at: Dict[int, Tuple] = {}
            lowered: Dict[int, List] = {}
            pages_of: Dict[int, Tuple] = {}
            for tid0, c, payload in items:
                try:
                    segs, pages, b = lower_item(rows_of(payload), stats)
                except _VmFault as f:
                    fault_at[tid0] = f.key
                    backoff += f.backoff
                    continue
                backoff += b
                lowered[tid0] = segs
                if pages:
                    pages_of[tid0] = pages
            failed = False
            for k, (tid0, c, payload) in enumerate(items):
                rec = rec_for(tid0)
                if tid0 in fault_at:
                    rec.status = "error"
                    rec.pending -= 1
                    errors.append(fault_at[tid0])
                    items = items[k + 1:]
                    failed = True
                    break
                segs = lowered[tid0]
                if segs:
                    batch = DescriptorBatch.from_arrays(
                        src_addr=np.asarray(
                            [xlate(s, sp) for s, d, ln, sp, dp in segs],
                            dtype=np.int64),
                        dst_addr=np.asarray(
                            [xlate(d, dp) for s, d, ln, sp, dp in segs],
                            dtype=np.int64),
                        length=np.asarray([ln for _, _, ln, _, _ in segs],
                                          dtype=np.int64),
                        src_proto=np.asarray([sp for *_, sp, _ in segs],
                                             dtype=np.uint8),
                        dst_proto=np.asarray([dp for *_, dp in segs],
                                             dtype=np.uint8))
                    transfers = legalize_batch(
                        batch, bus_width=bw).to_transfers()
                    stats["bursts"] += len(transfers)
                    moved = execute(transfers, mem, bus_width=bw)
                    stats["bytes"] += moved
                    rec.bytes_moved += moved
                rec.pending -= 1
                rec.faulted_pages = rec.faulted_pages + \
                    pages_of.get(tid0, ())
                if rec.pending <= 0 and rec.status != "error":
                    rec.status = "done"
            if not failed:
                items = []
            stats["backoff"] += backoff
            round_backoff.append(backoff)

    return VmRun(
        spaces={p: mem.spaces[p].tobytes() for p in mem.spaces},
        stats=(stats["bursts"], stats["bytes"], stats["errors"],
               stats["replays"], stats["backoff"], stats["continues"],
               stats["aborts"], stats["pins"], stats["retries"],
               stats["page_faults"]),
        records=[(r.tid, r.count, r.status, r.bytes_moved,
                  r.faulted_pages) for r in records],
        errors=errors,
        round_backoff=round_backoff)


# --------------------------------------------------------------------------
# Generation
# --------------------------------------------------------------------------

def generate_vm_program(seed: int, storm: bool = False) -> VmProgram:
    ss = np.random.SeedSequence([0x7A9E, seed])
    rng = np.random.default_rng(ss)
    page = int(rng.choice([4096, 8192]))
    action = str(rng.choice(
        ["replay", "continue", "abort", "pin", "retry"]))
    # the pin allocator hands out frames in fault order; with >1 channel
    # the engine's channel-major lowering order and the oracle's
    # tid-major order would pin different frames
    channels = 1 if action == "pin" else int(rng.integers(1, 3))
    unmapped_rate = 0.5 if storm else 0.15
    use_obi = bool(rng.random() < 0.35)

    # -- initial table: permuted frames, holes as fault bait --------------
    src_ppn = rng.permutation(SRC_HI - SRC_LO) + SRC_LO
    dst_ppn = rng.permutation(DST_HI - DST_LO) + DST_LO
    init_map: List[Tuple[int, int]] = []
    faultable: set = set()
    mapped_dst: List[int] = []
    unmapped_dst: List[int] = []
    for v in range(SRC_LO, SRC_HI):
        if v >= 14 and rng.random() < (0.5 if storm else 0.25):
            faultable.add(v)
            continue
        init_map.append((v, int(src_ppn[v - SRC_LO])))
    reserved = {v: int(dst_ppn[v - DST_LO]) for v in range(DST_LO, DST_HI)}
    for v in range(DST_LO, DST_HI):
        if rng.random() < unmapped_rate:
            faultable.add(v)
            unmapped_dst.append(v)
        else:
            init_map.append((v, reserved[v]))
            mapped_dst.append(v)

    # -- rounds: table ops + submissions ----------------------------------
    n_rounds = int(rng.integers(1, 4))
    spare = iter(range(SPARE_LO, SPARE_HI))
    rounds: List[VmRound] = []
    for r in range(n_rounds):
        ops: List[Tuple] = []
        if r > 0:
            for _ in range(int(rng.integers(0, 3))):
                kind = rng.choice(["map", "remap", "unmap", "invalidate"])
                if kind == "map" and unmapped_dst:
                    v = unmapped_dst.pop(int(rng.integers(len(unmapped_dst))))
                    ops.append(("map", v, reserved[v]))
                    mapped_dst.append(v)
                elif kind == "remap" and mapped_dst:
                    v = mapped_dst[int(rng.integers(len(mapped_dst)))]
                    try:
                        ops.append(("remap", v, next(spare)))
                    except StopIteration:
                        pass
                elif kind == "unmap" and len(mapped_dst) > 4:
                    v = mapped_dst.pop(int(rng.integers(len(mapped_dst))))
                    ops.append(("unmap", v))
                    faultable.add(v)
                    unmapped_dst.append(v)
                else:
                    ops.append(("invalidate",))
        subs = _gen_round_subs(rng, page, use_obi)
        rounds.append(VmRound(ops=tuple(ops), subs=tuple(subs)))

    handler_iter = iter(range(HANDLER_LO, HANDLER_HI))
    handler_map: Dict[int, Optional[int]] = {}
    for v in sorted(faultable):
        handler_map[v] = next(handler_iter) if rng.random() < 0.7 else None

    return VmProgram(
        seed=seed,
        action=action,
        max_replays=int(rng.integers(0, 4)),
        replay_backoff=int(rng.choice([0, 5, 17])),
        backoff_cap=int(rng.choice([1 << 16, 64])),
        channels=channels,
        page=page,
        tlb_capacity=int(rng.choice([4, 64, 256])),
        use_obi=use_obi,
        init_map=tuple(init_map),
        handler_map=handler_map,
        rounds=tuple(rounds),
        mem_seed=int(rng.integers(0, 2**31)))


def _gen_round_subs(rng, page: int, use_obi: bool) -> List[VmSub]:
    obi = PROTO_CODE[Protocol.OBI]
    axi = PROTO_CODE[Protocol.AXI4]

    def axi_len() -> int:
        kind = rng.random()
        if kind < 0.4:
            return int(rng.integers(1, 65))
        if kind < 0.7:
            return int(page + rng.integers(-16, 17))
        return int(rng.integers(page, 2 * page + 1))

    def make_rows(n: int, repeatable: bool,
                  alloc: List[int]) -> List[Tuple]:
        rows = []
        for _ in range(n):
            mode = rng.random()
            if not repeatable and use_obi and mode < 0.3:
                length = int(rng.integers(1, 257))
                if mode < 0.1:          # OBI -> OBI
                    src = int(rng.integers(0, 8192 - length))
                    dst = (16 << 10) + alloc[1]
                    alloc[1] += length + int(rng.integers(0, 33))
                    if dst + length > (32 << 10):
                        continue
                    rows.append((src, dst, length, obi, obi))
                elif mode < 0.2:        # AXI4 -> OBI
                    src = int(rng.integers(0, 13 * page))
                    dst = (16 << 10) + alloc[1]
                    alloc[1] += length + int(rng.integers(0, 33))
                    if dst + length > (32 << 10):
                        continue
                    rows.append((src, dst, length, axi, obi))
                else:                   # OBI -> AXI4
                    src = int(rng.integers(0, 8192 - length))
                    dst = DST_LO * page + alloc[0]
                    alloc[0] += length + int(rng.integers(0, 65))
                    if dst + length > 44 * page:
                        continue
                    rows.append((src, dst, length, obi, axi))
                continue
            length = axi_len()
            if repeatable:
                vpn = int(rng.integers(0, 11))
            elif rng.random() < 0.12:
                vpn = 13                 # spills into the 14/15 fault bait
            else:
                vpn = int(rng.integers(0, 12))
            src = vpn * page + int(rng.integers(0, page))
            dst = DST_LO * page + alloc[0]
            alloc[0] += length + int(rng.integers(0, 65))
            if dst + length > 44 * page:
                continue
            rows.append((src, dst, length, axi, axi))
        return rows

    def pack(kind: str, label: str, rows: List[Tuple]) -> VmSub:
        return VmSub(kind=kind, label=label,
                     src=tuple(r[0] for r in rows),
                     dst=tuple(r[1] for r in rows),
                     length=tuple(r[2] for r in rows),
                     src_proto=tuple(r[3] for r in rows),
                     dst_proto=tuple(r[4] for r in rows))

    subs: List[VmSub] = []
    for _ in range(int(rng.integers(1, 4))):
        alloc = [0, 0]                  # [AXI4 dst cursor, OBI dst cursor]
        pick = rng.random()
        if pick < 0.15:
            # linked scatter-gather list, built through the core helpers
            n_nodes = int(rng.integers(2, 6))
            entries = [(int(rng.integers(0, 13 * page)),
                        int(rng.integers(8, 301)))
                       for _ in range(n_nodes)]
            buf = np.zeros(4096, dtype=np.uint8)
            addrs = [i * 64 for i in range(n_nodes)]
            head = write_sg_list(buf, addrs, entries)
            nodes = read_sg_list(buf, head)
            batch = sg_gather_batch(
                buf, head, DST_LO * page + int(rng.integers(0, page)))
            assert len(nodes) == n_nodes and len(batch) == n_nodes
            subs.append(pack("batch", "sg", [
                (int(batch.src_addr[i]), int(batch.dst_addr[i]),
                 int(batch.length[i]), axi, axi)
                for i in range(len(batch))]))
        elif pick < 0.3:
            # MoE expert-routing gather (sparse VA gather, dense slots)
            t = int(rng.integers(8, 25))
            k = int(rng.choice([1, 2]))
            d_bytes = int(rng.choice([64, 128]))
            base = int(rng.integers(0, 12)) * page
            token_va = base + np.arange(t, dtype=np.int64) * d_bytes
            idx = rng.integers(0, 4, size=(t,) if k == 1 else (t, k))
            batch = expert_gather_batch(
                token_va, idx, n_experts=4, capacity=8, d_bytes=d_bytes,
                expert_buf_va=DST_LO * page + int(rng.integers(0, 8)) * 4096)
            if len(batch):
                subs.append(pack("batch", "moe", [
                    (int(batch.src_addr[i]), int(batch.dst_addr[i]),
                     int(batch.length[i]), axi, axi)
                    for i in range(len(batch))]))
        elif pick < 0.42:
            rows = make_rows(1, False, alloc)
            if rows:
                subs.append(pack("single", "rows", rows))
        else:
            repeat = rng.random() < 0.35
            rows = make_rows(int(rng.integers(1, 7)), repeat, alloc)
            if not rows:
                continue
            subs.append(pack("batch", "rows", rows))
            if repeat:
                # page-shifted twin: same lengths, same residues — the
                # second lowering hits the plan cache, so the fault verbs
                # also fire on the rebind path (satellite: verb-on-hit)
                ds = page * int(rng.integers(0, 3))
                dd = page * int(rng.integers(1, 9))
                subs.append(pack("batch", "repeat", [
                    (s + ds, d + dd, ln, sp, dp)
                    for s, d, ln, sp, dp in rows]))
    if not subs:
        alloc = [0, 0]
        rows = make_rows(2, False, alloc) or \
            [(0, DST_LO * page, 64, axi, axi)]
        subs.append(pack("batch", "rows", rows))
    return subs


# --------------------------------------------------------------------------
# Check + shrink
# --------------------------------------------------------------------------

def check_vm_program(program: VmProgram) -> Optional[Divergence]:
    """Engine (cache off), engine (cache on) and scalar oracle must
    agree; returns the first broken equivalence or None."""
    base = run_vm_engine(program, plan_cache=False)
    cached = run_vm_engine(program, plan_cache=64)
    oracle = run_vm_oracle(program)

    d = (_cmp_spaces("vm-bytes", "engine-vs-oracle", base.spaces,
                     oracle.spaces, program)
         or _cmp("vm-stats", "engine-vs-oracle stats (bursts,bytes,"
                 "errors,replays,backoff,continues,aborts,pins,"
                 "retries,page_faults)",
                 base.stats, oracle.stats, program)
         or _cmp("vm-records", "engine-vs-oracle completion records",
                 base.records, oracle.records, program)
         or _cmp("vm-errors", "engine-vs-oracle propagated page faults",
                 base.errors, oracle.errors, program)
         or _cmp("vm-backoff", "engine-vs-oracle per-round backoff",
                 base.round_backoff, oracle.round_backoff, program))
    if d:
        return d

    return (_cmp_spaces("vm-cache-bytes", "cache-on-vs-off", base.spaces,
                        cached.spaces, program)
            or _cmp("vm-cache-stats", "cache-on-vs-off stats",
                    base.stats, cached.stats, program)
            or _cmp("vm-cache-records", "cache-on-vs-off records",
                    base.records, cached.records, program)
            or _cmp("vm-cache-errors", "cache-on-vs-off propagated "
                    "page faults", base.errors, cached.errors, program)
            or _cmp("vm-cache-cycles", "cache-on-vs-off round cycles",
                    (base.round_cycles, base.channel_cycles,
                     base.round_backoff),
                    (cached.round_cycles, cached.channel_cycles,
                     cached.round_backoff), program))


def shrink_vm_program(program: VmProgram, divergence: Divergence,
                      budget: int = 200):
    """Greedy shrink: drop whole submissions, then rows within them,
    then table ops, preserving the divergence kind."""
    best_p, best_d = program, divergence
    tries = 0

    def still_fails(cand: VmProgram) -> Optional[Divergence]:
        nonlocal tries
        tries += 1
        try:
            d = check_vm_program(cand)
        except Exception:
            return None
        return d if d is not None and d.kind == best_d.kind else None

    changed = True
    while changed and tries < budget:
        changed = False
        # drop one submission at a time
        for ri, rnd in enumerate(best_p.rounds):
            for si in range(len(rnd.subs)):
                subs = rnd.subs[:si] + rnd.subs[si + 1:]
                new_rounds = list(best_p.rounds)
                new_rounds[ri] = VmRound(ops=rnd.ops, subs=subs)
                cand = dataclasses.replace(
                    best_p, rounds=tuple(r for r in new_rounds if r.subs))
                if not cand.rounds:
                    continue
                d = still_fails(cand)
                if d is not None:
                    best_p, best_d = cand, d
                    changed = True
                    break
            if changed:
                break
        if changed or tries >= budget:
            continue
        # drop one row of one batch submission
        for ri, rnd in enumerate(best_p.rounds):
            for si, sub in enumerate(rnd.subs):
                if sub.kind != "batch" or sub.num_rows <= 1:
                    continue
                for k in range(sub.num_rows):
                    cut = VmSub(
                        kind=sub.kind, label=sub.label,
                        src=sub.src[:k] + sub.src[k + 1:],
                        dst=sub.dst[:k] + sub.dst[k + 1:],
                        length=sub.length[:k] + sub.length[k + 1:],
                        src_proto=sub.src_proto[:k] + sub.src_proto[k + 1:],
                        dst_proto=sub.dst_proto[:k] + sub.dst_proto[k + 1:])
                    subs = rnd.subs[:si] + (cut,) + rnd.subs[si + 1:]
                    new_rounds = list(best_p.rounds)
                    new_rounds[ri] = VmRound(ops=rnd.ops, subs=subs)
                    cand = dataclasses.replace(best_p,
                                               rounds=tuple(new_rounds))
                    d = still_fails(cand)
                    if d is not None:
                        best_p, best_d = cand, d
                        changed = True
                        break
                if changed:
                    break
            if changed:
                break
        if changed or tries >= budget:
            continue
        # drop one table op
        for ri, rnd in enumerate(best_p.rounds):
            for oi in range(len(rnd.ops)):
                ops = rnd.ops[:oi] + rnd.ops[oi + 1:]
                new_rounds = list(best_p.rounds)
                new_rounds[ri] = VmRound(ops=ops, subs=rnd.subs)
                cand = dataclasses.replace(best_p, rounds=tuple(new_rounds))
                d = still_fails(cand)
                if d is not None:
                    best_p, best_d = cand, d
                    changed = True
                    break
            if changed:
                break
    return best_p, best_d
