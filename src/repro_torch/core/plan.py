"""Captured transfer plans — compile-once / replay-many descriptor pipelines.

The paper's front-end/mid-end split exists so the expensive part of a
transfer — decomposing an N-D/scatter pattern into legal bursts — happens
once per descriptor in dedicated hardware, not per byte.  This module gives
the software pipeline the same property *across submissions*: serving
traffic (paged-KV append/gather) re-submits structurally identical
descriptor batches every decode step with only base addresses changed, yet
the uncached pipeline re-runs ``legalize_batch`` → mid-end splitting →
grouping on every doorbell.  A `TransferPlan` runs that pipeline **once**
and freezes its output; every later submission with the same structural
signature replays the frozen bursts with a single vectorized address
rebind.

The artifact
------------

Capture lowers a `DescriptorBatch` through `legalize_batch` (with the full
`check_legal_batch` legality gate) and records, per emitted burst, a
*relocation entry*: the input descriptor row it derives from plus its
src/dst byte offsets from that row's addresses.  The burst columns that do
not depend on addresses — lengths, protocol codes, owner chain, option
caps — are frozen verbatim (and marked read-only), along with two
precomputed execution artifacts:

* ``beats``  — the `beats_array` of the stream at the capture bus width,
  consumed by `simulate_batch`/`simulate_channels` via their ``beats=``
  replay entry points;
* ``hints``  — the protocol-pair grouping + length-bin decomposition
  consumed by `backend.execute_batch(hints=)`.

Replay is then ``base[desc_row] + offset`` per port column — two gathers
and two adds — with no legalizer, mid-end, grouping, or legality-check
code on the path.

Why replay is sound
-------------------

Legalization is *not* a pure function of structure: AXI4 cuts at 4 KiB
page boundaries and TileLink's pow2 walk follows address alignment, both
functions of ``addr mod M`` for a protocol-specific modulus; beat counts
depend on ``src_addr mod bus_width``.  The structural signature therefore
includes the address **residues** modulo ``M = lcm(bus_width, page sizes
and pow2 alignment of every protocol present)`` alongside the
address-free columns.  Two submissions share a plan only when every
residue matches — which makes the frozen cut structure and beat counts
exactly correct for the rebound addresses, with no revalidation needed
beyond the back-end's ordinary vectorized bounds scan.  For the TPU
protocols (HBM/VMEM/ICI/HOST: no page rule) the modulus collapses to the
bus width, so arbitrary page-table permutations replay the same plan.

`PlanCache` keys plans by that signature in an LRU map and exposes
transparent hit/miss statistics (`analytics.plan_cache_profile`).  It is
wired opt-in through `IDMAEngine(plan_cache=...)` —
submit/submit_async/dispatch_batch all flow through it — and default-on
through `serve.kvcache.PagedKVDMA`, whose append/gather streams become
per-`KVLayout` plan templates.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Hashable, Optional, Sequence, Tuple

import numpy as np

from .backend import ExecHints, build_exec_hints
from .descriptor import (CODE_PROTO, GENERATOR_PROTOCOLS, PROTO_CODE,
                         BackendOptions, DescriptorBatch, NdTransfer)
from .legalizer import check_legal_batch, legalize_batch, rules_for
from .midend import tensor_nd_batch
from .simulator import beats_array

__all__ = [
    "TransferPlan", "PlanCache", "PlanCacheStats", "capture_plan",
    "capture_nd_plan", "plan_signature", "nd_plan_signature",
    "structure_modulus", "simulate_plan",
]


# --------------------------------------------------------------------------
# Structural signatures
# --------------------------------------------------------------------------

def structure_modulus(src_codes: np.ndarray, dst_codes: np.ndarray,
                      bus_width: int) -> int:
    """The address modulus `M` under which legalization and beat counts
    are invariant: lcm of the bus width with every present protocol's page
    size and pow2 alignment span.  Rebinding any descriptor by a multiple
    of `M` provably preserves the captured cut structure."""
    m = max(int(bus_width), 1)
    for col, is_src in ((src_codes, True), (dst_codes, False)):
        for code in np.unique(col).tolist():
            proto = CODE_PROTO[int(code)]
            if is_src and proto in GENERATOR_PROTOCOLS:
                continue
            r = rules_for(proto, bus_width)
            if r.page_size:
                m = math.lcm(m, r.page_size)
            if r.pow2_only:
                # natural alignment is checked up to the burst length,
                # which the cap bounds; align the modulus to the cap
                m = math.lcm(m, r.max_burst_bytes or r.page_size or 1)
    return m


def _options_key(options) -> Hashable:
    if options is None or isinstance(options, BackendOptions):
        return options
    return tuple(options)


def _pipeline_key(pipeline: Sequence) -> Tuple[Hashable, ...]:
    """Per-stage structural signatures of a spec mid-end pipeline.

    Raises for unsigned stages — callers (the engine's ``_plannable``
    gate) must bypass the cache for those, never hash them."""
    key = []
    for st in pipeline:
        sig = st.signature()
        if sig is None:
            raise ValueError(
                f"mid-end stage {getattr(st, 'name', st)!r} has no "
                f"structural signature — unsigned stages are not "
                f"plan-cacheable and must bypass the cache")
        key.append(sig)
    return tuple(key)


def _pipeline_modulus(pipeline: Sequence) -> int:
    """lcm of the pipeline stages' address moduli: the span that must be
    folded into the residue modulus so rebinding cannot change any
    stage's cut points or routing."""
    m = 1
    for st in pipeline:
        m = math.lcm(m, max(int(st.modulus()), 1))
    return m


def plan_signature(batch: DescriptorBatch, bus_width: int = 8,
                   pipeline: Sequence = ()) -> Hashable:
    """Structural signature of a `DescriptorBatch` — everything that
    shapes its legalization *except* the addresses themselves, plus the
    address residues mod `structure_modulus` (see module docstring).

    `pipeline` — the engine's spec mid-end stages: their per-stage
    signatures join the key (two engines with different pipelines can
    never share a plan) and their address moduli widen the residue
    modulus (an ``mp_split`` at boundary B cuts as a function of
    ``addr mod B``, so replays must preserve that residue too)."""
    m = math.lcm(
        structure_modulus(batch.src_proto, batch.dst_proto, bus_width),
        _pipeline_modulus(pipeline))
    return (
        "batch", int(bus_width), m, len(batch),
        _pipeline_key(pipeline),
        batch.length.tobytes(),
        batch.src_proto.tobytes(), batch.dst_proto.tobytes(),
        batch.owner.tobytes(),
        batch.max_burst.tobytes(), batch.reduce_len.tobytes(),
        (batch.src_addr % m).tobytes(), (batch.dst_addr % m).tobytes(),
        _options_key(batch.options),
    )


def nd_plan_signature(nd: NdTransfer, bus_width: int = 8,
                      pipeline: Sequence = ()) -> Hashable:
    """Structural signature of an N-D affine transfer: shapes, strides,
    inner length, protocols, options — addresses excluded up to their
    residues mod `structure_modulus`.  Two transfers with the same reps
    but different strides hash differently (their burst offset tables
    differ), so they can never share a plan.  `pipeline` joins the key
    exactly as in `plan_signature`."""
    src_code = np.asarray([PROTO_CODE[nd.src_protocol]], dtype=np.uint8)
    dst_code = np.asarray([PROTO_CODE[nd.dst_protocol]], dtype=np.uint8)
    m = math.lcm(structure_modulus(src_code, dst_code, bus_width),
                 _pipeline_modulus(pipeline))
    return (
        "nd", int(bus_width), m, nd.inner_length,
        _pipeline_key(pipeline),
        tuple((d.src_stride, d.dst_stride, d.reps) for d in nd.dims),
        nd.src_protocol, nd.dst_protocol, nd.options,
        nd.src_addr % m, nd.dst_addr % m,
    )


# --------------------------------------------------------------------------
# The plan artifact
# --------------------------------------------------------------------------

def _freeze(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    arr.setflags(write=False)
    return arr


#: replay-executor index matrices are only materialized for plans whose
#: total payload stays below this (elements == bytes moved per replay).
EXEC_TEMPLATE_MAX_ELEMS = 1 << 22


class _ExecBin:
    """One uniform-length bin of a replay-executor group: frozen
    descriptor indices plus fully materialized per-byte src/dst offset
    matrices, so a replay's addressing is two gathers and two adds."""

    __slots__ = ("didx", "soff", "doff")

    def __init__(self, didx: np.ndarray, soff: np.ndarray,
                 doff: np.ndarray) -> None:
        self.didx = _freeze(didx)          # (rows, 1) descriptor index
        self.soff = _freeze(soff)          # (rows, L) src byte offsets
        self.doff = _freeze(doff)          # (rows, L) dst byte offsets


class _ExecGroup:
    __slots__ = ("src_proto", "dst_proto", "bins")

    def __init__(self, src_proto, dst_proto, bins) -> None:
        self.src_proto = src_proto
        self.dst_proto = dst_proto
        self.bins = bins


@dataclass(eq=False, repr=False)
class TransferPlan:
    """One captured legalized burst stream with its relocation table.

    All columns are frozen (read-only) arrays of length ``n_bursts``;
    ``desc_row`` indexes the capture-time input batch (``n_desc`` rows).
    A replayed `DescriptorBatch` is byte- and cycle-identical to lowering
    the rebound submission from scratch (property-tested in
    ``tests/test_plan.py``).
    """

    n_desc: int
    bus_width: int
    desc_row: np.ndarray           # input descriptor index per burst
    src_off: np.ndarray            # burst src_addr - input src_addr[desc_row]
    dst_off: np.ndarray
    length: np.ndarray
    src_proto: np.ndarray
    dst_proto: np.ndarray
    owner: np.ndarray
    max_burst: np.ndarray
    reduce_len: np.ndarray
    options: Optional[object]      # descriptor._OptionsColumn
    beats: np.ndarray              # beats_array at `bus_width`
    hints: Optional[ExecHints]
    replays: int = 0               # submissions served by this plan
    _exec_tmpl: object = None      # lazy replay-executor template

    @property
    def n_bursts(self) -> int:
        return int(self.length.shape[0])

    @property
    def total_bytes(self) -> int:
        return int(self.length.sum()) if self.n_bursts else 0

    def rebind(self, src_base, dst_base, transfer_id=None
               ) -> DescriptorBatch:
        """Replay: rebase every burst onto new per-descriptor addresses.

        ``src_base``/``dst_base`` are the new submission's per-descriptor
        addresses (length ``n_desc``); ``transfer_id`` optionally carries
        the new per-descriptor ids (bursts inherit their descriptor's).
        The result is the legalized stream `legalize_batch` would emit for
        the rebound submission — without running it.
        """
        rows = self.desc_row
        src_base = np.asarray(src_base, dtype=np.int64)
        dst_base = np.asarray(dst_base, dtype=np.int64)
        if transfer_id is None:
            tid = np.zeros(rows.shape[0], dtype=np.int64)
        else:
            tid = np.asarray(transfer_id, dtype=np.int64)[rows]
        self.replays += 1
        return DescriptorBatch(
            src_addr=src_base[rows] + self.src_off,
            dst_addr=dst_base[rows] + self.dst_off,
            length=self.length,
            src_proto=self.src_proto, dst_proto=self.dst_proto,
            owner=self.owner, transfer_id=tid,
            max_burst=self.max_burst, reduce_len=self.reduce_len,
            options=self.options)

    def _exec_template(self):
        """Lazy replay-executor template: per protocol-pair group, per
        length bin, the fully materialized byte-offset matrices.  ``None``
        when not applicable (generator sources, missing hints, or a
        payload too large to freeze per-byte indices for)."""
        if self._exec_tmpl is not None:
            return self._exec_tmpl if self._exec_tmpl != () else None
        hints = self.hints
        if hints is None or bool(hints.src_gen.any()) or \
                self.total_bytes > EXEC_TEMPLATE_MAX_ELEMS:
            self._exec_tmpl = ()
            return None
        groups = []
        for code, rows, bins in hints.groups:
            assert bins is not None        # no generator groups here
            gbins = []
            didx_g = self.desc_row[rows]
            soff_g = self.src_off[rows]
            doff_g = self.dst_off[rows]
            for length, bin_rows in bins:
                span = np.arange(length, dtype=np.int64)
                gbins.append(_ExecBin(
                    didx_g[bin_rows][:, None],
                    soff_g[bin_rows][:, None] + span,
                    doff_g[bin_rows][:, None] + span))
            groups.append(_ExecGroup(CODE_PROTO[code >> 8],
                                     CODE_PROTO[code & 0xFF], gbins))
        self._exec_tmpl = groups
        return groups

    def replay_execute(self, src_base, dst_base, mem) -> int:
        """Fused replay: rebind + bounds revalidation + grouped copy in
        one pass over capture-frozen index matrices — the steady-state
        data-plane fast path (`PagedKVDMA` decode traffic).

        Byte-identical to ``execute_batch(self.rebind(...), mem,
        check=False, hints=self.hints)``, which is also the fallback
        whenever the template does not apply or the cheap vectorized
        bounds check fails (the generic path then raises the exact
        `TransferError` the engine error handler expects, with nothing
        partially written — all bounds are validated before any byte
        moves, as in `execute_batch`).  Returns bytes moved.
        """
        tmpl = self._exec_template()
        if tmpl is None:
            return _generic_replay_execute(self, src_base, dst_base, mem)
        src_base = np.asarray(src_base, dtype=np.int64)
        dst_base = np.asarray(dst_base, dtype=np.int64)
        # phase 1: address all bins and revalidate bounds (no writes yet)
        staged = []
        for group in tmpl:
            try:
                sbuf = mem.space(group.src_proto)
                dbuf = mem.space(group.dst_proto)
            except (KeyError, ValueError):
                # missing/generator space: let the generic back-end report
                # it with its exact error semantics and row ordering
                return _generic_replay_execute(self, src_base, dst_base,
                                               mem)
            for b in group.bins:
                smat = src_base[b.didx] + b.soff
                dmat = dst_base[b.didx] + b.doff
                if int(smat[:, 0].min()) < 0 or \
                        int(smat[:, -1].max()) >= sbuf.size or \
                        int(dmat[:, 0].min()) < 0 or \
                        int(dmat[:, -1].max()) >= dbuf.size:
                    return _generic_replay_execute(self, src_base,
                                                   dst_base, mem)
                staged.append((sbuf, dbuf, smat, dmat))
        # phase 2: move the bytes
        for sbuf, dbuf, smat, dmat in staged:
            dbuf[dmat] = sbuf[smat]
        self.replays += 1
        return self.total_bytes


def _generic_replay_execute(plan: "TransferPlan", src_base, dst_base,
                            mem) -> int:
    """Replay through the generic vectorized back-end (exact fault
    reporting; also the instream-free reference the fused path must
    match)."""
    from .backend import execute_batch
    legal = plan.rebind(src_base, dst_base)
    return execute_batch(legal, mem, check=False, hints=plan.hints,
                         bus_width=plan.bus_width)


def capture_plan(batch: DescriptorBatch, bus_width: int = 8,
                 hints: bool = True, pipeline: Sequence = ()
                 ) -> TransferPlan:
    """Compile `batch` once: run the spec mid-end `pipeline` (if any),
    legalize, run the full `check_legal_batch` gate, and freeze the burst
    stream plus its relocation table.

    The input rows are tracked through the pipeline by temporarily
    rewriting ``transfer_id`` to the row index — every rewrite in the
    mid-end stages and the legalizer gathers that column untouched, so
    the emitted stream's ``transfer_id`` IS the relocation table's
    ``desc_row`` (offsets stay relative to the *input* batch addresses).

    Value stages (`MidendStage.apply_structure` vs ``rebind_values``,
    e.g. the VM translation stage) contribute only their *structure*
    here: the captured plan stays on the input (virtual) address plane,
    keeping ``rebind`` linear, and the engine applies their value
    rewrite after every rebind.  Consequently `replay_execute` /
    `simulate_plan` are only valid for pipelines without value stages.
    """
    n = len(batch)
    shadow = dataclasses.replace(
        batch, transfer_id=np.arange(n, dtype=np.int64))
    for stage in pipeline:
        shadow = getattr(stage, "apply_structure", stage.apply)(shadow)
    legal = legalize_batch(shadow, bus_width=bus_width)
    check_legal_batch(legal, bus_width=bus_width)   # once, at capture
    rows = legal.transfer_id
    return TransferPlan(
        n_desc=n,
        bus_width=bus_width,
        desc_row=_freeze(rows),
        src_off=_freeze(legal.src_addr - batch.src_addr[rows]),
        dst_off=_freeze(legal.dst_addr - batch.dst_addr[rows]),
        length=_freeze(legal.length),
        src_proto=_freeze(legal.src_proto),
        dst_proto=_freeze(legal.dst_proto),
        owner=_freeze(legal.owner),
        max_burst=_freeze(legal.max_burst),
        reduce_len=_freeze(legal.reduce_len),
        options=legal.options,
        beats=_freeze(beats_array(legal.src_addr, legal.length, bus_width)),
        hints=build_exec_hints(legal) if hints else None,
    )


def capture_nd_plan(nd: NdTransfer, bus_width: int = 8,
                    hints: bool = True, pipeline: Sequence = ()
                    ) -> TransferPlan:
    """Compile an N-D affine transfer once: ``tensor_nd_batch`` → spec
    mid-end `pipeline` → ``legalize_batch``, with every burst's offsets
    recorded relative to the transfer's single (src, dst) base pair
    (``n_desc == 1``) — the strides are baked into the frozen offset
    table, which is why they are part of `nd_plan_signature`."""
    tb = tensor_nd_batch(nd)
    for stage in pipeline:
        tb = getattr(stage, "apply_structure", stage.apply)(tb)
    legal = legalize_batch(tb, bus_width=bus_width)
    check_legal_batch(legal, bus_width=bus_width)
    nb = len(legal)
    return TransferPlan(
        n_desc=1,
        bus_width=bus_width,
        desc_row=_freeze(np.zeros(nb, dtype=np.int64)),
        src_off=_freeze(legal.src_addr - nd.src_addr),
        dst_off=_freeze(legal.dst_addr - nd.dst_addr),
        length=_freeze(legal.length),
        src_proto=_freeze(legal.src_proto),
        dst_proto=_freeze(legal.dst_proto),
        owner=_freeze(legal.owner),
        max_burst=_freeze(legal.max_burst),
        reduce_len=_freeze(legal.reduce_len),
        options=legal.options,
        beats=_freeze(beats_array(legal.src_addr, legal.length, bus_width)),
        hints=build_exec_hints(legal) if hints else None,
    )


def simulate_plan(plan: TransferPlan, src_base, dst_base, cfg, src_mem,
                  dst_mem, transfer_id=None):
    """Cycle model of one replayed plan — the ``already_legal``-style
    entry point over `simulate_batch`, feeding it the frozen beat counts
    when the configured bus width matches the capture width."""
    from .simulator import simulate_batch
    legal = plan.rebind(src_base, dst_base, transfer_id=transfer_id)
    beats = plan.beats if cfg.bus_width == plan.bus_width else None
    return simulate_batch(legal, cfg, src_mem, dst_mem,
                          already_legal=True, beats=beats)


# --------------------------------------------------------------------------
# The LRU plan cache
# --------------------------------------------------------------------------

@dataclass
class PlanCacheStats:
    """Transparent capture/replay counters (surfaced by
    `analytics.plan_cache_profile` and the engine benchmarks)."""

    hits: int = 0
    misses: int = 0                # = captures
    evictions: int = 0
    bypasses: int = 0              # submissions a host chose not to plan

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0


class PlanCache:
    """LRU map from structural signature → `TransferPlan`.

    ``replay_batch`` / ``replay_nd`` are the one-call submission path:
    look the signature up, capture on miss, and return the legalized
    stream for *this* submission's addresses (a pure rebind on hits).
    A shared cache may serve several engines as long as they agree on the
    structural parameters baked into the signature (bus width and the
    spec mid-end pipeline are; legacy object-level mid-end chains and
    multi-back-end splits are not plannable and must bypass —
    `IDMAEngine` enforces this).
    """

    def __init__(self, capacity: int = 64, hints: bool = True) -> None:
        if capacity < 1:
            raise ValueError("plan cache capacity must be >= 1")
        self.capacity = capacity
        self.hints = hints
        self.stats = PlanCacheStats()
        self._plans: "OrderedDict[Hashable, TransferPlan]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._plans)

    @property
    def plans(self) -> Tuple[TransferPlan, ...]:
        return tuple(self._plans.values())

    def clear(self) -> None:
        self._plans.clear()

    def _insert(self, key: Hashable, plan: TransferPlan) -> None:
        self._plans[key] = plan
        if len(self._plans) > self.capacity:
            self._plans.popitem(last=False)
            self.stats.evictions += 1

    def plan_for(self, batch: DescriptorBatch, bus_width: int = 8,
                 pipeline: Sequence = ()) -> Tuple[TransferPlan, bool]:
        """(plan, hit) for a descriptor batch; captures on miss —
        `pipeline` (spec mid-end stages) is part of both the key and the
        captured lowering."""
        key = plan_signature(batch, bus_width, pipeline=pipeline)
        plan = self._plans.get(key)
        if plan is not None:
            self.stats.hits += 1
            self._plans.move_to_end(key)
            return plan, True
        self.stats.misses += 1
        plan = capture_plan(batch, bus_width=bus_width, hints=self.hints,
                            pipeline=pipeline)
        self._insert(key, plan)
        return plan, False

    def nd_plan_for(self, nd: NdTransfer, bus_width: int = 8,
                    pipeline: Sequence = ()) -> Tuple[TransferPlan, bool]:
        """(plan, hit) for an N-D affine transfer; captures on miss."""
        key = nd_plan_signature(nd, bus_width, pipeline=pipeline)
        plan = self._plans.get(key)
        if plan is not None:
            self.stats.hits += 1
            self._plans.move_to_end(key)
            return plan, True
        self.stats.misses += 1
        plan = capture_nd_plan(nd, bus_width=bus_width, hints=self.hints,
                               pipeline=pipeline)
        self._insert(key, plan)
        return plan, False

    # -- submission entry points ------------------------------------------

    def replay_batch(self, batch: DescriptorBatch, bus_width: int = 8,
                     pipeline: Sequence = ()
                     ) -> Tuple[DescriptorBatch, TransferPlan]:
        """Legalized stream for `batch` via its plan (captured on miss):
        the drop-in replacement for ``pipeline stages + legalize_batch``
        on repeat-heavy submission paths."""
        plan, _ = self.plan_for(batch, bus_width=bus_width,
                                pipeline=pipeline)
        return plan.rebind(batch.src_addr, batch.dst_addr,
                           transfer_id=batch.transfer_id), plan

    def replay_nd(self, nd: NdTransfer, bus_width: int = 8,
                  pipeline: Sequence = ()
                  ) -> Tuple[DescriptorBatch, TransferPlan]:
        """Legalized stream for an N-D transfer via its plan template."""
        plan, _ = self.nd_plan_for(nd, bus_width=bus_width,
                                   pipeline=pipeline)
        return plan.rebind(
            np.asarray([nd.src_addr], dtype=np.int64),
            np.asarray([nd.dst_addr], dtype=np.int64),
            transfer_id=np.asarray([nd.transfer_id], dtype=np.int64)), plan
