"""Vectorized sweep-line hazard detection over descriptor programs.

The analyzer never executes anything: it projects every descriptor row
onto its byte intervals — a read interval ``[src, src+len)`` in the
source space (absent for generator pseudo-protocol sources) and a write
interval ``[dst, dst+len)`` in the destination space — and sweeps each
address space for overlaps between intervals that the engine does not
order.

The ordering model mirrors the engine's documented contract exactly:

* rows of one queue item (one ``submit_async`` payload or one shard of a
  ``dispatch_batch``) execute with **no intra-item ordering guarantee** —
  ``execute_batch`` is vectorized and its docstring excludes dependent
  rows from the scalar-equivalence contract → ``H001``/``H002``/``H004``;
* two items on the **same channel** drain FIFO → ordered, never a hazard;
* items on **different channels** of one drain interleave with no
  cross-channel byte-ordering guarantee (``wait_all``'s contract)
  → ``H003``;
* batches on **different engines** sharing one memory map (a
  `CollectiveFabric` phase) → ``H006``;
* one row whose source and destination windows overlap in the same
  space → ``H005``;
* a hazard present on the **physical plane** (after the pipeline's
  translation stages) but absent on the **virtual plane** (translation
  cut structure applied, addresses left virtual) is created by the
  translation itself — two virtual pages aliasing one physical page
  → ``H007``.

The sweep screens each address space in two tiers.  First a
disjointness screen: sorting starts and ends *independently* (two plain
``np.sort`` calls, no permutation array), any overlap shows up as some
(k+1)-th smallest start preceding the k-th smallest end — if none does,
the space is certified clean and the pass ends.  Only overlapping
spaces pay for the argsort + running-maximum candidate screen
(``start[i] < cummax(end)[i-1]`` after sorting by start), and only
candidates are enumerated pairwise.  Clean programs (the common case)
never enter a Python loop — or an argsort — which is what keeps a
1M-burst program well under 10% of its own ``execute_batch`` cost
(the reference's ``benchmarks/sanitize_bench.py`` gates this).  Address spaces are
distinct per protocol (separate `MemoryMap` buffers), so intervals in
different protocols can never collide; read-only spaces are skipped
outright.

Sweeping runs on the **pre-legalizer** rows (after the spec mid-end
pipeline): legalization and multi-port splitting only cut contiguous
intervals into contiguous pieces, so the byte footprint — and therefore
every overlap verdict — is invariant under them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import DescriptorBatch, mp_dist_batch
from repro_torch.core.descriptor import (CODE_PROTO, GENERATOR_PROTOCOLS,
                                         PROTO_CODE, NdTransfer, Transfer1D)
from repro_torch.core.midend import tensor_nd_batch

from .diagnostics import (Access, Diagnostic, Report, normalize_suppress)

__all__ = ["Unit", "as_batch", "check_batch", "check_units",
           "check_engine", "check_phase", "channel_units"]

_GEN_CODES = np.asarray(sorted(PROTO_CODE[p] for p in GENERATOR_PROTOCOLS),
                        dtype=np.uint8)
#: O(1) generator-source test: a 256-entry lookup beats `np.isin` on the
#: million-row hot path
_IS_GEN = np.zeros(256, dtype=bool)
_IS_GEN[_GEN_CODES] = True
_NEG = np.iinfo(np.int64).min


@dataclass(frozen=True)
class Unit:
    """One ordering-domain unit: a batch whose rows are mutually
    unordered.  ``(engine, channel, item)`` place it in the drain —
    two units are FIFO-ordered (hazard-free by construction) iff they
    share an engine and a non-negative channel but differ in ``item``."""

    batch: DescriptorBatch
    engine: int = 0
    channel: int = -1
    item: int = 0
    label: str = ""


def as_batch(payload, pipeline: Sequence = (),
             plane: str = "physical") -> DescriptorBatch:
    """Normalize any submission payload to a `DescriptorBatch` and run
    the spec mid-end pipeline over it (the footprint the engine will
    actually execute).

    Value stages (``stage.translates``) are handled per ``plane``:
    ``"physical"`` rebinds addresses through the stage, dropping rows
    whose pages are unmapped via ``apply_partial`` (the sanitizer runs
    pre-drain and must never raise a `PageFault` itself); ``"virtual"``
    applies only the stage's cut structure, leaving virtual addresses in
    place — the footprint used for the H007 alias re-sweep."""
    if isinstance(payload, DescriptorBatch):
        batch = payload
    elif isinstance(payload, NdTransfer):
        batch = tensor_nd_batch(payload)
    elif isinstance(payload, Transfer1D):
        batch = DescriptorBatch.from_transfers([payload])
    else:
        raise TypeError(f"cannot sanitize payload of type "
                        f"{type(payload).__name__}")
    for stage in pipeline:
        if getattr(stage, "translates", False):
            if plane == "virtual":
                batch = stage.apply_structure(batch)
            elif hasattr(stage, "apply_partial"):
                batch, _ = stage.apply_partial(batch)
            else:
                batch = stage.apply(batch)
        else:
            batch = stage.apply(batch)
    return batch


def channel_units(batch: DescriptorBatch, num_channels: int,
                  scheme: str = "round_robin", boundary: int = 0,
                  engine: int = 0, item: int = 0) -> List[Unit]:
    """Mirror of `IDMAEngine.dispatch_batch`'s channel sharding: one
    `Unit` per non-empty channel shard, so cross-channel hazards of a
    single dispatch are checked exactly as the engine will run them."""
    if num_channels <= 1:
        return [Unit(batch, engine=engine, channel=0, item=item)]
    if scheme == "address":
        shards = mp_dist_batch(batch, num_channels, scheme="address",
                               boundary=boundary, which="dst")
    else:
        shards = mp_dist_batch(batch, num_channels, scheme=scheme)
    return [Unit(sh, engine=engine, channel=c, item=item)
            for c, sh in enumerate(shards) if len(sh)]


# --------------------------------------------------------------------------
# Interval construction
# --------------------------------------------------------------------------

@dataclass
class _Seg:
    """One unit's write (or read) intervals as a contiguous segment.

    ``code`` is the segment's uniform protocol code, or ``-1`` when rows
    mix protocols (then only the flat view can split it).  ``rows`` is
    ``None`` for the every-row-contributes fast path (≡ ``arange(n)``),
    avoiding a gather per million-row batch."""

    code: int
    space: np.ndarray
    start: np.ndarray
    end: np.ndarray
    kind: bool          # True = write intervals
    unit: int
    base: int           # global row-sequence offset of the owning unit
    n_unit: int
    rows: Optional[np.ndarray]


class _Intervals:
    """Interval table over all units: per-segment columns for the cheap
    disjointness screens, flattened into one row-aligned global view
    (``space``/``start``/``end``/``kind``/``unit``/``row``/``seq``) only
    when a screen actually finds an overlap to enumerate.  Clean sweeps
    — the common case — never allocate the flat view at all."""

    __slots__ = ("segs", "units", "_flat")

    def __init__(self, units: Sequence[Unit]) -> None:
        self.units = units
        self.segs: List[_Seg] = []
        self._flat = None
        base = 0
        for ui, u in enumerate(units):
            b = u.batch
            n = len(b)
            if n == 0:
                continue
            live = b.length > 0
            all_live = bool(live.all())
            # write interval per live row
            if all_live:
                w_rows = None
                wspace, wstart = b.dst_proto, b.dst_addr
                wend = b.dst_addr + b.length
            else:
                w_rows = np.flatnonzero(live)
                wspace = b.dst_proto[w_rows]
                wstart = b.dst_addr[w_rows]
                wend = wstart + b.length[w_rows]
            self._add(ui, True, base, n, wspace, wstart, wend, w_rows)
            # read interval per live non-generator-source row
            gen = _IS_GEN[b.src_proto]
            if all_live and not gen.any():
                r_rows = None
                rspace, rstart = b.src_proto, b.src_addr
                rend = b.src_addr + b.length
            else:
                r_rows = np.flatnonzero(live & ~gen)
                rspace = b.src_proto[r_rows]
                rstart = b.src_addr[r_rows]
                rend = rstart + b.length[r_rows]
            self._add(ui, False, base, n, rspace, rstart, rend, r_rows)
            base += n

    def _add(self, ui: int, kind: bool, base: int, n_unit: int,
             space: np.ndarray, start: np.ndarray, end: np.ndarray,
             rows: Optional[np.ndarray]) -> None:
        if start.size == 0:
            return
        code = int(space[0])
        if start.size > 1 and not (space == space[0]).all():
            code = -1
        self.segs.append(_Seg(code=code, space=space, start=start,
                              end=end, kind=kind, unit=ui, base=base,
                              n_unit=n_unit, rows=rows))

    # -- lazily flattened global view --------------------------------------

    def _flatten(self):
        if self._flat is None:
            segs = self.segs
            if not segs:
                zi = np.empty(0, dtype=np.int64)
                self._flat = (np.empty(0, dtype=np.uint8), zi, zi,
                              np.empty(0, dtype=bool), zi, zi, zi)
            else:
                cnt = np.asarray([g.start.size for g in segs],
                                 dtype=np.int64)
                rows = [g.rows if g.rows is not None
                        else np.arange(g.n_unit, dtype=np.int64)
                        for g in segs]
                self._flat = (
                    np.concatenate([g.space for g in segs]),
                    np.concatenate([g.start for g in segs]),
                    np.concatenate([g.end for g in segs]),
                    np.repeat(np.asarray([g.kind for g in segs],
                                         dtype=bool), cnt),
                    np.repeat(np.asarray([g.unit for g in segs],
                                         dtype=np.int64), cnt),
                    np.concatenate(rows),
                    # global program row order
                    np.concatenate([r if g.base == 0 else g.base + r
                                    for g, r in zip(segs, rows)]))
        return self._flat

    @property
    def space(self) -> np.ndarray:
        return self._flatten()[0]

    @property
    def start(self) -> np.ndarray:
        return self._flatten()[1]

    @property
    def end(self) -> np.ndarray:
        return self._flatten()[2]

    @property
    def kind(self) -> np.ndarray:
        return self._flatten()[3]

    @property
    def unit(self) -> np.ndarray:
        return self._flatten()[4]

    @property
    def row(self) -> np.ndarray:
        return self._flatten()[5]

    @property
    def seq(self) -> np.ndarray:
        return self._flatten()[6]

    def access(self, i: int) -> Access:
        u = self.units[int(self.unit[i])]
        b = u.batch
        r = int(self.row[i])
        return Access(
            unit=int(self.unit[i]), row=r,
            op="write" if self.kind[i] else "read",
            start=int(self.start[i]), end=int(self.end[i]),
            src=int(b.src_addr[r]), dst=int(b.dst_addr[r]),
            length=int(b.length[r]),
            gen_src=bool(_IS_GEN[b.src_proto[r]]),
            engine=u.engine, channel=u.channel)


# --------------------------------------------------------------------------
# The sweep
# --------------------------------------------------------------------------

class _Sweep:
    """One `check_units` pass: candidate screening per space, bounded
    pair enumeration, hazard classification."""

    def __init__(self, units: Sequence[Unit], suppress: Tuple[str, ...],
                 limit: int, budget: int) -> None:
        self.units = units
        self.suppress = suppress
        self.limit = limit
        self.budget = budget
        self.report = Report(
            checked_rows=sum(len(u.batch) for u in units))
        self._counts: dict = {}
        self._seen: set = set()

    # -- emission ---------------------------------------------------------

    def _emit(self, code: str, space_code: int, a: Access, b: Access
              ) -> None:
        rep = self.report
        if code in self.suppress:
            rep.suppressed[code] = rep.suppressed.get(code, 0) + 1
            return
        n = self._counts.get(code, 0)
        self._counts[code] = n + 1
        if n >= self.limit:
            if n == self.limit:
                rep.notes.append(
                    f"{code}: more than {self.limit} instances, "
                    f"further ones dropped")
            return
        proto = CODE_PROTO[int(space_code)].value
        lo = max(a.start, b.start)
        hi = min(a.end, b.end)
        rep.diagnostics.append(Diagnostic(
            code=code,
            message=(f"{a.describe()} while {b.describe()} "
                     f"— overlap [{lo:#x}, {hi:#x})"),
            space=proto, window=(lo, hi), a=a, b=b))

    def _pair(self, space_code: int, iv: _Intervals, gi: int, gj: int
              ) -> None:
        """Classify one overlapping interval pair (global indices)."""
        if iv.row[gi] == iv.row[gj] and iv.unit[gi] == iv.unit[gj]:
            return      # same row's own src/dst overlap → handled as H005
        ua = self.units[int(iv.unit[gi])]
        ub = self.units[int(iv.unit[gj])]
        if (ua.engine == ub.engine and ua.channel == ub.channel
                and ua.channel >= 0 and ua.item != ub.item):
            return      # same-channel FIFO: ordered, allowed
        key = (int(space_code), int(min(gi, gj)), int(max(gi, gj)))
        if key in self._seen:
            return
        self._seen.add(key)
        if ua.engine != ub.engine:
            code = "H006"
        elif ua.channel != ub.channel and ua.channel >= 0 \
                and ub.channel >= 0:
            code = "H003"
        elif iv.kind[gi] and iv.kind[gj]:
            code = "H002"
        else:
            # one read, one write, unordered rows of one stream: name the
            # dependence by program row order (the scalar oracle's order)
            wseq = iv.seq[gi] if iv.kind[gi] else iv.seq[gj]
            rseq = iv.seq[gj] if iv.kind[gi] else iv.seq[gi]
            code = "H001" if wseq < rseq else "H004"
        # report with the program-earlier access first
        a, b = (gi, gj) if iv.seq[gi] <= iv.seq[gj] else (gj, gi)
        self._emit(code, space_code, iv.access(a), iv.access(b))

    # -- passes -----------------------------------------------------------

    def _self_overlap(self, iv: _Intervals) -> None:
        """H005: vectorized src/dst overlap within each row."""
        for ui, u in enumerate(self.units):
            b = u.batch
            if not len(b):
                continue
            same = b.src_proto == b.dst_proto
            if not same.any():
                continue    # distinct spaces everywhere: no self-overlap
            same &= (b.length > 0) & ~_IS_GEN[b.src_proto]
            if not same.any():
                continue
            lo = np.maximum(b.src_addr, b.dst_addr)
            hi = np.minimum(b.src_addr + b.length, b.dst_addr + b.length)
            hit = np.flatnonzero(same & (lo < hi))
            for r in hit.tolist():
                rep = self.report
                if "H005" in self.suppress:
                    rep.suppressed["H005"] = \
                        rep.suppressed.get("H005", 0) + 1
                    continue
                n = self._counts.get("H005", 0)
                self._counts["H005"] = n + 1
                if n >= self.limit:
                    if n == self.limit:
                        rep.notes.append(
                            f"H005: more than {self.limit} instances, "
                            f"further ones dropped")
                    continue
                proto = CODE_PROTO[int(b.dst_proto[r])].value
                w = (int(lo[r]), int(hi[r]))
                acc = Access(
                    unit=ui, row=r, op="write", dst=int(b.dst_addr[r]),
                    src=int(b.src_addr[r]), length=int(b.length[r]),
                    start=int(b.dst_addr[r]),
                    end=int(b.dst_addr[r] + b.length[r]), gen_src=False,
                    engine=u.engine, channel=u.channel)
                rep.diagnostics.append(Diagnostic(
                    code="H005",
                    message=(f"unit[{ui}] row {r} copies "
                             f"[{int(b.src_addr[r]):#x}, "
                             f"{int(b.src_addr[r] + b.length[r]):#x}) onto "
                             f"itself at [{int(b.dst_addr[r]):#x}, "
                             f"{int(b.dst_addr[r] + b.length[r]):#x})"),
                    space=proto, window=w, a=acc, b=acc))

    def _spend(self) -> bool:
        self.budget -= 1
        if self.budget == 0:
            self.report.notes.append(
                "pair-enumeration budget exhausted — diagnostics are "
                "truncated (the program is very overlap-dense)")
        return self.budget > 0

    def _ww_pass(self, space_code: int, iv: _Intervals) -> None:
        """Write-write overlaps within one space (enumeration path —
        `run` already screened the space as overlapping)."""
        w = np.flatnonzero((iv.space == space_code) & iv.kind)
        if w.size < 2:
            return
        order = w[np.argsort(iv.start[w], kind="stable")]
        s = iv.start[order]
        e = iv.end[order]
        cmax = np.maximum.accumulate(e)
        cand = np.flatnonzero(s[1:] < cmax[:-1]) + 1
        for i in cand.tolist():
            si = s[i]
            j = i - 1
            while j >= 0 and cmax[j] > si:
                if not self._spend():
                    return
                if e[j] > si:
                    self._pair(space_code, iv, int(order[i]),
                               int(order[j]))
                j -= 1

    def _wr_pass(self, space_code: int, iv: _Intervals) -> None:
        """Write-vs-read overlaps within one space.  Read-read pairs are
        never enumerated: backward scans hop along previous-write /
        previous-read index chains, so a million mutually-overlapping
        reads cost nothing unless a write actually intersects them."""
        sel = np.flatnonzero(iv.space == space_code)
        kinds = iv.kind[sel]
        if not kinds.any() or kinds.all():
            return      # no writes, or no reads: nothing to cross-check
        order = sel[np.argsort(iv.start[sel], kind="stable")]
        s = iv.start[order]
        e = iv.end[order]
        w = iv.kind[order]
        n = order.size
        pos = np.arange(n)
        wmax = np.maximum.accumulate(np.where(w, e, _NEG))
        rmax = np.maximum.accumulate(np.where(~w, e, _NEG))
        wprev = np.maximum.accumulate(np.where(w, pos, -1))
        rprev = np.maximum.accumulate(np.where(~w, pos, -1))

        def scan(i: int, prev: np.ndarray, emax: np.ndarray) -> bool:
            si = s[i]
            j = int(prev[i - 1])
            while j >= 0 and emax[j] > si:
                if not self._spend():
                    return False
                if e[j] > si:
                    self._pair(space_code, iv, int(order[i]),
                               int(order[j]))
                j = int(prev[j - 1]) if j > 0 else -1
            return True

        # reads crossing an earlier write's window
        for i in (np.flatnonzero(~w[1:] & (s[1:] < wmax[:-1])) + 1
                  ).tolist():
            if not scan(i, wprev, wmax):
                return
        # writes crossing an earlier read's window
        for i in (np.flatnonzero(w[1:] & (s[1:] < rmax[:-1])) + 1
                  ).tolist():
            if not scan(i, rprev, rmax):
                return

    @staticmethod
    def _disjoint(segs: Sequence[_Seg]) -> bool:
        """True iff the segments' intervals are pairwise disjoint.
        Classic meeting-rooms screen: sort starts and ends
        *independently* — two intervals overlap iff some (k+1)-th
        smallest start precedes the k-th smallest end.  Two plain sorts,
        no permutation array: an order of magnitude cheaper than the
        argsort the enumeration passes need, so clean spaces (the
        common case) never pay for one."""
        if len(segs) == 1:
            s_vals, e_vals = segs[0].start, segs[0].end
        else:
            s_vals = np.concatenate([g.start for g in segs])
            e_vals = np.concatenate([g.end for g in segs])
        if s_vals.size < 2:
            return True
        ss = np.sort(s_vals)
        es = np.sort(e_vals)
        return not bool(np.any(ss[1:] < es[:-1]))

    def run(self) -> Report:
        iv = _Intervals(self.units)
        self._self_overlap(iv)
        if not iv.segs:
            return self.report
        by_code: dict = {}
        mixed = False
        for g in iv.segs:
            if g.code < 0:
                mixed = True    # per-row protocol mix: flat view splits it
                break
            by_code.setdefault(g.code, []).append(g)
        codes = (np.unique(iv.space).tolist() if mixed
                 else sorted(by_code))
        for space_code in codes:
            if mixed:
                ww_clean = wr_clean = False
            else:
                space_segs = by_code[space_code]
                wsegs = [g for g in space_segs if g.kind]
                if not wsegs:
                    continue    # read-only space: nothing a write races
                ww_clean = self._disjoint(wsegs)
                wr_clean = len(wsegs) == len(space_segs) \
                    or self._disjoint(space_segs)
            if not ww_clean:
                self._ww_pass(space_code, iv)
                if self.budget <= 0:
                    break
            if not wr_clean:
                self._wr_pass(space_code, iv)
                if self.budget <= 0:
                    break
        return self.report


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------

def check_units(units: Iterable[Unit], suppress: Sequence[str] = (),
                limit: int = 50, budget: int = 250_000) -> Report:
    """Sweep a set of ordering-domain units for memory hazards.

    ``suppress`` drops listed codes (counted in the report);  ``limit``
    caps reported diagnostics per code; ``budget`` bounds candidate-pair
    enumeration for pathologically overlap-dense programs (a note marks
    truncation)."""
    return _Sweep(list(units), normalize_suppress(suppress), limit,
                  budget).run()


def check_batch(batch: DescriptorBatch, suppress: Sequence[str] = (),
                limit: int = 50, budget: int = 250_000) -> Report:
    """Sweep one submission: every row unordered against every other
    (the `execute_batch` vectorization contract)."""
    return check_units([Unit(batch)], suppress=suppress, limit=limit,
                       budget=budget)


#: physical-plane pair hazards that VA aliasing can manufacture — the
#: codes the H007 two-plane re-sweep compares across planes
_ALIASABLE = ("H001", "H002", "H003", "H004", "H006")


def _alias_audit(report: Report, virtual_units: Sequence[Unit],
                 pipeline: Sequence, suppress: Tuple[str, ...],
                 limit: int, budget: int) -> None:
    """H007: two-plane alias audit.  If the physical-plane sweep found a
    pair hazard but repeating it on the virtual plane (translation cut
    structure applied, addresses left virtual) comes back clean, the
    hazard was created by the translation itself: two virtual pages
    alias one physical page.  Names the aliased physical pages from each
    translator's page table."""
    hit = [c for c in _ALIASABLE if report.has(c)]
    if not hit:
        return
    translators = [st for st in pipeline
                   if getattr(st, "translates", False)]
    if not translators:
        return
    virt = check_units(virtual_units, suppress=suppress, limit=limit,
                       budget=budget)
    if any(virt.has(c) for c in _ALIASABLE):
        return      # hazardous on the virtual plane too: not aliasing
    if "H007" in suppress:
        report.suppressed["H007"] = report.suppressed.get("H007", 0) + 1
        return
    emitted = 0
    for st in translators:
        table = getattr(st, "table", None)
        aliases = table.aliases() if table is not None else {}
        for proto in sorted(aliases, key=lambda p: p.value):
            for ppn, vpns in sorted(aliases[proto].items()):
                if emitted >= limit:
                    report.notes.append(
                        f"H007: more than {limit} aliased pages, "
                        f"further ones dropped")
                    return
                emitted += 1
                report.diagnostics.append(Diagnostic(
                    code="H007",
                    message=(f"physical page {ppn:#x} in {proto.name} "
                             f"aliased by virtual pages "
                             f"{', '.join(f'{v:#x}' for v in vpns)} — "
                             f"program is disjoint on the virtual plane "
                             f"but races after translation"),
                    space=proto.value))
    if not emitted:
        # the hazard only exists post-translation yet no page shows a
        # duplicate mapping in the current walk (e.g. the table mutated
        # since lowering) — still name the plane discrepancy
        report.diagnostics.append(Diagnostic(
            code="H007",
            message=("hazard present on the physical plane only: "
                     "translation aliases distinct virtual windows onto "
                     "overlapping physical bytes")))


def check_engine(engine, suppress: Sequence[str] = (), limit: int = 50,
                 budget: int = 250_000) -> Report:
    """Sweep everything queued on an engine — the drain `wait_all` is
    about to run.  Each queue item becomes one unit on its channel
    (post spec-pipeline footprint), so same-channel FIFO ordering is
    honored and cross-channel interleavings are flagged.  When the
    pipeline translates, a physical-plane pair hazard triggers the
    virtual-plane re-sweep (H007 alias audit)."""
    sup = normalize_suppress(suppress)
    translated = any(getattr(st, "translates", False)
                     for st in engine.pipeline)
    units: List[Unit] = []
    vunits: List[Unit] = []
    for c, q in enumerate(engine._queues):
        for tid0, _, payload in q:
            units.append(Unit(as_batch(payload, engine.pipeline),
                              channel=c, item=tid0))
            if translated:
                vunits.append(Unit(as_batch(payload, engine.pipeline,
                                            plane="virtual"),
                                   channel=c, item=tid0))
    report = check_units(units, suppress=sup, limit=limit, budget=budget)
    if translated:
        _alias_audit(report, vunits, engine.pipeline, sup, limit, budget)
    return report


def check_phase(batches, pipeline: Sequence = (),
                suppress: Sequence[str] = (), limit: int = 50,
                budget: int = 250_000) -> Report:
    """Sweep one `CollectiveFabric` phase: ``batches`` maps rank → that
    rank's phase `DescriptorBatch` (or is a sequence indexed by rank).
    Every rank is a distinct engine over one shared memory map, so any
    cross-rank overlap is an H006 race; rows within one rank's batch
    are unordered (one functional drain per rank per phase)."""
    if hasattr(batches, "items"):
        pairs = sorted(batches.items())
    else:
        pairs = list(enumerate(batches))
    sup = normalize_suppress(suppress)
    units = [Unit(as_batch(b, pipeline), engine=int(r), channel=-1,
                  item=int(r))
             for r, b in pairs if b is not None and len(b)]
    report = check_units(units, suppress=sup, limit=limit, budget=budget)
    if any(getattr(st, "translates", False) for st in pipeline):
        vunits = [Unit(as_batch(b, pipeline, plane="virtual"),
                       engine=int(r), channel=-1, item=int(r))
                  for r, b in pairs if b is not None and len(b)]
        _alias_audit(report, vunits, pipeline, sup, limit, budget)
    return report
