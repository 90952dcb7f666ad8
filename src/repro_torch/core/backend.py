"""Back-end protocol managers and functional execution (paper §2.3).

The RTL back-end moves real bytes; so do we.  `MemoryMap` hosts named
address spaces (numpy byte buffers); `execute` runs a legalized burst list
against it, byte-for-byte, including the Init pseudo-protocol's three
pattern generators (constant / incrementing / pseudorandom).

The pseudorandom stream is a splitmix32 counter generator over 32-bit
words — deterministic, seedable, TPU-friendly (no 64-bit vector ops on the
TPU VPU), and reproduced bit-exactly by the Pallas init_engine kernel
(`repro.kernels.init_engine`), so RTL-level and kernel-level tests check
against the same oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .descriptor import (CODE_PROTO, GENERATOR_PROTOCOLS, PROTO_CODE,
                         BackendOptions, DescriptorBatch, InitPattern,
                         Protocol, Transfer1D)
from .legalizer import check_legal, check_legal_batch


def splitmix32(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix32 finalizer — the Init PRNG (uint32 in/out).

    Any array module with wrapping uint32 semantics works: the Pallas
    init_engine kernel calls this on jnp uint32 traces inside the kernel
    body, the functional back-end on numpy uint32 arrays.
    """
    c1, c2, c3 = np.uint32(0x9E3779B9), np.uint32(0x85EBCA6B), np.uint32(0xC2B2AE35)
    s16, s13 = np.uint32(16), np.uint32(13)
    x = x + c1
    z = x
    z = (z ^ (z >> s16)) * c2
    z = (z ^ (z >> s13)) * c3
    z = z ^ (z >> s16)
    return z


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (kept for host-side tooling)."""
    x = x.astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return z


def init_stream(pattern: InitPattern, value: int, offset: int,
                length: int) -> np.ndarray:
    """Bytes produced by the Init read manager for [offset, offset+length).

    The stream is a pure function of (pattern, value, absolute offset) so
    that split/legalized transfers produce identical bytes — the invariant
    the property tests lean on.
    """
    if length == 0:
        return np.zeros(0, dtype=np.uint8)
    if pattern == InitPattern.CONSTANT:
        return np.full(length, value & 0xFF, dtype=np.uint8)
    if pattern == InitPattern.INCREMENTING:
        idx = np.arange(offset, offset + length, dtype=np.uint64)
        return ((idx + np.uint64(value)) & np.uint64(0xFF)).astype(np.uint8)
    if pattern == InitPattern.PSEUDORANDOM:
        first = offset // 4
        last = (offset + length - 1) // 4
        words = splitmix32(
            (np.arange(first, last + 1, dtype=np.uint64) % (1 << 32))
            .astype(np.uint32) + np.uint32(value & 0xFFFFFFFF))
        stream = words.view(np.uint8)  # little-endian byte expansion
        start = offset - first * 4
        return stream[start:start + length].copy()
    raise ValueError(f"unknown init pattern {pattern}")


@dataclass
class MemoryMap:
    """Named address spaces backed by numpy byte buffers."""

    spaces: Dict[Protocol, np.ndarray] = field(default_factory=dict)

    @classmethod
    def create(cls, sizes: Dict[Protocol, int]) -> "MemoryMap":
        return cls({p: np.zeros(n, dtype=np.uint8) for p, n in sizes.items()})

    def space(self, protocol: Protocol) -> np.ndarray:
        if protocol in GENERATOR_PROTOCOLS:
            raise ValueError("generator protocols have no backing store")
        try:
            return self.spaces[protocol]
        except KeyError:
            raise KeyError(f"no address space bound for {protocol}") from None

    def read(self, protocol: Protocol, addr: int, length: int) -> np.ndarray:
        buf = self.space(protocol)
        # addr < 0 must be rejected explicitly: Python slice semantics would
        # silently wrap and return the wrong bytes while the end-guard passes
        if addr < 0:
            raise IndexError(f"read at negative address {addr} on {protocol}")
        if addr + length > buf.size:
            raise IndexError(
                f"read [{addr}, {addr + length}) beyond {protocol} size {buf.size}")
        return buf[addr:addr + length]

    def write(self, protocol: Protocol, addr: int, data: np.ndarray) -> None:
        buf = self.space(protocol)
        if addr < 0:
            raise IndexError(f"write at negative address {addr} on {protocol}")
        if addr + data.size > buf.size:
            raise IndexError(
                f"write [{addr}, {addr + data.size}) beyond {protocol} size {buf.size}")
        buf[addr:addr + data.size] = data


@dataclass
class TransferError(Exception):
    """A failing burst, reported with its legalized base address AND its
    index in the executed burst sequence so the front-end can decide
    continue/abort/replay (paper's error handler).

    `index` is relative to the sequence the raising `execute`/
    `execute_batch` call was given: locating the offender by value is
    ambiguous when a stream carries duplicate identical bursts.
    """

    burst: Transfer1D
    reason: str
    index: int = -1

    @property
    def kind(self) -> str:
        """Coarse error class: ``"injected"`` (seeded fault site),
        ``"page-fault"`` (translation miss) or ``"bounds"`` (a real
        out-of-range access)."""
        if "injected" in self.reason:
            return "injected"
        if "page fault" in self.reason:
            return "page-fault"
        return "bounds"

    def __str__(self) -> str:
        return (f"transfer error [{self.kind}] at burst {self.index} "
                f"src={self.burst.src_addr:#x} "
                f"dst={self.burst.dst_addr:#x} len={self.burst.length}: "
                f"{self.reason}")


@dataclass
class PageFault(TransferError):
    """A burst whose virtual page has no current translation.

    Raised by `repro.core.vm.TranslateStage` during lowering (not during
    byte movement): ``index`` is the row of the faulting burst in the
    batch handed to the stage, ``vaddr`` the exact faulting virtual
    address, ``space`` the address space and ``vpn`` the virtual page
    number.  ``table`` references the live `PageTable` so the engine's
    ``pin`` verb can map the page on demand (`PageFault.pin`).
    """

    vaddr: int = -1
    space: object = None
    vpn: int = -1
    table: object = None

    def pin(self) -> int:
        """Map the faulting page on demand via the owning page table's
        pin allocator; returns the assigned physical page number."""
        if self.table is None:
            raise RuntimeError("page fault carries no page table to pin on")
        return self.table.pin(self.space, self.vpn)

    def __str__(self) -> str:
        return (f"transfer error [page-fault] at burst {self.index} "
                f"va={self.vaddr:#x} space={self.space} vpn={self.vpn}: "
                f"{self.reason}")


@dataclass
class FaultSite:
    """One deterministic seeded fault site for the verification exerciser.

    ``index`` is a *drain-global* burst ordinal: the engine numbers the
    bursts of one drain (`wait_all` / `run_functional`) consecutively
    across every lowered port, so a site names one physical burst slot
    regardless of how the error handler re-issues around it.

    Kinds:
      * ``"transient"`` — the burst fails ``hits`` times, then succeeds
        (a transient read error: the replay verb recovers when
        ``max_replays >= hits``);
      * ``"persistent"`` — the burst fails on every attempt (a hard
        bounds-style fault: drives replay exhaustion / abort / continue);
      * ``"stall"``      — the burst does not fail but the channel stalls
        for ``stall_cycles`` (surfaced with the replay backoff on
        `ChannelSimResult.backoff_cycles`).
    """

    index: int
    kind: str = "transient"       # "transient" | "persistent" | "stall"
    hits: int = 1
    stall_cycles: int = 0

    def __post_init__(self) -> None:
        if self.kind not in ("transient", "persistent", "stall"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.index < 0:
            raise ValueError("fault index must be >= 0")
        if self.kind == "transient" and self.hits < 1:
            raise ValueError("transient faults need hits >= 1")
        if self.kind == "stall" and self.stall_cycles < 1:
            raise ValueError("stall faults need stall_cycles >= 1")


class FaultInjector:
    """Deterministic fault-site store consulted by the engine's drain loop
    (and mirrored by the exerciser's scalar oracle: two instances built
    from the same site list fire identically on both paths).

    `next_fault(lo, hi)` returns the drain-global index of the first
    armed fault site in ``[lo, hi)`` and consumes one hit from it;
    `take_stalls(lo, hi)` consumes and sums the stall cycles of stall
    sites in the range.  Exhausted transient sites stop firing.
    """

    def __init__(self, sites: Sequence[FaultSite] = ()) -> None:
        self.sites = sorted((FaultSite(s.index, s.kind, s.hits,
                                       s.stall_cycles) for s in sites),
                            key=lambda s: s.index)
        self.fired = 0
        self.stalled_cycles = 0

    def next_fault(self, lo: int, hi: int) -> Optional[int]:
        for s in self.sites:
            if s.index >= hi:
                break
            if s.index < lo or s.kind == "stall":
                continue
            if s.kind == "transient" and s.hits <= 0:
                continue
            if s.kind == "transient":
                s.hits -= 1
            self.fired += 1
            return s.index
        return None

    def take_stalls(self, lo: int, hi: int) -> int:
        cycles = 0
        for s in self.sites:
            if s.index >= hi:
                break
            if s.kind == "stall" and lo <= s.index and s.stall_cycles:
                cycles += s.stall_cycles
                s.stall_cycles = 0
        self.stalled_cycles += cycles
        return cycles


class ReadManager:
    """Protocol read manager: emit the byte stream of one burst."""

    def __init__(self, mem: MemoryMap, instream=None) -> None:
        self.mem = mem
        self.instream = instream

    def fetch(self, burst: Transfer1D, stream_offset: int) -> np.ndarray:
        if burst.src_protocol in GENERATOR_PROTOCOLS:
            data = init_stream(burst.options.init_pattern,
                               burst.options.init_value,
                               stream_offset, burst.length)
        else:
            data = self.mem.read(burst.src_protocol, burst.src_addr,
                                 burst.length).copy()
        return data


class WriteManager:
    """Protocol write manager: sink the (possibly transformed) byte stream."""

    def __init__(self, mem: MemoryMap) -> None:
        self.mem = mem

    def commit(self, burst: Transfer1D, data: np.ndarray) -> None:
        self.mem.write(burst.dst_protocol, burst.dst_addr, data)


def execute(bursts: Sequence[Transfer1D], mem: MemoryMap,
            instream=None, bus_width: int = 8,
            fail_at: Optional[int] = None,
            stream_base: Optional[Dict[int, int]] = None) -> int:
    """Run legalized bursts functionally; returns bytes moved.

    `instream` — optional in-stream accelerator applied between the read and
    write managers (paper Fig. 5 '⚡' port).
    `fail_at` — burst index to fault (error-handler tests).
    `stream_base` — per-transfer-id stream origin for generator sources: a
    generator burst's stream offset is ``src_addr - stream_base.get(tid, 0)``.
    With the default origin of 0 the offset is the absolute source address,
    so a legalized Init transfer produces the same stream as the unsplit
    one even when its bursts are split across back-end ports or replayed
    in separate `execute` calls.

    Faults — injected or real (an out-of-bounds burst) — raise
    `TransferError` carrying the burst and its index; bursts before the
    offender have fully executed, the offender has no effect.
    """
    check_legal(bursts, bus_width=bus_width)
    rm = ReadManager(mem)
    wm = WriteManager(mem)
    moved = 0
    for i, b in enumerate(bursts):
        if fail_at is not None and i == fail_at:
            raise TransferError(b, "injected fault", index=i)
        if b.src_protocol in GENERATOR_PROTOCOLS:
            base = 0 if stream_base is None \
                else stream_base.get(b.transfer_id, 0)
            offset = b.src_addr - base
        else:
            offset = 0                      # unused for memory sources
        try:
            data = rm.fetch(b, stream_offset=offset)
            if instream is not None:
                data = instream(data)
            wm.commit(b, data)
        except IndexError as err:           # bounds fault -> error handler
            raise TransferError(b, str(err), index=i) from None
        moved += b.length
    return moved


# --------------------------------------------------------------------------
# Vectorized functional data plane — the batched sibling of `execute`.
# --------------------------------------------------------------------------

#: payload bytes materialized per vectorized slice of one protocol group;
#: bounds the int64 index scratch at a small multiple of this.
EXEC_CHUNK_BYTES = 16 << 20

#: numeric Init pattern codes, so grouped stream generation never touches
#: per-row Python objects
_INIT_CODE = {InitPattern.CONSTANT: 0, InitPattern.INCREMENTING: 1,
              InitPattern.PSEUDORANDOM: 2}

_GEN_CODES = np.asarray([PROTO_CODE[p] for p in GENERATOR_PROTOCOLS],
                        dtype=np.uint8)


def _chunked(lens: np.ndarray):
    """Yield (row_slice, pos, split_points) covering all rows in slices of
    at most ~EXEC_CHUNK_BYTES payload (always >= 1 row per slice).

    `pos` is the intra-burst byte offset of every payload byte of the
    slice; `split_points` cut the flat payload back into per-burst chunks
    (for the in-stream accelerator).
    """
    n = lens.shape[0]
    cum = np.concatenate(([0], np.cumsum(lens)))
    row = 0
    while row < n:
        hi = int(np.searchsorted(cum, cum[row] + EXEC_CHUNK_BYTES,
                                 side="right")) - 1
        hi = min(max(hi, row + 1), n)
        sl = np.s_[row:hi]
        starts = cum[row:hi] - cum[row]
        pos = np.arange(int(cum[hi] - cum[row]), dtype=np.int64) \
            - np.repeat(starts, lens[sl])
        yield sl, pos, starts[1:]
        row = hi


def _apply_instream(data: np.ndarray, split_points: np.ndarray,
                    instream) -> np.ndarray:
    """Per-burst application of the in-stream accelerator: the flat group
    payload is cut back into burst chunks, transformed, re-concatenated.
    Transforms must be length-preserving on the batched path."""
    parts = [np.asarray(instream(p)) for p in np.split(data, split_points)]
    out = np.concatenate(parts) if parts else data
    if out.shape[0] != data.shape[0]:
        raise ValueError(
            "in-stream accelerators must preserve length on the batched "
            f"path (got {out.shape[0]} bytes from {data.shape[0]})")
    return out


def _length_bins(lens: np.ndarray):
    """Yield (L, rows) groups of equal burst length, zero-length dropped.

    Legalized streams cluster on very few distinct lengths (the protocol
    cap plus tails), so binning turns ragged gather/scatter into dense 2-D
    broadcast indexing — no `np.repeat` index materialization at all.
    """
    n = lens.shape[0]
    first = int(lens[0])
    if (lens == first).all():            # uniform-length stream: no sort
        if first:
            yield first, np.arange(n, dtype=np.int64)
        return
    uniq, inv = np.unique(lens, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(uniq.shape[0] + 1))
    for k in range(uniq.shape[0]):
        length = int(uniq[k])
        if length:
            yield length, order[bounds[k]:bounds[k + 1]]


def _exec_copy_group(src_buf: np.ndarray, dst_buf: np.ndarray,
                     sa: np.ndarray, da: np.ndarray, lens: np.ndarray,
                     instream, bins=None) -> None:
    """Grouped gather/scatter: every burst of one (src, dst) protocol pair
    moved with two fancy-indexed array ops per length bin / chunk.

    `bins` — precomputed `_length_bins(lens)` output (a captured plan's
    grouping); row indices are local to `sa`/`da`/`lens`.
    """
    if instream is None:
        for length, rows in (bins if bins is not None
                             else _length_bins(lens)):
            span = np.arange(length, dtype=np.int64)
            step = max(EXEC_CHUNK_BYTES // length, 1)
            for i in range(0, rows.shape[0], step):
                r = rows[i:i + step]
                dst_buf[da[r][:, None] + span] = src_buf[sa[r][:, None] + span]
        return
    # in-stream accelerator: per-burst chunks in row order (ragged path)
    for sl, pos, splits in _chunked(lens):
        data = src_buf[np.repeat(sa[sl], lens[sl]) + pos]
        data = _apply_instream(data, splits, instream)
        dst_buf[np.repeat(da[sl], lens[sl]) + pos] = data


@dataclass(eq=False, repr=False)
class ExecHints:
    """Precomputed grouping of a legalized `DescriptorBatch` for
    `execute_batch` — the data-plane half of a captured transfer plan.

    ``groups`` mirrors the batched back-end's protocol-pair grouping:
    one ``(code, rows, bins)`` triple per (src, dst) protocol pair, where
    ``code = (src_proto << 8) | dst_proto``, ``rows`` are the batch rows of
    the group (ascending), and ``bins`` is the materialized
    `_length_bins` output over ``length[rows]`` (``None`` for generator
    groups, which recompute).  ``src_gen`` is the per-row generator-source
    mask.  Hints are only valid for the exact batch *structure* they were
    built from (row count, lengths, protocol columns) — addresses may
    differ, which is what plan replay relies on.
    """

    groups: List[Tuple[int, np.ndarray,
                       Optional[List[Tuple[int, np.ndarray]]]]]
    src_gen: np.ndarray
    dst_gen: Optional[np.ndarray] = None


def build_exec_hints(batch: DescriptorBatch) -> ExecHints:
    """Materialize `execute_batch`'s grouping decisions for `batch` so a
    replayed plan pays none of them per submission."""
    n = len(batch)
    src_gen = np.isin(batch.src_proto, _GEN_CODES)
    dst_gen = np.isin(batch.dst_proto, _GEN_CODES)
    groups: List[Tuple[int, np.ndarray,
                       Optional[List[Tuple[int, np.ndarray]]]]] = []
    if n:
        sp, dp = batch.src_proto, batch.dst_proto
        if (sp == sp[0]).all() and (dp == dp[0]).all():
            pairs = [((int(sp[0]) << 8) | int(dp[0]),
                      np.arange(n, dtype=np.int64))]
        else:
            codes = (sp.astype(np.int64) << 8) | dp
            pairs = [(code, np.flatnonzero(codes == code))
                     for code in np.unique(codes).tolist()]
        for code, rows in pairs:
            if src_gen[rows[0]]:
                groups.append((code, rows, None))
            else:
                bins = list(_length_bins(batch.length[rows]))
                groups.append((code, rows, bins))
    return ExecHints(groups=groups, src_gen=src_gen, dst_gen=dst_gen)


def _init_params(batch: DescriptorBatch, rows: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(pattern_code, init_value) columns for generator rows."""
    opts = batch.options
    m = rows.shape[0]
    if opts is None:
        return np.zeros(m, dtype=np.int64), np.zeros(m, dtype=np.int64)
    if isinstance(opts, BackendOptions):
        return (np.full(m, _INIT_CODE[opts.init_pattern], dtype=np.int64),
                np.full(m, opts.init_value, dtype=np.int64))
    return (np.fromiter((_INIT_CODE[opts[int(i)].init_pattern]
                         for i in rows), dtype=np.int64, count=m),
            np.fromiter((opts[int(i)].init_value for i in rows),
                        dtype=np.int64, count=m))


def _gen_stream(pattern: int, off: np.ndarray, val: np.ndarray
                ) -> np.ndarray:
    """Vectorized Init read manager: bytes at stream offsets `off` with
    per-byte init value `val` — bit-exact with `init_stream`."""
    if pattern == 0:                                   # CONSTANT
        return (val & 0xFF).astype(np.uint8)
    if pattern == 1:                                   # INCREMENTING
        return ((off + val) & 0xFF).astype(np.uint8)
    # PSEUDORANDOM: splitmix32 over 32-bit words, little-endian bytes
    word = (off >> 2) % (1 << 32)
    w = splitmix32(word.astype(np.uint32) + val.astype(np.uint32))
    shift = ((off & 3) << 3).astype(np.uint32)
    return ((w >> shift) & np.uint32(0xFF)).astype(np.uint8)


def _gen_prng_rows(starts: np.ndarray, vals: np.ndarray, length: int
                   ) -> np.ndarray:
    """PSEUDORANDOM streams for a uniform-length bin, word-granular.

    `starts`/`vals` are (rows, 1) column vectors.  The per-byte `_gen_stream`
    form runs splitmix32 once per BYTE; here each 32-bit word is generated
    once (as in `init_stream`) and expanded little-endian, then the
    (possibly misaligned) byte windows are sliced out per row — 4x less
    PRNG work, bit-exact with the scalar oracle.
    """
    rows = starts.shape[0]
    n_words = (length + 6) >> 2          # covers any start misalignment
    words = (starts >> 2) + np.arange(n_words, dtype=np.int64)
    if (int(starts.min()) >> 2) < 0 or \
            (int(starts.max()) >> 2) + n_words >= (1 << 32):
        words = words % (1 << 32)        # rare: counter wrap, as init_stream
    w = splitmix32(words.astype(np.uint32) + vals.astype(np.uint32))
    stream = w.view(np.uint8).reshape(rows, n_words * 4)
    shifts = starts & 3
    s0 = int(shifts[0, 0])
    if (shifts == s0).all():             # uniform alignment: pure slice
        return stream[:, s0:s0 + length]
    cols = shifts + np.arange(length, dtype=np.int64)
    return stream[np.arange(rows, dtype=np.int64)[:, None], cols]


def _exec_init_group(batch: DescriptorBatch, rows: np.ndarray,
                     dst_buf: np.ndarray, instream,
                     stream_base: Optional[Dict[int, int]]) -> None:
    """Generator source: produce the Init streams of a whole row group
    vectorized, then scatter them (splitmix32 path for PSEUDORANDOM)."""
    pats, vals = _init_params(batch, rows)
    base = np.zeros(rows.shape[0], dtype=np.int64)
    if stream_base:
        tids = batch.transfer_id[rows]
        for tid, b in stream_base.items():
            base[tids == tid] = b
    sa = batch.src_addr[rows] - base
    da = batch.dst_addr[rows]
    lens = batch.length[rows]
    for pat in np.unique(pats).tolist():
        sub = np.flatnonzero(pats == pat)
        s_sa, s_da, s_ln, s_val = sa[sub], da[sub], lens[sub], vals[sub]
        if instream is None:
            for length, bin_rows in _length_bins(s_ln):
                span = np.arange(length, dtype=np.int64)
                step = max(EXEC_CHUNK_BYTES // length, 1)
                for i in range(0, bin_rows.shape[0], step):
                    r = bin_rows[i:i + step]
                    starts = s_sa[r][:, None]
                    vals_c = s_val[r][:, None]
                    if pat == 2:
                        data = _gen_prng_rows(starts, vals_c, length)
                    elif pat == 1:
                        data = _gen_stream(pat, starts + span, vals_c)
                    else:
                        data = _gen_stream(pat, starts, vals_c)
                    dst_buf[s_da[r][:, None] + span] = data
            continue
        for sl, pos, splits in _chunked(s_ln):
            reps = s_ln[sl]
            off = np.repeat(s_sa[sl], reps) + pos
            data = _gen_stream(pat, off, np.repeat(s_val[sl], reps))
            data = _apply_instream(data, splits, instream)
            dst_buf[np.repeat(s_da[sl], reps) + pos] = data


def _first_fault(batch: DescriptorBatch, mem: MemoryMap, src_gen: np.ndarray,
                 fail_at: Optional[int],
                 dst_gen: Optional[np.ndarray] = None
                 ) -> Optional[Tuple[int, int]]:
    """(row, kind) of the first failing row, or None.

    Kinds (priority at equal row, matching the scalar per-burst order):
    0 injected, 1 src space missing, 2 src out of bounds, 3 dst space
    missing/generator, 4 dst out of bounds.

    The no-fault case (every replayed submission in steady state) takes a
    single combined-mask `.any()` scan — the plan layer's cheap bounds
    revalidation; the kind/priority decomposition below only runs once a
    fault is known to exist.  `dst_gen` optionally carries the
    `ExecHints` precomputed generator mask (np.isin is the single most
    expensive term of the scan).
    """
    n = len(batch)
    size_of = np.full(len(CODE_PROTO), -1, dtype=np.int64)
    for proto, buf in mem.spaces.items():
        size_of[PROTO_CODE[proto]] = buf.size

    sa, da, ln = batch.src_addr, batch.dst_addr, batch.length
    src_sz = size_of[batch.src_proto]
    dst_sz = size_of[batch.dst_proto]
    if dst_gen is None:
        dst_gen = np.isin(batch.dst_proto, _GEN_CODES)

    if fail_at is None:
        ok_src = src_gen | ((src_sz >= 0) & (sa >= 0) & (sa + ln <= src_sz))
        bad = (~ok_src | dst_gen | (dst_sz < 0)
               | (da < 0) | (da + ln > dst_sz))
        if not bad.any():
            return None

    cands = []
    if fail_at is not None and 0 <= fail_at < n:
        cands.append((fail_at, 0))
    for mask, kind in (
            (~src_gen & (src_sz < 0), 1),
            (~src_gen & ((sa < 0) | (sa + ln > src_sz)), 2),
            (dst_gen | (dst_sz < 0), 3),
            ((da < 0) | (da + ln > dst_sz), 4)):
        hits = np.flatnonzero(mask)
        if hits.size:
            cands.append((int(hits[0]), kind))
    if not cands:
        return None
    return min(cands, key=lambda c: (c[0], c[1]))


def _raise_fault(batch: DescriptorBatch, mem: MemoryMap, row: int,
                 kind: int) -> None:
    b = batch.row(row)
    if kind == 0:
        raise TransferError(b, "injected fault", index=row)
    if kind in (1, 3):
        mem.space(b.src_protocol if kind == 1 else b.dst_protocol)
        raise AssertionError("space lookup should have raised")
    try:                 # reuse the scalar managers' exact bounds message
        if kind == 2:
            mem.read(b.src_protocol, b.src_addr, b.length)
        else:
            mem.write(b.dst_protocol, b.dst_addr,
                      np.empty(b.length, dtype=np.uint8))
    except IndexError as err:
        raise TransferError(b, str(err), index=row) from None
    raise AssertionError("bounds check should have raised")


def execute_batch(batch: DescriptorBatch, mem: MemoryMap,
                  instream=None, bus_width: int = 8,
                  fail_at: Optional[int] = None,
                  stream_base: Optional[Dict[int, int]] = None,
                  check: bool = True,
                  hints: Optional[ExecHints] = None,
                  fault_hook: Optional[
                      Callable[[DescriptorBatch], Optional[int]]] = None
                  ) -> int:
    """Vectorized functional back-end: run a legalized `DescriptorBatch`
    against `mem`; returns bytes moved.  The batched sibling of `execute`
    (which remains the scalar oracle) — property tests assert the two are
    byte-identical.

    Bursts are grouped by (src_protocol, dst_protocol); each group moves
    through grouped gather/scatter with fancy indexing, ragged bursts
    flattened via offset/length prefix sums and processed in
    `EXEC_CHUNK_BYTES` slices so the index scratch stays bounded.
    Generator (Init) sources produce their streams vectorized over the
    whole group on the `splitmix32` path.  The in-stream accelerator, when
    given, is applied per burst chunk, exactly as on the scalar path.

    One ordering caveat: because groups move as single array ops (and
    length bins within a group execute in ascending-length order), bursts
    of one call must not depend on each other — no burst may read bytes
    another burst writes (read-after-write), and overlapping *destination*
    ranges resolve in an unspecified order (write-write).  The scalar
    `execute` runs strictly in row order; batches with intra-call
    dependencies are outside the equivalence contract, exactly as
    decoupled-R/W hardware refuses to order them.

    Faults — injected via `fail_at` or real (out-of-bounds rows, checked
    vectorized before any byte moves) — raise `TransferError` with the
    exact failing row in ``index``; rows before it have fully executed,
    so the error handler can continue/replay from a precise position.

    `hints` — precomputed `ExecHints` for exactly this batch structure (a
    captured plan's grouping); ignored when a fault truncates the batch or
    an in-stream accelerator forces the ragged path.

    `fault_hook` — the verification exerciser's fault-injection hook:
    called with the (possibly already truncated-by-`done`) batch before
    the bounds scan, it may return a row index to fault exactly as
    `fail_at` would (deterministic seeded sites: see `FaultInjector`).
    Both may be given; the earlier row wins.
    """
    n = len(batch)
    if n == 0:
        return 0
    if fault_hook is not None:
        hooked = fault_hook(batch)
        if hooked is not None and (fail_at is None or hooked < fail_at):
            fail_at = hooked
    if check:
        check_legal_batch(batch, bus_width=bus_width)
    src_gen = hints.src_gen if hints is not None \
        else np.isin(batch.src_proto, _GEN_CODES)
    fault = _first_fault(batch, mem, src_gen, fail_at,
                         dst_gen=hints.dst_gen if hints is not None
                         else None)
    stop = fault[0] if fault is not None else n
    if hints is not None and (stop != n or instream is not None):
        hints = None                       # grouping no longer matches

    if stop:
        if hints is not None:
            groups = hints.groups
        else:
            sp, dp = batch.src_proto[:stop], batch.dst_proto[:stop]
            if (sp == sp[0]).all() and (dp == dp[0]).all():
                groups = [((int(sp[0]) << 8) | int(dp[0]),
                           np.arange(stop, dtype=np.int64), None)]
            else:
                codes = (sp.astype(np.int64) << 8) | dp
                groups = [(code, np.flatnonzero(codes == code), None)
                          for code in np.unique(codes).tolist()]
        for code, rows, bins in groups:
            dst_buf = mem.space(CODE_PROTO[code & 0xFF])
            if src_gen[rows[0]]:
                _exec_init_group(batch, rows, dst_buf, instream, stream_base)
            else:
                _exec_copy_group(mem.space(CODE_PROTO[code >> 8]), dst_buf,
                                 batch.src_addr[rows], batch.dst_addr[rows],
                                 batch.length[rows], instream, bins=bins)
    moved = int(batch.length[:stop].sum())
    if fault is not None:
        _raise_fault(batch, mem, *fault)
    return moved
