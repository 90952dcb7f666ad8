"""Transfer legalizer — reshape 1-D transfers to what the fabric allows.

Paper §2.3 / Fig. 4: the legalizer accepts a 1-D transfer and splits it so
that every emitted burst is legal for the selected protocol(s):

* AXI4        : bursts of at most 256 beats or 4 KiB (whichever first) and
                never crossing a 4 KiB page boundary;
* AXI4-Lite   : no bursts — single bus-sized beats;
* AXI4-Stream : unlimited burst length (no addresses / pages);
* OBI         : no bursts — single bus-sized beats;
* TileLink UH : power-of-two burst lengths, naturally aligned;
* Init        : generator — follows the *destination* protocol's rules.

Both the source and destination protocols' constraints are honoured: the
emitted burst boundary set is the union of both sides' cut points, so every
burst is legal on both ports (paper: 'The source and destination protocols'
requirements are considered to guarantee only legal transfers are emitted.')

This repo adds a second fabric: TPU tiles.  `legalize_tile` rounds 2-D VMEM
tiles to hardware lane/sublane multiples ((8,128) fp32, (16,128) bf16,
(32,128) int8) and `dma_granule` alignment (512 B) — the TPU analogue of
page/burst legalization, consumed by the Pallas kernel generators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .descriptor import (CODE_PROTO, GENERATOR_PROTOCOLS, DescriptorBatch,
                         Protocol, Transfer1D)

PAGE_SIZE = 4096          # AXI 4 KiB page rule
AXI_MAX_BEATS = 256       # AXI4 burst cap in beats
TPU_DMA_GRANULE = 512     # bytes; efficient TPU DMA granularity
TPU_LANES = 128           # lane count of a VREG tile

#: sublane multiple per dtype itemsize (fp32→8, bf16→16, int8/fp8→32)
TPU_SUBLANES: Dict[int, int] = {4: 8, 2: 16, 1: 32}


@dataclass(frozen=True)
class ProtocolRules:
    """Burst legality of one protocol (paper Table 3)."""

    supports_bursts: bool
    max_burst_bytes: int          # 0 = unlimited
    page_size: int                # 0 = no page rule
    pow2_only: bool = False


def rules_for(protocol: Protocol, bus_width: int) -> ProtocolRules:
    if protocol == Protocol.AXI4:
        return ProtocolRules(True, min(AXI_MAX_BEATS * bus_width, PAGE_SIZE),
                             PAGE_SIZE)
    if protocol in (Protocol.AXI_LITE, Protocol.OBI):
        return ProtocolRules(False, bus_width, 0)
    if protocol == Protocol.AXI_STREAM:
        return ProtocolRules(True, 0, 0)
    if protocol == Protocol.TILELINK:
        # TL-UH: power-of-two, naturally aligned; practical cap 4 KiB.
        return ProtocolRules(True, PAGE_SIZE, PAGE_SIZE, pow2_only=True)
    if protocol == Protocol.INIT:
        # Generator: no constraints of its own.
        return ProtocolRules(True, 0, 0)
    if protocol in (Protocol.HBM, Protocol.VMEM, Protocol.ICI, Protocol.HOST):
        # TPU DMA: treat 4 MiB as a descriptor cap, no page rule at this level.
        return ProtocolRules(True, 4 << 20, 0)
    raise ValueError(f"unknown protocol {protocol}")


def _page_cuts(addr: int, length: int, page: int) -> Iterator[int]:
    """Offsets (relative to transfer start) where a page boundary is crossed."""
    if page <= 0:
        return
    first = (addr // page + 1) * page
    cut = first
    while cut < addr + length:
        yield cut - addr
        cut += page


def _largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _pow2_aligned_bursts(addr: int, addr2: Optional[int], length: int,
                         cap: int) -> Iterator[int]:
    """Yield burst lengths for a pow2/naturally-aligned protocol (TileLink).

    Classic address-alignment walk: each burst is the largest power of two
    that is (a) <= remaining length, (b) <= cap, (c) naturally aligned at
    BOTH port addresses (`addr2=None` for generator sources).
    """
    while length > 0:
        joint = addr if addr2 is None else (addr | addr2)
        align = joint & -joint if joint else cap or _largest_pow2_leq(length)
        step = min(align or cap, _largest_pow2_leq(length), cap)
        step = max(step, 1)
        yield step
        addr += step
        if addr2 is not None:
            addr2 += step
        length -= step


def legalize(transfer: Transfer1D, bus_width: int = 8,
             with_error_addrs: bool = False) -> List[Transfer1D]:
    """Split `transfer` into protocol-legal bursts (paper Fig. 4).

    Returns the list of emitted bursts, in order.  Zero-length transfers
    legalize to an empty list (the RTL optionally rejects them; we drop).
    """
    if transfer.length == 0:
        return []
    src_rules = rules_for(transfer.src_protocol, bus_width)
    dst_rules = rules_for(transfer.dst_protocol, bus_width)
    src_is_gen = transfer.src_protocol in GENERATOR_PROTOCOLS

    cap = transfer.options.max_burst or 0
    for r in ((dst_rules,) if src_is_gen else (src_rules, dst_rules)):
        if r.max_burst_bytes:
            cap = min(cap, r.max_burst_bytes) if cap else r.max_burst_bytes
    if transfer.options.reduce_len:
        cap = min(cap, transfer.options.reduce_len) if cap \
            else transfer.options.reduce_len

    # Collect mandatory cut offsets from page rules on both ports.
    cuts = set()
    if not src_is_gen and src_rules.page_size:
        cuts.update(_page_cuts(transfer.src_addr, transfer.length,
                               src_rules.page_size))
    if dst_rules.page_size:
        cuts.update(_page_cuts(transfer.dst_addr, transfer.length,
                               dst_rules.page_size))
    cuts.add(transfer.length)
    boundaries = sorted(cuts)

    pow2 = (dst_rules.pow2_only or (not src_is_gen and src_rules.pow2_only))

    bursts: List[Transfer1D] = []
    start = 0
    for boundary in boundaries:
        seg = boundary - start
        offset = start
        while seg > 0:
            if pow2:
                # walk pow2-aligned inside the segment (both ports); a
                # non-pow2 user cap (max_burst/reduce_len) must round DOWN
                # to a power of two or the walk emits illegal bursts
                for blen in _pow2_aligned_bursts(
                        transfer.dst_addr + offset,
                        None if src_is_gen else transfer.src_addr + offset,
                        seg, _largest_pow2_leq(cap) if cap
                        else _largest_pow2_leq(seg)):
                    bursts.append(transfer.shifted(offset, offset, blen))
                    offset += blen
                seg = 0
            else:
                blen = min(seg, cap) if cap else seg
                bursts.append(transfer.shifted(offset, offset, blen))
                offset += blen
                seg -= blen
        start = boundary
    return bursts


# --------------------------------------------------------------------------
# Batched (structure-of-arrays) legalization — the vectorized hot path.
# --------------------------------------------------------------------------

def _progression_cuts(addr: np.ndarray, length: np.ndarray, period: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized `_page_cuts` over rows: (row_index, cut_offset) pairs for
    every `period`-aligned absolute address strictly inside each transfer."""
    first = period - addr % period                    # in (0, period]
    cnt = np.maximum((length - first + period - 1) // period, 0)
    total = int(cnt.sum())
    rows = np.repeat(np.arange(addr.shape[0], dtype=np.int64), cnt)
    starts = np.concatenate(
        ([0], np.cumsum(cnt)[:-1])).astype(np.int64)
    k = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    return rows, first[rows] + k * period


def _boundary_segments(src: np.ndarray, dst: np.ndarray, length: np.ndarray,
                       p_src: int, p_dst: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split each row at the union of both ports' boundary cuts.

    Returns (row, segment_start_offset, segment_length); segments of one row
    are consecutive and ordered.  Rows must have length > 0.
    """
    m = length.shape[0]
    rows_parts = []
    offs_parts = []
    if p_src > 0:
        r, o = _progression_cuts(src, length, p_src)
        rows_parts.append(r)
        offs_parts.append(o)
    if p_dst > 0:
        r, o = _progression_cuts(dst, length, p_dst)
        rows_parts.append(r)
        offs_parts.append(o)
    rows_parts.append(np.arange(m, dtype=np.int64))
    offs_parts.append(length.astype(np.int64))    # the final boundary
    row = np.concatenate(rows_parts)
    off = np.concatenate(offs_parts)
    order = np.lexsort((off, row))
    row, off = row[order], off[order]
    keep = np.empty(row.shape[0], dtype=bool)
    keep[0] = True
    keep[1:] = (row[1:] != row[:-1]) | (off[1:] != off[:-1])
    row, off = row[keep], off[keep]
    new_row = np.empty(row.shape[0], dtype=bool)
    new_row[0] = True
    new_row[1:] = row[1:] != row[:-1]
    prev = np.concatenate(([0], off[:-1]))
    start = np.where(new_row, 0, prev)
    return row, start, off - start


def _chunk_segments(row: np.ndarray, start: np.ndarray, seg_len: np.ndarray,
                    cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chop every segment into `cap`-byte chunks from its start (cap 0 =
    unlimited) — vectorized tail of the object legalizer's inner loop."""
    if cap <= 0:
        return row, start, seg_len
    cnt = -(-seg_len // cap)
    total = int(cnt.sum())
    rep = np.repeat(np.arange(seg_len.shape[0], dtype=np.int64), cnt)
    starts = np.concatenate(([0], np.cumsum(cnt)[:-1])).astype(np.int64)
    j = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    off = start[rep] + j * cap
    return row[rep], off, np.minimum(cap, seg_len[rep] - j * cap)


def legalize_batch(batch: DescriptorBatch, bus_width: int = 8
                   ) -> DescriptorBatch:
    """Vectorized `legalize` over a whole `DescriptorBatch`.

    Byte-identical to mapping the object legalizer over the rows (property
    tests assert this): bursts come out grouped by input row in input order,
    ascending by offset, zero-length rows dropped.  Rows are grouped by
    (protocol pair, max_burst, reduce_len) so page/cap parameters are
    scalars inside each vectorized group; the rare pow2-aligned protocols
    (TileLink) fall back to the scalar walk per row, everything else is
    pure array arithmetic.
    """
    if len(batch) == 0:
        return batch
    nz = np.nonzero(batch.length > 0)[0]
    out_row: List[np.ndarray] = []
    out_off: List[np.ndarray] = []
    out_len: List[np.ndarray] = []
    if nz.shape[0]:
        cols = (batch.src_proto[nz], batch.dst_proto[nz],
                batch.max_burst[nz], batch.reduce_len[nz])
        if all((c == c[0]).all() for c in cols):
            # the overwhelmingly common case: one homogeneous rule group
            groups = [(tuple(int(c[0]) for c in cols), nz)]
        else:
            # mixed-radix combination of per-column inverses — much faster
            # than np.unique(axis=0)'s row-wise void comparisons
            uniques = []
            invs = []
            radix = 1
            for c in cols:
                u, inv = np.unique(c, return_inverse=True)
                uniques.append(u)
                invs.append(inv)
                radix *= int(u.shape[0])
            groups = []
            if radix < 2 ** 62:
                inv_all = np.zeros(nz.shape[0], dtype=np.int64)
                for u, inv in zip(uniques, invs):
                    inv_all = inv_all * u.shape[0] + inv
                gids, ginv = np.unique(inv_all, return_inverse=True)
                for g, gid in enumerate(gids.tolist()):
                    vals = []
                    for u in reversed(uniques):
                        gid, r = divmod(gid, u.shape[0])
                        vals.append(int(u[r]))
                    groups.append((tuple(reversed(vals)), nz[ginv == g]))
            else:       # degenerate: mixed radix would overflow int64
                seen = {}
                for pos, key in enumerate(zip(*(c.tolist() for c in cols))):
                    seen.setdefault(key, []).append(pos)
                for key, poss in seen.items():
                    groups.append((key, nz[np.asarray(poss)]))
        for (spc, dpc, mb, rl), rows_g in groups:
            src_proto = CODE_PROTO[spc]
            dst_proto = CODE_PROTO[dpc]
            src_rules = rules_for(src_proto, bus_width)
            dst_rules = rules_for(dst_proto, bus_width)
            src_is_gen = src_proto in GENERATOR_PROTOCOLS

            cap = mb or 0
            for r in ((dst_rules,) if src_is_gen
                      else (src_rules, dst_rules)):
                if r.max_burst_bytes:
                    cap = min(cap, r.max_burst_bytes) if cap \
                        else r.max_burst_bytes
            if rl:
                cap = min(cap, rl) if cap else rl

            pow2 = (dst_rules.pow2_only or
                    (not src_is_gen and src_rules.pow2_only))
            if pow2:
                # data-dependent alignment walk — scalar reference per row
                frow, foff, flen = [], [], []
                for r in rows_g.tolist():
                    t = Transfer1D(
                        src_addr=int(batch.src_addr[r]),
                        dst_addr=int(batch.dst_addr[r]),
                        length=int(batch.length[r]),
                        src_protocol=src_proto, dst_protocol=dst_proto,
                        options=batch.option_for(r))
                    for b in legalize(t, bus_width=bus_width):
                        frow.append(r)
                        foff.append(b.dst_addr - t.dst_addr)
                        flen.append(b.length)
                out_row.append(np.asarray(frow, dtype=np.int64))
                out_off.append(np.asarray(foff, dtype=np.int64))
                out_len.append(np.asarray(flen, dtype=np.int64))
                continue

            p_src = 0 if src_is_gen else src_rules.page_size
            p_dst = dst_rules.page_size
            length = batch.length[rows_g]
            if p_src or p_dst:
                lrow, start, seg = _boundary_segments(
                    batch.src_addr[rows_g], batch.dst_addr[rows_g],
                    length, p_src, p_dst)
            else:
                lrow = np.arange(rows_g.shape[0], dtype=np.int64)
                start = np.zeros_like(length)
                seg = length
            lrow, off, ln = _chunk_segments(lrow, start, seg, cap)
            out_row.append(rows_g[lrow])
            out_off.append(off)
            out_len.append(ln)

    if not out_row:
        return batch.rewrite(np.empty(0, dtype=np.int64),
                             np.empty(0, dtype=np.int64),
                             np.empty(0, dtype=np.int64))
    row = np.concatenate(out_row)
    off = np.concatenate(out_off)
    ln = np.concatenate(out_len)
    order = np.lexsort((off, row))        # global order: (input row, offset)
    return batch.rewrite(row[order], off[order], ln[order])


def legal_latency(num_midends: int, has_legalizer: bool = True,
                  tensor_nd_zero_latency: bool = False) -> int:
    """Paper §4.3 latency rule: 2 cycles descriptor→first read request with
    hardware legalization, 1 without; +1 per mid-end; the tensor_ND mid-end
    can be configured for 0 cycles."""
    base = 2 if has_legalizer else 1
    extra = num_midends
    if tensor_nd_zero_latency and num_midends > 0:
        extra -= 1
    return base + extra


# --------------------------------------------------------------------------
# TPU tile legalization — the second fabric.
# --------------------------------------------------------------------------

def sublane_multiple(itemsize: int) -> int:
    try:
        return TPU_SUBLANES[itemsize]
    except KeyError:
        raise ValueError(f"unsupported itemsize {itemsize}") from None


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def legalize_tile(shape: Tuple[int, int], itemsize: int,
                  vmem_budget: int = 64 * 1024 * 1024,
                  max_tile: Tuple[int, int] = (1024, 2048),
                  ) -> Tuple[int, int]:
    """Round a requested VMEM tile to TPU-legal, budget-respecting shape.

    - second-minor dim → multiple of the dtype sublane count,
    - minor dim → multiple of 128 lanes,
    - shrink (by halving the larger axis) until it fits `vmem_budget` bytes.

    Mirrors what the RTL legalizer does for AXI: the *request* is arbitrary,
    the *emitted* unit is hardware-legal.
    """
    sub = sublane_multiple(itemsize)
    rows = max(min(shape[0], max_tile[0]), 1)
    cols = max(min(shape[1], max_tile[1]), 1)
    rows = _round_up(rows, sub)
    cols = _round_up(cols, TPU_LANES)
    while rows * cols * itemsize > vmem_budget:
        if rows > sub and rows >= cols:
            rows = max(sub, _round_up(rows // 2, sub))
        elif cols > TPU_LANES:
            cols = max(TPU_LANES, _round_up(cols // 2, TPU_LANES))
        else:
            break
    return rows, cols


def legal_dma_len(length: int) -> int:
    """Round a 1-D HBM DMA length up to the efficient 512-B granule."""
    return _round_up(max(length, 1), TPU_DMA_GRANULE)


def check_legal_batch(batch: DescriptorBatch, bus_width: int = 8) -> None:
    """Vectorized `check_legal` over a whole `DescriptorBatch`.

    Raises `ValueError` for the first offending row (lowest index), with the
    same message the scalar checker produces for that burst.  This is the
    legality gate of the vectorized data plane (`backend.execute_batch`);
    the scalar `check_legal` remains the oracle the property tests compare
    against.
    """
    n = len(batch)
    if n == 0:
        return
    bad = np.zeros(n, dtype=bool)
    length = batch.length
    for proto_col, addr, is_src in ((batch.src_proto, batch.src_addr, True),
                                    (batch.dst_proto, batch.dst_addr, False)):
        for code in np.unique(proto_col).tolist():
            proto = CODE_PROTO[code]
            if is_src and proto in GENERATOR_PROTOCOLS:
                continue
            r = rules_for(proto, bus_width)
            m = proto_col == code
            a, ln = addr[m], length[m]
            v = np.zeros(ln.shape[0], dtype=bool)
            if r.max_burst_bytes:
                v |= ln > r.max_burst_bytes
            if r.page_size:
                v |= a // r.page_size != (a + ln - 1) // r.page_size
            if r.pow2_only:
                v |= (ln & (ln - 1)) != 0
                nz = ln > 0
                v |= nz & (a % np.maximum(ln, 1) != 0)
            bad[m] |= v
    if bad.any():
        i = int(np.argmax(bad))
        check_legal([batch.row(i)], bus_width=bus_width)
        raise ValueError(f"row {i} of the batch is not legal")  # unreachable


def check_legal(bursts: Sequence[Transfer1D], bus_width: int = 8) -> None:
    """Assert every burst satisfies both ports' rules.  Raises ValueError."""
    for b in bursts:
        src_is_gen = b.src_protocol in GENERATOR_PROTOCOLS
        for proto, addr in (
                () if src_is_gen else ((b.src_protocol, b.src_addr),)
        ) + ((b.dst_protocol, b.dst_addr),):
            r = rules_for(proto, bus_width)
            if r.max_burst_bytes and b.length > r.max_burst_bytes:
                raise ValueError(
                    f"burst of {b.length} B exceeds {proto} cap "
                    f"{r.max_burst_bytes} B")
            if r.page_size:
                if addr // r.page_size != (addr + b.length - 1) // r.page_size:
                    raise ValueError(f"burst crosses {proto} page boundary")
            if r.pow2_only:
                if b.length & (b.length - 1):
                    raise ValueError(f"{proto} burst {b.length} not pow2")
                if addr % b.length:
                    raise ValueError(
                        f"{proto} burst at {addr:#x} not naturally aligned")
