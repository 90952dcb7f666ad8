"""Virtual-memory mid-end: page table, translation TLB, page faults (the
port's copy of `repro.core.vm`).

The RISC-V Linux DMAC line of work (Benz et al., PAPERS.md) extends the
paper's mid-end taxonomy with *address translation*: guests submit
virtual-address descriptors and a translation stage lowers them to
physical bursts, faulting on unmapped pages so the OS can pin on demand.
This module is that stage on the repo's vectorized descriptor plane:

* :class:`PageTable`     — per-address-space multi-level (radix) page
  tables with power-of-two page sizes, a deterministic pin-on-demand
  allocator and an epoch counter bumped on any *re*-mapping (remap /
  unmap / explicit invalidate) so captured plans revalidate;
* :class:`Tlb`           — a small LRU translation cache consulted per
  unique page, flushed by page-table shootdowns (a ``shootdown=False``
  stage models a missed IPI — the stale entries it then serves are what
  `repro_torch.sanitize.planaudit` flags as P003);
* :class:`TranslateStage`— the typed `MidendStage`.  Structure (page
  splitting, like ``mp_split``) and value rewriting (VA→PA) are split
  across ``apply_structure``/``rebind_values`` so plan capture stays on
  the virtual plane and replayed plans re-translate against the *current*
  table (see `MidendStage` docs on value stages);
* scatter-gather lists   — linked (addr, len, next) node chains in guest
  memory, walked into `DescriptorBatch`es (`write_sg_list` /
  `read_sg_list` / `sg_gather_batch`);
* :func:`expert_gather_batch` — the sparse MoE expert-routing gather of
  `repro_torch.models.moe` expressed as a virtual-address descriptor batch
  (argsort dispatch with capacity slots, bit-exact with the model's
  routing math).

Unmapped pages raise :class:`.backend.PageFault` carrying the
exact faulting row, VA, space and page number; the engine's error-policy
verbs (``pin`` / ``retry`` / ``continue`` / ``abort``) decide what
happens next (`.engine`).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Hashable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .backend import PageFault
from .descriptor import (CODE_PROTO, GENERATOR_PROTOCOLS, PROTO_CODE,
                         DescriptorBatch, Protocol)
from .midend import page_split_batch
from .spec import BackendSpec, EngineSpec, MidendStage, build_engine

__all__ = [
    "MIN_PAGE_SIZE", "PageTable", "Tlb", "TlbStats", "TranslateStage",
    "expert_gather_batch", "read_sg_list", "sg_gather_batch",
    "write_sg_list",
]

#: smallest supported page: the legalizer's cut structure is periodic in
#: at most this (bus width × protocol caps), so splitting at page
#: boundaries >= 4 KiB commutes with legalization — the invariant that
#: keeps virtual-plane captured plans byte-identical on replay.
MIN_PAGE_SIZE = 4096

_GEN_CODES = frozenset(PROTO_CODE[p] for p in GENERATOR_PROTOCOLS)


@dataclass
class TlbStats:
    """Translation-cache counters (per *unique page* per lookup call —
    the vectorized stage resolves each page once per batch)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    shootdowns: int = 0


class Tlb:
    """LRU translation cache over (address space, virtual page number).

    The vectorized `TranslateStage` consults it once per unique page of a
    batch, so a TLB-warm 1M-burst gather costs a handful of dictionary
    probes, not a million.  `shootdown` (invoked by the owning
    `PageTable` on any remap/unmap/invalidate) flushes everything — the
    conservative IPI model.
    """

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError("tlb capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple[int, int], int]" = OrderedDict()
        self.stats = TlbStats()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, space_code: int, vpn: int) -> Optional[int]:
        key = (space_code, vpn)
        ppn = self._entries.get(key)
        if ppn is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return ppn

    def insert(self, space_code: int, vpn: int, ppn: int) -> None:
        key = (space_code, vpn)
        if key not in self._entries and \
                len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        self._entries[key] = ppn
        self._entries.move_to_end(key)

    def shootdown(self) -> None:
        self._entries.clear()
        self.stats.shootdowns += 1

    def entries(self) -> List[Tuple[int, int, int]]:
        """Snapshot of cached translations as (space_code, vpn, ppn)."""
        return [(s, v, p) for (s, v), p in self._entries.items()]


class PageTable:
    """Per-space multi-level page tables with a pin-on-demand allocator.

    ``page_sizes`` maps each *translated* address space (`Protocol`) to
    its power-of-two page size (>= `MIN_PAGE_SIZE`); spaces absent from
    the map pass through untranslated (physical submissions).  The walk
    is a nested-dict radix tree over ``levels`` bits of the VPN per
    level (default two 9-bit levels, Sv39-style).

    **Epoch policy** — ``epoch`` feeds the `TranslateStage` signature, so
    bumping it invalidates every captured plan that translated against
    the old mappings.  Mapping a *fresh* page does **not** bump: monotone
    growth (pins, fault-handler maps mid-drain) cannot invalidate a plan
    that already translated successfully.  Remapping an existing page,
    unmapping, and explicit `invalidate` all bump and shoot down every
    registered TLB.

    ``pin_windows`` maps a space to a ``(first_ppn, count)`` window the
    pin allocator hands out from, in deterministic bump order.
    """

    def __init__(self, page_sizes: Dict[Protocol, int],
                 levels: Tuple[int, ...] = (9, 9),
                 pin_windows: Optional[
                     Dict[Protocol, Tuple[int, int]]] = None) -> None:
        if not page_sizes:
            raise ValueError("page table needs at least one translated "
                             "address space")
        for proto, size in page_sizes.items():
            if size < MIN_PAGE_SIZE or (size & (size - 1)):
                raise ValueError(
                    f"page size for {proto} must be a power of two "
                    f">= {MIN_PAGE_SIZE}, got {size}")
        if not levels or any(b < 1 for b in levels):
            raise ValueError("walk levels must be positive bit counts")
        self.page_sizes: Dict[Protocol, int] = dict(page_sizes)
        self.levels = tuple(levels)
        self.epoch = 0
        self._roots: Dict[int, dict] = {
            PROTO_CODE[p]: {} for p in page_sizes}
        self._pins: Dict[int, List[int]] = {}
        if pin_windows:
            for proto, (first, count) in pin_windows.items():
                if first < 0 or count < 1:
                    raise ValueError("pin windows need first_ppn >= 0 "
                                     "and count >= 1")
                self._pins[PROTO_CODE[proto]] = [first, first + count]
        self._tlbs: List[Tlb] = []

    # -- wiring ------------------------------------------------------------

    def register_tlb(self, tlb: Tlb) -> None:
        """Subscribe a TLB to this table's shootdowns."""
        if tlb not in self._tlbs:
            self._tlbs.append(tlb)

    def _code(self, space) -> int:
        return space if isinstance(space, int) else PROTO_CODE[space]

    def _bump(self) -> None:
        self.epoch += 1
        for tlb in self._tlbs:
            tlb.shootdown()

    def _leaf(self, root: dict, vpn: int, create: bool) -> Optional[dict]:
        """Walk to the leaf directory holding `vpn`'s PTE."""
        node = root
        for bits in self.levels[:-1]:
            idx = vpn & ((1 << bits) - 1)
            vpn >>= bits
            nxt = node.get(idx)
            if nxt is None:
                if not create:
                    return None
                nxt = node[idx] = {}
            node = nxt
        return node

    def _leaf_key(self, vpn: int) -> int:
        for bits in self.levels[:-1]:
            vpn >>= bits
        return vpn

    # -- mapping -----------------------------------------------------------

    def map(self, space, vpn: int, ppn: int) -> None:
        """Install vpn → ppn.  Fresh installs do not bump the epoch;
        remapping an existing page does (and shoots down TLBs)."""
        if vpn < 0 or ppn < 0:
            raise ValueError("vpn and ppn must be >= 0")
        code = self._code(space)
        leaf = self._leaf(self._roots[code], vpn, create=True)
        key = self._leaf_key(vpn)
        old = leaf.get(key)
        if old == ppn:
            return
        leaf[key] = ppn
        if old is not None:
            self._bump()

    def map_range(self, space, vpn: int, ppn: int, count: int) -> None:
        for i in range(count):
            self.map(space, vpn + i, ppn + i)

    def unmap(self, space, vpn: int) -> bool:
        """Remove a mapping; returns whether one existed.  Bumps the
        epoch and shoots down TLBs when it did."""
        code = self._code(space)
        leaf = self._leaf(self._roots[code], vpn, create=False)
        key = self._leaf_key(vpn)
        if leaf is None or key not in leaf:
            return False
        del leaf[key]
        self._bump()
        return True

    def invalidate(self) -> None:
        """Explicit global invalidation (the mid-drain shootdown knob):
        bump the epoch and flush every registered TLB even though no
        mapping changed."""
        self._bump()

    def pin(self, space, vpn: int) -> int:
        """Pin-on-demand allocator: map `vpn` to the next physical page
        of the space's pin window (deterministic bump order).  Idempotent
        for already-mapped pages.  Fresh pins never bump the epoch."""
        code = self._code(space)
        existing = self.walk(code, vpn)
        if existing is not None:
            return existing
        window = self._pins.get(code)
        if window is None:
            raise RuntimeError(
                f"no pin window configured for {CODE_PROTO[code]}")
        nxt, end = window
        if nxt >= end:
            raise RuntimeError(
                f"pin window exhausted for {CODE_PROTO[code]}")
        window[0] = nxt + 1
        self.map(code, vpn, nxt)
        return nxt

    # -- lookup ------------------------------------------------------------

    def walk(self, space, vpn: int) -> Optional[int]:
        """Full table walk (TLB bypass); None when unmapped."""
        code = self._code(space)
        root = self._roots.get(code)
        if root is None:
            return None
        leaf = self._leaf(root, vpn, create=False)
        if leaf is None:
            return None
        return leaf.get(self._leaf_key(vpn))

    def translates(self, space) -> bool:
        return self._code(space) in self._roots

    def entries(self, space) -> Iterator[Tuple[int, int]]:
        """Iterate (vpn, ppn) leaves of one space (unordered)."""
        code = self._code(space)

        def rec(node: dict, prefix: int, shift: int, depth: int):
            bits = self.levels[depth]
            if depth == len(self.levels) - 1:
                for key, ppn in node.items():
                    yield prefix | (key << shift), ppn
                return
            for idx, child in node.items():
                yield from rec(child, prefix | (idx << shift),
                               shift + bits, depth + 1)

        yield from rec(self._roots[code], 0, 0, 0)

    def aliases(self) -> Dict[Protocol, Dict[int, Tuple[int, ...]]]:
        """Duplicate-PA pages per space: ppn → the (sorted) virtual pages
        mapping onto it, for every ppn with more than one — the raw
        material of the sanitizer's H007 VA-aliasing hazard."""
        out: Dict[Protocol, Dict[int, Tuple[int, ...]]] = {}
        for code in self._roots:
            rev: Dict[int, List[int]] = {}
            for vpn, ppn in self.entries(code):
                rev.setdefault(ppn, []).append(vpn)
            dups = {ppn: tuple(sorted(vpns))
                    for ppn, vpns in rev.items() if len(vpns) > 1}
            if dups:
                out[CODE_PROTO[code]] = dups
        return out


# --------------------------------------------------------------------------
# The translation mid-end stage
# --------------------------------------------------------------------------

@dataclass(eq=False)
class TranslateStage(MidendStage):
    """VA→PA translation as a typed mid-end stage (a *value* stage —
    see `MidendStage`).

    ``apply_structure`` splits every burst at page boundaries of its
    spaces (page sizes differ per space), so no burst straddles a page
    and translating each burst's start address translates the whole
    burst.  ``rebind_values`` then rewrites src/dst addresses through the
    TLB + page table; an unmapped page raises `PageFault` for the lowest
    faulting row (source port before destination at equal row).  The
    ``*_partial`` variants implement the ``continue`` verb: unmapped rows
    drop and the faulted pages are reported, deduplicated per unique
    (space, vpn) in first-occurrence row order.

    ``shootdown=False`` detaches the stage's TLB from the table's
    shootdowns — the missed-IPI model whose stale entries
    ``audit_translations`` (and planaudit's P003) exist to catch.
    """

    table: PageTable
    tlb_capacity: int = 256
    shootdown: bool = True
    name: str = "translate"
    translates = True

    def __post_init__(self) -> None:
        self.tlb = Tlb(self.tlb_capacity)
        if self.shootdown:
            self.table.register_tlb(self.tlb)

    # -- the MidendStage protocol -----------------------------------------

    def apply(self, batch: DescriptorBatch) -> DescriptorBatch:
        return self.rebind_values(self.apply_structure(batch))

    def apply_structure(self, batch: DescriptorBatch) -> DescriptorBatch:
        return page_split_batch(batch, self.table.page_sizes)

    def rebind_values(self, batch: DescriptorBatch) -> DescriptorBatch:
        out, faults = self._translate(batch)
        if faults:
            self._raise_first(batch, faults)
        return out

    def apply_partial(self, batch: DescriptorBatch
                      ) -> Tuple[DescriptorBatch, List[Tuple[str, int]]]:
        """``continue``-verb apply: translate, dropping rows whose pages
        are unmapped; returns (batch, faulted pages)."""
        out, keep, faults = self.rebind_values_partial(
            self.apply_structure(batch))
        return out, faults

    def rebind_values_partial(self, batch: DescriptorBatch
                              ) -> Tuple[DescriptorBatch, np.ndarray,
                                         List[Tuple[str, int]]]:
        """``continue``-verb rebind: returns (translated batch with
        unmapped rows dropped, keep mask over the input rows, faulted
        pages as (space name, vpn) in first-occurrence order)."""
        out, faults = self._translate(batch)
        if not faults:
            return out, np.ones(len(batch), dtype=bool), []
        keep = np.ones(len(batch), dtype=bool)
        pages: List[Tuple[str, int]] = []
        seen = set()
        for row, _va, code, vpn in faults:
            keep[row] = False
            key = (CODE_PROTO[code].name, vpn)
            if key not in seen:
                seen.add(key)
                pages.append(key)
        return out.select(keep), keep, pages

    def signature(self) -> Hashable:
        sizes = tuple(sorted((p.name, s)
                             for p, s in self.table.page_sizes.items()))
        return ("translate", sizes, self.table.epoch)

    def modulus(self) -> int:
        # cut points are a function of addr mod the page size of the
        # row's spaces; the lcm of power-of-two sizes is their max
        return max(self.table.page_sizes.values())

    # -- translation core --------------------------------------------------

    def _lookup_unique(self, code: int, vpns: np.ndarray) -> np.ndarray:
        """PPNs (or -1) for an array of *unique* page numbers, through
        the TLB with table-walk fill."""
        out = np.empty(vpns.shape[0], dtype=np.int64)
        tlb, table = self.tlb, self.table
        for i, vpn in enumerate(vpns.tolist()):
            ppn = tlb.lookup(code, vpn)
            if ppn is None:
                ppn = table.walk(code, vpn)
                if ppn is None:
                    out[i] = -1
                    continue
                tlb.insert(code, vpn, ppn)
            out[i] = ppn
        return out

    def _translate_port(self, addr: np.ndarray, proto: np.ndarray,
                        skip: np.ndarray, faults: list, port_rank: int
                        ) -> np.ndarray:
        """Translate one address column; appends (row, va, code, vpn,
        port_rank) fault records for unmapped pages."""
        out = addr.copy()
        for code in np.unique(proto).tolist():
            pt_proto = CODE_PROTO[code]
            page = self.table.page_sizes.get(pt_proto)
            if page is None or code in _GEN_CODES:
                continue
            rows = np.flatnonzero((proto == code) & ~skip)
            if not rows.shape[0]:
                continue
            shift = page.bit_length() - 1
            va = addr[rows]
            vpn = va >> shift
            uniq, inv = np.unique(vpn, return_inverse=True)
            ppn = self._lookup_unique(code, uniq)[inv]
            bad = np.flatnonzero(ppn < 0)
            for j in bad.tolist():
                faults.append((int(rows[j]), int(va[j]), code,
                               int(vpn[j]), port_rank))
            out[rows] = (ppn << shift) | (va & (page - 1))
        return out

    def _translate(self, batch: DescriptorBatch
                   ) -> Tuple[DescriptorBatch,
                              List[Tuple[int, int, int, int]]]:
        """Translate both ports of an already page-split batch.  Returns
        (translated batch, faults sorted by (row, port)); fault rows keep
        their *virtual* addresses in the output (they are either raised
        or dropped, never executed)."""
        if len(batch) == 0:
            return batch, []
        raw: list = []
        no_skip = np.zeros(len(batch), dtype=bool)
        gen_src = np.isin(batch.src_proto,
                          np.fromiter(_GEN_CODES, dtype=np.uint8))
        sa = self._translate_port(batch.src_addr, batch.src_proto,
                                  gen_src, raw, 0)
        da = self._translate_port(batch.dst_addr, batch.dst_proto,
                                  no_skip, raw, 1)
        raw.sort(key=lambda f: (f[0], f[4]))
        faults = [(row, va, code, vpn) for row, va, code, vpn, _ in raw]
        out = DescriptorBatch(
            src_addr=sa, dst_addr=da, length=batch.length,
            src_proto=batch.src_proto, dst_proto=batch.dst_proto,
            owner=batch.owner, transfer_id=batch.transfer_id,
            max_burst=batch.max_burst, reduce_len=batch.reduce_len,
            options=batch.options)
        return out, faults

    def _raise_first(self, batch: DescriptorBatch, faults: list) -> None:
        row, va, code, vpn = faults[0]
        proto = CODE_PROTO[code]
        raise PageFault(
            burst=batch.row(row),
            reason=f"page fault: va {va:#x} unmapped in {proto.name}",
            index=row, vaddr=va, space=proto, vpn=vpn, table=self.table)

    # -- audit -------------------------------------------------------------

    def audit_translations(self) -> List[Tuple[str, int, int,
                                               Optional[int]]]:
        """Compare every cached TLB entry against a fresh table walk;
        returns stale entries as (space name, vpn, cached ppn, walked ppn
        or None).  Empty when the TLB is coherent — planaudit turns
        non-empty results into P003 diagnostics."""
        stale = []
        for code, vpn, cached in self.tlb.entries():
            walked = self.table.walk(code, vpn)
            if walked != cached:
                stale.append((CODE_PROTO[code].name, vpn, cached, walked))
        return stale


# --------------------------------------------------------------------------
# Linked scatter-gather lists
# --------------------------------------------------------------------------

#: packed SG node: (addr, length, next_node_addr) little-endian int64
SG_NODE_BYTES = 24


def write_sg_list(buf: np.ndarray, node_addrs: Sequence[int],
                  entries: Sequence[Tuple[int, int]]) -> int:
    """Write a linked scatter-gather list into guest memory `buf`.

    Node ``i`` lives at ``node_addrs[i]`` and packs ``(addr, length,
    next)`` as three little-endian int64s; the last node's ``next`` is
    -1.  Returns the head node address.
    """
    if len(node_addrs) != len(entries) or not entries:
        raise ValueError("need one node address per entry (>= 1)")
    for i, (node, (addr, length)) in enumerate(zip(node_addrs, entries)):
        nxt = node_addrs[i + 1] if i + 1 < len(node_addrs) else -1
        words = np.asarray([addr, length, nxt], dtype="<i8")
        buf[node:node + SG_NODE_BYTES] = words.view(np.uint8)
    return int(node_addrs[0])


def read_sg_list(buf: np.ndarray, head: int,
                 max_nodes: int = 1 << 20) -> List[Tuple[int, int]]:
    """Walk a linked SG list from `head`; returns [(addr, length), ...].
    Guards against cycles/runaways via `max_nodes`."""
    out: List[Tuple[int, int]] = []
    node = head
    while node != -1:
        if len(out) >= max_nodes:
            raise ValueError(f"sg list exceeds {max_nodes} nodes "
                             "(cycle or corruption)")
        if node < 0 or node + SG_NODE_BYTES > buf.size:
            raise IndexError(f"sg node at {node:#x} out of bounds")
        addr, length, nxt = (
            buf[node:node + SG_NODE_BYTES].copy().view("<i8").tolist())
        out.append((int(addr), int(length)))
        node = int(nxt)
    return out


def sg_gather_batch(buf: np.ndarray, head: int, dst_addr: int,
                    src_protocol: Protocol = Protocol.AXI4,
                    dst_protocol: Protocol = Protocol.AXI4,
                    transfer_id: int = 0) -> DescriptorBatch:
    """Gather a linked SG list into a dense destination: node ``i``'s
    ``length`` bytes at its (virtual) ``addr`` land contiguously at
    ``dst_addr + sum(lengths[:i])``."""
    entries = read_sg_list(buf, head)
    if not entries:
        return DescriptorBatch.empty()
    src = np.fromiter((a for a, _ in entries), dtype=np.int64,
                      count=len(entries))
    lens = np.fromiter((n for _, n in entries), dtype=np.int64,
                       count=len(entries))
    dst = dst_addr + np.concatenate(
        ([0], np.cumsum(lens[:-1]))).astype(np.int64)
    return DescriptorBatch.from_arrays(
        src_addr=src, dst_addr=dst, length=lens,
        src_protocol=src_protocol, dst_protocol=dst_protocol,
        transfer_id=np.full(len(entries), transfer_id, dtype=np.int64))


# --------------------------------------------------------------------------
# Sparse MoE expert-routing gather
# --------------------------------------------------------------------------

def expert_gather_batch(token_va: np.ndarray, expert_idx: np.ndarray,
                        n_experts: int, capacity: int, d_bytes: int,
                        expert_buf_va: int,
                        src_protocol: Protocol = Protocol.AXI4,
                        dst_protocol: Protocol = Protocol.AXI4,
                        transfer_id: int = 0) -> DescriptorBatch:
    """The MoE dispatch scatter of
    `repro_torch.models.moe.moe_dispatch_compute` as a (virtual-address)
    descriptor gather.

    ``token_va`` (T,) holds each token vector's VA; ``expert_idx`` (T, k)
    the routed experts.  Routing mirrors the model bit-exactly: stable
    argsort by expert id, rank-within-expert via searchsorted, tokens
    beyond ``capacity`` dropped.  Kept pairs produce one ``d_bytes`` burst
    from the token to expert slot ``e*capacity + rank`` of the dense
    (E, C, d) buffer at ``expert_buf_va``.
    """
    token_va = np.asarray(token_va, dtype=np.int64)
    expert_idx = np.asarray(expert_idx, dtype=np.int64)
    if expert_idx.ndim == 1:
        expert_idx = expert_idx[:, None]
    T, k = expert_idx.shape
    if (expert_idx < 0).any() or (expert_idx >= n_experts).any():
        raise ValueError("expert indices out of range")
    flat_e = expert_idx.reshape(-1)
    flat_t = np.repeat(np.arange(T, dtype=np.int64), k)
    order = np.argsort(flat_e, kind="stable")
    e_s = flat_e[order]
    t_s = flat_t[order]
    first = np.searchsorted(e_s, e_s, side="left")
    rank = np.arange(T * k, dtype=np.int64) - first
    keep = rank < capacity
    slot = e_s[keep] * capacity + rank[keep]
    src = token_va[t_s[keep]]
    dst = expert_buf_va + slot * d_bytes
    n = src.shape[0]
    return DescriptorBatch.from_arrays(
        src_addr=src, dst_addr=dst,
        length=np.full(n, d_bytes, dtype=np.int64),
        src_protocol=src_protocol, dst_protocol=dst_protocol,
        transfer_id=np.full(n, transfer_id, dtype=np.int64))


def expert_gather_on_engine(rows: np.ndarray, expert_idx: np.ndarray,
                            n_experts: int, capacity: int) -> np.ndarray:
    """`expert_gather_batch` run on an `IDMAEngine` over the token rows'
    bytes ``rows`` (T, row bytes) uint8, the rows at VA 0 and the
    (E, C, row bytes) buffer on the next page.  Returns that buffer as the
    engine fills it, zero where no pair lands: the bytes of the MoE
    dispatch's capacity buffer for the same routing."""
    T, row = rows.shape
    buf_va = -(-T * row // MIN_PAGE_SIZE) * MIN_PAGE_SIZE
    engine = build_engine(EngineSpec(
        name="moe_dispatch",
        backend=BackendSpec(protocols=(Protocol.AXI4,), bus_width=64),
        mem_spaces=((Protocol.AXI4, buf_va + n_experts * capacity * row),)))
    mem = engine.mem.spaces[Protocol.AXI4]
    mem[:T * row] = rows.reshape(-1)
    engine.dispatch_batch(expert_gather_batch(
        np.arange(T, dtype=np.int64) * row, expert_idx, n_experts=n_experts,
        capacity=capacity, d_bytes=row, expert_buf_va=buf_va))
    engine.wait_all()
    return mem[buf_va:].reshape(n_experts, capacity, row).copy()
