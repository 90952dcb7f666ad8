"""Paged KV cache — the scatter/gather descriptor use case (the port of
`repro.serve.kvcache`).

Contiguous caches (models/lm.py) are what the serving engine decodes
over; this module adds the vLLM-style paged variant the continuous-
batching front door uses to share a physical pool across requests of
ragged lengths:

* the physical pool is (n_pages, page_size, Hkv, dh) per layer-stack,
* each sequence owns a page table (max_pages,) of physical page ids,
* appending a token is one scatter descriptor (`tensor_nd` walk of one
  row); reading the cache for decode is a gather over the table — both
  are exactly the paper's scatter-gather transfer type (Table 5),
* new pages are zero-filled by the Init engine on allocation.

`init_paged_kv`, `append_token` and `gather_kv` work on torch tensors
(plain PyTorch, as the reference's are plain jnp: no kernel).  Tests
assert paged == contiguous decode.

The second half of this module expresses the same paged traffic on the
batched descriptor plane (host NumPy, a copy of the reference's):
`append_descriptors` / `gather_descriptors` build `DescriptorBatch`
scatter/gather streams straight from a page table, and `PagedKVDMA`
executes them through an `IDMAEngine` (HBM pool ↔ VMEM staging) — the
serving engine's decode-step cache traffic expressed as engine
transfers, exactly the paper's scatter-gather transfer type (Table 5).
Tests assert paged-via-DMA == contiguous.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import (PROTO_CODE, CompletionEvent, DescriptorBatch,
                              EngineSpec, IDMAEngine, MemoryMap, PlanCache,
                              Protocol, build_engine, concat_batches,
                              edge_ai, execute_batch, legalize_batch,
                              structure_modulus)
from repro_torch.kernels.runtime import resolve_device


@dataclass
class PagePool:
    """Host-side allocator for a physical page pool (per cache stack)."""

    n_pages: int
    page_size: int
    free: List[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.free:
            self.free = list(range(self.n_pages))

    def alloc(self) -> int:
        if not self.free:
            raise MemoryError("KV page pool exhausted")
        return self.free.pop()

    def release(self, pages) -> None:
        for p in pages:
            if p >= 0:
                self.free.append(int(p))


def init_paged_kv(n_pages: int, page_size: int, n_kv_heads: int, dh: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Union[str, torch.device, None] = None
                  ) -> Dict[str, torch.Tensor]:
    """Physical pool tensors (k, v): (n_pages, page_size, Hkv, dh), on
    `device` (default: the card)."""
    shape = (n_pages, page_size, n_kv_heads, dh)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _last_occurrence(phys: torch.Tensor) -> torch.Tensor:
    """Indices of the rows of `phys` that no later row repeats."""
    _, inverse = torch.unique(phys, return_inverse=True)
    rows = torch.arange(phys.shape[0], device=phys.device)
    last = torch.full((int(inverse.max()) + 1,), -1, dtype=rows.dtype,
                      device=phys.device)
    return last.scatter_reduce_(0, inverse, rows, "amax")


def append_token(pool: Dict[str, torch.Tensor], page_table: torch.Tensor,
                 pos: Union[int, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, page_size: int
                 ) -> Dict[str, torch.Tensor]:
    """Scatter one token's (k, v) (B, Hkv, dh) into the pool, in place;
    returns `pool`.

    `page_table` (B, max_pages) integer; `pos` the current length.  Where
    two rows name the same physical page, the later row's values land,
    as the reference's `.at[].set` leaves them (on every device: the
    repeated rows are dropped before the store)."""
    pos = int(pos)
    phys = page_table[:, pos // page_size].long()           # (B,)
    keep = _last_occurrence(phys)
    if keep.numel() != phys.numel():
        phys, k, v = phys[keep], k[keep], v[keep]
    offset = pos % page_size
    pool["k"][phys, offset] = k.to(pool["k"].dtype)
    pool["v"][phys, offset] = v.to(pool["v"].dtype)
    return pool


def gather_kv(pool: Dict[str, torch.Tensor], page_table: torch.Tensor,
              max_len: int, page_size: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize contiguous (B, Hkv, max_len, dh) views via page gather."""
    n = max_len // page_size
    tables = page_table[:, :n].long()                  # (B, n)
    B = tables.shape[0]
    Hkv, dh = pool["k"].shape[2], pool["k"].shape[3]

    def gather(buf: torch.Tensor) -> torch.Tensor:     # (B, n, ps, H, dh)
        return buf[tables].reshape(B, n * page_size, Hkv, dh).transpose(1, 2)

    return gather(pool["k"]), gather(pool["v"])


def make_page_tables(pool_alloc: PagePool, batch: int, seq_len: int
                     ) -> np.ndarray:
    """Allocate enough pages for `seq_len` tokens per sequence."""
    per_seq = -(-seq_len // pool_alloc.page_size)
    tables = np.full((batch, per_seq), -1, np.int32)
    for b in range(batch):
        for i in range(per_seq):
            tables[b, i] = pool_alloc.alloc()
    return tables


# ---------------------------------------------------------------------------
# Descriptor-plane scatter/gather (the iDMA serving path)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KVLayout:
    """Byte layout of one paged K or V pool: (n_pages, page_size, Hkv, dh).

    `row_bytes` is one token's KV row, `page_bytes` one physical page —
    the transfer granules of the scatter (append) and gather streams.
    """

    n_pages: int
    page_size: int
    n_kv_heads: int
    head_dim: int
    itemsize: int = 4

    @property
    def row_bytes(self) -> int:
        return self.n_kv_heads * self.head_dim * self.itemsize

    @property
    def page_bytes(self) -> int:
        return self.page_size * self.row_bytes

    @property
    def pool_bytes(self) -> int:
        return self.n_pages * self.page_bytes


def gather_bases(layout: KVLayout, page_table: np.ndarray, max_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(sequence, page) byte offsets of a page gather: source offsets
    within one pool, destination offsets within one contiguous region.

    The single source of truth for the gather address math — shared by
    `gather_descriptors` and `PagedKVDMA`'s template-replay fast path, so
    the two can never diverge."""
    n = max_len // layout.page_size
    tables = np.asarray(page_table)[:, :n].astype(np.int64)   # (B, n)
    src = tables.reshape(-1) * layout.page_bytes
    dst = np.arange(tables.size, dtype=np.int64) * layout.page_bytes
    return src, dst


def append_bases(layout: KVLayout, page_table: np.ndarray, pos: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sequence byte offsets of a token append: source offsets within
    the staging buffer, destination offsets within one pool.

    The single source of truth for the append address math — shared by
    `append_descriptors` and `PagedKVDMA`'s template-replay fast path."""
    tables = np.asarray(page_table).astype(np.int64)
    phys = tables[:, pos // layout.page_size]                 # (B,)
    dst = (phys * layout.page_bytes
           + (pos % layout.page_size) * layout.row_bytes)
    src = np.arange(phys.shape[0], dtype=np.int64) * layout.row_bytes
    return src, dst


def gather_descriptors(layout: KVLayout, page_table: np.ndarray,
                       max_len: int, pool_base: int = 0, dst_base: int = 0,
                       src_protocol: Protocol = Protocol.HBM,
                       dst_protocol: Protocol = Protocol.VMEM
                       ) -> DescriptorBatch:
    """Page-gather as a `DescriptorBatch`: one page-sized transfer per
    (sequence, page) pair, materializing contiguous per-sequence KV rows.

    Row ordering matches `gather_kv`: sequence-major, pages in table
    order, so the destination range ``[dst_base + b*L*row_bytes, ...)`` is
    sequence b's first `max_len` token rows, contiguous.
    """
    src, dst = gather_bases(layout, page_table, max_len)
    return DescriptorBatch.from_arrays(
        src_addr=pool_base + src, dst_addr=dst_base + dst,
        length=np.full(src.shape[0], layout.page_bytes, dtype=np.int64),
        src_protocol=src_protocol, dst_protocol=dst_protocol)


def append_descriptors(layout: KVLayout, page_table: np.ndarray, pos: int,
                       src_base: int = 0, pool_base: int = 0,
                       src_protocol: Protocol = Protocol.VMEM,
                       dst_protocol: Protocol = Protocol.HBM
                       ) -> DescriptorBatch:
    """Token-append as a `DescriptorBatch`: scatter one row-sized transfer
    per sequence from a contiguous staging buffer (row b at
    ``src_base + b*row_bytes``) into each sequence's current page slot."""
    src, dst = append_bases(layout, page_table, pos)
    return DescriptorBatch.from_arrays(
        src_addr=src_base + src, dst_addr=pool_base + dst,
        length=np.full(src.shape[0], layout.row_bytes, dtype=np.int64),
        src_protocol=src_protocol, dst_protocol=dst_protocol)


def span_append_descriptors(layout: KVLayout, blocks, start: int, end: int,
                            stage_k: int = 0, stage_v: int = 0,
                            pool_base: int = 0,
                            src_protocol: Protocol = Protocol.VMEM,
                            dst_protocol: Protocol = Protocol.HBM
                            ) -> DescriptorBatch:
    """Multi-row append for ONE sequence as a `DescriptorBatch`: scatter
    the token rows of positions ``[start, end)`` from contiguous staging
    regions (K rows at ``stage_k``, V rows at ``stage_v``, row ``i`` of
    the span at ``+ i*row_bytes``) into the sequence's pages.

    This is the prefill-chunk / decode-append granule of the continuous
    batching scheduler (`serve.sched`): one doorbell covers a whole
    prompt chunk (or a single decode row, ``end == start + 1``), K and V
    in one batch."""
    pos = np.arange(start, end, dtype=np.int64)
    phys = np.asarray(blocks, dtype=np.int64)[pos // layout.page_size]
    dst = (phys * layout.page_bytes
           + (pos % layout.page_size) * layout.row_bytes)
    src = np.arange(end - start, dtype=np.int64) * layout.row_bytes
    return concat_batches([
        DescriptorBatch.from_arrays(
            src_addr=base + src, dst_addr=pool + dst,
            length=np.full(src.shape[0], layout.row_bytes, dtype=np.int64),
            src_protocol=src_protocol, dst_protocol=dst_protocol)
        for base, pool in ((stage_k, pool_base),
                           (stage_v, pool_base + layout.pool_bytes))])


def swap_descriptors(layout: KVLayout, blocks, slots, direction: str,
                     pool_base: int = 0, host_base: int = 0,
                     host_protocol: Protocol = Protocol.HOST,
                     pool_protocol: Protocol = Protocol.HBM
                     ) -> DescriptorBatch:
    """Preemption swap traffic as a `DescriptorBatch`: page-granular
    moves between the HBM pools and per-block HOST swap slots.

    ``blocks[i]`` pairs with ``slots[i]``; each HOST slot is
    ``2 * page_bytes`` (the block's K page then its V page).
    ``direction="out"`` evicts (HBM→HOST), ``"in"`` restores (HOST→HBM —
    typically into freshly allocated blocks, so a resumed request's pages
    land wherever the allocator had room).  Swap streams ride the same
    engine channels as decode gathers, so eviction traffic contends with
    serving traffic in `simulate_channels` — the scheduler's swap cost is
    the timing model's, not a constant."""
    blocks = np.asarray(blocks, dtype=np.int64)
    slots = np.asarray(slots, dtype=np.int64)
    if blocks.shape != slots.shape:
        raise ValueError(f"swap needs one slot per block: "
                         f"{blocks.shape} vs {slots.shape}")
    pb = layout.page_bytes
    pool = pool_base + np.concatenate([blocks * pb,
                                       layout.pool_bytes + blocks * pb])
    host = host_base + np.concatenate([slots * 2 * pb,
                                       slots * 2 * pb + pb])
    length = np.full(pool.shape[0], pb, dtype=np.int64)
    if direction == "out":
        return DescriptorBatch.from_arrays(
            src_addr=pool, dst_addr=host, length=length,
            src_protocol=pool_protocol, dst_protocol=host_protocol)
    if direction == "in":
        return DescriptorBatch.from_arrays(
            src_addr=host, dst_addr=pool, length=length,
            src_protocol=host_protocol, dst_protocol=pool_protocol)
    raise ValueError(f"direction must be 'out' or 'in', got {direction!r}")


class PagedKVDMA:
    """A paged KV cache whose append/gather are *engine transfers*.

    The physical pools live in an HBM address space (K at 0, V at
    `layout.pool_bytes`); append stages token rows in VMEM and scatters
    them via `append_descriptors`; gather runs `gather_descriptors` into
    a contiguous VMEM region.  All traffic is dispatched across the
    engine's channels (`dispatch_batch` → `wait_all`), so decode-step
    cache movement shows up in the engine's stats and multi-channel
    timing model like any other DMA workload.

    ``timing=False`` skips the engine's submission queues and cycle model
    entirely and drives the descriptor streams straight through the
    vectorized functional data plane (`core.backend.execute_batch`) — the
    serving-throughput configuration: same bytes, no per-decode-step
    timing simulation.  Engine byte/descriptor stats are still updated;
    transfer ids are not assigned on this path.

    Steady-state decode is compile-once / replay-many: each append/gather
    stream's structure is a pure function of the `KVLayout` and the
    (batch, page-count) shape, so the cache captures per-layout
    `TransferPlan` templates (`core.plan`) on first use and every later
    step is a vectorized page-table address rebind — no legalizer or
    mid-end code runs.  ``plan_cache=True`` (default) builds a private
    `PlanCache` (also handed to an internally created engine);
    pass a `PlanCache` to share one, or ``False`` to disable.  A
    caller-supplied engine keeps whatever ``plan_cache`` it was built
    with — engine-level planning stays opt-in.

    Engine composition is spec-driven: when no `engine` is passed, one is
    built from `spec` (default: the ``edge_ai`` preset with this cache's
    channel count) over the HBM-pool/VMEM-staging memory map —
    ``PagedKVDMA.from_spec`` is the explicit entry point.
    """

    def __init__(self, layout: KVLayout, max_batch: int, max_len: int,
                 engine: Optional[IDMAEngine] = None,
                 num_channels: int = 1, timing: bool = True,
                 plan_cache: Union[bool, PlanCache] = True,
                 spec: Optional[EngineSpec] = None,
                 on_complete=None) -> None:
        self.layout = layout
        self.timing = timing
        self._notify = on_complete is not None
        if plan_cache is True:
            plan_cache = PlanCache(capacity=128)
        elif plan_cache is False:
            plan_cache = None
        self.plan_cache: Optional[PlanCache] = plan_cache
        # per-KVLayout plan templates: (site, n_rows) → TransferPlan.  The
        # append/gather builders emit streams whose structural signature
        # is a pure function of the layout and the row count, so the
        # functional path can skip even the signature hash once a site's
        # template exists (sound only when the layout's transfer granules
        # are bus-width multiples — checked before use).  LRU-bounded so
        # a growing-context loop (a new gather shape per page count)
        # cannot pin an unbounded set of plans past the PlanCache's own
        # eviction.
        self._templates: "OrderedDict[Tuple[str, int], object]" = \
            OrderedDict()
        self._template_capacity = 32
        self._template_modulus: Optional[int] = None
        self.max_batch = max_batch
        self.max_len = max_len
        gather_bytes = max_batch * max_len * layout.row_bytes
        stage_bytes = max_batch * layout.row_bytes
        # VMEM: [0, G) gather-K, [G, 2G) gather-V, then staging K, V rows
        self._gk = 0
        self._gv = gather_bytes
        self._sk = 2 * gather_bytes
        self._sv = 2 * gather_bytes + stage_bytes
        mem = MemoryMap.create({
            Protocol.HBM: 2 * layout.pool_bytes,
            Protocol.VMEM: 2 * gather_bytes + 2 * stage_bytes,
        })
        if engine is None:
            if spec is None:
                spec = edge_ai(num_channels=num_channels)
            engine = build_engine(
                spec, mem=mem,
                plan_cache=self.plan_cache
                if self.plan_cache is not None else False)
        elif engine.mem is None:
            raise ValueError("PagedKVDMA needs an engine with a MemoryMap")
        else:
            # adopt the engine's existing spaces (never clobber them);
            # they must be big enough to host the pools/staging
            for proto, arr in mem.spaces.items():
                have = engine.mem.spaces.get(proto)
                if have is None:
                    engine.mem.spaces[proto] = arr
                elif have.size < arr.size:
                    raise ValueError(
                        f"engine {proto} space has {have.size} B, paged KV "
                        f"needs {arr.size} B")
        self.engine = engine
        self.mem = engine.mem
        # completion notification (the event-driven serve scheduler's
        # hook): on the timing path the engine's interrupt controller
        # delivers real `CompletionEvent`s from the `wait_all` drain; the
        # functional fast path posts synthetic ones per append/gather
        # (cycle 0, no tids) so the callback contract holds either way
        if on_complete is not None:
            engine.on_complete(on_complete)

    @classmethod
    def from_spec(cls, spec: EngineSpec, layout: KVLayout, max_batch: int,
                  max_len: int, timing: bool = True,
                  plan_cache: Union[bool, PlanCache] = True
                  ) -> "PagedKVDMA":
        """Build a paged KV cache whose engine is composed from `spec`
        (front-end × mid-end pipeline × back-end × channels — see
        `core.spec`), over the pool/staging memory map this cache sizes
        for itself.  The spec must keep the HBM/VMEM protocol ports the
        append/gather descriptor streams target."""
        return cls(layout, max_batch=max_batch, max_len=max_len,
                   timing=timing, plan_cache=plan_cache, spec=spec)

    # -- pool views ---------------------------------------------------------

    def _pool(self, which: str) -> np.ndarray:
        base = 0 if which == "k" else self.layout.pool_bytes
        return self.mem.spaces[Protocol.HBM][base:base
                                             + self.layout.pool_bytes]

    def load_pool(self, which: str, pool: np.ndarray) -> None:
        """Copy an existing (n_pages, page_size, Hkv, dh) pool in."""
        self._pool(which)[:] = np.ascontiguousarray(pool).view(np.uint8
                                                               ).reshape(-1)

    # -- the decode-step traffic -------------------------------------------

    def _move(self, desc: DescriptorBatch,
              site: Optional[str] = None) -> List[int]:
        """Route one descriptor stream: through the engine's channel
        queues when `timing`, else straight through the vectorized
        functional data plane (`execute_batch`).

        On the functional path a configured plan cache replaces the
        per-call `pipeline + legalize_batch` with a captured-plan rebind
        (the engine's spec mid-end pipeline joins both the capture and
        the signature, exactly as on the timing path).  `site` names the
        builder ("append"/"gather") whose output structure is a pure
        function of (layout, row count): the captured plan is also
        stored as that site's template, which lets `append`/`gather`
        bypass descriptor building *and* the signature hash on later
        steps (`_replay_move`)."""
        if self.timing:
            return self.engine.dispatch_batch(desc)
        eng = self.engine
        if self.plan_cache is not None and eng._plannable:
            plan, _ = self.plan_cache.plan_for(desc,
                                               bus_width=eng.bus_width,
                                               pipeline=eng.pipeline)
            if site is not None and self._template_modulus is not None \
                    and self.layout.row_bytes % self._template_modulus == 0:
                self._templates[(site, len(desc))] = plan
                if len(self._templates) > self._template_capacity:
                    self._templates.popitem(last=False)
            legal = plan.rebind(desc.src_addr, desc.dst_addr,
                                transfer_id=desc.transfer_id)
            hints = plan.hints
        else:
            if self.plan_cache is not None:
                # unplannable engine (unsigned stage): surfaced bypass,
                # mirroring IDMAEngine._lower_ports
                self.plan_cache.stats.bypasses += 1
                eng.stats.plan_bypasses += 1
            batch = desc
            for stage in eng.pipeline:
                batch = stage.apply(batch)
            if eng.midends:
                ones = batch.to_transfers()
                for me in eng.midends:
                    ones = me(ones)
                batch = DescriptorBatch.from_transfers(ones)
            legal = legalize_batch(batch, bus_width=eng.bus_width)
            hints = None
        moved = execute_batch(legal, eng.mem, bus_width=eng.bus_width,
                              check=False, hints=hints)
        eng.stats.submitted += len(desc)
        eng.stats.completed += len(desc)
        eng.stats.bursts += len(legal)
        eng.stats.bytes_moved += moved
        self._post_functional(len(desc), moved)
        return []

    def _template(self, site: str, n_rows: int):
        """The captured per-`KVLayout` plan template for a builder site,
        or None (first call, timing engine, or planning disabled).

        Skipping the plan-cache signature is only sound when every base
        the builders emit keeps the captured address residues, i.e. when
        `row_bytes` (the granule every base is a multiple of) is itself
        a multiple of `structure_modulus` for the protocols this cache
        drives — for HBM↔VMEM that is the bus width, but the check is
        computed from the protocol rules so a paged/pow2 protocol pair
        would correctly disable the shortcut rather than silently replay
        a stale cut structure."""
        if self.timing or self.plan_cache is None or \
                not self.engine._plannable:
            return None
        if self._template_modulus is None:
            codes = np.asarray([PROTO_CODE[Protocol.HBM],
                                PROTO_CODE[Protocol.VMEM]], dtype=np.uint8)
            m = structure_modulus(codes, codes, self.engine.bus_width)
            # spec mid-end stages widen the residue modulus exactly as in
            # core.plan: an address-sensitive stage (e.g. MpSplitStage)
            # must disable the signature-skipping shortcut unless the
            # builders' address granule still covers it
            for stage in self.engine.pipeline:
                m = math.lcm(m, max(int(stage.modulus()), 1))
            self._template_modulus = m
        if self.layout.row_bytes % self._template_modulus != 0:
            return None
        plan = self._templates.get((site, n_rows))
        if plan is not None:
            self._templates.move_to_end((site, n_rows))
        return plan

    def _replay_move(self, plan, src_base: np.ndarray,
                     dst_base: np.ndarray) -> List[int]:
        """Steady-state submission: replay the site template onto this
        step's page-table bases (`TransferPlan.replay_execute`).  No
        descriptor objects, no signature hash, no legalizer — bounds
        revalidation is the plan's vectorized pre-write check."""
        eng = self.engine
        self.plan_cache.stats.hits += 1        # transparent template hit
        moved = plan.replay_execute(src_base, dst_base, eng.mem)
        eng.stats.submitted += plan.n_desc
        eng.stats.completed += plan.n_desc
        eng.stats.bursts += plan.n_bursts
        eng.stats.bytes_moved += moved
        self._post_functional(plan.n_desc, moved)
        return []

    def _post_functional(self, count: int, moved: int) -> None:
        """Functional-path completion notification: one synthetic event
        per append/gather through the engine's interrupt controller (no
        transfer ids or cycles exist on this path), immediately flushed —
        the fast path has no drain boundary to coalesce towards."""
        if not self._notify:
            return
        self.engine.irq.post(CompletionEvent(
            tid=-1, count=count, channel=-1, cycle=0, status="done",
            bytes_moved=moved))
        self.engine.irq.flush()

    def append(self, page_table: np.ndarray, pos: int,
               k: np.ndarray, v: np.ndarray) -> List[int]:
        """Scatter one token's (B, Hkv, dh) K/V rows into the pools.

        Returns the transfer ids of the dispatched scatter descriptors."""
        lay = self.layout
        B = k.shape[0]
        if B > self.max_batch:
            raise ValueError(f"append batch {B} exceeds max_batch "
                             f"{self.max_batch}")
        vmem = self.mem.spaces[Protocol.VMEM]
        kb = np.ascontiguousarray(k).view(np.uint8).reshape(-1)
        vb = np.ascontiguousarray(v).view(np.uint8).reshape(-1)
        vmem[self._sk:self._sk + kb.size] = kb
        vmem[self._sv:self._sv + vb.size] = vb
        plan = self._template("append", 2 * B)
        if plan is not None:
            # steady state: compute this step's bases straight from the
            # page table (same math as append_descriptors, via
            # append_bases) and replay the captured template
            stage, slot = append_bases(lay, page_table, pos)
            return self._replay_move(
                plan,
                np.concatenate([self._sk + stage, self._sv + stage]),
                np.concatenate([slot, lay.pool_bytes + slot]))
        # K and V scatters ride one DescriptorBatch: a single doorbell
        # (and a single plan signature) per decode step, not two
        ids = self._move(concat_batches([
            append_descriptors(lay, page_table, pos, src_base=self._sk,
                               pool_base=0),
            append_descriptors(lay, page_table, pos, src_base=self._sv,
                               pool_base=lay.pool_bytes)]), site="append")
        if self.timing:
            self.engine.wait_all()
        return ids

    def gather(self, page_table: np.ndarray, max_len: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize contiguous (B, Hkv, L, dh) K/V copies by running
        the page-gather descriptor stream through the engine.

        As with `gather_kv`, only whole pages are gathered:
        ``L = (max_len // page_size) * page_size``."""
        lay = self.layout
        B = np.asarray(page_table).shape[0]
        L = (max_len // lay.page_size) * lay.page_size
        if B > self.max_batch or L > self.max_len:
            raise ValueError(
                f"gather ({B}, {L}) exceeds the ({self.max_batch}, "
                f"{self.max_len}) VMEM region this cache was sized for")
        n = L // lay.page_size
        plan = self._template("gather", 2 * B * n)
        if plan is not None:
            # same math as gather_descriptors, via gather_bases
            flat, walk = gather_bases(lay, page_table, max_len)
            self._replay_move(
                plan,
                np.concatenate([flat, lay.pool_bytes + flat]),
                np.concatenate([self._gk + walk, self._gv + walk]))
        else:
            # one doorbell per step: K and V page walks in one batch
            self._move(concat_batches([
                gather_descriptors(lay, page_table, max_len, pool_base=0,
                                   dst_base=self._gk),
                gather_descriptors(lay, page_table, max_len,
                                   pool_base=lay.pool_bytes,
                                   dst_base=self._gv)]), site="gather")
        if self.timing:
            self.engine.wait_all()

        vmem = self.mem.spaces[Protocol.VMEM]
        nbytes = B * L * lay.row_bytes
        dtype = {1: np.uint8, 2: np.float16, 4: np.float32,
                 8: np.float64}[lay.itemsize]

        def out(base: int) -> np.ndarray:
            flat = vmem[base:base + nbytes].view(dtype)
            arr = flat.reshape(B, L, lay.n_kv_heads, lay.head_dim)
            # copy: later gathers reuse the VMEM region, results must not
            # alias it
            return arr.transpose(0, 2, 1, 3).copy()

        return out(self._gk), out(self._gv)
