"""Mid-ends — transfer acceleration (paper §2.2, Table 2).

A mid-end consumes a (config, transfer) bundle, strips its configuration and
emits one or more rewritten transfers for the next stage.  Implemented here:

* ``tensor_nd``  — decompose an N-D affine transfer into 1-D transfers
                   (generalizes ``tensor_2D``); dense walks are coalesced
                   into fewer/larger 1-D transfers first;
* ``mp_split``   — split a 1-D transfer at a parametric address boundary so
                   no emitted transfer crosses it (MemPool L1 banks);
* ``mp_dist``    — distribute transfers over N downstream ports by address
                   offset or round-robin (binary tree of 2-port nodes in the
                   RTL; we expose the flattened N-port behaviour plus the
                   tree builder for fidelity);
* ``rt_schedule``— the ``rt_3D`` real-time mid-end: autonomously re-launch a
                   (3-D) transfer every `period` cycles.

All of these are pure functions over descriptors — they are used (a) by the
cycle simulator, (b) to generate Pallas/XLA copy plans, and (c) by the
distributed collective scheduler (`dist.collectives`), which treats shard
boundaries as the `mp_split` parameter and mesh axes as `mp_dist` ports.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .descriptor import (PROTO_CODE, DescriptorBatch, NdTransfer, RtConfig,
                         TensorDim, Transfer1D, total_bytes)


# --------------------------------------------------------------------------
# tensor_ND
# --------------------------------------------------------------------------

def coalesce_nd(nd: NdTransfer) -> NdTransfer:
    """Merge dimensions whose strides make the walk contiguous on *both*
    ports (src and dst) into the inner length — fewer, longer 1-D bursts.

    This is the optimization that lets tensor_ND reach full bus utilization
    on dense tensors: a dense (C,H,W) copy becomes ONE 1-D transfer.
    """
    inner = nd.inner_length
    dims = list(nd.dims)
    while dims:
        d = dims[0]
        if d.src_stride == inner and d.dst_stride == inner:
            inner *= d.reps
            dims.pop(0)
        else:
            break
    return NdTransfer(
        src_addr=nd.src_addr, dst_addr=nd.dst_addr, inner_length=inner,
        dims=tuple(dims), src_protocol=nd.src_protocol,
        dst_protocol=nd.dst_protocol, options=nd.options,
        transfer_id=nd.transfer_id)


def iter_tensor_nd(nd: NdTransfer, coalesce: bool = True
                   ) -> Iterator[Transfer1D]:
    """Lazily walk an N-D transfer in row-major order, innermost first."""
    if coalesce:
        nd = coalesce_nd(nd)
    if not nd.dims:
        if nd.inner_length:
            yield nd.as_1d()
        return
    reps = [d.reps for d in nd.dims]
    for idx in itertools.product(*(range(r) for r in reversed(reps))):
        # idx is outermost-first after the reversal below
        src_off = 0
        dst_off = 0
        for dim, i in zip(nd.dims, reversed(idx)):
            src_off += dim.src_stride * i
            dst_off += dim.dst_stride * i
        yield Transfer1D(
            src_addr=nd.src_addr + src_off,
            dst_addr=nd.dst_addr + dst_off,
            length=nd.inner_length,
            src_protocol=nd.src_protocol,
            dst_protocol=nd.dst_protocol,
            options=nd.options,
            transfer_id=nd.transfer_id,
        )


def tensor_nd(nd: NdTransfer, coalesce: bool = True) -> List[Transfer1D]:
    """Materialized `iter_tensor_nd` (paper's tensor_ND mid-end)."""
    return list(iter_tensor_nd(nd, coalesce=coalesce))


def tensor_nd_batch(nd: NdTransfer, coalesce: bool = True
                    ) -> DescriptorBatch:
    """Vectorized `tensor_nd`: the full N-D walk as one address computation.

    Row j of the result equals element j of `tensor_nd(nd)` (dims[0] varies
    fastest); each emitted 1-D transfer is its own owner, matching how the
    simulator treats a materialized descriptor list.
    """
    if coalesce:
        nd = coalesce_nd(nd)
    if not nd.dims:
        if not nd.inner_length:
            return DescriptorBatch.empty()
        return DescriptorBatch.from_transfers([nd.as_1d()])
    reps = [d.reps for d in nd.dims]
    total = 1
    for r in reps:
        total *= r
    idx = np.arange(total, dtype=np.int64)
    src_off = np.zeros(total, dtype=np.int64)
    dst_off = np.zeros(total, dtype=np.int64)
    period = 1
    for d, r in zip(nd.dims, reps):
        k = (idx // period) % r
        src_off += k * d.src_stride
        dst_off += k * d.dst_stride
        period *= r
    return DescriptorBatch.from_arrays(
        src_addr=nd.src_addr + src_off,
        dst_addr=nd.dst_addr + dst_off,
        length=np.full(total, nd.inner_length, dtype=np.int64),
        src_proto=PROTO_CODE[nd.src_protocol],
        dst_proto=PROTO_CODE[nd.dst_protocol],
        owner=idx,
        transfer_id=np.full(total, nd.transfer_id, dtype=np.int64),
        max_burst=np.full(total, nd.options.max_burst, dtype=np.int64),
        reduce_len=np.full(total, nd.options.reduce_len, dtype=np.int64),
        options=nd.options,       # broadcast — O(1) through every rewrite
    )


def tensor_2d(base_src: int, base_dst: int, inner_length: int,
              src_stride: int, dst_stride: int, reps: int,
              **kw) -> List[Transfer1D]:
    """The embedded-systems 2-D interface (paper tensor_2D)."""
    nd = NdTransfer(base_src, base_dst, inner_length,
                    (TensorDim(src_stride, dst_stride, reps),), **kw)
    return tensor_nd(nd)


# --------------------------------------------------------------------------
# mp_split — split at a parametric address boundary
# --------------------------------------------------------------------------

def mp_split(transfer: Transfer1D, boundary: int,
             which: str = "dst") -> List[Transfer1D]:
    """Split so that no emitted transfer crosses `boundary`-aligned addresses
    on the chosen port (`"src"`, `"dst"`, or `"both"`).

    MemPool splits on the *destination* (L1 bank region) when copying in and
    on the source when copying out; `dist.collectives` uses `"both"` with the
    shard byte-extent as the boundary.
    """
    if boundary <= 0 or (boundary & (boundary - 1)):
        raise ValueError(f"boundary must be a positive power of two, got {boundary}")
    out: List[Transfer1D] = []
    offset = 0
    remaining = transfer.length
    while remaining > 0:
        cuts = []
        if which in ("src", "both"):
            a = transfer.src_addr + offset
            cuts.append(boundary - (a % boundary))
        if which in ("dst", "both"):
            a = transfer.dst_addr + offset
            cuts.append(boundary - (a % boundary))
        step = min(cuts + [remaining])
        out.append(transfer.shifted(offset, offset, step))
        offset += step
        remaining -= step
    return out


def mp_split_batch(batch: DescriptorBatch, boundary: int,
                   which: str = "dst") -> DescriptorBatch:
    """Vectorized `mp_split` over every row of a batch: no emitted row
    crosses a `boundary`-aligned address on the chosen port(s).  Output is
    grouped by input row in input order (zero-length rows drop, as in the
    scalar walk)."""
    if boundary <= 0 or (boundary & (boundary - 1)):
        raise ValueError(
            f"boundary must be a positive power of two, got {boundary}")
    if which not in ("src", "dst", "both"):
        raise ValueError(f"unknown mp_split port {which!r}")
    from .legalizer import _boundary_segments
    nz = np.nonzero(batch.length > 0)[0]
    if nz.shape[0] == 0:
        return batch.rewrite(np.empty(0, dtype=np.int64),
                             np.empty(0, dtype=np.int64),
                             np.empty(0, dtype=np.int64))
    p_src = boundary if which in ("src", "both") else 0
    p_dst = boundary if which in ("dst", "both") else 0
    row, start, seg = _boundary_segments(
        batch.src_addr[nz], batch.dst_addr[nz], batch.length[nz],
        p_src, p_dst)
    return batch.rewrite(nz[row], start, seg)


def page_split_batch(batch: DescriptorBatch,
                     page_sizes: dict) -> DescriptorBatch:
    """Vectorized page-boundary split for the virtual-memory mid-end: no
    emitted row crosses a page boundary on *either* port, with the page
    size looked up per address space (`page_sizes` maps `Protocol` →
    power-of-two page bytes).  Generator sources have no address space and
    never constrain the split.  Output is grouped by input row in input
    order (zero-length rows drop), exactly like `mp_split_batch`.
    """
    from .descriptor import CODE_PROTO, GENERATOR_PROTOCOLS
    from .legalizer import _boundary_segments
    for proto, size in page_sizes.items():
        if size <= 0 or (size & (size - 1)):
            raise ValueError(f"page size for {proto} must be a positive "
                             f"power of two, got {size}")
    nz = np.nonzero(batch.length > 0)[0]
    empty = np.empty(0, dtype=np.int64)
    if nz.shape[0] == 0:
        return batch.rewrite(empty, empty, empty)
    gen_codes = {PROTO_CODE[p] for p in GENERATOR_PROTOCOLS}
    sp = batch.src_proto[nz]
    dp = batch.dst_proto[nz]

    def period_of(code: int) -> int:
        if code in gen_codes:
            return 0
        return page_sizes.get(CODE_PROTO[code], 0)

    pair = (sp.astype(np.int64) << 8) | dp
    rows_parts: List[np.ndarray] = []
    starts_parts: List[np.ndarray] = []
    segs_parts: List[np.ndarray] = []
    for code in np.unique(pair).tolist():
        sub = np.flatnonzero(pair == code)
        p_src = period_of(code >> 8)
        p_dst = period_of(code & 0xFF)
        row, start, seg = _boundary_segments(
            batch.src_addr[nz[sub]], batch.dst_addr[nz[sub]],
            batch.length[nz[sub]], p_src, p_dst)
        rows_parts.append(sub[row])
        starts_parts.append(start)
        segs_parts.append(seg)
    rows = np.concatenate(rows_parts)
    starts = np.concatenate(starts_parts)
    segs = np.concatenate(segs_parts)
    order = np.lexsort((starts, rows))     # restore input-row order
    return batch.rewrite(nz[rows[order]], starts[order], segs[order])


# --------------------------------------------------------------------------
# mp_dist — distribute over downstream ports
# --------------------------------------------------------------------------

def mp_dist(transfers: Sequence[Transfer1D], num_ports: int,
            scheme: str = "address", boundary: int = 0,
            which: str = "dst") -> List[List[Transfer1D]]:
    """Distribute transfers over `num_ports` downstream mid-/back-ends.

    `scheme="address"` (paper default): port = (addr // boundary) % num_ports,
    i.e. transfers are routed by their address offset, so each back-end only
    sees its exclusive memory region.  `scheme="round_robin"`: cyclic.
    """
    ports: List[List[Transfer1D]] = [[] for _ in range(num_ports)]
    if scheme == "round_robin":
        for i, t in enumerate(transfers):
            ports[i % num_ports].append(t)
        return ports
    if scheme != "address":
        raise ValueError(f"unknown mp_dist scheme {scheme!r}")
    if boundary <= 0:
        raise ValueError("address scheme needs the split boundary")
    for t in transfers:
        addr = t.dst_addr if which == "dst" else t.src_addr
        ports[(addr // boundary) % num_ports].append(t)
    return ports


def mp_dist_batch(batch: DescriptorBatch, num_ports: int,
                  scheme: str = "address", boundary: int = 0,
                  which: str = "dst") -> List[DescriptorBatch]:
    """Vectorized `mp_dist`: route rows to ports by address window or
    round-robin; row order inside each port matches the scalar version."""
    if scheme == "round_robin":
        pos = np.arange(len(batch), dtype=np.int64)
        return [batch.select(pos % num_ports == p) for p in range(num_ports)]
    if scheme != "address":
        raise ValueError(f"unknown mp_dist scheme {scheme!r}")
    if boundary <= 0:
        raise ValueError("address scheme needs the split boundary")
    addr = batch.dst_addr if which == "dst" else batch.src_addr
    port = (addr // boundary) % num_ports
    return [batch.select(port == p) for p in range(num_ports)]


def mp_dist_tree(transfers: Sequence[Transfer1D], num_ports: int,
                 boundary: int, which: str = "dst"
                 ) -> List[List[Transfer1D]]:
    """RTL-faithful binary tree of 2-port mp_dist nodes (paper Fig. 9).

    Equivalent output to `mp_dist(..., scheme="address")` when `num_ports`
    is a power of two — asserted in tests.
    """
    if num_ports & (num_ports - 1):
        raise ValueError("tree distribution needs a power-of-two port count")

    def route(batch: Sequence[Transfer1D], ports: int, bit: int
              ) -> List[List[Transfer1D]]:
        if ports == 1:
            return [list(batch)]
        lo, hi = [], []
        for t in batch:
            addr = t.dst_addr if which == "dst" else t.src_addr
            if (addr // boundary) & bit:
                hi.append(t)
            else:
                lo.append(t)
        half = ports // 2
        return route(lo, half, bit * 2) + route(hi, half, bit * 2)

    # bit 1 distinguishes port parity at the leaves; the tree above inspects
    # progressively higher bits.  Reorder to match linear port indexing.
    leaves = route(transfers, num_ports, 1)
    # route() produces ports in bit-reversed order; fix up:
    idx = sorted(range(num_ports), key=lambda p: int(
        format(p, f"0{num_ports.bit_length() - 1}b")[::-1], 2))
    return [leaves[i] for i in idx]


def split_and_distribute(transfer: Transfer1D, num_ports: int,
                         boundary: int, which: str = "dst"
                         ) -> List[List[Transfer1D]]:
    """The MemPool composition: mp_split then mp_dist (paper Fig. 9)."""
    return mp_dist(mp_split(transfer, boundary, which=which), num_ports,
                   scheme="address", boundary=boundary, which=which)


# --------------------------------------------------------------------------
# rt_3D — autonomous repeated transfers
# --------------------------------------------------------------------------

def rt_schedule(cfg: RtConfig, nd: NdTransfer, horizon: int
                ) -> List[Tuple[int, NdTransfer]]:
    """Launch times (cycle, transfer) of the real-time mid-end within
    `horizon` cycles.  The engine re-launches the same 3-D transfer every
    `cfg.period` cycles, `cfg.num_launches` times (0 = unbounded)."""
    # RtConfig validates at construction, but duck-typed configs reach this
    # loop too — a non-positive period with num_launches == 0 never
    # terminates, so reject it here as well.
    if cfg.period <= 0:
        raise ValueError(f"rt period must be positive, got {cfg.period}")
    out: List[Tuple[int, NdTransfer]] = []
    t = 0
    n = 0
    while t < horizon and (cfg.num_launches == 0 or n < cfg.num_launches):
        out.append((t, nd))
        t += cfg.period
        n += 1
    return out


# --------------------------------------------------------------------------
# Invariant helpers used by property tests
# --------------------------------------------------------------------------

def preserves_bytes(before: NdTransfer, after: Sequence[Transfer1D]) -> bool:
    return before.total_length == total_bytes(after)


def no_boundary_crossing(transfers: Sequence[Transfer1D], boundary: int,
                         which: str = "dst") -> bool:
    for t in transfers:
        addr = t.dst_addr if which == "dst" else t.src_addr
        if t.length and addr // boundary != (addr + t.length - 1) // boundary:
            return False
    return True
