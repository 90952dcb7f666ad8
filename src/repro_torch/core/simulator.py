"""Event-driven model of the iDMA back-end transport layer (paper §2.3/§4.4).

The paper evaluates iDMA's standalone performance by copying a 64 KiB
region, fragmented into transfers of 1 B .. 1 KiB, against three memory
models (SRAM: 3 cyc / 8 outstanding; RPC-DRAM: ~13 cyc / 16; HBM: ~100 cyc /
64) — Fig. 14 — and against Xilinx AXI DMA v7.1 on Cheshire — Fig. 8.

This module reproduces that evaluation with a burst-level event simulation
of the decoupled transport layer:

  read manager ──► dataflow element (buffer, NAx slots) ──► write manager
       │                                                        │
   src endpoint (latency L_r, outstanding O_r, 1 beat/cycle) dst endpoint

Recurrences per legalized burst i (b_i beats):
  req_i         = max(req_{i-1}+1, rdata_end_{i-O_r}, wend_{i-NAx}, launch_i)
  rdata_start_i = max(req_i + L_r, rdata_end_{i-1}, buffer backpressure)
  rdata_end_i   = rdata_start_i + b_i
  wdata_start_i = max(rdata_start_i + d_pass, wdata_end_{i-1}, wcomp_{i-O_w})
                  (d_pass = 1: stream-through shifters — decoupled mode;
                   coupled mode waits for rdata_end_i: full burst buffered)
  wdata_end_i   = wdata_start_i + b_i ;  wcomp_i = wdata_end_i + L_w

The launch latency honours §4.3: first read request exactly
`legal_latency(...)` cycles after descriptor acceptance.

The model is O(#bursts), so the full Fig. 14 sweep runs in milliseconds.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .descriptor import PROTO_CODE, DescriptorBatch, Protocol, Transfer1D
from .legalizer import legal_latency, legalize, legalize_batch


@dataclass(frozen=True)
class MemSystem:
    """A memory endpoint model (paper §4.4).

    `contention_period` — model a shared port: one stall cycle is injected
    every `contention_period` data beats (0 = exclusive port).  Used for the
    PULP-open L2, whose port the cluster cores share with the iDMAE
    (paper §3.1: 'contention with other ongoing memory accesses').
    """

    name: str
    latency: int                 # cycles request → first data beat
    outstanding: int             # max requests in flight at the endpoint
    write_latency: Optional[int] = None   # default: same as read
    contention_period: int = 0

    @property
    def wlat(self) -> int:
        return self.latency if self.write_latency is None else self.write_latency

    def stretched(self, beats: int, cum_before: int = 0) -> int:
        """Data-phase cycles for `beats` beats including contention stalls.

        `cum_before` — beats already moved on this port, so stalls accrue
        correctly across many small bursts (cumulative accounting)."""
        if self.contention_period <= 0:
            return beats
        p = self.contention_period
        return beats + (cum_before + beats) // p - cum_before // p


# The paper's three reference systems (§4.4).
SRAM = MemSystem("SRAM", latency=3, outstanding=8)
RPC_DRAM = MemSystem("RPC-DRAM", latency=13, outstanding=16)
HBM = MemSystem("HBM", latency=100, outstanding=64)

# PULP-open L2 via 64-b AXI (§3.1 calibration, see EXPERIMENTS.md):
# read latency 8, posted-write ack 7, one stall per 16 beats from core
# contention on the shared L2 port.
PULP_L2 = MemSystem("PULP-L2", latency=8, outstanding=8, write_latency=7,
                    contention_period=16)
PULP_TCDM = MemSystem("PULP-TCDM", latency=1, outstanding=8)


@dataclass(frozen=True)
class EngineConfig:
    """Back-end configuration knobs (paper §3.6 wrapper parameters)."""

    bus_width: int = 4            # DW in bytes (base config: 32-b data)
    n_outstanding: int = 2        # NAx
    buffer_beats: int = 16        # dataflow-element FIFO depth
    decoupled: bool = True        # read/write decoupling (iDMA) vs coupled
    num_midends: int = 0
    has_legalizer: bool = True
    tensor_nd_zero_latency: bool = False
    # Per-transfer-descriptor overhead cycles paid before the launch —
    # non-zero for baseline engines that reconfigure between descriptors
    # (Xilinx AXI DMA style) and for register-file front-end programming.
    config_cycles: int = 0
    # Coupled engines serialize descriptors (no inter-transfer overlap).
    exclusive_transfers: bool = False

    @property
    def launch_latency(self) -> int:
        return legal_latency(self.num_midends, self.has_legalizer,
                             self.tensor_nd_zero_latency)


@dataclass
class SimResult:
    cycles: int                   # total cycles, accept → last write beat
    useful_bytes: int
    bus_beats: int                # busiest-port data-beat count
    first_read_req: int           # cycle of the first read request
    n_bursts: int

    @property
    def utilization(self) -> float:
        """Fraction of cycles the (write) data bus moved useful bytes."""
        if self.cycles == 0:
            return 1.0
        return self.useful_bytes / (self.cycles * self._width)

    _width: int = 4

    def with_width(self, width: int) -> "SimResult":
        self._width = width
        return self


def _beats(t: Transfer1D, width: int) -> int:
    """Data beats of a burst including head/tail misalignment padding."""
    if t.length == 0:
        return 0
    head = t.src_addr % width
    return (head + t.length + width - 1) // width


def beats_array(src_addr: np.ndarray, length: np.ndarray, width: int
                ) -> np.ndarray:
    """Vectorized `_beats` — the single definition of the beat-count rule
    for the batch paths (shared with `analytics.burst_profile`)."""
    head = src_addr % width
    return np.where(length == 0, 0, (head + length + width - 1) // width)


def simulate(transfers: Sequence[Transfer1D], cfg: EngineConfig,
             src: MemSystem, dst: MemSystem,
             already_legal: bool = False) -> SimResult:
    """Run the transport-layer model over a descriptor list.

    Thin adapter over the structure-of-arrays hot path (`simulate_batch`);
    `simulate_reference` keeps the original per-object walk as the oracle
    the batch path is property-tested against.
    """
    return simulate_batch(DescriptorBatch.from_transfers(transfers), cfg,
                          src, dst, already_legal=already_legal)


def simulate_reference(transfers: Sequence[Transfer1D], cfg: EngineConfig,
                       src: MemSystem, dst: MemSystem,
                       already_legal: bool = False) -> SimResult:
    """Scalar reference implementation (one `Transfer1D` object per burst).

    Kept verbatim as the equivalence oracle for `simulate_batch` and as the
    object-path baseline timed by `benchmarks/descriptor_plane_bench.py`.
    """
    bursts: List[Transfer1D] = []
    launch_of: List[int] = []     # index of owning descriptor per burst
    for di, t in enumerate(transfers):
        legal = [t] if already_legal else legalize(t, bus_width=cfg.bus_width)
        bursts.extend(legal)
        launch_of.extend([di] * len(legal))

    n = len(bursts)
    if n == 0:
        return SimResult(0, 0, 0, cfg.launch_latency, 0).with_width(cfg.bus_width)

    width = cfg.bus_width
    nax = max(1, cfg.n_outstanding)
    o_r = max(1, src.outstanding)
    o_w = max(1, dst.outstanding)
    is_gen = bursts[0].src_protocol in (Protocol.INIT,)

    req = [0] * n
    rstart = [0] * n
    rend = [0] * n
    wstart = [0] * n
    wend = [0] * n
    wcomp = [0] * n

    # Descriptor acceptance times: front-end hands descriptors over one per
    # cycle once the previous is accepted; config_cycles model programming
    # overhead per descriptor; exclusive engines wait for full completion.
    accept = 0
    desc_launch: Dict[int, int] = {}

    buf = max(1, cfg.buffer_beats)
    cum_r = 0
    cum_w = 0
    for i, b in enumerate(bursts):
        beats = _beats(b, width)
        di = launch_of[i]
        if di not in desc_launch:
            if cfg.exclusive_transfers and i > 0:
                accept = max(accept, wcomp[i - 1])
            desc_launch[di] = accept + cfg.config_cycles + cfg.launch_latency
            accept = accept + cfg.config_cycles + 1

        t0 = desc_launch[di]
        r = max(t0, req[i - 1] + 1 if i else t0)
        if i >= o_r:
            r = max(r, rend[i - o_r])           # endpoint request credit
        if i >= nax:
            r = max(r, wend[i - nax])           # engine tracking slot
        req[i] = r

        rs = max(r + (0 if is_gen else src.latency), rend[i - 1] if i else 0)
        # dataflow-element backpressure: read may run at most `buf` beats
        # ahead of write.  Approximate at burst granularity.
        lag = max(1, buf // max(beats, 1))
        if i >= lag:
            rs = max(rs, wstart[i - lag])
        rstart[i] = rs
        rend[i] = rs + src.stretched(beats, cum_r)
        cum_r += beats

        if cfg.decoupled:
            ws = rstart[i] + 1                  # stream through the shifters
        else:
            ws = rend[i]                        # fully buffer the burst
        ws = max(ws, wend[i - 1] if i else 0)
        if i >= o_w:
            ws = max(ws, wcomp[i - o_w])
        wstart[i] = ws
        wend[i] = ws + dst.stretched(beats, cum_w)
        cum_w += beats
        wcomp[i] = wend[i] + dst.wlat

    useful = sum(t.length for t in transfers)
    total_beats = sum(_beats(b, width) for b in bursts)
    return SimResult(
        cycles=wend[-1],
        useful_bytes=useful,
        bus_beats=total_beats,
        first_read_req=req[0],
        n_bursts=n,
    ).with_width(width)


_INIT_CODE = PROTO_CODE[Protocol.INIT]


def simulate_batch(batch: DescriptorBatch, cfg: EngineConfig,
                   src: MemSystem, dst: MemSystem,
                   already_legal: bool = False,
                   beats: Optional[np.ndarray] = None) -> SimResult:
    """Structure-of-arrays transport-layer model — the hot path.

    Cycle-identical to `simulate_reference` over the equivalent object list
    (asserted by property tests).  Everything data-parallel — beat counts,
    contention-stretched burst durations (prefix sums), buffer-lag windows,
    descriptor launch times — is computed as whole-array NumPy expressions
    up front; only the irreducible burst recurrence (each term depends on
    earlier bursts through the o_r / NAx / o_w credit windows) runs as one
    tight scalar loop over those precomputed buffers.  No descriptor
    objects, no dict lookups, no per-burst legalizer calls.

    `already_legal=True` mirrors the reference semantics exactly: every row
    is taken as one pre-legalized burst that is its own descriptor.

    `beats` — optional precomputed `beats_array` for the (already legal)
    burst stream at `cfg.bus_width` — the captured-plan replay entry point:
    a `TransferPlan` freezes its beat counts at capture, so steady-state
    replays skip even this array pass.
    """
    useful = batch.total_bytes
    if already_legal:
        bursts = batch
        per_row_desc = True
    else:
        if batch.options is not None:
            # the numeric columns fully determine legalization; drop the
            # per-row options objects so the burst rewrite stays pure-array
            batch = dataclasses.replace(batch, options=None)
        bursts = legalize_batch(batch, bus_width=cfg.bus_width)
        per_row_desc = False
        beats = None                      # precomputed beats are per burst

    n = len(bursts)
    if n == 0:
        return SimResult(0, 0, 0, cfg.launch_latency,
                         0).with_width(cfg.bus_width)

    width = cfg.bus_width
    nax = max(1, cfg.n_outstanding)
    o_r = max(1, src.outstanding)
    o_w = max(1, dst.outstanding)
    is_gen = int(bursts.src_proto[0]) == _INIT_CODE
    rlat = 0 if is_gen else src.latency
    wlat = dst.wlat
    config = cfg.config_cycles
    latency = cfg.launch_latency
    decoupled = cfg.decoupled
    exclusive = cfg.exclusive_transfers

    if beats is None:
        beats = beats_array(bursts.src_addr, bursts.length, width)
    total_beats = int(beats.sum())

    def stretched(mem: MemSystem) -> np.ndarray:
        # data-phase durations incl. contention stalls, via prefix sums
        # (the shifted-view form of MemSystem.stretched's cumulative rule)
        p = mem.contention_period
        if p <= 0:
            return beats
        cum = np.cumsum(beats)
        before = cum - beats
        return beats + cum // p - before // p

    buf = max(1, cfg.buffer_beats)
    beats_l = beats.tolist()
    rdur = stretched(src)
    wdur = stretched(dst)
    rdur = beats_l if rdur is beats else rdur.tolist()
    wdur = beats_l if wdur is beats else wdur.tolist()
    lag = np.maximum(1, buf // np.maximum(beats, 1)).tolist()

    # Descriptor-accept chain: one new acceptance per owning descriptor.
    if per_row_desc:
        new_desc_arr = np.ones(n, dtype=bool)
    else:
        own = bursts.owner
        new_desc_arr = np.empty(n, dtype=bool)
        new_desc_arr[0] = True
        new_desc_arr[1:] = own[1:] != own[:-1]
    if exclusive:
        # launch times depend on completion of the previous descriptor —
        # resolved inside the recurrence loop below
        launch = None
        new_desc = new_desc_arr.tolist()
    else:
        # non-exclusive engines accept one descriptor per cycle: launch
        # times are a pure function of the descriptor rank (shifted view).
        # The .tolist() is deliberate: indexing the ndarray directly in
        # the recurrence loop leaks np.int64 scalars into every subsequent
        # max/add and measures ~30% slower end-to-end (EXPERIMENTS.md §2).
        rank = np.cumsum(new_desc_arr) - 1
        launch = (rank * (config + 1) + config + latency).tolist()
        new_desc = None

    # History buffers, front-padded with zeros so every credit /
    # backpressure lookback (o_r, NAx, o_w, buffer lag <= buf) lands on a
    # valid "no constraint" slot — the loop body carries no window guards.
    pad = max(o_r, nax, o_w, buf)
    size = pad + n
    rend = [0] * size
    wstart = [0] * size
    wend = [0] * size
    wcomp = [0] * size

    req_prev = -1
    rend_prev = 0
    wend_prev = 0
    accept = 0
    cur_launch = 0
    # Every path issues the first read request `config + latency` cycles in
    # (rank-0 launch; no credit term can bind at burst 0).
    first_req = config + latency
    j = pad                       # write cursor = i + pad
    for i in range(n):
        if launch is not None:
            r = launch[i]
        else:
            if new_desc[i]:
                v = wcomp[j - 1]
                if v > accept:
                    accept = v
                cur_launch = accept + config + latency
                accept += config + 1
            r = cur_launch
        v = req_prev + 1
        if v > r:
            r = v
        v = rend[j - o_r]             # endpoint request credit
        if v > r:
            r = v
        v = wend[j - nax]             # engine tracking slot
        if v > r:
            r = v
        req_prev = r

        rs = r + rlat
        if rend_prev > rs:
            rs = rend_prev
        v = wstart[j - lag[i]]        # dataflow-element backpressure
        if v > rs:
            rs = v
        re = rs + rdur[i]
        rend[j] = re
        rend_prev = re

        ws = rs + 1 if decoupled else re
        if wend_prev > ws:
            ws = wend_prev
        v = wcomp[j - o_w]
        if v > ws:
            ws = v
        wstart[j] = ws
        we = ws + wdur[i]
        wend[j] = we
        wend_prev = we
        wcomp[j] = we + wlat
        j += 1

    return SimResult(
        cycles=wend_prev,
        useful_bytes=useful,
        bus_beats=total_beats,
        first_read_req=first_req,
        n_bursts=n,
    ).with_width(width)


# --------------------------------------------------------------------------
# Multi-channel concurrent engine model (paper §4, Fig. 14 concurrency)
# --------------------------------------------------------------------------

@dataclass
class ChannelSimResult:
    """Result of a concurrent multi-channel run.

    `per_channel[c]` carries channel c's stream in *global* time (its
    `cycles` is the cycle its last write beat lands, measured from the
    common start).  `aggregate` merges them: makespan cycles, summed
    bytes/beats/bursts, earliest first read request.

    `burst_wend[c]` is channel c's per-burst write-end cycle in stream
    order — the completion event times the interrupt front-end delivers
    callbacks in (`IrqController`).  `backoff_cycles` is the error
    handler's retry/stall penalty accumulated by the drain that produced
    this result (`ErrorPolicy.replay_backoff` per replay, plus injected
    channel stalls); it is kept outside the transport recurrences and
    folded in by `total_cycles`.
    """

    per_channel: List[SimResult]
    aggregate: SimResult
    backoff_cycles: int = 0
    burst_wend: Optional[List[List[int]]] = None

    @property
    def total_cycles(self) -> int:
        """Makespan including the error handler's backoff/stall penalty."""
        return self.aggregate.cycles + self.backoff_cycles

    @property
    def aggregate_bandwidth(self) -> float:
        """Useful bytes per cycle across all channels (the Fig. 14
        concurrency metric — saturates as shared endpoints contend)."""
        if self.aggregate.cycles == 0:
            return 0.0
        return self.aggregate.useful_bytes / self.aggregate.cycles


class _EndpointPort:
    """Shared per-endpoint, per-role (read or write) state.

    Channels naming the *same* `MemSystem` object share this: the
    `outstanding` credit window, the single-burst-at-a-time data port, the
    request-channel serialization, and the cumulative contention counter
    all span every channel targeting the endpoint.
    """

    __slots__ = ("mem", "last_req", "data_busy", "cum", "inflight",
                 "outstanding")

    def __init__(self, mem: MemSystem) -> None:
        self.mem = mem
        self.last_req = -1          # request channel: one grant per cycle
        self.data_busy = 0          # data port serves one burst at a time
        self.cum = 0                # beats served (contention accounting)
        self.outstanding = max(1, mem.outstanding)
        # completion times of the `outstanding` most recent grants; a new
        # grant must wait for the oldest when the window is full
        self.inflight = deque(maxlen=self.outstanding)

    def stretch(self, beats: int) -> int:
        p = self.mem.contention_period
        if p <= 0:
            return beats
        return beats + (self.cum + beats) // p - self.cum // p


class _ChannelState:
    """One channel's burst stream plus its private recurrence state."""

    __slots__ = ("idx", "n", "beats", "lag", "launch", "new_desc", "rlat",
                 "wlat", "nax", "decoupled", "config", "latency",
                 "exclusive", "i", "req_prev", "first_req", "accept",
                 "cur_launch", "wcomp_prev", "wend_hist", "wstart_hist",
                 "last_wend", "useful", "total_beats", "rd", "wr", "width")

    def __init__(self, idx: int, bursts: DescriptorBatch, useful: int,
                 cfg: EngineConfig, rd: _EndpointPort, wr: _EndpointPort,
                 beats: Optional[np.ndarray] = None) -> None:
        self.idx = idx
        self.n = len(bursts)
        self.rd = rd
        self.wr = wr
        self.width = cfg.bus_width
        self.useful = useful
        if beats is None:
            beats = beats_array(bursts.src_addr, bursts.length,
                                cfg.bus_width)
        self.total_beats = int(beats.sum())
        self.beats = beats.tolist()
        buf = max(1, cfg.buffer_beats)
        self.lag = np.maximum(1, buf // np.maximum(beats, 1)).tolist()
        self.nax = max(1, cfg.n_outstanding)
        self.decoupled = cfg.decoupled
        self.config = cfg.config_cycles
        self.latency = cfg.launch_latency
        self.exclusive = cfg.exclusive_transfers
        # per-burst read latency: generator (Init) bursts pay none — unlike
        # `simulate_batch`'s whole-batch flag this stays correct when a
        # channel stream mixes Init and memory sources (async drains
        # concatenate submissions); identical on uniform streams
        self.rlat = np.where(bursts.src_proto == _INIT_CODE, 0,
                             rd.mem.latency).tolist()
        self.wlat = wr.mem.wlat

        own = bursts.owner
        nd = np.empty(self.n, dtype=bool)
        if self.n:
            nd[0] = True
            nd[1:] = own[1:] != own[:-1]
        if self.exclusive:
            self.launch = None
            self.new_desc = nd.tolist()
        else:
            rank = np.cumsum(nd) - 1
            self.launch = (rank * (self.config + 1) + self.config
                           + self.latency).tolist()
            self.new_desc = None

        self.i = 0
        self.req_prev = -1
        self.first_req = self.config + self.latency
        self.accept = 0
        self.cur_launch = 0
        self.wcomp_prev = 0
        self.wend_hist: List[int] = []
        self.wstart_hist: List[int] = []
        self.last_wend = 0

    def lower_bound(self) -> int:
        """Earliest possible next request time from channel-private state
        only — the heap key (shared-endpoint constraints are resolved at
        grant time)."""
        i = self.i
        if self.launch is not None:
            lb = self.launch[i]
        elif self.new_desc[i]:
            lb = (max(self.accept, self.wcomp_prev) + self.config
                  + self.latency)
        else:
            lb = self.cur_launch
        if self.req_prev + 1 > lb:
            lb = self.req_prev + 1
        if i >= self.nax and self.wend_hist[i - self.nax] > lb:
            lb = self.wend_hist[i - self.nax]
        return lb

    def grant(self) -> None:
        """Issue burst `self.i`: resolve launch, shared endpoint credits,
        data-port serialization and buffer backpressure, then commit the
        burst's read/write phases to the shared endpoint state.

        The recurrences are exactly `simulate_batch`'s — with one channel
        per endpoint the shared terms collapse onto the private ones, so a
        1-channel run is cycle-identical to `simulate_batch` (property-
        tested)."""
        i = self.i
        rd, wr = self.rd, self.wr
        if self.launch is not None:
            r = self.launch[i]
        else:
            if self.new_desc[i]:
                if self.wcomp_prev > self.accept:
                    self.accept = self.wcomp_prev
                self.cur_launch = self.accept + self.config + self.latency
                self.accept += self.config + 1
            r = self.cur_launch
        if self.req_prev + 1 > r:
            r = self.req_prev + 1
        if rd.last_req + 1 > r:
            r = rd.last_req + 1
        if len(rd.inflight) == rd.outstanding and rd.inflight[0] > r:
            r = rd.inflight[0]          # shared endpoint request credit
        if i >= self.nax and self.wend_hist[i - self.nax] > r:
            r = self.wend_hist[i - self.nax]    # engine tracking slot
        self.req_prev = r
        rd.last_req = r
        if i == 0:
            self.first_req = r

        beats = self.beats[i]
        rs = r + self.rlat[i]
        if rd.data_busy > rs:
            rs = rd.data_busy           # shared read data port
        k = i - self.lag[i]
        if k >= 0 and self.wstart_hist[k] > rs:
            rs = self.wstart_hist[k]    # dataflow-element backpressure
        re = rs + rd.stretch(beats)
        rd.cum += beats
        rd.data_busy = re
        rd.inflight.append(re)

        ws = rs + 1 if self.decoupled else re
        if wr.data_busy > ws:
            ws = wr.data_busy           # shared write data port
        if len(wr.inflight) == wr.outstanding and wr.inflight[0] > ws:
            ws = wr.inflight[0]         # shared write completion credit
        we = ws + wr.stretch(beats)
        wr.cum += beats
        wr.data_busy = we
        wc = we + self.wlat
        wr.inflight.append(wc)

        self.wstart_hist.append(ws)
        self.wend_hist.append(we)
        self.wcomp_prev = wc
        self.last_wend = we
        self.i += 1

    def result(self) -> SimResult:
        return SimResult(
            cycles=self.last_wend,
            useful_bytes=self.useful,
            bus_beats=self.total_beats,
            first_read_req=self.first_req,
            n_bursts=self.n,
        ).with_width(self.width)


def simulate_channels(
    batches: Sequence[DescriptorBatch],
    cfg: Union[EngineConfig, Sequence[EngineConfig]],
    mems: Union[Tuple[MemSystem, MemSystem],
                Sequence[Tuple[MemSystem, MemSystem]]],
    already_legal: bool = False,
    beats: Optional[Sequence[Optional[np.ndarray]]] = None,
    tie_seed: Optional[int] = None,
) -> ChannelSimResult:
    """Concurrent multi-channel transport model (event-driven).

    `batches[c]` is channel c's descriptor stream; `cfg` is one
    `EngineConfig` for all channels or one per channel; `mems` is a single
    ``(src, dst)`` endpoint pair shared by every channel, or one pair per
    channel.  Endpoint state is keyed by **object identity**: channels that
    name the same `MemSystem` instance contend for its `outstanding` credit
    window, its one-burst-at-a-time data port, its request channel, and
    its cumulative `contention_period` stall accounting — the paper's
    'multiple iDMA instantiations sharing high-latency endpoints' setup.

    The scheduler is a heap of per-channel next-request lower bounds:
    the channel that could issue earliest is granted next, with shared
    constraints resolved at grant time (deterministic; ties break on
    channel index).  With a single channel the shared terms collapse onto
    the private ones and the run is cycle-identical to `simulate_batch`.

    `beats` — optional per-channel precomputed `beats_array` columns (the
    captured-plan replay entry point, as on `simulate_batch`); entries may
    be ``None`` per channel and the whole argument only applies with
    `already_legal=True`.

    `tie_seed` — adversarial tie-breaking for the sanitizer's differential
    mode: heap ties (equal lower bounds) break on a seeded permutation of
    the channel indices instead of channel order.  This perturbs *grant
    order only* — per-channel burst FIFOs and the functional fabric are
    untouched, so bytes never depend on it; cycle counts may shift under
    endpoint contention.  ``None`` keeps the default (behavior-identical:
    ties break on channel index).
    """
    n_ch = len(batches)
    cfgs = ([cfg] * n_ch if isinstance(cfg, EngineConfig) else list(cfg))
    if len(cfgs) != n_ch:
        raise ValueError(f"{len(cfgs)} configs for {n_ch} channels")
    if (len(mems) == 2 and isinstance(mems[0], MemSystem)
            and isinstance(mems[1], MemSystem)):
        pairs = [(mems[0], mems[1])] * n_ch
    else:
        pairs = [tuple(p) for p in mems]
    if len(pairs) != n_ch:
        raise ValueError(f"{len(pairs)} endpoint pairs for {n_ch} channels")

    # Shared endpoint ports, keyed by MemSystem identity and role.  Read
    # and write streams are tracked separately (independent AXI R/W
    # channels — also what makes src==dst single-channel runs match
    # `simulate_batch`, which keeps separate read/write accounting).
    rd_ports: Dict[int, _EndpointPort] = {}
    wr_ports: Dict[int, _EndpointPort] = {}

    channels: List[_ChannelState] = []
    for c in range(n_ch):
        batch = batches[c]
        useful = batch.total_bytes
        ch_beats = beats[c] if (beats is not None and already_legal) else None
        if not already_legal:
            if batch.options is not None:
                batch = dataclasses.replace(batch, options=None)
            batch = legalize_batch(batch, bus_width=cfgs[c].bus_width)
        src, dst = pairs[c]
        rd = rd_ports.setdefault(id(src), _EndpointPort(src))
        wr = wr_ports.setdefault(id(dst), _EndpointPort(dst))
        channels.append(_ChannelState(c, batch, useful, cfgs[c], rd, wr,
                                      beats=ch_beats))

    if tie_seed is None:
        order = np.arange(n_ch)
    else:
        order = np.random.default_rng(tie_seed).permutation(n_ch)
    heap = [(ch.lower_bound(), int(order[ch.idx]), ch.idx)
            for ch in channels if ch.n]
    heapq.heapify(heap)
    while heap:
        _, _, c = heapq.heappop(heap)
        ch = channels[c]
        ch.grant()
        if ch.i < ch.n:
            heapq.heappush(heap, (ch.lower_bound(), int(order[c]), c))

    per = [ch.result() for ch in channels]
    if per:
        agg = SimResult(
            cycles=max(r.cycles for r in per),
            useful_bytes=sum(r.useful_bytes for r in per),
            bus_beats=sum(r.bus_beats for r in per),
            first_read_req=min(r.first_read_req for r in per),
            n_bursts=sum(r.n_bursts for r in per),
        ).with_width(cfgs[0].bus_width)
    else:
        agg = SimResult(0, 0, 0, 0, 0)
    return ChannelSimResult(per_channel=per, aggregate=agg,
                            burst_wend=[ch.wend_hist for ch in channels])


# --------------------------------------------------------------------------
# Paper experiment drivers
# --------------------------------------------------------------------------

def _fragment_lengths(total_bytes: int, fragment: int):
    """(number of full fragments, tail bytes) covering exactly
    `total_bytes` — a trailing short descriptor instead of silently
    dropping the `total_bytes % fragment` remainder."""
    if fragment <= 0:
        raise ValueError(f"fragment must be positive, got {fragment}")
    n_full, tail = divmod(total_bytes, fragment)
    return n_full, tail


def make_fragmented_batch(total_bytes: int, fragment: int,
                          src_protocol: Protocol = Protocol.AXI4,
                          dst_protocol: Protocol = Protocol.AXI4
                          ) -> DescriptorBatch:
    """The §4.4 fragmented-copy descriptor stream as a `DescriptorBatch`,
    built with array ops — no per-descriptor objects."""
    n_full, tail = _fragment_lengths(total_bytes, fragment)
    n = n_full + (1 if tail else 0)
    addr = np.arange(n, dtype=np.int64) * fragment
    length = np.full(n, fragment, dtype=np.int64)
    if tail:
        length[-1] = tail
    return DescriptorBatch.from_arrays(
        src_addr=addr, dst_addr=addr, length=length,
        src_protocol=src_protocol, dst_protocol=dst_protocol)


def fragmented_copy(total_bytes: int, fragment: int, cfg: EngineConfig,
                    src: MemSystem, dst: MemSystem,
                    src_protocol: Protocol = Protocol.AXI4,
                    dst_protocol: Protocol = Protocol.AXI4) -> SimResult:
    """Paper §4.4: copy `total_bytes` fragmented into `fragment`-byte
    descriptors (1 B .. 1 KiB sweep), with a final short descriptor when
    `total_bytes` is not a fragment multiple.  Runs on the batch path."""
    batch = make_fragmented_batch(total_bytes, fragment,
                                  src_protocol, dst_protocol)
    return simulate_batch(batch, cfg, src, dst)


def fragmented_copy_reference(total_bytes: int, fragment: int,
                              cfg: EngineConfig, src: MemSystem,
                              dst: MemSystem,
                              src_protocol: Protocol = Protocol.AXI4,
                              dst_protocol: Protocol = Protocol.AXI4
                              ) -> SimResult:
    """Object-path `fragmented_copy`: one frozen `Transfer1D` per fragment
    through `simulate_reference`.  The baseline the descriptor-plane
    benchmark times the batch path against."""
    n_full, tail = _fragment_lengths(total_bytes, fragment)
    ts = [Transfer1D(src_addr=i * fragment, dst_addr=i * fragment,
                     length=fragment, src_protocol=src_protocol,
                     dst_protocol=dst_protocol)
          for i in range(n_full)]
    if tail:
        ts.append(Transfer1D(src_addr=n_full * fragment,
                             dst_addr=n_full * fragment, length=tail,
                             src_protocol=src_protocol,
                             dst_protocol=dst_protocol))
    return simulate_reference(ts, cfg, src, dst)


def utilization_sweep(cfg: EngineConfig, mem: MemSystem,
                      fragments: Sequence[int] = (1, 2, 4, 8, 16, 32, 64,
                                                  128, 256, 512, 1024),
                      total: int = 64 * 1024) -> Dict[int, float]:
    """Fig. 14 x-axis sweep for one memory system / NAx config."""
    out = {}
    for frag in fragments:
        res = fragmented_copy(total, frag, cfg, mem, mem)
        out[frag] = res.utilization
    return out


def xilinx_baseline_config(bus_width: int = 8) -> EngineConfig:
    """A non-decoupled, store-and-forward engine with per-descriptor
    reprogramming — models AXI DMA v7.1-class behaviour (Fig. 8 baseline).

    Calibration: at 64-B transfers on Cheshire (64-b bus), this engine
    reaches ~1/6 of iDMA's utilization (paper: 'increases bus utilization by
    almost 6x when launching fine-grained 64 B transfers')."""
    return EngineConfig(bus_width=bus_width, n_outstanding=1,
                        buffer_beats=1024, decoupled=False,
                        config_cycles=10, exclusive_transfers=True)


def cheshire_idma_config(bus_width: int = 8) -> EngineConfig:
    """Cheshire iDMAE: 64-b, 8 outstanding (§3.3)."""
    return EngineConfig(bus_width=bus_width, n_outstanding=8,
                        buffer_beats=16, decoupled=True)


def pulp_idma_config() -> EngineConfig:
    """PULP-open cluster iDMAE: 64-b AXI to L2, tensor_ND(3) mid-end,
    16 outstanding (§3.1)."""
    return EngineConfig(bus_width=8, n_outstanding=16, buffer_beats=16,
                        decoupled=True, num_midends=1,
                        tensor_nd_zero_latency=True, config_cycles=9)


def manticore_idma_config() -> EngineConfig:
    """Manticore cluster DMA: 512-b data, 32 outstanding (§3.5)."""
    return EngineConfig(bus_width=64, n_outstanding=32, buffer_beats=64,
                        decoupled=True, num_midends=1,
                        tensor_nd_zero_latency=True)
