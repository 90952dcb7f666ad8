"""Front-ends — the control plane (paper §2.1, Table 1).

Three bindings, mirroring the paper's selection:

* ``RegFrontend``  — core-private register file (`reg_32[_2d/_3d]`,
  `reg_64[_2d]`): program src/dst/length (+ per-dimension stride/reps
  registers), launch by *reading* `transfer_id`, poll `status` for the last
  completed ID (transfer-level synchronization).
* ``DescFrontend`` — `desc_64`: Linux-DMA-style transfer descriptors placed
  in a memory buffer; launch via a single doorbell write (single-write
  launch ⇒ atomic in multi-hart environments); descriptor *chaining* via a
  next-pointer supports arbitrarily shaped transfers.
* ``InstFrontend`` — `inst_64`: custom RISC-V instructions (Snitch Xdma
  style): `dmsrc`/`dmdst` set pointers, `dmstr` strides, `dmrep`
  repetitions, `dmcpy` launches and returns the transfer ID — a 1-D
  transfer launches in 3 instructions, a 2-D in at most 6.

Front-ends produce descriptor objects and hand them to an
:class:`repro.core.engine.IDMAEngine`.  They are deliberately stateful (the
RTL is), while everything downstream is purely functional.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .descriptor import (CODE_PROTO, PROTO_CODE, DescriptorBatch, NdTransfer,
                         Protocol, TensorDim, Transfer1D)

# ---------------------------------------------------------------------------
# Register-file front-end
# ---------------------------------------------------------------------------


class RegFrontend:
    """`reg_<w>[_<n>d]` register-file front-end.

    One instance per PE ('core-private register-based configuration
    interfaces ... eliminate race conditions').  Register map (word offsets):

      0 src_addr   1 dst_addr   2 length   3 config   4 status   5 transfer_id
      6+3k src_stride[k]   7+3k dst_stride[k]   8+3k reps[k]     (k < ndims-1)
    """

    SRC, DST, LEN, CONF, STATUS, TID = range(6)

    def __init__(self, engine: "IDMAEngineLike", word_bits: int = 32,
                 ndims: int = 1) -> None:
        if ndims < 1:
            raise ValueError("ndims must be >= 1")
        self.engine = engine
        self.word_bits = word_bits
        self.ndims = ndims
        self.regs: Dict[int, int] = {}
        self._next_id = 1

    @property
    def name(self) -> str:
        suffix = "" if self.ndims == 1 else f"_{self.ndims}d"
        return f"reg_{self.word_bits}{suffix}"

    def write(self, reg: int, value: int) -> None:
        mask = (1 << self.word_bits) - 1
        if reg in (self.STATUS, self.TID):
            raise PermissionError("status/transfer_id registers are read-only")
        self.regs[reg] = value & mask

    def read(self, reg: int) -> int:
        if reg == self.TID:
            return self._launch()
        if reg == self.STATUS:
            return self.engine.last_completed_id()
        return self.regs.get(reg, 0)

    def configure(self, src: int, dst: int, length: int,
                  dims: Tuple[TensorDim, ...] = (),
                  src_protocol: Protocol = Protocol.AXI4,
                  dst_protocol: Protocol = Protocol.AXI4) -> None:
        """Convenience bulk programming (what a driver would do)."""
        if len(dims) > self.ndims - 1:
            raise ValueError(
                f"{self.name} supports at most {self.ndims - 1} stride dims")
        self.write(self.SRC, src)
        self.write(self.DST, dst)
        self.write(self.LEN, length)
        self._protocols = (src_protocol, dst_protocol)
        for k, d in enumerate(dims):
            self.write(6 + 3 * k, d.src_stride)
            self.write(7 + 3 * k, d.dst_stride)
            self.write(8 + 3 * k, d.reps)

    def launch(self) -> int:
        """Launch by reading `transfer_id` (paper's launch mechanism)."""
        return self.read(self.TID)

    # -- internals ---------------------------------------------------------

    _protocols: Tuple[Protocol, Protocol] = (Protocol.AXI4, Protocol.AXI4)

    def _launch(self) -> int:
        tid = self._next_id
        self._next_id += 1
        dims = []
        for k in range(self.ndims - 1):
            reps = self.regs.get(8 + 3 * k, 0)
            if reps:
                dims.append(TensorDim(self.regs.get(6 + 3 * k, 0),
                                      self.regs.get(7 + 3 * k, 0), reps))
        nd = NdTransfer(
            src_addr=self.regs.get(self.SRC, 0),
            dst_addr=self.regs.get(self.DST, 0),
            inner_length=self.regs.get(self.LEN, 0),
            dims=tuple(dims),
            src_protocol=self._protocols[0],
            dst_protocol=self._protocols[1],
            transfer_id=tid,
        )
        self.engine.submit(nd)
        return tid


# ---------------------------------------------------------------------------
# Descriptor front-end (desc_64)
# ---------------------------------------------------------------------------

#: struct layout of an in-memory descriptor: next_ptr, src, dst, length,
#: flags (2 × u32 protocols packed) — 40 bytes, 8-byte aligned.
_DESC_FMT = "<QQQQII"
DESC_SIZE = struct.calcsize(_DESC_FMT)
_NULL = 0xFFFF_FFFF_FFFF_FFFF

# Canonical wire encoding lives next to the descriptor types.
_PROTO_CODE = PROTO_CODE
_CODE_PROTO = CODE_PROTO

#: NumPy view of the `desc_64` record — lets a contiguous descriptor ring
#: be decoded into a `DescriptorBatch` with one `frombuffer` instead of a
#: per-hop unpack loop.
_DESC_DTYPE = np.dtype([("next", "<u8"), ("src", "<u8"), ("dst", "<u8"),
                        ("length", "<u8"), ("sp", "<u4"), ("dp", "<u4")])


def pack_descriptor(src: int, dst: int, length: int,
                    next_ptr: int = _NULL,
                    src_protocol: Protocol = Protocol.AXI4,
                    dst_protocol: Protocol = Protocol.AXI4) -> bytes:
    return struct.pack(_DESC_FMT, next_ptr, src, dst, length,
                       _PROTO_CODE[src_protocol], _PROTO_CODE[dst_protocol])


class DescFrontend:
    """`desc_64`: fetch chained descriptors from memory via a manager port.

    `memory` is any buffer supporting slicing (the scratchpad the cores
    write descriptors into).  `doorbell(addr)` performs the single-write
    launch; the front-end walks the chain and submits each hop.

    `async_submit` — the spec-level doorbell mode (`FrontendSpec
    (doorbell="async")`): when set, `doorbell` and `doorbell_ring`
    default to the asynchronous control plane (enqueue on the engine's
    channel queues; the caller drains with ``engine.wait_all()``)."""

    def __init__(self, engine: "IDMAEngineLike",
                 memory: bytearray, async_submit: bool = False) -> None:
        self.engine = engine
        self.memory = memory
        self.async_submit = async_submit
        self.fetches = 0

    def _walk_chain(self, addr: int):
        """Fetch and decode descriptors hop by hop (loop / alignment /
        bounds checked), yielding one `Transfer1D` per hop."""
        seen = set()
        while addr != _NULL:
            if addr in seen:
                raise ValueError(f"descriptor chain loop at {addr:#x}")
            seen.add(addr)
            if addr % 8:
                raise ValueError("descriptor must be 8-byte aligned")
            raw = bytes(self.memory[addr:addr + DESC_SIZE])
            if len(raw) < DESC_SIZE:
                raise ValueError("descriptor fetch out of bounds")
            nxt, src, dst, length, sp, dp = struct.unpack(_DESC_FMT, raw)
            self.fetches += 1
            yield Transfer1D(src_addr=src, dst_addr=dst, length=length,
                             src_protocol=_CODE_PROTO[sp],
                             dst_protocol=_CODE_PROTO[dp])
            addr = nxt

    def doorbell(self, addr: int) -> List[int]:
        if self.async_submit:
            return self.doorbell_async(addr)
        return [self.engine.submit(t) for t in self._walk_chain(addr)]

    def doorbell_async(self, addr: int) -> List[int]:
        """Asynchronous doorbell: walk the chain and *enqueue* each hop on
        the engine's channel submission queues (`submit_async`) instead of
        executing inline.  Returns the transfer ids; the caller completes
        them with `engine.wait_all()` and tracks them via `engine.poll` —
        the submission-queue/completion-record control plane of the
        Linux-DMAC driver model."""
        return [self.engine.submit_async(t) for t in self._walk_chain(addr)]

    def doorbell_ring(self, base: int, count: int,
                      async_submit: Optional[bool] = None) -> List[int]:
        """Batched doorbell: decode `count` contiguous descriptors at
        `base` into a `DescriptorBatch` in one `frombuffer` and submit them
        as a batch — the XDMA-style alternative to walking a chain one
        manager-port fetch at a time (next-pointers are ignored; the ring
        layout IS the chain).

        With `async_submit` (default: the front-end's spec-level doorbell
        mode) the batch is sharded across the engine's channel queues
        (`dispatch_batch`) instead of executing inline."""
        if async_submit is None:
            async_submit = self.async_submit
        if base < 0 or count < 0:
            raise ValueError("descriptor ring base/count must be >= 0")
        if base % 8:
            raise ValueError("descriptor ring must be 8-byte aligned")
        end = base + count * DESC_SIZE
        if end > len(self.memory):
            raise ValueError("descriptor ring out of bounds")
        raw = np.frombuffer(bytes(self.memory[base:end]), dtype=_DESC_DTYPE)
        n_proto = len(Protocol)
        if (raw["sp"] >= n_proto).any() or (raw["dp"] >= n_proto).any():
            raise ValueError("descriptor ring contains invalid protocol "
                             "codes (corrupted descriptor?)")
        self.fetches += count
        batch = DescriptorBatch.from_arrays(
            src_addr=raw["src"].astype(np.int64),
            dst_addr=raw["dst"].astype(np.int64),
            length=raw["length"].astype(np.int64),
            src_proto=raw["sp"].astype(np.uint8),
            dst_proto=raw["dp"].astype(np.uint8))
        if async_submit:
            return self.engine.dispatch_batch(batch)
        return self.engine.submit_batch(batch)


def write_chain(memory: bytearray, base: int,
                hops: List[Tuple[int, int, int]],
                src_protocol: Protocol = Protocol.AXI4,
                dst_protocol: Protocol = Protocol.AXI4) -> int:
    """Place a descriptor chain into `memory` at `base`; returns `base`."""
    for i, (src, dst, length) in enumerate(hops):
        addr = base + i * DESC_SIZE
        nxt = base + (i + 1) * DESC_SIZE if i + 1 < len(hops) else _NULL
        memory[addr:addr + DESC_SIZE] = pack_descriptor(
            src, dst, length, nxt, src_protocol, dst_protocol)
    return base


# ---------------------------------------------------------------------------
# Instruction front-end (inst_64)
# ---------------------------------------------------------------------------

class InstFrontend:
    """`inst_64`: decode Snitch-style Xdma instructions.

    Instruction stream (mnemonic, operands):
      ('dmsrc', hi, lo)  ('dmdst', hi, lo)  ('dmstr', src_stride, dst_stride)
      ('dmrep', reps)    ('dmcpy', length)  → returns transfer id

    A 1-D transfer is dmsrc+dmdst+dmcpy = 3 instructions (paper: 'launch a
    transaction within three cycles'); 2-D adds dmstr+dmrep (≤ 6).
    """

    def __init__(self, engine: "IDMAEngineLike") -> None:
        self.engine = engine
        self._src = 0
        self._dst = 0
        self._stride: Optional[Tuple[int, int]] = None
        self._reps = 0
        self._issued = 0

    def execute(self, mnemonic: str, *operands: int) -> Optional[int]:
        self._issued += 1
        if mnemonic == "dmsrc":
            hi, lo = operands
            self._src = (hi << 32) | lo
            return None
        if mnemonic == "dmdst":
            hi, lo = operands
            self._dst = (hi << 32) | lo
            return None
        if mnemonic == "dmstr":
            self._stride = (operands[0], operands[1])
            return None
        if mnemonic == "dmrep":
            self._reps = operands[0]
            return None
        if mnemonic == "dmcpy":
            (length,) = operands
            if self._stride is not None and self._reps > 1:
                nd = NdTransfer(
                    self._src, self._dst, length,
                    (TensorDim(self._stride[0], self._stride[1], self._reps),))
                tid = self.engine.submit(nd)
            else:
                tid = self.engine.submit(
                    Transfer1D(self._src, self._dst, length))
            # one-shot stride/rep state, as in Snitch
            self._stride = None
            self._reps = 0
            return tid
        raise ValueError(f"unknown iDMA instruction {mnemonic!r}")

    def copy_1d(self, src: int, dst: int, length: int) -> Tuple[int, int]:
        """(transfer_id, instructions_used) — asserts the 3-instruction claim."""
        before = self._issued
        self.execute("dmsrc", src >> 32, src & 0xFFFFFFFF)
        self.execute("dmdst", dst >> 32, dst & 0xFFFFFFFF)
        tid = self.execute("dmcpy", length)
        return tid, self._issued - before

    def copy_2d(self, src: int, dst: int, inner: int,
                src_stride: int, dst_stride: int, reps: int
                ) -> Tuple[int, int]:
        before = self._issued
        self.execute("dmsrc", src >> 32, src & 0xFFFFFFFF)
        self.execute("dmdst", dst >> 32, dst & 0xFFFFFFFF)
        self.execute("dmstr", src_stride, dst_stride)
        self.execute("dmrep", reps)
        tid = self.execute("dmcpy", inner)
        return tid, self._issued - before


# ---------------------------------------------------------------------------
# Completion-interrupt front-end (MSI-X style)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CompletionEvent:
    """One completion posted by the engine's drain, in `simulate_channels`
    event order: ``cycle`` is the submission's last write-end cycle in the
    drain's timing result (ties broken by ``tid``).  ``status`` is the
    completion record's terminal state; ``count`` the number of transfer
    ids the record covers."""

    tid: int
    count: int
    channel: int
    cycle: int
    status: str                   # "done" | "error"
    bytes_moved: int


@dataclass
class IrqStats:
    posted: int = 0               # completion events posted
    delivered: int = 0            # events handed to callbacks
    fired: int = 0                # interrupts raised (coalesced batches)
    flushed: int = 0              # end-of-drain timeout kicks


class IrqController:
    """MSI-X-style completion-interrupt controller.

    Channels post `CompletionEvent`s to interrupt vectors (channel →
    ``channel % num_vectors``; sharded records post on vector 0) and the
    controller *coalesces* them: a vector fires once ``coalesce_count``
    events are pending, or — with a nonzero ``coalesce_cycles`` — once
    the newest pending event is that many cycles younger than the oldest.
    `flush` raises the end-of-drain timeout interrupt for whatever is
    still pending, so no completion is ever lost.

    Callbacks (`register`) receive ``(vector, events)`` with the events
    of one interrupt in posting (completion) order.  Delivery is purely
    observational: it never changes engine timing or byte movement.
    """

    def __init__(self, num_vectors: int = 1, coalesce_count: int = 1,
                 coalesce_cycles: int = 0) -> None:
        if num_vectors < 1:
            raise ValueError("irq controller needs num_vectors >= 1")
        if coalesce_count < 1:
            raise ValueError("irq coalesce_count must be >= 1")
        if coalesce_cycles < 0:
            raise ValueError("irq coalesce_cycles must be >= 0")
        self.num_vectors = num_vectors
        self.coalesce_count = coalesce_count
        self.coalesce_cycles = coalesce_cycles
        self.pending: List[List[CompletionEvent]] = [
            [] for _ in range(num_vectors)]
        self.callbacks: List = []
        self.stats = IrqStats()

    def register(self, callback) -> None:
        """Register a ``callback(vector, events)`` completion handler."""
        self.callbacks.append(callback)

    def vector_of(self, channel: int) -> int:
        return channel % self.num_vectors if channel >= 0 else 0

    def post(self, event: CompletionEvent) -> None:
        """Post one completion; fires the vector when a coalescing
        threshold is crossed."""
        v = self.vector_of(event.channel)
        pend = self.pending[v]
        pend.append(event)
        self.stats.posted += 1
        if len(pend) >= self.coalesce_count or (
                self.coalesce_cycles > 0
                and event.cycle - pend[0].cycle >= self.coalesce_cycles):
            self._fire(v)

    def flush(self) -> None:
        """End-of-drain timeout kick: fire every vector still pending."""
        for v in range(self.num_vectors):
            if self.pending[v]:
                self.stats.flushed += 1
                self._fire(v)

    def _fire(self, v: int) -> None:
        events, self.pending[v] = self.pending[v], []
        if not events:
            return
        self.stats.fired += 1
        self.stats.delivered += len(events)
        for cb in self.callbacks:
            cb(v, events)


class IDMAEngineLike:
    """Protocol for engines a front-end can drive (see core.engine)."""

    def submit(self, transfer) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def last_completed_id(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Front-end registry — the spec layer's construction entry point
# ---------------------------------------------------------------------------

#: control-plane kinds (paper Table 1) → front-end classes
FRONTENDS = {"reg": RegFrontend, "desc": DescFrontend,
             "inst": InstFrontend}


def make_frontend(kind: str, engine: "IDMAEngineLike", *,
                  memory: Optional[bytearray] = None,
                  word_bits: int = 32, ndims: int = 1,
                  async_submit: bool = False):
    """Instantiate a front-end by kind — the factory
    `core.spec.FrontendSpec.build` resolves through.

    ``reg``  uses `word_bits`/`ndims`; ``desc`` needs a descriptor
    `memory` buffer and honours `async_submit` as its default doorbell
    mode; ``inst`` takes no options."""
    cls = FRONTENDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown front-end kind {kind!r}: expected one "
                         f"of {sorted(FRONTENDS)}")
    if cls is RegFrontend:
        return cls(engine, word_bits=word_bits, ndims=ndims)
    if cls is DescFrontend:
        if memory is None:
            raise ValueError("desc front-ends need a descriptor memory "
                             "buffer")
        return cls(engine, memory, async_submit=async_submit)
    return cls(engine)
