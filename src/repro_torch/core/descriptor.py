"""Transfer descriptors — the standardized interfaces between iDMA planes.

The paper (Fig. 2) specifies the 1-D transfer descriptor exchanged between
mid-end and back-end: source address, destination address, transfer length,
protocol selection, and back-end options.  Mid-ends receive *bundles* of
mid-end configuration plus a 1-D descriptor (or, for the tensor mid-ends, an
N-D affine descriptor) and strip their own configuration while rewriting the
transfer.

This module defines those records as frozen dataclasses.  Everything that
flows between `frontend` → `midend*` → `legalizer` → `backend` is one of
these types, for both of this repo's fabrics:

* the cycle-accurate RTL-equivalent simulator (`core.simulator`), and
* the TPU execution paths (Pallas BlockSpec plans / XLA copy plans).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np


class Protocol(enum.Enum):
    """On-chip protocols of the paper's Table 3, plus the TPU address spaces
    this repo adds as back-end targets (HBM/VMEM/ICI/HOST).

    Each value carries (name, supports_bursts, burst_rule).
    """

    AXI4 = "axi4"            # 256 beats or 4 KiB, whichever first
    AXI_LITE = "axi_lite"    # no bursts: single bus-sized beats
    AXI_STREAM = "axi_stream"  # unlimited bursts (no addresses)
    OBI = "obi"              # no bursts
    TILELINK = "tilelink"    # TL-UH: power-of-two bursts
    INIT = "init"            # pseudo-protocol: read-only pattern generator
    # --- TPU fabric address spaces (this work's extension) ---
    HBM = "hbm"              # device high-bandwidth memory
    VMEM = "vmem"            # on-chip vector memory (Pallas tiles)
    ICI = "ici"              # inter-chip interconnect (remote DMA)
    HOST = "host"            # host DRAM over PCIe/DMA


#: Protocols that carry no source address (generated streams).
GENERATOR_PROTOCOLS = (Protocol.INIT,)

#: Protocols that move data between devices rather than within one.
REMOTE_PROTOCOLS = (Protocol.ICI,)


class InitPattern(enum.Enum):
    """Patterns of the Init pseudo-protocol read manager (Table 3)."""

    CONSTANT = "constant"
    INCREMENTING = "incrementing"
    PSEUDORANDOM = "pseudorandom"


@dataclass(frozen=True)
class BackendOptions:
    """Run-time back-end options carried by the 1-D descriptor.

    `decouple_rw`   — fully decouple read/write (default in iDMA).
    `max_burst`     — user burst-length cap in bytes (0 = protocol max).
    `reduce_len`    — artificially reduce legalizer output length (debug).
    `init_pattern`  — pattern when src protocol is INIT.
    `init_value`    — seed/constant for the Init read manager.
    """

    decouple_rw: bool = True
    max_burst: int = 0
    reduce_len: int = 0
    init_pattern: InitPattern = InitPattern.CONSTANT
    init_value: int = 0


@dataclass(frozen=True)
class Transfer1D:
    """The paper's Fig. 2 record: one in-order 1-D arbitrary-length transfer."""

    src_addr: int
    dst_addr: int
    length: int                      # bytes
    src_protocol: Protocol = Protocol.AXI4
    dst_protocol: Protocol = Protocol.AXI4
    options: BackendOptions = field(default_factory=BackendOptions)
    # Bookkeeping (not part of the RTL record; used by mp_dist / tests).
    transfer_id: int = 0

    def __post_init__(self) -> None:
        if self.length < 0:
            raise ValueError(f"negative transfer length {self.length}")
        if self.src_addr < 0 or self.dst_addr < 0:
            raise ValueError("negative address")

    @property
    def src_end(self) -> int:
        return self.src_addr + self.length

    @property
    def dst_end(self) -> int:
        return self.dst_addr + self.length

    def shifted(self, src_by: int, dst_by: int, length: Optional[int] = None
                ) -> "Transfer1D":
        return replace(
            self,
            src_addr=self.src_addr + src_by,
            dst_addr=self.dst_addr + dst_by,
            length=self.length if length is None else length,
        )


@dataclass(frozen=True)
class TensorDim:
    """One dimension of an N-D affine transfer: (src_stride, dst_stride, reps).

    Matches the register layout of the `reg_*_nd` front-ends: every tensor
    dimension adds `src_stride`, `dst_stride`, `num_repetitions`.
    """

    src_stride: int
    dst_stride: int
    reps: int

    def __post_init__(self) -> None:
        if self.reps <= 0:
            raise ValueError(f"dimension repetitions must be positive, got {self.reps}")


@dataclass(frozen=True)
class NdTransfer:
    """N-D affine transfer: an innermost contiguous 1-D burst of
    `inner_length` bytes, repeated along `dims` (outermost last).

    Total bytes moved = inner_length * prod(d.reps for d in dims).
    """

    src_addr: int
    dst_addr: int
    inner_length: int
    dims: Tuple[TensorDim, ...] = ()
    src_protocol: Protocol = Protocol.AXI4
    dst_protocol: Protocol = Protocol.AXI4
    options: BackendOptions = field(default_factory=BackendOptions)
    transfer_id: int = 0

    @property
    def ndim(self) -> int:
        return 1 + len(self.dims)

    @property
    def total_length(self) -> int:
        n = self.inner_length
        for d in self.dims:
            n *= d.reps
        return n

    @property
    def num_inner(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.reps
        return n

    def as_1d(self) -> Transfer1D:
        """Collapse to a single 1-D transfer; only legal when dense."""
        if not self.is_dense():
            raise ValueError("NdTransfer is not dense; use midend.tensor_nd")
        return Transfer1D(
            src_addr=self.src_addr,
            dst_addr=self.dst_addr,
            length=self.total_length,
            src_protocol=self.src_protocol,
            dst_protocol=self.dst_protocol,
            options=self.options,
            transfer_id=self.transfer_id,
        )

    def is_dense(self) -> bool:
        """True when the walk is contiguous in both src and dst, i.e. each
        dimension's stride equals the extent of the dimensions below it."""
        extent = self.inner_length
        for d in self.dims:
            if d.src_stride != extent or d.dst_stride != extent:
                return False
            extent *= d.reps
        return True


@dataclass(frozen=True)
class RtConfig:
    """Real-time mid-end (`rt_3D`) configuration: autonomously launch the
    bundled transfer every `period` cycles, `num_launches` times
    (0 = forever).  A bypass flag lets unrelated transfers share the
    front-/back-end (paper §2.2)."""

    period: int
    num_launches: int = 0
    bypass: bool = False

    def __post_init__(self) -> None:
        if self.period <= 0:
            raise ValueError("rt period must be positive")


@dataclass(frozen=True)
class MidendBundle:
    """What a mid-end consumes: its own config + the transfer to rewrite.

    Each mid-end strips `configs[0]` and passes the rest downstream
    (paper §2: 'A mid-end will strip its configuration information while
    modifying the 1D transfer descriptor.')."""

    transfer: object                     # Transfer1D | NdTransfer
    configs: Tuple[object, ...] = ()

    def strip(self) -> "MidendBundle":
        return MidendBundle(transfer=self.transfer, configs=self.configs[1:])


#: Canonical numeric protocol codes — the wire encoding of `desc_64`
#: descriptors and the dtype of `DescriptorBatch.src_proto`/`dst_proto`.
PROTO_CODE = {p: i for i, p in enumerate(Protocol)}
CODE_PROTO = {i: p for i, p in enumerate(Protocol)}

_DEFAULT_OPTIONS = BackendOptions()

#: options column of a DescriptorBatch: a single BackendOptions broadcasts
#: to every row; a tuple carries one entry per row.
_OptionsColumn = Union[BackendOptions, Tuple[BackendOptions, ...]]


@dataclass
class DescriptorBatch:
    """Structure-of-arrays plane of 1-D transfer descriptors.

    The batched analogue of a ``List[Transfer1D]``: one NumPy column per
    descriptor field, so the legalizer / mid-ends / simulator can rewrite
    millions of descriptors with array ops instead of per-object Python.
    Mirrors how batched descriptor streams (XDMA, DataMaestro) keep a DMA
    control plane off the critical path.

    Columns (all length ``n``):

    * ``src_addr`` / ``dst_addr`` / ``length`` — int64 byte addresses/sizes;
    * ``src_proto`` / ``dst_proto``            — uint8 `PROTO_CODE` values;
    * ``owner``       — index of the owning *input* descriptor: legalized
      bursts keep the owner of the descriptor they were split from (the
      simulator's accept/launch chain is per owner);
    * ``transfer_id`` — bookkeeping id, as on `Transfer1D`;
    * ``max_burst`` / ``reduce_len`` — the two `BackendOptions` fields that
      affect legalization, lifted into columns so the batch legalizer never
      touches Python objects.

    ``options`` optionally carries the full `BackendOptions` for loss-free
    round-trips through `to_transfers()`: ``None`` means every row uses the
    defaults implied by the numeric columns, a single `BackendOptions`
    broadcasts to all rows (O(1) to carry through every rewrite — the hot
    paths never touch per-row Python objects), and a tuple holds one entry
    per row.
    """

    src_addr: np.ndarray
    dst_addr: np.ndarray
    length: np.ndarray
    src_proto: np.ndarray
    dst_proto: np.ndarray
    owner: np.ndarray
    transfer_id: np.ndarray
    max_burst: np.ndarray
    reduce_len: np.ndarray
    options: Optional["_OptionsColumn"] = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(cls, src_addr, dst_addr, length,
                    src_proto=None, dst_proto=None, owner=None,
                    transfer_id=None, max_burst=None, reduce_len=None,
                    options: Optional["_OptionsColumn"] = None,
                    src_protocol: Protocol = Protocol.AXI4,
                    dst_protocol: Protocol = Protocol.AXI4,
                    ) -> "DescriptorBatch":
        src_addr = np.ascontiguousarray(src_addr, dtype=np.int64)
        n = src_addr.shape[0]

        # The legalizer reads only the numeric columns — when options are
        # supplied without explicit max_burst/reduce_len columns, derive
        # them so the batch path honors the same caps as the object path.
        if options is not None:
            if isinstance(options, BackendOptions):
                if max_burst is None:
                    max_burst = options.max_burst
                if reduce_len is None:
                    reduce_len = options.reduce_len
            else:
                options = tuple(options)
                if max_burst is None:
                    max_burst = np.fromiter(
                        (o.max_burst for o in options), dtype=np.int64,
                        count=len(options))
                if reduce_len is None:
                    reduce_len = np.fromiter(
                        (o.reduce_len for o in options), dtype=np.int64,
                        count=len(options))

        def col(x, dtype, fill):
            if x is None:
                return np.full(n, fill, dtype=dtype)
            return np.ascontiguousarray(np.broadcast_to(
                np.asarray(x, dtype=dtype), (n,)))

        return cls(
            src_addr=src_addr,
            dst_addr=col(dst_addr, np.int64, 0),
            length=col(length, np.int64, 0),
            src_proto=col(src_proto, np.uint8, PROTO_CODE[src_protocol]),
            dst_proto=col(dst_proto, np.uint8, PROTO_CODE[dst_protocol]),
            owner=np.arange(n, dtype=np.int64) if owner is None
            else col(owner, np.int64, 0),
            transfer_id=col(transfer_id, np.int64, 0),
            max_burst=col(max_burst, np.int64, 0),
            reduce_len=col(reduce_len, np.int64, 0),
            options=(options if options is None
                     or isinstance(options, BackendOptions)
                     else tuple(options)),
        )

    @classmethod
    def from_transfers(cls, transfers: Sequence[Transfer1D]
                       ) -> "DescriptorBatch":
        """Adapter from the object API (one row per `Transfer1D`)."""
        n = len(transfers)
        opts: Optional[_OptionsColumn] = tuple(t.options for t in transfers)
        if n == 0:
            opts = None
        elif all(o is opts[0] for o in opts):
            opts = opts[0]        # uniform — keep the O(1) broadcast form
        return cls.from_arrays(
            src_addr=np.fromiter((t.src_addr for t in transfers),
                                 dtype=np.int64, count=n),
            dst_addr=np.fromiter((t.dst_addr for t in transfers),
                                 dtype=np.int64, count=n),
            length=np.fromiter((t.length for t in transfers),
                               dtype=np.int64, count=n),
            src_proto=np.fromiter((PROTO_CODE[t.src_protocol]
                                   for t in transfers), dtype=np.uint8,
                                  count=n),
            dst_proto=np.fromiter((PROTO_CODE[t.dst_protocol]
                                   for t in transfers), dtype=np.uint8,
                                  count=n),
            owner=np.arange(n, dtype=np.int64),
            transfer_id=np.fromiter((t.transfer_id for t in transfers),
                                    dtype=np.int64, count=n),
            max_burst=np.fromiter((t.options.max_burst for t in transfers),
                                  dtype=np.int64, count=n),
            reduce_len=np.fromiter((t.options.reduce_len for t in transfers),
                                   dtype=np.int64, count=n),
            options=opts,
        )

    @classmethod
    def empty(cls) -> "DescriptorBatch":
        return cls.from_arrays(np.empty(0, dtype=np.int64), None, None)

    # -- views -------------------------------------------------------------

    def __len__(self) -> int:
        return int(self.src_addr.shape[0])

    @property
    def total_bytes(self) -> int:
        return int(self.length.sum()) if len(self) else 0

    def option_for(self, row: int) -> BackendOptions:
        if isinstance(self.options, BackendOptions):
            return self.options
        if self.options is not None:
            return self.options[row]
        mb = int(self.max_burst[row])
        rl = int(self.reduce_len[row])
        if mb == 0 and rl == 0:
            return _DEFAULT_OPTIONS
        return BackendOptions(max_burst=mb, reduce_len=rl)

    def _options_at(self, rows: np.ndarray) -> Optional["_OptionsColumn"]:
        """Options column for a row selection — O(1) for the None /
        broadcast representations, per-row gather only for tuples."""
        if self.options is None or isinstance(self.options, BackendOptions):
            return self.options
        return tuple(self.options[int(i)] for i in rows)

    def select(self, index) -> "DescriptorBatch":
        """Row subset / reorder; `index` is any NumPy fancy index or mask."""
        opts = self.options
        if opts is not None and not isinstance(opts, BackendOptions):
            opts = self._options_at(np.arange(len(self))[index])
        return DescriptorBatch(
            src_addr=self.src_addr[index], dst_addr=self.dst_addr[index],
            length=self.length[index], src_proto=self.src_proto[index],
            dst_proto=self.dst_proto[index], owner=self.owner[index],
            transfer_id=self.transfer_id[index],
            max_burst=self.max_burst[index],
            reduce_len=self.reduce_len[index], options=opts)

    def rewrite(self, row, offset, length) -> "DescriptorBatch":
        """Burst view: row `row[j]` shifted by `offset[j]` on both ports and
        cut to `length[j]` bytes — the batched `Transfer1D.shifted`."""
        row = np.asarray(row, dtype=np.int64)
        offset = np.asarray(offset, dtype=np.int64)
        opts = self._options_at(row)
        return DescriptorBatch(
            src_addr=self.src_addr[row] + offset,
            dst_addr=self.dst_addr[row] + offset,
            length=np.ascontiguousarray(length, dtype=np.int64),
            src_proto=self.src_proto[row], dst_proto=self.dst_proto[row],
            owner=self.owner[row], transfer_id=self.transfer_id[row],
            max_burst=self.max_burst[row], reduce_len=self.reduce_len[row],
            options=opts)

    def row(self, i: int) -> Transfer1D:
        """Row `i` as a `Transfer1D`, bypassing `__post_init__` validation —
        error reporting must be able to materialize a row whose fields are
        exactly what the batch carries, even when they are illegal (e.g. a
        negative address flagged by the back-end bounds check)."""
        t = object.__new__(Transfer1D)
        object.__setattr__(t, "src_addr", int(self.src_addr[i]))
        object.__setattr__(t, "dst_addr", int(self.dst_addr[i]))
        object.__setattr__(t, "length", int(self.length[i]))
        object.__setattr__(t, "src_protocol", CODE_PROTO[int(self.src_proto[i])])
        object.__setattr__(t, "dst_protocol", CODE_PROTO[int(self.dst_proto[i])])
        object.__setattr__(t, "options", self.option_for(i))
        object.__setattr__(t, "transfer_id", int(self.transfer_id[i]))
        return t

    def to_transfers(self) -> List[Transfer1D]:
        """Adapter back to the object API (the slow path — for interop,
        functional execution and tests; the hot paths stay on arrays)."""
        out: List[Transfer1D] = []
        sa, da, ln = (self.src_addr.tolist(), self.dst_addr.tolist(),
                      self.length.tolist())
        sp, dp = self.src_proto.tolist(), self.dst_proto.tolist()
        tid = self.transfer_id.tolist()
        for i in range(len(self)):
            out.append(Transfer1D(
                src_addr=sa[i], dst_addr=da[i], length=ln[i],
                src_protocol=CODE_PROTO[sp[i]], dst_protocol=CODE_PROTO[dp[i]],
                options=self.option_for(i), transfer_id=tid[i]))
        return out


def concat_batches(batches: Iterable[DescriptorBatch]) -> DescriptorBatch:
    """Concatenate batches into one descriptor stream.

    Owner indices are re-based by a running offset so descriptors from
    different batches never alias in the simulator's accept chain (two
    single-row batches both carry owner 0; naive concatenation would fuse
    them into one descriptor).
    """
    batches = [b for b in batches if len(b)]
    if not batches:
        return DescriptorBatch.empty()
    if len(batches) == 1:
        return batches[0]

    owners = []
    base = 0
    for b in batches:
        owners.append(b.owner + base)
        base += int(b.owner.max()) + 1

    opts: Optional[_OptionsColumn] = None
    per_batch = [b.options for b in batches]
    if any(o is not None for o in per_batch):
        first = per_batch[0]
        if isinstance(first, BackendOptions) and \
                all(o is first for o in per_batch):
            opts = first                      # common broadcast preserved
        else:
            opts = tuple(b.option_for(i)
                         for b in batches for i in range(len(b)))

    cat = np.concatenate
    return DescriptorBatch(
        src_addr=cat([b.src_addr for b in batches]),
        dst_addr=cat([b.dst_addr for b in batches]),
        length=cat([b.length for b in batches]),
        src_proto=cat([b.src_proto for b in batches]),
        dst_proto=cat([b.dst_proto for b in batches]),
        owner=cat(owners),
        transfer_id=cat([b.transfer_id for b in batches]),
        max_burst=cat([b.max_burst for b in batches]),
        reduce_len=cat([b.reduce_len for b in batches]),
        options=opts)


def total_bytes(transfers: Sequence[Transfer1D]) -> int:
    return sum(t.length for t in transfers)


def contiguous_coverage(transfers: Sequence[Transfer1D]) -> bool:
    """Check a transfer list covers a contiguous src AND dst byte range with
    no overlap and no gap — the invariant every mid-end/legalizer rewrite of
    a dense transfer must preserve."""
    if not transfers:
        return True
    by_src = sorted(transfers, key=lambda t: t.src_addr)
    for prev, nxt in zip(by_src, by_src[1:]):
        if prev.src_end != nxt.src_addr:
            return False
        # dst must follow the same order for a dense copy
        if prev.dst_end != nxt.dst_addr:
            return False
    return True
