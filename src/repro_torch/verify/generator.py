"""Seeded constrained-random descriptor-program generator.

A *program* is one complete engine workload: an `EngineSpec` (a named
preset or a random custom composition — mid-end pipelines, multi-port
back-ends, channel schemes, error policies, interrupt shapes), a list of
submissions (descriptor batches, single 1-D descriptors, N-D affine
transfers), a deterministic memory-fill seed, and a list of seeded
fault-injection sites.

Constraints make programs *differentially checkable* against the scalar
oracle without forbidding the interesting cases:

* every address space is split in half — sources read from the lower
  half, destinations write into the upper half, and destination windows
  within one submission are allocated disjointly.  Cross-item write
  ordering is then irrelevant (the engine's documented multi-channel
  hazard), while overlapping *reads* remain fully exercised;
* illegal rows are out-of-bounds-high on the destination, placed beyond
  the submission's allocation high-water mark, so their in-bounds burst
  prefix can never corrupt another row's window;
* no-burst protocols (OBI / AXI-Lite) cap row lengths so the legalized
  single-beat streams stay tractable for the scalar oracle.

Everything is derived from `numpy.random.default_rng(seed)` — the same
seed always yields the same program, which is what makes shrinking and
replay (`python -m repro_torch.verify --replay SEED`) possible.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import (HBM, PROTO_CODE, PULP_L2, SRAM, BackendOptions,
                              DescriptorBatch, EngineSpec, ErrorPolicy,
                              FaultSite, InitPattern, IrqSpec, MemoryMap,
                              MpDistStage, MpSplitStage, NdTransfer, Protocol,
                              RtReplicateStage, TensorDim, Transfer1D, preset)
from repro_torch.core.spec import BackendSpec, ChannelSpec

#: program families, indexed by ``seed % len(FAMILIES)`` so any contiguous
#: seed range covers every preset plus random custom compositions
FAMILIES: Tuple[str, ...] = ("pulp_cluster", "manticore", "cheshire",
                             "edge_ai", "custom")

#: protocols whose legalized bursts are single bus beats — row lengths are
#: capped for these so the scalar oracle stays O(rows), not O(bytes)
_NO_BURST = (Protocol.OBI, Protocol.AXI_LITE)

_CUSTOM_SPACES = ((Protocol.AXI4, 128 << 10), (Protocol.OBI, 64 << 10),
                  (Protocol.TILELINK, 64 << 10),
                  (Protocol.AXI_LITE, 64 << 10))


@dataclass(frozen=True)
class Row:
    """One generated 1-D descriptor row."""

    src: int
    dst: int
    length: int
    src_proto: Protocol
    dst_proto: Protocol
    max_burst: int = 0


@dataclass
class Submission:
    """One control-plane submission.

    ``kind`` — ``"batch"`` (`dispatch_batch` of all rows), ``"single"``
    (`submit_async` of row 0) or ``"nd"`` (`submit_async` of the bundled
    `NdTransfer`).  ``options`` ride uniformly on every row (Init pattern
    configuration); per-row ``max_burst`` caps are carried on the rows.
    """

    kind: str
    rows: Tuple[Row, ...]
    options: Optional[BackendOptions] = None
    nd: Optional[NdTransfer] = None

    def materialize(self):
        """The payload handed to the engine (batch or descriptor)."""
        if self.kind == "nd":
            return self.nd
        if self.kind == "single":
            r = self.rows[0]
            return Transfer1D(
                src_addr=r.src, dst_addr=r.dst, length=r.length,
                src_protocol=r.src_proto, dst_protocol=r.dst_proto,
                options=self.options or BackendOptions(
                    max_burst=r.max_burst))
        rows = self.rows
        return DescriptorBatch.from_arrays(
            src_addr=np.asarray([r.src for r in rows], dtype=np.int64),
            dst_addr=np.asarray([r.dst for r in rows], dtype=np.int64),
            length=np.asarray([r.length for r in rows], dtype=np.int64),
            src_proto=np.asarray(
                [PROTO_CODE[r.src_proto] for r in rows], dtype=np.uint8),
            dst_proto=np.asarray(
                [PROTO_CODE[r.dst_proto] for r in rows], dtype=np.uint8),
            max_burst=np.asarray([r.max_burst for r in rows],
                                 dtype=np.int64),
            options=self.options,
        )

    @property
    def num_rows(self) -> int:
        if self.kind == "nd":
            return 1
        return len(self.rows)


@dataclass
class Program:
    """One seeded differential-test program (see module docstring)."""

    seed: int
    family: str
    spec: EngineSpec
    submissions: List[Submission]
    fault_sites: List[FaultSite] = field(default_factory=list)
    mem_seed: int = 0

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.submissions)

    def describe(self) -> str:
        pol = self.spec.backend.error_policy
        lines = [
            f"program seed={self.seed} family={self.family!r}",
            f"  spec: channels={self.spec.channels.count}"
            f"/{self.spec.channels.scheme}"
            f" ports={self.spec.backend.num_ports}"
            f" bus={self.spec.backend.bus_width}"
            f" midend={[type(s).__name__ for s in self.spec.midend]}",
            f"  policy: {pol.action} max_replays={pol.max_replays}"
            f" replay_backoff={pol.replay_backoff}",
            f"  irq: count={self.spec.irq.coalesce_count}"
            f" cycles={self.spec.irq.coalesce_cycles}"
            f" vectors={self.spec.irq.vectors}",
        ]
        for i, sub in enumerate(self.submissions):
            if sub.kind == "nd":
                nd = sub.nd
                lines.append(
                    f"  sub[{i}] nd inner={nd.inner_length} dims="
                    f"{[(d.src_stride, d.dst_stride, d.reps) for d in nd.dims]}"
                    f" src={nd.src_addr:#x} dst={nd.dst_addr:#x}")
                continue
            lines.append(f"  sub[{i}] {sub.kind} rows={len(sub.rows)}"
                         + (f" options={sub.options}" if sub.options
                            else ""))
            for r in sub.rows:
                lines.append(
                    f"    {r.src_proto.value}->{r.dst_proto.value}"
                    f" src={r.src:#x} dst={r.dst:#x} len={r.length}"
                    + (f" max_burst={r.max_burst}" if r.max_burst else ""))
        for s in self.fault_sites:
            lines.append(f"  fault @burst {s.index}: {s.kind}"
                         + (f" hits={s.hits}" if s.kind == "transient"
                            else "")
                         + (f" stall={s.stall_cycles}" if s.kind == "stall"
                            else ""))
        return "\n".join(lines)


def fill_mem(mem: MemoryMap, mem_seed: int) -> None:
    """Deterministically fill every address space with seeded bytes —
    spaces are filled in protocol-name order so engine and oracle memory
    images start identical."""
    rng = np.random.default_rng(mem_seed)
    for proto in sorted(mem.spaces, key=lambda p: p.value):
        buf = mem.spaces[proto]
        buf[:] = rng.integers(0, 256, size=buf.size, dtype=np.uint8)


# --------------------------------------------------------------------------
# Generation
# --------------------------------------------------------------------------

class _DstAllocator:
    """Disjoint destination-window allocator over the upper half of each
    address space (per submission)."""

    def __init__(self, sizes: Dict[Protocol, int]) -> None:
        self.sizes = sizes
        self.cursor = {p: sizes[p] // 2 for p in sizes}

    def reset(self) -> None:
        for p in self.sizes:
            self.cursor[p] = self.sizes[p] // 2

    def alloc(self, proto: Protocol, length: int, gap: int) -> Optional[int]:
        start = self.cursor[proto] + gap
        if start + length > self.sizes[proto]:
            return None
        self.cursor[proto] = start + length
        return start

    def high_water(self, proto: Protocol) -> int:
        return self.cursor[proto]


def _pick_len(rng: np.random.Generator, bus: int, no_burst: bool) -> int:
    """Weighted transfer-length mix: sub-beat, bus-aligned, page-straddling
    and multi-burst lengths all show up."""
    kind = rng.choice(5, p=[0.25, 0.2, 0.2, 0.25, 0.1])
    if kind == 0:                          # tiny / unaligned
        n = int(rng.integers(1, 2 * bus + 1))
    elif kind == 1:                        # exact beats
        n = bus * int(rng.integers(1, 9))
    elif kind == 2:                        # around the 4 KiB page cut
        n = int(rng.integers(4096 - 8, 4096 + 9))
    elif kind == 3:                        # medium
        n = int(rng.integers(1, 1025))
    else:                                  # large multi-burst
        n = int(rng.integers(1024, 8193))
    if no_burst:
        n = min(n, 256)
    return max(1, n)


def _spec_for(seed: int, family: str,
              rng: np.random.Generator) -> EngineSpec:
    policy = ErrorPolicy(
        action=str(rng.choice(["replay", "continue", "abort"],
                              p=[0.5, 0.25, 0.25])),
        max_replays=int(rng.integers(0, 4)),
        replay_backoff=int(rng.choice([0, 5, 17])))
    irq = IrqSpec(coalesce_count=int(rng.choice([1, 2, 4])),
                  coalesce_cycles=int(rng.choice([0, 0, 32])),
                  vectors=int(rng.choice([0, 1, 2])))

    if family != "custom":
        hi = 5 if family == "edge_ai" else 4
        spec = preset(family, num_channels=int(rng.integers(1, hi)))
        return dataclasses.replace(
            spec,
            backend=dataclasses.replace(spec.backend, error_policy=policy),
            irq=irq)

    n_spaces = int(rng.integers(1, 3))
    picks = rng.choice(len(_CUSTOM_SPACES), size=n_spaces, replace=False)
    mem_spaces = tuple(_CUSTOM_SPACES[i] for i in sorted(picks))
    bus = int(rng.choice([4, 8, 16]))

    pipe = []
    roll = rng.random()
    if roll < 0.3:
        pipe.append(MpSplitStage(boundary=int(rng.choice([1024, 4096])),
                                 which=str(rng.choice(["dst", "both"]))))
    elif roll < 0.4:
        pipe.append(MpSplitStage(boundary=4096))
        pipe.append(MpDistStage(num_ports=2, scheme="round_robin"))
    elif roll < 0.5:
        pipe.append(RtReplicateStage(period=64, horizon=128))

    num_ports, boundary = 1, 0
    if rng.random() < 0.15:
        num_ports, boundary = 2, 4096

    count = int(rng.integers(1, 4))
    scheme, ch_boundary = "round_robin", 0
    if count > 1 and rng.random() < 0.25:
        scheme, ch_boundary = "address", 1 << 13

    systems = (SRAM, HBM, PULP_L2)
    return EngineSpec(
        name=f"fuzz_custom_{seed}",
        midend=tuple(pipe),
        backend=BackendSpec(num_ports=num_ports, boundary=boundary,
                            bus_width=bus,
                            protocols=tuple(p for p, _ in mem_spaces),
                            error_policy=policy),
        channels=ChannelSpec(count=count, scheme=scheme,
                             boundary=ch_boundary),
        irq=irq,
        src_system=systems[int(rng.integers(0, len(systems)))],
        dst_system=systems[int(rng.integers(0, len(systems)))],
        mem_spaces=mem_spaces,
    )


def _gen_nd(rng: np.random.Generator, spaces: Dict[Protocol, int],
            alloc: _DstAllocator, bus: int) -> Optional[Submission]:
    protos = [p for p in spaces if p not in _NO_BURST] or list(spaces)
    proto = protos[int(rng.integers(0, len(protos)))]
    inner = int(rng.integers(1, 4 * bus + 1)) * max(1, bus // 4)
    ndims = int(rng.integers(1, 3))
    dims: List[TensorDim] = []
    span = inner
    for _ in range(ndims):
        reps = int(rng.integers(2, 5))
        stride = span + int(rng.integers(0, 2 * bus + 1))
        dims.append(TensorDim(src_stride=stride, dst_stride=stride,
                              reps=reps))
        span = stride * (reps - 1) + span
    dst = alloc.alloc(proto, span, gap=int(rng.integers(0, 65)))
    if dst is None:
        return None
    half = spaces[proto] // 2
    if span >= half:
        return None
    src = int(rng.integers(0, half - span))
    nd = NdTransfer(src_addr=src, dst_addr=dst, inner_length=inner,
                    dims=tuple(dims), src_protocol=proto,
                    dst_protocol=proto)
    row = Row(src=src, dst=dst, length=span, src_proto=proto,
              dst_proto=proto)
    return Submission(kind="nd", rows=(row,), nd=nd)


def generate_program(seed: int, family: Optional[str] = None) -> Program:
    """Generate the deterministic program for ``seed`` (optionally pinned
    to one family: a preset name or ``"custom"``)."""
    fam = family or FAMILIES[seed % len(FAMILIES)]
    rng = np.random.default_rng(np.random.SeedSequence([0x1D3A, seed]))
    spec = _spec_for(seed, fam, rng)

    spaces = dict(spec.mem_spaces)
    mem_protos = list(spaces)
    alloc = _DstAllocator(spaces)
    bus = spec.backend.bus_width

    submissions: List[Submission] = []
    max_used = {p: spaces[p] // 2 for p in spaces}
    n_subs = int(rng.integers(1, 4))
    for _ in range(n_subs):
        for p in spaces:
            max_used[p] = max(max_used[p], alloc.high_water(p))
        alloc.reset()
        kind = str(rng.choice(["batch", "batch", "batch", "single", "nd"]))
        if kind == "nd":
            sub = _gen_nd(rng, spaces, alloc, bus)
            if sub is not None:
                submissions.append(sub)
            continue

        n_rows = 1 if kind == "single" else int(rng.integers(1, 25))
        use_init = rng.random() < 0.2
        options = None
        if use_init:
            patterns = list(InitPattern)
            options = BackendOptions(
                init_pattern=patterns[int(rng.integers(0, len(patterns)))],
                init_value=int(rng.integers(0, 1 << 31)))
        rows: List[Row] = []
        for _ in range(n_rows):
            dst_proto = mem_protos[int(rng.integers(0, len(mem_protos)))]
            if use_init and rng.random() < 0.5:
                src_proto = Protocol.INIT
            else:
                src_proto = mem_protos[int(rng.integers(0, len(mem_protos)))]
            no_burst = src_proto in _NO_BURST or dst_proto in _NO_BURST
            length = _pick_len(rng, bus, no_burst)
            dst = alloc.alloc(dst_proto, length, gap=int(rng.integers(0, 65)))
            if dst is None:
                continue
            if src_proto is Protocol.INIT:
                src = int(rng.integers(0, 1 << 16))
            else:
                half = spaces[src_proto] // 2
                if length >= half:
                    continue
                src = int(rng.integers(0, half - length))
            max_burst = 0
            if rng.random() < 0.2 and not no_burst:
                max_burst = int(rng.choice([64, 256]))
            rows.append(Row(src=src, dst=dst, length=length,
                            src_proto=src_proto, dst_proto=dst_proto,
                            max_burst=max_burst))
        if rows:
            submissions.append(Submission(kind=kind, rows=tuple(rows),
                                          options=options))

    if not submissions:        # degenerate seed: one guaranteed tiny row
        proto = mem_protos[0]
        half = spaces[proto] // 2
        submissions.append(Submission(kind="batch", rows=(
            Row(src=0, dst=half, length=bus, src_proto=proto,
                dst_proto=proto),)))

    # -- illegal row: destination out-of-bounds-high, beyond every
    #    allocated window of its space --------------------------------------
    if rng.random() < 0.3:
        si = int(rng.integers(0, len(submissions)))
        sub = submissions[si]
        if sub.kind != "nd" and sub.rows:
            ri = len(sub.rows) - 1
            r = sub.rows[ri]
            if r.dst_proto in spaces:
                size = spaces[r.dst_proto]
                over = int(rng.integers(1, min(r.length, 64) + 1)) \
                    if r.length > 1 else 1
                dst = size - r.length + over
                high = max(max_used[r.dst_proto],
                           alloc.high_water(r.dst_proto))
                if dst > high and dst >= 0:
                    rows = list(sub.rows)
                    rows[ri] = dataclasses.replace(r, dst=dst)
                    sub.rows = tuple(rows)

    # -- seeded fault sites -------------------------------------------------
    fault_sites: List[FaultSite] = []
    if rng.random() < 0.45:
        total_rows = sum(s.num_rows for s in submissions)
        hi = max(4 * total_rows, 4)
        for _ in range(int(rng.integers(1, 4))):
            kind = str(rng.choice(["transient", "persistent", "stall"],
                                  p=[0.5, 0.25, 0.25]))
            site = FaultSite(
                index=int(rng.integers(0, hi)),
                kind=kind,
                hits=int(rng.integers(1, 3)) if kind == "transient" else 1,
                stall_cycles=int(rng.integers(5, 51))
                if kind == "stall" else 0)
            fault_sites.append(site)

    return Program(seed=seed, family=fam, spec=spec,
                   submissions=submissions, fault_sites=fault_sites,
                   mem_seed=int(rng.integers(0, 1 << 31)))


# --------------------------------------------------------------------------
# Racy family — programs the sanitizer MUST flag
# --------------------------------------------------------------------------

#: deliberately hazardous program shapes, indexed by ``seed % len(...)``.
#: Each kind carries a *guaranteed-divergence* construction: the flagged
#: hazard provably changes observable bytes (cross-channel kinds under an
#: adversarial drain schedule; ``intra-raw`` between the engine's binned
#: vectorized execution and the scalar oracle's row-sequential one).
#: Kinds whose outcome the engine and oracle can legitimately agree on
#: (intra-submission WAW — numpy scatter is last-row-wins, same as
#: sequential; intra-row src/dst overlap — both paths prefetch the full
#: source) are deliberately absent.
RACY_KINDS: Tuple[str, ...] = ("cross-ww", "cross-rw", "dispatch-ww",
                               "intra-raw")

#: the diagnostic code `repro_torch.sanitize.check_engine` must report per kind
RACY_EXPECT: Dict[str, str] = {
    "cross-ww": "H003",
    "cross-rw": "H003",
    "dispatch-ww": "H003",
    "intra-raw": "H001",
}


def _racy_spec(seed: int, channels: int) -> EngineSpec:
    """A deliberately plain host spec for the racy rows: one AXI4 space,
    default policy, no mid-end, no faults — the *only* interesting thing
    about a racy program is its hazard."""
    return EngineSpec(
        name=f"racy_{seed}",
        backend=BackendSpec(protocols=(Protocol.AXI4,)),
        channels=ChannelSpec(count=channels),
        mem_spaces=((Protocol.AXI4, 64 << 10),),
    )


def generate_racy_program(seed: int) -> Tuple[Program, str]:
    """The deterministic racy program for ``seed``.

    Returns ``(program, expected_code)`` — the sanitizer must flag the
    program with ``expected_code``, and `repro_torch.verify.adversary` must
    observe actual byte divergence (or classify the overlap as a benign
    same-value write, which seeded random fill makes vanishingly rare).
    """
    kind = RACY_KINDS[seed % len(RACY_KINDS)]
    rng = np.random.default_rng(np.random.SeedSequence([0x7ACE, seed]))
    proto = Protocol.AXI4
    space = 64 << 10
    half = space // 2

    # Every address is 512-aligned and every length is a multiple of 8
    # capped at 256 B, so no row ever straddles a 4 KiB page: the
    # legalizer emits exactly one burst per row, and same-length rows
    # land in the same vectorized execution bin — which is what makes
    # the intra-raw kind's engine-vs-oracle divergence a *guarantee*
    # rather than an alignment accident.
    length = int(rng.integers(4, 33)) * 8
    # victim window W in the upper half, with headroom for cross-rw's
    # reader destination at w + 4 * length
    w = half + int(rng.integers(0, half // 512 - 4)) * 512
    delta = int(rng.integers(1, length // 8)) * 8
    # disjoint sources in the lower half
    src_a = int(rng.integers(0, half // 2 // 512)) * 512
    src_b = (half // 2) + int(rng.integers(0, half // 2 // 512 - 1)) * 512

    def row(src: int, dst: int, n: int = length) -> Row:
        return Row(src=src, dst=dst, length=n, src_proto=proto,
                   dst_proto=proto)

    if kind == "cross-ww":
        # two async singles land on channels 0 and 1 (round-robin) and
        # write overlapping windows — drain order decides the bytes
        subs = [Submission(kind="single", rows=(row(src_a, w),)),
                Submission(kind="single", rows=(row(src_b, w + delta),))]
        channels = 2
    elif kind == "cross-rw":
        # channel 0 writes W while channel 1 reads a window overlapping W
        # (into a disjoint destination) — drain order decides whether the
        # reader sees pre- or post-write bytes
        rd_dst = w + 4 * length
        subs = [Submission(kind="single", rows=(row(src_a, w),)),
                Submission(kind="single", rows=(row(w + delta, rd_dst),))]
        channels = 2
    elif kind == "dispatch-ww":
        # one dispatch_batch sharded round-robin across two channels:
        # rows 0 and 1 write overlapping windows from different channels
        subs = [Submission(kind="batch",
                           rows=(row(src_a, w), row(src_b, w + delta)))]
        channels = 2
    else:   # intra-raw
        # one single-channel batch: row 1 reads bytes row 0 writes.  The
        # rows share a length, so the engine's binned execution gathers
        # both sources before either scatter — the scalar oracle's
        # row-sequential semantics read row 0's output instead.
        subs = [Submission(kind="batch",
                           rows=(row(src_a, w), row(w + delta, src_b)))]
        channels = 1

    program = Program(seed=seed, family="racy",
                      spec=_racy_spec(seed, channels),
                      submissions=subs, fault_sites=[],
                      mem_seed=int(rng.integers(0, 1 << 31)))
    return program, RACY_EXPECT[kind]
