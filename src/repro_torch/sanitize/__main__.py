"""CLI: ``python -m repro_torch.sanitize``.

Three entry points:

* ``--demo`` — a deliberately racy two-channel program, printed with its
  diagnostics: the quickstart example (exit 0; the demo *showing* the
  hazard is the success case);
* ``--corpus`` — sweep every descriptor program the repo itself
  constructs (KV-cache gather/append templates, all four collective
  fabric schedules, the data-plane scatter/gather benchmark stream, the
  §4.4 fragmented-copy stream, the named spec presets) and exit non-zero
  iff any is hazardous.  This is the CI gate that keeps the repo's own
  programs certified race-free;
* ``--fuzz-racy N`` — generate N deliberately racy programs
  (`repro_torch.verify.generator.generate_racy_program`) and exit non-zero
  unless *every one* is flagged with its expected hazard code.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import (DescriptorBatch, Protocol, build_engine,
                              make_fragmented_batch, preset)
from repro_torch.core.spec import PRESETS

from . import (Report, SanitizeError, check_batch, check_engine,
               check_spec)


def _demo(log=print) -> int:
    """The quickstart: two overlapping writes dispatched to different
    channels of one engine — flagged before a byte moves."""
    from repro_torch.core.descriptor import Transfer1D
    from repro_torch.core.spec import BackendSpec, ChannelSpec, EngineSpec

    spec = EngineSpec(
        name="demo",
        backend=BackendSpec(protocols=(Protocol.AXI4,)),
        channels=ChannelSpec(count=2),
        mem_spaces=((Protocol.AXI4, 1 << 16),))
    engine = build_engine(spec, sanitize=True)
    # channel 0 writes [0x8000, 0x8100); channel 1 writes [0x8080, 0x8180)
    engine.submit_async(Transfer1D(src_addr=0x0000, dst_addr=0x8000,
                                   length=256))
    engine.submit_async(Transfer1D(src_addr=0x1000, dst_addr=0x8080,
                                   length=256))
    log("two 256-B writes, overlapping at [0x8080, 0x8100), dispatched")
    log("round-robin to channels 0 and 1 — drain order decides the bytes:")
    log("")
    try:
        engine.wait_all()
    except SanitizeError as err:
        log(err.report.format())
        return 0
    log("UNEXPECTED: the demo program was not flagged")
    return 1


def _corpus_entries():
    """Yield ``(name, thunk)`` pairs; each thunk returns a `Report`."""
    from repro_torch.serve.kvcache import (KVLayout, append_descriptors,
                                           gather_descriptors)

    layout = KVLayout(n_pages=64, page_size=16, n_kv_heads=4, head_dim=32)
    rng = np.random.default_rng(0)
    # 8 sequences x 4 pages of distinct physical pages — the allocator
    # never double-books a page, which is exactly what the sweep certifies
    table = rng.permutation(64)[:32].reshape(8, 4).astype(np.int32)

    yield ("kvcache.gather_descriptors", lambda: check_batch(
        gather_descriptors(layout, table, max_len=64)))
    yield ("kvcache.append_descriptors", lambda: check_batch(
        append_descriptors(layout, table, pos=17)))

    def collectives() -> Report:
        from repro_torch.dist.fabric import CollectiveFabric
        total = Report()
        x = np.arange(256, dtype=np.float32)
        for op in ("allgather", "allreduce", "alltoall"):
            fab = CollectiveFabric(4, region_bytes=1 << 14, channels=2,
                                   sanitize=True)
            if op == "allgather":
                fab.allgather([x + r for r in range(4)])
            elif op == "allreduce":
                fab.allreduce([x + r for r in range(4)])
            else:
                fab.alltoall([np.stack([x + 10 * r + c for c in range(4)])
                              for r in range(4)])
            for _, report in fab.sanitize_reports:
                total.merge(report)
        # transport: every rank moves bytes within its own region
        fab = CollectiveFabric(4, region_bytes=1 << 14, channels=2,
                               sanitize=True)
        batches = []
        for r in range(4):
            base = r * fab.region_bytes
            batches.append(DescriptorBatch.from_arrays(
                np.asarray([base], dtype=np.int64),
                np.asarray([base + 4096], dtype=np.int64),
                np.asarray([2048], dtype=np.int64),
                src_protocol=fab.proto, dst_protocol=fab.proto))
        fab.transport(batches)
        for _, report in fab.sanitize_reports:
            total.merge(report)
        return total

    yield ("dist.collectives[allgather,allreduce,alltoall,transport]",
           collectives)

    def scatter_gather() -> Report:
        # the data-plane benchmark stream (disjoint per-burst slots):
        # every burst owns its source and destination slot, so the sweep
        # must certify it order-independent
        n, slot = 100_000, 64
        srng = np.random.default_rng(0)
        return check_batch(DescriptorBatch.from_arrays(
            src_addr=srng.permutation(n).astype(np.int64) * slot,
            dst_addr=srng.permutation(n).astype(np.int64) * slot,
            length=srng.integers(1, slot + 1, n).astype(np.int64),
            src_protocol=Protocol.HBM, dst_protocol=Protocol.VMEM))

    yield ("benchmarks.scatter_gather_stream[100k]", scatter_gather)

    # §4.4 fragmented copy is a deliberate src==dst identity stream — the
    # H005 self-overlap is intentional (every write re-writes the byte it
    # read), so it rides with an explicit suppression, counted in the
    # report rather than silently dropped
    yield ("core.make_fragmented_batch[64KiB/67B] (H005 suppressed)",
           lambda: check_batch(make_fragmented_batch(1 << 16, 67),
                               suppress=("H005",)))

    def presets() -> Report:
        total = Report()
        for name in PRESETS:
            total.merge(check_spec(preset(name)))
        return total

    yield ("spec.presets[" + ",".join(PRESETS) + "]", presets)


def _corpus(log=print) -> int:
    failures = 0
    for name, thunk in _corpus_entries():
        report = thunk()
        status = "clean" if report.clean else "HAZARDOUS"
        extra = ""
        if report.suppressed:
            extra += " " + " ".join(f"suppressed:{c}x{n}" for c, n
                                    in sorted(report.suppressed.items()))
        if report.codes:
            extra += f" codes={','.join(report.codes)}"
        log(f"  {status:9s} {name} ({report.checked_rows} rows{extra})")
        if not report.clean:
            failures += 1
            log(report.format(limit=5))
    log(f"corpus: {failures} hazardous program(s)")
    return 1 if failures else 0


def _fuzz_racy(n: int, log=print) -> int:
    from repro_torch.verify.generator import generate_racy_program

    missed = 0
    for seed in range(n):
        program, expected = generate_racy_program(seed)
        engine = build_engine(program.spec)
        for sub in program.submissions:
            payload = sub.materialize()
            if sub.kind == "batch":
                engine.dispatch_batch(payload)
            else:
                engine.submit_async(payload)
        report = check_engine(engine)
        if report.clean or not report.has(expected):
            missed += 1
            log(f"  seed {seed}: expected {expected}, "
                f"got {report.codes or '(clean)'}")
    log(f"fuzz-racy: {n - missed}/{n} flagged with the expected code")
    return 1 if missed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.sanitize",
        description="static descriptor-program race detector")
    parser.add_argument("--demo", action="store_true",
                        help="flag a racy two-channel example and exit")
    parser.add_argument("--corpus", action="store_true",
                        help="sweep every in-repo descriptor program; "
                             "exit non-zero iff any is hazardous")
    parser.add_argument("--fuzz-racy", type=int, default=None, metavar="N",
                        help="require N generated racy programs all "
                             "flagged with their expected codes")
    args = parser.parse_args(argv)

    if not (args.demo or args.corpus or args.fuzz_racy is not None):
        parser.print_help()
        return 0
    rc = 0
    if args.demo:
        rc = max(rc, _demo())
    if args.corpus:
        rc = max(rc, _corpus())
    if args.fuzz_racy is not None:
        rc = max(rc, _fuzz_racy(args.fuzz_racy))
    return rc


if __name__ == "__main__":
    sys.exit(main())
