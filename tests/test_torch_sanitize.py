"""The port's static sanitizer (`repro_torch.sanitize`) against the
reference's (`repro.sanitize`), on the cases of `tests/test_sanitize.py`,
`tests/test_sanitize_differential.py` and the H007 / P003 cases of
`tests/test_vm.py`.

Each case is a function of a package bundle (`repro` or `repro_torch`):
it builds the same batches, specs, engines and fabrics from the same
NumPy inputs, checks what the reference test checks, and returns what it
saw.  The two packages' `Report` and `Diagnostic` are different classes,
so reports are compared as plain tuples: codes, every diagnostic's code,
severity and fields, ``checked_rows``, ``suppressed`` and notes.  The
same holds for every ``--corpus`` entry and every ``--fuzz-racy`` seed in
0-63.
"""

import contextlib
import dataclasses
import importlib
import io
import types
import warnings

import numpy as np
import pytest


def pkg(root):
    """The modules of one package that the cases use."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, core=m("core"), desc=m("core.descriptor"),
        spec=m("core.spec"), S=m("sanitize"), fabric=m("dist.fabric"),
        kv=m("serve.kvcache"), main=m("sanitize.__main__"),
        verify=m("verify"), generator=m("verify.generator"),
        adversary=m("verify.adversary"), harness=m("verify.harness"))


J, T = pkg("repro"), pkg("repro_torch")


def rsnap(report):
    """A report as plain tuples, equal across the two packages."""
    return (report.codes, report.clean,
            tuple((d.code, d.severity) for d in report.diagnostics),
            dataclasses.astuple(report))


def text(s):
    return s.replace("repro_torch", "repro")


def raised(fn):
    """What ``fn`` raised: a `SanitizeError`'s report, or the type and
    message of any other exception."""
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - the snapshot compares it
        if type(e).__name__ == "SanitizeError":
            return ("SanitizeError", rsnap(e.report))
        return (type(e).__name__, text(str(e)))
    return None


def rows(P, *triples, src_p="AXI4", dst_p="AXI4"):
    s, d, ln = (np.asarray(c, dtype=np.int64) for c in zip(*triples))
    return P.core.DescriptorBatch.from_arrays(
        s, d, ln, src_protocol=P.core.Protocol[src_p],
        dst_protocol=P.core.Protocol[dst_p])


def spec2ch(P, channels=2, name="t"):
    AXI = P.core.Protocol.AXI4
    return P.spec.EngineSpec(
        name=name, backend=P.spec.BackendSpec(protocols=(AXI,)),
        channels=P.spec.ChannelSpec(count=channels),
        mem_spaces=((AXI, 1 << 16),))


def t1d(P, src, dst, length):
    return P.desc.Transfer1D(src_addr=src, dst_addr=dst, length=length)


# -- the hazard sweep: the classification matrix -----------------------------

def disjoint_rows_clean(P):
    r = P.S.check_batch(rows(P, (0, 0x1000, 64), (0x100, 0x2000, 64)))
    assert r.clean and r.codes == () and r.checked_rows == 2
    return rsnap(r)


def h001_read_after_write(P):
    r = P.S.check_batch(rows(P, (0, 0x1000, 64), (0x1000, 0x3000, 64)))
    assert r.codes == ("H001",)
    d = r.select("H001")[0]
    assert d.window == (0x1000, 0x1040)
    assert d.a.op == "write" and d.b.op == "read"
    return rsnap(r)


def h004_write_after_read(P):
    r = P.S.check_batch(rows(P, (0x1000, 0x3000, 64), (0, 0x1000, 64)))
    assert r.codes == ("H004",)
    return rsnap(r)


def h002_write_after_write(P):
    r = P.S.check_batch(rows(P, (0, 0x1000, 64), (0x100, 0x1020, 64)))
    assert r.codes == ("H002",)
    assert r.select("H002")[0].window == (0x1020, 0x1040)
    return rsnap(r)


def h005_self_overlap(P):
    r = P.S.check_batch(rows(P, (0x1000, 0x1020, 64)))
    assert r.codes == ("H005",)
    return rsnap(r)


def h003_cross_channel(P):
    units = [P.S.Unit(rows(P, (0, 0x1000, 64)), channel=0, item=0),
             P.S.Unit(rows(P, (0x100, 0x1020, 64)), channel=1, item=1)]
    r = P.S.check_units(units)
    assert r.codes == ("H003",)
    return rsnap(r)


def same_channel_fifo_allowed(P):
    units = [P.S.Unit(rows(P, (0, 0x1000, 64)), channel=0, item=0),
             P.S.Unit(rows(P, (0x100, 0x1020, 64)), channel=0, item=1)]
    r = P.S.check_units(units)
    assert r.clean
    return rsnap(r)


def h006_cross_engine(P):
    r = P.S.check_phase([rows(P, (0, 0x1000, 64)),
                         rows(P, (0x100, 0x1020, 64))])
    assert r.codes == ("H006",)
    r2 = P.S.check_phase({0: rows(P, (0, 0x1000, 64)),
                          1: rows(P, (0x100, 0x1020, 64))})
    assert r2.codes == ("H006",)
    return rsnap(r), rsnap(r2)


def cross_protocol_never_collides(P):
    units = [P.S.Unit(rows(P, (0, 0x1000, 64), dst_p="AXI4")),
             P.S.Unit(rows(P, (0, 0x1000, 64), dst_p="OBI"), item=1)]
    r = P.S.check_units(units)
    assert r.clean
    return rsnap(r)


def mixed_protocol_rows_within_one_batch(P):
    b = P.core.DescriptorBatch.from_arrays(
        np.asarray([0, 0x100], np.int64),
        np.asarray([0x1000, 0x1020], np.int64),
        np.asarray([64, 64], np.int64),
        src_proto=np.asarray([2, 3], np.uint8),
        dst_proto=np.asarray([2, 2], np.uint8))
    r = P.S.check_batch(b)
    assert "H002" in r.codes
    return rsnap(r)


def generator_source_has_no_read_interval(P):
    b = P.core.DescriptorBatch.from_arrays(
        np.asarray([0x1000, 0], np.int64),
        np.asarray([0x1000, 0x3000], np.int64),
        np.asarray([64, 64], np.int64),
        src_protocol=P.core.Protocol.INIT,
        dst_protocol=P.core.Protocol.AXI4)
    r = P.S.check_batch(b)
    assert r.clean
    return rsnap(r)


def zero_length_rows_ignored(P):
    r = P.S.check_batch(rows(P, (0, 0x1000, 0), (0, 0x1000, 0)))
    assert r.clean
    return rsnap(r)


def read_read_overlap_never_flagged(P):
    r = P.S.check_batch(rows(P, (0x500, 0x1000, 64), (0x500, 0x2000, 64)))
    assert r.clean
    return rsnap(r)


def touching_intervals_do_not_overlap(P):
    r = P.S.check_batch(rows(P, (0, 0x1000, 64), (0x100, 0x1040, 64)))
    assert r.clean
    return rsnap(r)


# -- sweep controls ----------------------------------------------------------

def suppress_counts(P):
    r = P.S.check_batch(rows(P, (0x1000, 0x1020, 64)), suppress=("H005",))
    assert r.clean and r.suppressed == {"H005": 1}
    return rsnap(r)


def unknown_suppress_code_rejected(P):
    err = raised(lambda: P.S.check_batch(rows(P, (0, 0x1000, 64)),
                                         suppress=("H999",)))
    assert err[0] == "ValueError" and "unknown diagnostic code" in err[1]
    return err


def per_code_limit_with_note(P):
    b = rows(P, *[(i * 0x100, 0x1000, 64) for i in range(6)])
    r = P.S.check_batch(b, limit=3)
    assert len(r.select("H002")) == 3
    assert any("more than 3 instances" in n for n in r.notes)
    return rsnap(r)


def budget_exhaustion_note(P):
    b = rows(P, *[(i * 0x100, 0x1000, 64) for i in range(8)])
    r = P.S.check_batch(b, budget=4)
    assert any("budget exhausted" in n for n in r.notes)
    return rsnap(r)


def fragmented_batch_needs_h005_suppression(P):
    b = P.core.make_fragmented_batch(1 << 12, 67)
    loud = P.S.check_batch(b)
    assert loud.has("H005")
    r = P.S.check_batch(b, suppress=("H005",))
    assert r.clean and r.suppressed["H005"] == len(b)
    return rsnap(loud), rsnap(r)


def report_format_and_merge(P):
    r = P.S.check_batch(rows(P, (0, 0x1000, 64), (0x100, 0x1020, 64)))
    out = r.format()
    assert "HAZARDOUS" in out and "H002" in out
    total = P.S.Report()
    total.merge(r).merge(P.S.check_batch(rows(P, (0, 0x7000, 64))))
    assert total.checked_rows == 3 and total.codes == ("H002",)
    return text(out), rsnap(total), text(total.format(limit=0))


def severity_model(P):
    assert P.S.severity("H003") == "error"
    assert P.S.severity("P001") == "error"
    assert P.S.severity("S002") == "warning"
    assert set(P.S.CODES) == {f"H00{i}" for i in range(1, 8)} | \
        {f"S00{i}" for i in range(1, 6)} | {"P001", "P002", "P003"}
    return dict(P.S.CODES), [P.S.severity(c) for c in sorted(P.S.CODES)]


def warnings_keep_report_clean(P):
    spec = spec2ch(P)
    bad = P.spec.EngineSpec(
        name="warn", backend=spec.backend,
        channels=P.spec.ChannelSpec(count=1),
        irq=P.spec.IrqSpec(vectors=4), mem_spaces=spec.mem_spaces)
    r = P.S.check_spec(bad)
    assert r.has("S004") and r.clean
    return rsnap(r)


# -- payload normalisation ---------------------------------------------------

def as_batch_transfer1d(P):
    b = P.S.as_batch(t1d(P, 0, 0x100, 32))
    assert len(b) == 1 and int(b.length[0]) == 32
    return b.src_addr.tolist(), b.dst_addr.tolist(), b.length.tolist()


def as_batch_nd(P):
    nd = P.desc.NdTransfer(src_addr=0, dst_addr=0x1000, inner_length=64,
                           dims=(P.desc.TensorDim(src_stride=256,
                                                  dst_stride=64, reps=4),))
    b = P.S.as_batch(nd)
    assert len(b) == 4
    r = P.S.check_batch(b)
    assert r.clean
    return b.src_addr.tolist(), b.dst_addr.tolist(), rsnap(r)


def as_batch_rejects_unknown(P):
    err = raised(lambda: P.S.as_batch(object()))
    assert err[0] == "TypeError" and "cannot sanitize" in err[1]
    return err[0]


def channel_units_mirror_dispatch(P):
    b = rows(P, (0, 0x1000, 64), (0x100, 0x1020, 64))
    units = P.S.channel_units(b, 2)
    assert [u.channel for u in units] == [0, 1]
    r = P.S.check_units(units)
    assert r.codes == ("H003",)
    return [(u.channel, u.item, u.engine) for u in units], rsnap(r)


# -- S codes: spec lint ------------------------------------------------------

def presets_all_clean(P):
    out = {}
    for name in P.spec.PRESETS:
        r = P.S.check_spec(P.core.preset(name))
        assert not r.diagnostics, (name, r.codes)
        out[name] = rsnap(r)
    return out


def s003_port_without_backing_space(P):
    pr = P.core.Protocol
    spec = P.spec.EngineSpec(
        name="s3", backend=P.spec.BackendSpec(protocols=(pr.AXI4, pr.OBI)),
        mem_spaces=((pr.AXI4, 1 << 14),))
    r = P.S.check_spec(spec)
    assert r.has("S003")
    return rsnap(r)


def s004_excess_irq_vectors(P):
    AXI = P.core.Protocol.AXI4
    spec = P.spec.EngineSpec(
        name="s4", backend=P.spec.BackendSpec(protocols=(AXI,)),
        channels=P.spec.ChannelSpec(count=2),
        irq=P.spec.IrqSpec(vectors=5), mem_spaces=((AXI, 1 << 14),))
    r = P.S.check_spec(spec)
    assert r.has("S004")
    return rsnap(r)


def s005_replay_with_zero_budget(P):
    AXI = P.core.Protocol.AXI4
    spec = P.spec.EngineSpec(
        name="s5", backend=P.spec.BackendSpec(
            protocols=(AXI,),
            error_policy=P.core.ErrorPolicy(action="replay", max_replays=0)),
        mem_spaces=((AXI, 1 << 14),))
    r = P.S.check_spec(spec)
    assert r.has("S005")
    return rsnap(r)


def s002_plan_cache_multiport(P):
    AXI = P.core.Protocol.AXI4
    spec = P.spec.EngineSpec(
        name="s2", backend=P.spec.BackendSpec(protocols=(AXI,), num_ports=2,
                                              boundary=4096),
        plan_cache=True, mem_spaces=((AXI, 1 << 14),))
    r = P.S.check_spec(spec)
    assert r.has("S002")
    return rsnap(r)


# -- the engine's sanitize= modes, drain check and plan audit ----------------

def _submit_racy(P, engine):
    engine.submit_async(t1d(P, 0x0000, 0x8000, 256))
    engine.submit_async(t1d(P, 0x1000, 0x8080, 256))


def _engine_state(engine):
    return ([rsnap(r) for r in engine.sanitize_reports],
            [len(q) for q in engine._queues],
            bytes(engine.mem.spaces[next(iter(engine.mem.spaces))]))


def raise_mode_blocks_racy_drain(P):
    engine = P.core.build_engine(spec2ch(P), sanitize=True)
    mem = engine.mem.spaces[P.core.Protocol.AXI4]
    mem[:] = np.random.default_rng(1).integers(0, 256, mem.size, np.uint8)
    before = mem.copy()
    _submit_racy(P, engine)
    err = raised(engine.wait_all)
    assert err[0] == "SanitizeError" and err[1][0] == ("H003",)
    assert len(engine.sanitize_reports) == 1
    assert np.array_equal(mem, before)      # flagged before a byte moved
    return err, _engine_state(engine)


def warn_mode_drains_anyway(P):
    engine = P.core.build_engine(spec2ch(P), sanitize="warn")
    _submit_racy(P, engine)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine.wait_all()
    seen = [(w.category.__name__, text(str(w.message)), w.filename,
             w.lineno) for w in caught]
    assert any(c == "RuntimeWarning" and "H003" in m for c, m, _, _ in seen)
    assert not any(engine._queues)
    return seen, _engine_state(engine)


def clean_program_certified_and_drained(P):
    engine = P.core.build_engine(spec2ch(P), sanitize=True)
    engine.submit_async(t1d(P, 0, 0x8000, 256))
    engine.submit_async(t1d(P, 0x1000, 0x9000, 256))
    engine.wait_all()
    assert not any(engine._queues)
    assert len(engine.sanitize_reports) == 1
    assert engine.sanitize_reports[0].clean
    return _engine_state(engine)


def off_by_default(P):
    engine = P.core.build_engine(spec2ch(P))
    _submit_racy(P, engine)
    engine.wait_all()
    assert engine.sanitize_reports == []
    return _engine_state(engine), engine.sanitize


def invalid_mode_rejected(P):
    err = raised(lambda: P.core.build_engine(spec2ch(P), sanitize="loud"))
    assert err[0] == "ValueError" and "sanitize must be" in err[1]
    return err


def same_channel_pipeline_not_flagged(P):
    engine = P.core.build_engine(spec2ch(P, channels=1), sanitize=True)
    engine.submit_async(t1d(P, 0, 0x8000, 64))
    engine.submit_async(t1d(P, 0x8000, 0x9000, 64))
    engine.wait_all()
    assert engine.sanitize_reports[0].clean
    return _engine_state(engine)


def _audit_engine(P):
    return P.core.build_engine(spec2ch(P, channels=1), plan_cache=True,
                               sanitize=True)


def plan_hit_is_audited_clean(P):
    engine = _audit_engine(P)
    engine.submit_async(t1d(P, 0x0000, 0x8000, 300))
    engine.wait_all()
    engine.submit_async(t1d(P, 0x4000, 0xC000, 300))
    engine.wait_all()
    assert engine.plan_cache.stats.hits == 1
    audits = [r for r in engine.sanitize_reports if r.checked_rows == 1
              and not r.diagnostics]
    assert audits, "expected a clean plan-audit report on the hit"
    return _engine_state(engine), engine.plan_cache.stats.hits


def tampered_plan_flagged_p001(P):
    engine = _audit_engine(P)
    engine.submit_async(t1d(P, 0x0000, 0x8000, 300))
    engine.wait_all()
    plan = next(iter(engine.plan_cache._plans.values()))
    plan.length = plan.length.copy()
    plan.length[0] += 8

    def resubmit():
        engine.submit_async(t1d(P, 0x4000, 0xC000, 300))
        engine.wait_all()
    err = raised(resubmit)
    assert err[0] == "SanitizeError" and "P001" in err[1][0]
    return err, [rsnap(r) for r in engine.sanitize_reports]


def audit_replay_miss_returns_none(P):
    engine = _audit_engine(P)
    out = P.S.audit_replay(engine.plan_cache, t1d(P, 0, 0x8000, 300),
                           bus_width=engine.bus_width)
    assert out is None
    return out


# -- the collective fabric's phase certification -----------------------------

def _fabric(P):
    return P.fabric.CollectiveFabric(4, region_bytes=1 << 14, channels=2,
                                     sanitize=True)


def all_four_collectives_certified(P):
    x = np.arange(256, dtype=np.float32)
    shards = [x + r for r in range(4)]
    fab = _fabric(P)
    out, _ = fab.allgather(shards)
    np.testing.assert_array_equal(out[0], np.stack(shards))
    fab2 = _fabric(P)
    red, _ = fab2.allreduce(shards)
    np.testing.assert_allclose(red[0], sum(shards))
    fab3 = _fabric(P)
    a2a, _ = fab3.alltoall([np.stack([x + 10 * r + c for c in range(4)])
                            for r in range(4)])
    fab4 = _fabric(P)
    base = [r * fab4.region_bytes for r in range(4)]
    fab4.transport([P.core.DescriptorBatch.from_arrays(
        np.asarray([b], np.int64), np.asarray([b + 4096], np.int64),
        np.asarray([2048], np.int64),
        src_protocol=fab4.proto, dst_protocol=fab4.proto) for b in base])
    reports = []
    for fab_i in (fab, fab2, fab3, fab4):
        assert fab_i.sanitize_reports
        for name, report in fab_i.sanitize_reports:
            assert report.clean, (name, report.codes)
            reports.append((name, rsnap(report)))
    return ([o.tobytes() for o in out + red + a2a], reports,
            bytes(fab4.engines[0].mem.spaces[fab4.proto]))


def corrupted_schedule_rejected(P):
    fab = _fabric(P)
    batches = [P.core.DescriptorBatch.from_arrays(
        np.asarray([r * fab.region_bytes], np.int64),
        np.asarray([0x100], np.int64), np.asarray([512], np.int64),
        src_protocol=fab.proto, dst_protocol=fab.proto) for r in range(4)]
    err = raised(lambda: fab.transport(batches))
    assert err[0] == "SanitizeError" and "H006" in err[1][0]
    return err


# -- the in-repo corpus and the CLI ------------------------------------------

def kv_templates_certified(P):
    layout = P.kv.KVLayout(n_pages=64, page_size=16, n_kv_heads=4,
                           head_dim=32)
    table = np.random.default_rng(0).permutation(64)[:32] \
        .reshape(8, 4).astype(np.int32)
    g = P.S.check_batch(P.kv.gather_descriptors(layout, table, max_len=64))
    a = P.S.check_batch(P.kv.append_descriptors(layout, table, pos=17))
    assert g.clean and a.clean
    return rsnap(g), rsnap(a)


def _cli(P, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = P.main.main(argv)
    return rc, text(out.getvalue())


def cli_demo_corpus_fuzz(P):
    runs = [_cli(P, ["--demo"]), _cli(P, ["--corpus"]),
            _cli(P, ["--fuzz-racy", "6"])]
    assert [rc for rc, _ in runs] == [0, 0, 0]
    out = "".join(o for _, o in runs)
    assert "H003" in out and "0 hazardous" in out and "6/6 flagged" in out
    return runs


def cli_no_args_prints_help(P):
    rc, out = _cli(P, [])
    assert rc == 0 and "--corpus" in out
    return rc, out


# -- the vm's H007 and P003 codes (tests/test_vm.py) -------------------------

PAGE = 4096


def _vm_table(P):
    return P.core.PageTable({P.core.Protocol.AXI4: PAGE})


def _vm_identity(P, n_pages):
    t = _vm_table(P)
    t.map_range(P.core.Protocol.AXI4, 0, 0, n_pages)
    return t


def _vm_spec(P, stage, name="vm_test"):
    AXI = P.core.Protocol.AXI4
    return P.spec.EngineSpec(
        name=name, midend=(stage,),
        backend=P.spec.BackendSpec(protocols=(AXI,), bus_width=8),
        channels=P.spec.ChannelSpec(count=1), mem_spaces=((AXI, 64 * PAGE),))


def h007_alias_audit_flags_translated_overlap(P):
    t, AXI = _vm_table(P), P.core.Protocol.AXI4
    for v, p in ((0, 2), (1, 2), (4, 4), (5, 5)):
        t.map(AXI, v, p)
    engine = P.core.build_engine(_vm_spec(P, P.core.TranslateStage(t)),
                                 plan_cache=False)
    engine.dispatch_batch(rows(P, (4 * PAGE, 0, 64), (5 * PAGE, PAGE, 64)))
    report = P.S.check_engine(engine)
    assert report.has("H007") and not report.clean
    engine.wait_all()
    return rsnap(report), engine.stats.completed


def h007_not_raised_for_virtual_plane_hazards(P):
    t = _vm_identity(P, 8)
    engine = P.core.build_engine(_vm_spec(P, P.core.TranslateStage(t)),
                                 plan_cache=False)
    engine.dispatch_batch(rows(P, (0, 4 * PAGE, 64), (PAGE, 4 * PAGE, 64)))
    report = P.S.check_engine(engine)
    assert report.has("H002") or report.has("H003")
    assert not report.has("H007")
    engine.wait_all()
    return rsnap(report)


def p003_stale_tlb_flagged_by_planaudit(P):
    t, AXI = _vm_identity(P, 16), P.core.Protocol.AXI4
    stage = P.core.TranslateStage(t, shootdown=False)
    engine = P.core.build_engine(_vm_spec(P, stage, "p003"), plan_cache=64)
    engine.dispatch_batch(rows(P, (0, 8 * PAGE, 64)))
    engine.wait_all()
    t.map(AXI, 0, 9)
    assert stage.audit_translations() != []
    miss = P.S.audit_replay(engine.plan_cache, rows(P, (0, 8 * PAGE, 64)),
                            bus_width=8, pipeline=engine.pipeline)
    assert miss is None
    plan = next(iter(engine.plan_cache._plans.values()))
    report = P.S.audit_plan(plan, rows(P, (0, 8 * PAGE, 64)), bus_width=8,
                            pipeline=engine.pipeline)
    assert report.has("P003")
    return rsnap(report)


def p003_clean_when_shootdown_wired(P):
    t, AXI = _vm_identity(P, 16), P.core.Protocol.AXI4
    stage = P.core.TranslateStage(t)
    engine = P.core.build_engine(_vm_spec(P, stage, "p003b"), plan_cache=64,
                                 sanitize=True)
    engine.dispatch_batch(rows(P, (0, 8 * PAGE, 64)))
    engine.wait_all()
    t.map(AXI, 0, 9)
    assert stage.audit_translations() == []
    return [rsnap(r) for r in engine.sanitize_reports]


CASES = [
    disjoint_rows_clean, h001_read_after_write, h004_write_after_read,
    h002_write_after_write, h005_self_overlap, h003_cross_channel,
    same_channel_fifo_allowed, h006_cross_engine,
    cross_protocol_never_collides, mixed_protocol_rows_within_one_batch,
    generator_source_has_no_read_interval, zero_length_rows_ignored,
    read_read_overlap_never_flagged, touching_intervals_do_not_overlap,
    suppress_counts, unknown_suppress_code_rejected,
    per_code_limit_with_note, budget_exhaustion_note,
    fragmented_batch_needs_h005_suppression, report_format_and_merge,
    severity_model, warnings_keep_report_clean,
    as_batch_transfer1d, as_batch_nd, as_batch_rejects_unknown,
    channel_units_mirror_dispatch,
    presets_all_clean, s003_port_without_backing_space,
    s004_excess_irq_vectors, s005_replay_with_zero_budget,
    s002_plan_cache_multiport,
    raise_mode_blocks_racy_drain, warn_mode_drains_anyway,
    clean_program_certified_and_drained, off_by_default,
    invalid_mode_rejected, same_channel_pipeline_not_flagged,
    plan_hit_is_audited_clean, tampered_plan_flagged_p001,
    audit_replay_miss_returns_none,
    all_four_collectives_certified, corrupted_schedule_rejected,
    kv_templates_certified, cli_demo_corpus_fuzz, cli_no_args_prints_help,
    h007_alias_audit_flags_translated_overlap,
    h007_not_raised_for_virtual_plane_hazards,
    p003_stale_tlb_flagged_by_planaudit, p003_clean_when_shootdown_wired,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_port_matches_the_reference(case):
    want, got = case(J), case(T)
    assert got == want


#: the reference's corpus, by name (thunks are not run at collection)
CORPUS = [name for name, _ in J.main._corpus_entries()]


@pytest.mark.parametrize("index", range(len(CORPUS)), ids=CORPUS)
def test_corpus_entry_report_equals_the_reference(index):
    entries = {}
    for P in (J, T):
        name, thunk = list(P.main._corpus_entries())[index]
        report = thunk()
        assert report.clean, (P.root, name, report.codes)
        entries[P.root] = (name, rsnap(report), text(report.format()))
    assert entries["repro_torch"] == entries["repro"]


def _racy_report(P, seed):
    program, expected = P.generator.generate_racy_program(seed)
    engine = P.core.build_engine(program.spec)
    for sub in program.submissions:
        payload = sub.materialize()
        if sub.kind == "batch":
            engine.dispatch_batch(payload)
        else:
            engine.submit_async(payload)
    report = P.S.check_engine(engine)
    assert not report.clean and report.has(expected), (seed, expected)
    return expected, program.describe(), rsnap(report)


@pytest.mark.parametrize("seed", range(64))
def test_fuzz_racy_report_equals_the_reference(seed):
    assert _racy_report(T, seed) == _racy_report(J, seed)


# -- the differential contract (tests/test_sanitize_differential.py) ---------

def verdict(d):
    """A divergence (or None) as text, equal across the two packages."""
    return None if d is None else text(str(d))


@pytest.mark.parametrize("seed", range(40))
def test_clean_programs_schedule_invariant(seed):
    got = [P.verify.check_differential(P.verify.generate_program(seed))
           for P in (J, T)]
    assert got[1] is None
    assert verdict(got[1]) == verdict(got[0])


@pytest.mark.parametrize("seed", range(20))
def test_racy_programs_flagged_and_diverge(seed):
    got = [P.verify.check_racy_seed(seed) for P in (J, T)]
    assert got[1] is None
    assert verdict(got[1]) == verdict(got[0])


def racy_kind_rotation_covered(P):
    kinds = {P.verify.generate_racy_program(s)[1] for s in range(12)}
    assert kinds == {P.generator.RACY_EXPECT[k] for k in P.verify.RACY_KINDS}
    return sorted(kinds)


def wrong_expectation_is_caught(P):
    program, _ = P.verify.generate_racy_program(0)
    d = P.adversary.check_racy_program(program, "H006")
    assert d is not None and "sanitize" in d.kind
    return verdict(d)


def racy_program_has_static_verdict(P):
    program, expected = P.verify.generate_racy_program(1)
    report = P.verify.sanitize_verdict(program)
    assert report.has(expected)
    return rsnap(report)


def schedule_set_shape(P):
    s = P.verify.SCHEDULES
    assert s[0] is None and "reverse" in s
    assert any(isinstance(x, int) for x in s)
    return tuple(s)


def _spaces(run):
    return {p.name: bytes(b) for p, b in run.spaces.items()}


def same_seed_same_bytes(P):
    program = P.verify.generate_program(3)
    a = P.verify.run_bytes(program, 0xD1CE)
    b = P.verify.run_bytes(program, 0xD1CE)
    assert a.spaces == b.spaces
    return _spaces(a)


def tie_seed_is_timing_only(P):
    program = P.verify.generate_program(5)
    a = P.harness.run_engine(program, tie_seed=None)
    b = P.harness.run_engine(program, tie_seed=1234)
    assert a.spaces == b.spaces
    return _spaces(a)


def reverse_schedule_flips_racy_outcome(P):
    for seed in range(8):
        program, kind = P.verify.generate_racy_program(seed)
        if kind != "H003":
            continue
        nat = P.verify.run_bytes(program, None)
        rev = P.verify.run_bytes(program, "reverse")
        if nat.spaces != rev.spaces:
            return seed, _spaces(nat), _spaces(rev)
    pytest.fail("no cross-channel racy seed diverged under reverse")


def racy_shrinker_preserves_divergence(P):
    program, expected = P.verify.generate_racy_program(2)
    assert P.adversary.check_racy_program(program, expected) is None

    def check(p):
        return P.adversary.check_racy_program(p, "H006")

    d = check(program)
    assert d is not None
    small, small_d = P.verify.shrink_program(program, d, budget=60,
                                             check=check)
    assert small_d is not None and small_d.kind == d.kind
    assert small.num_rows <= program.num_rows
    return verdict(d), verdict(small_d), small.describe()


DIFFERENTIAL_CASES = [
    racy_kind_rotation_covered, wrong_expectation_is_caught,
    racy_program_has_static_verdict, schedule_set_shape,
    same_seed_same_bytes, tie_seed_is_timing_only,
    reverse_schedule_flips_racy_outcome, racy_shrinker_preserves_divergence,
]


@pytest.mark.parametrize("case", DIFFERENTIAL_CASES,
                         ids=lambda f: f.__name__)
def test_differential_matches_the_reference(case):
    want, got = case(J), case(T)
    assert got == want


def test_the_port_holds_its_own_classes():
    """The port's engine raises the port's `SanitizeError` and its
    sanitizer returns the port's `Report`: nothing of `repro` behind it."""
    assert T.S.SanitizeError is not J.S.SanitizeError
    assert T.S.Report is not J.S.Report
    r = T.S.check_batch(rows(T, (0, 0x1000, 64)))
    assert type(r) is T.S.Report
    engine = T.core.build_engine(spec2ch(T), sanitize=True)
    _submit_racy(T, engine)
    with pytest.raises(T.S.SanitizeError):
        engine.wait_all()
