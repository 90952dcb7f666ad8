"""The port's virtual-memory mid-end (`repro_torch.core.vm`) against the
reference's (`repro.core.vm`), on the cases of `tests/test_vm.py`.

Each case is a function of a core package (`repro.core` or
`repro_torch.core`): it builds the same page tables, TLBs, translating
stages, engines and batches from the same NumPy inputs, checks what the
reference test checks, and returns what it saw: batches, translated
addresses, `TlbStats`, `PageFault` fields and messages, engine stats,
records and memory bytes.  The two packages must return equal
snapshots.  The sanitizer cases (H007, P003) also run each package's own
sanitizer (`repro.sanitize` / `repro_torch.sanitize`) beside the bytes
and the stage's `audit_translations`, and compare its reports.
"""

import dataclasses
import enum
import importlib
import struct

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T

PAGE = 4096


def snap(obj):
    """A value of plain Python types, equal across the two packages."""
    if isinstance(obj, np.ndarray):
        return ("array", str(obj.dtype), obj.shape, obj.tolist())
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, BaseException):
        fields = {k: snap(getattr(obj, k)) for k in
                  ("kind", "index", "vaddr", "vpn", "space")
                  if hasattr(obj, k)}
        return (type(obj).__name__, str(obj), fields)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: snap(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "table"}
    if isinstance(obj, dict):
        return {snap(k): snap(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(snap(v) for v in obj)
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    return obj


def batch_cols(b):
    return {c: b.__getattribute__(c) for c in
            ("src_addr", "dst_addr", "length")}


def _table(C, pin=None, page=PAGE):
    AXI = C.Protocol.AXI4
    return C.PageTable({AXI: page}, pin_windows={AXI: pin} if pin else None)


def _spec(C, table, policy=None, size=64 * PAGE):
    AXI = C.Protocol.AXI4
    return C.EngineSpec(
        name="vm_test", midend=(C.TranslateStage(table),),
        backend=C.BackendSpec(protocols=(AXI,), bus_width=8,
                              error_policy=policy or C.ErrorPolicy()),
        channels=C.ChannelSpec(count=1), mem_spaces=((AXI, size),))


def _batch(C, rows):
    return C.DescriptorBatch.from_arrays(
        src_addr=np.asarray([r[0] for r in rows], dtype=np.int64),
        dst_addr=np.asarray([r[1] for r in rows], dtype=np.int64),
        length=np.asarray([r[2] for r in rows], dtype=np.int64))


def _sanitizer(C):
    """The sanitizer of the package whose core is ``C``."""
    return importlib.import_module(C.__name__.rsplit(".", 1)[0]
                                   + ".sanitize")


def _raised(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - the snapshot compares it
        return e
    return None


# ---------------------------------------------------------------- cases

def page_table_walk_map_unmap(C):
    t, AXI = _table(C), C.Protocol.AXI4
    out = [t.walk(AXI, 3)]
    t.map(AXI, 3, 17)
    t.map(AXI, 1 << 20, 9)          # a deep vpn walks several levels
    out += [t.walk(AXI, 3), t.walk(AXI, 1 << 20), t.unmap(AXI, 3),
            t.unmap(AXI, 3), t.walk(AXI, 3)]
    assert out == [None, 17, 9, True, False, None]
    return out


def page_table_epoch_semantics(C):
    t, AXI = _table(C), C.Protocol.AXI4
    epochs = [t.epoch]
    for op in (lambda: t.map(AXI, 0, 5), lambda: t.map(AXI, 0, 5),
               lambda: t.map(AXI, 0, 6), lambda: t.unmap(AXI, 0),
               t.invalidate):
        op()
        epochs.append(t.epoch)
    assert np.diff(epochs).tolist() == [0, 0, 1, 1, 1]
    return epochs


def page_sizes_validated(C):
    AXI = C.Protocol.AXI4
    errs = [_raised(lambda: C.PageTable({AXI: 1000})),
            _raised(lambda: C.PageTable({AXI: C.MIN_PAGE_SIZE // 2}))]
    assert all(isinstance(e, ValueError) for e in errs)
    return errs


def pin_window_allocates_and_is_idempotent(C):
    t, AXI = _table(C, pin=(8, 2)), C.Protocol.AXI4
    out = [t.pin(AXI, 40), t.walk(AXI, 40), t.pin(AXI, 40), t.pin(AXI, 41),
           _raised(lambda: t.pin(AXI, 42)),
           _raised(lambda: _table(C).pin(AXI, 1))]
    assert out[:4] == [8, 8, 8, 9]
    assert all(isinstance(e, RuntimeError) for e in out[4:])
    return out


def tlb_eviction_and_shootdown(C):
    t, AXI = _table(C), C.Protocol.AXI4
    t.map_range(AXI, 0, 0, 8)
    tlb = C.Tlb(capacity=4)
    t.register_tlb(tlb)
    code = C.PROTO_CODE[AXI]
    out = []
    for vpn in range(6):
        out.append(tlb.lookup(code, vpn))
        tlb.insert(code, vpn, t.walk(AXI, vpn))
    out += [dataclasses.replace(tlb.stats), tlb.lookup(code, 5),
            tlb.lookup(code, 0)]
    t.map(AXI, 2, 7)                # a remap shoots the TLB down
    out += [tlb.stats, tlb.lookup(code, 5)]
    assert (out[6].misses, out[6].evictions) == (6, 2)    # capacity 4
    assert tlb.stats.shootdowns == 1 and out[-1] is None
    return out


def translate_matches_scalar_and_never_straddles(C):
    rng = np.random.default_rng(0)
    t, AXI = _table(C), C.Protocol.AXI4
    perm = rng.permutation(32)
    for v in range(32):
        t.map(AXI, v, int(perm[v]))
    stage = C.TranslateStage(t)
    rows = [(int(rng.integers(0, 14 * PAGE)), int(rng.integers(16, 28)
             * PAGE + rng.integers(0, PAGE)), int(rng.integers(1, 3 * PAGE)))
            for _ in range(50)]
    out = stage.apply(_batch(C, rows))
    for col in (out.src_addr, out.dst_addr):
        assert np.all((col % PAGE) + out.length <= PAGE)
    return batch_cols(out), stage.tlb.stats


def page_fault_reports_exact_burst_and_va(C):
    t, AXI = _table(C), C.Protocol.AXI4
    t.map_range(AXI, 0, 0, 2)       # vpn 2 unmapped
    stage = C.TranslateStage(t)
    err = _raised(lambda: stage.apply(_batch(
        C, [(0, PAGE, 64), (2 * PAGE - 8, PAGE + 512, 32)])))
    assert isinstance(err, C.PageFault)
    assert (err.index, err.vaddr, err.vpn) == (2, 2 * PAGE, 2)
    assert err.space is AXI and err.kind == "page-fault"
    return err


def transfer_error_str_has_kind_index_and_addresses(C):
    err = C.TransferError(
        burst=C.Transfer1D(src_addr=0x100, dst_addr=0x200, length=32),
        reason="write beyond space", index=7)
    assert "[bounds]" in str(err) and "burst 7" in str(err)
    return err


def _run_verb(C, action, handler=None, max_replays=2, backoff=0,
              cap=1 << 16, pin=None):
    t, AXI = _table(C, pin=pin), C.Protocol.AXI4
    t.map_range(AXI, 0, 0, 4)       # vpns 0..3; 4+ unmapped
    policy = C.ErrorPolicy(action=action, max_replays=max_replays,
                           replay_backoff=backoff, backoff_cap=cap)
    engine = C.build_engine(_spec(C, t, policy), plan_cache=False)
    if handler is not None:
        engine.page_fault_handler = handler
    engine.mem.spaces[AXI][:PAGE] = 7
    # row 1's destination, page 5, is unmapped
    engine.dispatch_batch(_batch(C, [(0, 2 * PAGE, 64),
                                     (256, 5 * PAGE + 8, 64),
                                     (512, 3 * PAGE, 64)]))
    err = _raised(engine.wait_all)
    return engine, t, err


def _verb_snapshot(C, engine, t, err, vpns=(5,)):
    AXI = C.Protocol.AXI4
    return {"err": err, "stats": engine.stats,
            "records": [(r.status, r.faulted_pages) for r in
                        engine._records],
            "walks": [t.walk(AXI, v) for v in vpns],
            "mem": engine.mem.spaces[AXI]}


def verb_abort_propagates_with_page(C):
    engine, t, err = _run_verb(C, "abort")
    assert isinstance(err, C.PageFault) and err.vpn == 5
    assert engine.stats.aborts == 1 and engine._records[0].status == "error"
    return _verb_snapshot(C, engine, t, err)


def verb_pin_maps_on_demand(C):
    engine, t, err = _run_verb(C, "pin", pin=(16, 4))
    AXI = C.Protocol.AXI4
    assert err is None and t.walk(AXI, 5) == 16
    assert np.all(engine.mem.spaces[AXI][16 * PAGE + 8:16 * PAGE + 72] == 7)
    return _verb_snapshot(C, engine, t, err)


def verb_retry_runs_handler_with_bounded_attempts(C):
    calls = []

    def handler(fault, attempt):
        calls.append((fault.vpn, attempt))
        fault.table.map(fault.space, fault.vpn, 20)

    engine, t, err = _run_verb(C, "retry", handler=handler)
    assert err is None and calls == [(5, 1)]
    return calls, _verb_snapshot(C, engine, t, err)


def verb_retry_exhaustion_aborts(C):
    engine, t, err = _run_verb(C, "retry", handler=lambda f, n: None)
    assert isinstance(err, C.PageFault)
    assert (engine.stats.retries, engine.stats.errors,
            engine.stats.aborts) == (2, 3, 1)
    return _verb_snapshot(C, engine, t, err)


def verb_continue_partial_completion_and_faulted_pages(C):
    engine, t, err = _run_verb(C, "continue")
    assert err is None and engine.stats.bytes_moved == 128
    assert engine._records[0].faulted_pages == (("AXI4", 5),)
    return _verb_snapshot(C, engine, t, err)


def backoff_exponential_with_cap(C):
    p = C.ErrorPolicy(action="replay", max_replays=5, replay_backoff=4,
                      backoff_cap=9)
    out = [[p.backoff_for(a) for a in range(4)],
           C.ErrorPolicy(replay_backoff=0).backoff_for(3),
           _raised(lambda: C.ErrorPolicy(backoff_cap=0))]
    assert out[:2] == [[4, 8, 9, 9], 0] and isinstance(out[2], ValueError)
    return out


def fault_loop_charges_exponential_backoff(C):
    engine, t, err = _run_verb(C, "retry", handler=lambda f, n: None,
                               max_replays=3, backoff=4)
    assert engine.stats.backoff_cycles == 28
    return (engine.last_channel_result.backoff_cycles,
            _verb_snapshot(C, engine, t, err))


def _identity(C, n_pages):
    t = _table(C)
    t.map_range(C.Protocol.AXI4, 0, 0, n_pages)
    return t


def plan_cache_hit_is_byte_identical_cold_vs_replayed(C):
    rows = [(256, 20 * PAGE + 64, 3000), (PAGE - 40, 24 * PAGE, 200)]
    shifted = [(s + 2 * PAGE, d + 3 * PAGE, ln) for s, d, ln in rows]
    AXI = C.Protocol.AXI4
    out = []
    for plan_cache in (False, 64):
        engine = C.build_engine(_spec(C, _identity(C, 64)),
                                plan_cache=plan_cache)
        buf = engine.mem.spaces[AXI]
        buf[:] = np.random.default_rng(3).integers(0, 256, size=buf.size,
                                                   dtype=np.uint8)
        for rs in (rows, shifted):
            engine.dispatch_batch(_batch(C, rs))
            engine.wait_all()
        out.append((buf, engine.stats, None if not plan_cache else
                    engine.plan_cache.stats))
    assert out[1][2].hits >= 1 and np.array_equal(out[0][0], out[1][0])
    return out


def verbs_fire_identically_on_plan_cache_hit(C):
    AXI = C.Protocol.AXI4
    out = []
    for action in ("pin", "continue", "abort"):
        for plan_cache in (False, 64):
            t = _table(C, pin=(48, 4))
            t.map_range(AXI, 0, 0, 32)
            policy = C.ErrorPolicy(action=action, max_replays=1)
            engine = C.build_engine(_spec(C, t, policy),
                                    plan_cache=plan_cache)
            buf = engine.mem.spaces[AXI]
            buf[:] = np.random.default_rng(5).integers(
                0, 256, size=buf.size, dtype=np.uint8)
            engine.dispatch_batch(_batch(C, [(256, 20 * PAGE, 64)]))
            engine.wait_all()
            engine.dispatch_batch(_batch(C, [(256 + PAGE, 40 * PAGE, 64)]))
            err = _raised(engine.wait_all)
            out.append((action, plan_cache,
                        _verb_snapshot(C, engine, t, err, vpns=(40, 43))))
            if plan_cache:
                assert engine.plan_cache.stats.hits >= 1
                cold, hit = out[-2][2], out[-1][2]
                assert np.array_equal(cold["mem"], hit["mem"])
    return out


def remap_bumps_epoch_and_changes_plan_signature(C):
    t = _identity(C, 8)
    stage = C.TranslateStage(t)
    sig0 = stage.signature()
    t.map(C.Protocol.AXI4, 1, 7)
    t2 = _identity(C, 8)
    t2.map(C.Protocol.AXI4, 20, 21)
    s2 = C.TranslateStage(t2)
    assert stage.signature() != sig0 and s2.signature()[-1] == 0
    return sig0, stage.signature(), s2.signature()


def translate_stage_modulus_folds_into_plan_residues(C):
    stage = C.TranslateStage(_identity(C, 8))
    sigs = [C.plan_signature(_batch(C, [r]), 8, pipeline=[stage])
            for r in ((0, 2 * PAGE, 64), (PAGE, 3 * PAGE, 64),
                      (8, 2 * PAGE, 64))]
    out = [stage.modulus(), sigs[0] == sigs[1], sigs[0] == sigs[2]]
    assert out == [PAGE, True, False]
    return out


def alias_batch_executes(C):
    """test_vm's H007 case: two virtual pages map to one frame, so the
    two writes land on the same physical bytes; the sanitizer flags the
    aliasing (H007) and the batch still executes."""
    t, AXI = _table(C), C.Protocol.AXI4
    for v, p in ((0, 2), (1, 2), (4, 4), (5, 5)):
        t.map(AXI, v, p)
    engine = C.build_engine(_spec(C, t), plan_cache=False)
    buf = engine.mem.spaces[AXI]
    buf[:] = np.random.default_rng(6).integers(0, 256, size=buf.size,
                                               dtype=np.uint8)
    engine.dispatch_batch(_batch(C, [(4 * PAGE, 0, 64),
                                     (5 * PAGE, PAGE, 64)]))
    report = _sanitizer(C).check_engine(engine)
    assert report.has("H007") and not report.clean
    engine.wait_all()
    return buf, engine.stats, report


def virtual_plane_race_executes(C):
    """test_vm's second H007 case: a write-write race on the virtual
    plane is flagged as such (H002 or H003), not as aliasing (no H007),
    and executes."""
    engine = C.build_engine(_spec(C, _identity(C, 8)), plan_cache=False)
    buf = engine.mem.spaces[C.Protocol.AXI4]
    buf[:] = np.random.default_rng(7).integers(0, 256, size=buf.size,
                                               dtype=np.uint8)
    engine.dispatch_batch(_batch(C, [(0, 4 * PAGE, 64),
                                     (PAGE, 4 * PAGE, 64)]))
    report = _sanitizer(C).check_engine(engine)
    assert report.has("H002") or report.has("H003")
    assert not report.has("H007")
    engine.wait_all()
    return buf, engine.stats, report


def stale_tlb_found_by_audit_translations(C):
    t, AXI = _identity(C, 16), C.Protocol.AXI4
    stage = C.TranslateStage(t, shootdown=False)   # deliberately unhooked
    spec = C.EngineSpec(name="p003", midend=(stage,),
                        backend=C.BackendSpec(protocols=(AXI,), bus_width=8),
                        mem_spaces=((AXI, 64 * PAGE),))
    engine = C.build_engine(spec, plan_cache=64)
    engine.dispatch_batch(_batch(C, [(0, 8 * PAGE, 64)]))
    engine.wait_all()               # warm TLB + capture plan
    t.map(AXI, 0, 9)                # remap; TLB not shot down
    audit = stage.audit_translations()
    assert audit != []
    S = _sanitizer(C)
    assert S.audit_replay(engine.plan_cache, _batch(C, [(0, 8 * PAGE, 64)]),
                          bus_width=8, pipeline=engine.pipeline) is None
    plan = next(iter(engine.plan_cache._plans.values()))
    report = S.audit_plan(plan, _batch(C, [(0, 8 * PAGE, 64)]),
                          bus_width=8, pipeline=engine.pipeline)
    assert report.has("P003")
    return audit, stage.tlb.stats, engine.plan_cache.stats, report


def audit_clean_when_shootdown_wired(C):
    t, AXI = _identity(C, 16), C.Protocol.AXI4
    stage = C.TranslateStage(t)
    spec = C.EngineSpec(name="p003b", midend=(stage,),
                        backend=C.BackendSpec(protocols=(AXI,), bus_width=8),
                        mem_spaces=((AXI, 64 * PAGE),))
    engine = C.build_engine(spec, plan_cache=64)
    engine.dispatch_batch(_batch(C, [(0, 8 * PAGE, 64)]))
    engine.wait_all()
    t.map(AXI, 0, 9)
    assert stage.audit_translations() == []
    return stage.tlb.stats


def sg_list_roundtrip_and_gather(C):
    buf = np.zeros(1024, dtype=np.uint8)
    entries = [(0x1000, 100), (0x5000, 8), (0x2345, 256)]
    head = C.write_sg_list(buf, [0, 64, 128], entries)
    batch = C.sg_gather_batch(buf, head, dst_addr=0x9000)
    assert C.read_sg_list(buf, head) == entries
    assert np.array_equal(batch.dst_addr, [0x9000, 0x9064, 0x906c])
    return head, buf, batch_cols(batch)


def sg_list_cycle_guard(C):
    buf = np.zeros(256, dtype=np.uint8)
    head = C.write_sg_list(buf, [0, 64], [(0, 8), (8, 8)])
    struct.pack_into("<q", buf, 64 + 16, 0)   # the tail points at the head
    err = _raised(lambda: C.read_sg_list(buf, head))
    assert isinstance(err, ValueError)
    return err


def expert_gather_matches_moe_routing(C):
    rng = np.random.default_rng(11)
    token_va = 0x4000 + np.arange(16, dtype=np.int64) * 64
    idx = rng.integers(0, 4, size=16)
    batch = C.expert_gather_batch(token_va, idx, n_experts=4, capacity=3,
                                  d_bytes=64, expert_buf_va=0x20000)
    assert len(np.unique(batch.dst_addr)) == len(batch)
    k2 = rng.integers(0, 6, size=(16, 2))
    wide = C.expert_gather_batch(token_va, k2, n_experts=6, capacity=4,
                                 d_bytes=64, expert_buf_va=0x20000)
    bad = _raised(lambda: C.expert_gather_batch(token_va, idx + 4, 4, 3, 64,
                                                0))
    return batch_cols(batch), batch_cols(wide), bad


def expert_gather_end_to_end_through_translation(C):
    t, AXI = _table(C), C.Protocol.AXI4
    rng = np.random.default_rng(13)
    perm = rng.permutation(32)
    for v in range(32):
        t.map(AXI, v, int(perm[v]))
    engine = C.build_engine(_spec(C, t), plan_cache=False)
    buf = engine.mem.spaces[AXI]
    buf[:] = rng.integers(0, 256, size=buf.size, dtype=np.uint8)
    idx = rng.integers(0, 2, size=8)
    batch = C.expert_gather_batch(np.arange(8, dtype=np.int64) * 64, idx,
                                  n_experts=2, capacity=8, d_bytes=64,
                                  expert_buf_va=20 * PAGE)
    mem2 = C.MemoryMap.create({AXI: buf.size})
    mem2.spaces[AXI][:] = buf

    def xl(a):
        return int(perm[a // PAGE]) * PAGE + a % PAGE
    oracle = C.DescriptorBatch.from_arrays(
        src_addr=np.asarray([xl(int(a)) for a in batch.src_addr]),
        dst_addr=np.asarray([xl(int(a)) for a in batch.dst_addr]),
        length=batch.length.copy())
    C.execute(C.legalize_batch(oracle, bus_width=8).to_transfers(), mem2,
              bus_width=8)
    engine.dispatch_batch(batch)
    engine.wait_all()
    assert np.array_equal(buf, mem2.spaces[AXI])
    return buf, engine.stats


CASES = [page_table_walk_map_unmap, page_table_epoch_semantics,
         page_sizes_validated, pin_window_allocates_and_is_idempotent,
         tlb_eviction_and_shootdown,
         translate_matches_scalar_and_never_straddles,
         page_fault_reports_exact_burst_and_va,
         transfer_error_str_has_kind_index_and_addresses,
         verb_abort_propagates_with_page, verb_pin_maps_on_demand,
         verb_retry_runs_handler_with_bounded_attempts,
         verb_retry_exhaustion_aborts,
         verb_continue_partial_completion_and_faulted_pages,
         backoff_exponential_with_cap,
         fault_loop_charges_exponential_backoff,
         plan_cache_hit_is_byte_identical_cold_vs_replayed,
         verbs_fire_identically_on_plan_cache_hit,
         remap_bumps_epoch_and_changes_plan_signature,
         translate_stage_modulus_folds_into_plan_residues,
         alias_batch_executes, virtual_plane_race_executes,
         stale_tlb_found_by_audit_translations,
         audit_clean_when_shootdown_wired, sg_list_roundtrip_and_gather,
         sg_list_cycle_guard, expert_gather_matches_moe_routing,
         expert_gather_end_to_end_through_translation]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_port_matches_the_reference(case):
    want, got = snap(case(J)), snap(case(T))
    assert got == want


def test_moe_model_wrapper_delegates():
    """`repro_torch.models.moe.moe_expert_gather` against the reference
    model's, at a capacity that drops pairs and at `_capacity`'s."""
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models.moe import moe_expert_gather as j_gather
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import moe_expert_gather
    token_va = np.arange(12, dtype=np.int64) * 128
    idx = np.random.default_rng(3).integers(0, 4, size=(12, 2))
    idx[:, 0] = 0
    for cap in (4, None):
        got = moe_expert_gather(token_va, idx, MoEConfig(4, 2, 64), 128,
                                0x10000, capacity=cap)
        want = j_gather(token_va, idx, JMoEConfig(4, 2, 64), 128, 0x10000,
                        capacity=cap)
        assert snap(batch_cols(got)) == snap(batch_cols(want))
    assert len(moe_expert_gather(token_va, idx[:, :1], MoEConfig(4, 1, 64),
                                 128, 0x10000, capacity=4)) == 4


def test_the_port_holds_its_own_classes():
    """The port's vm raises the port's `PageFault` and builds the port's
    batches: nothing of `repro` behind it."""
    from repro_torch.core import backend, descriptor, vm
    assert vm.PageFault is backend.PageFault is T.PageFault
    assert vm.DescriptorBatch is descriptor.DescriptorBatch
    assert T.PageFault is not J.PageFault
    assert issubclass(vm.TranslateStage, T.MidendStage)
