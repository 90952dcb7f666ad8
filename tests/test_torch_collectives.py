"""The port's collective fabric and plans (`repro_torch.dist.fabric`,
`repro_torch.dist.collectives`) against the reference's (`repro.dist`),
on the cases of `tests/test_collectives.py`.

Every case runs the same shards through both packages' fabrics.  The
port's outputs must equal the reference's bit for bit (and the port's own
NumPy oracles'), and its cycle counts must be equal phase by phase: the
fabric is host NumPy over the descriptor plane in both packages, so there
is nothing to round.  The analytic plans must give equal descriptor lists
and cycles.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as JCORE
import repro.dist.collectives as JC
import repro_torch.core as TCORE
import repro_torch.dist.collectives as TC

#: each package's descriptor plane, by its collectives module
CORE = {JC: JCORE, TC: TCORE}

WORLDS = (1, 2, 4)
DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint8, np.float16)
SIZES = (1, 7, 97, 1000, 4093)


def shards_for(world, nelems, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return [rng.standard_normal(nelems).astype(dtype)
                for _ in range(world)]
    hi = min(int(np.iinfo(dtype).max), 100)
    return [rng.integers(0, hi, nelems).astype(dtype) for _ in range(world)]


def fabric(C, world, **kw):
    kw.setdefault("region_bytes", 1 << 18)
    return C.CollectiveFabric(world, **kw)


def phases(trace):
    """A trace's per-phase numbers, equal across the two packages."""
    return [(p.cycles, p.bytes_moved, p.backoff_cycles, len(p.streams))
            for p in trace.phases]


def run_both(op, world, shards, **kw):
    """``op`` on both fabrics: the outputs must be bit-identical and the
    cycles equal phase by phase.  Returns the port's outputs."""
    out = {}
    for C in (JC, TC):
        res, trace = getattr(fabric(C, world), op)(shards, **kw)
        out[C] = ([(a.dtype.str, a.shape, a.tobytes()) for a in res],
                  phases(trace), trace.total_cycles, trace.total_bytes)
    assert out[TC] == out[JC]
    return res


class TestByteIdentity:
    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("nelems", SIZES)
    def test_ring_allreduce(self, world, dtype, nelems):
        shards = shards_for(world, nelems, dtype)
        out = run_both("allreduce", world, shards, algo="ring")
        ref = TC.numpy_ring_allreduce(shards)
        assert len(out) == world
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("dtype", (np.float32, np.int64))
    @pytest.mark.parametrize("nelems", SIZES)
    def test_halving_allreduce(self, world, dtype, nelems):
        shards = shards_for(world, nelems, dtype)
        out = run_both("allreduce", world, shards, algo="halving")
        ref = TC.numpy_halving_allreduce(shards)
        for a, b in zip(out, ref):
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("dtype", (np.float32, np.uint8))
    @pytest.mark.parametrize("nelems", (1, 97, 1000))
    def test_allgather(self, world, dtype, nelems):
        shards = shards_for(world, nelems, dtype)
        out = run_both("allgather", world, shards)
        ref = TC.numpy_allgather(shards)
        for a, b in zip(out, ref):
            assert a.shape == (world, nelems)
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("dtype", (np.float32, np.int32))
    @pytest.mark.parametrize("nelems", (1, 97, 1000, 4093))
    def test_alltoall(self, world, dtype, nelems):
        shards = shards_for(world, nelems, dtype)
        out = run_both("alltoall", world, shards)
        ref = TC.numpy_alltoall(shards)
        for a, b in zip(out, ref):
            assert a.tobytes() == b.tobytes()

    def test_numpy_oracles_equal_the_reference(self):
        for world in WORLDS:
            shards = shards_for(world, 97, np.float32, seed=world)
            for name in ("numpy_ring_allreduce", "numpy_halving_allreduce",
                         "numpy_allgather", "numpy_alltoall"):
                want = getattr(JC, name)(shards)
                got = getattr(TC, name)(shards)
                assert [a.tobytes() for a in got] == \
                    [a.tobytes() for a in want], (world, name)

    def test_exact_dtypes_equal_plain_sum(self):
        shards = shards_for(4, 1000, np.int64)
        out = run_both("allreduce", 4, shards)
        np.testing.assert_array_equal(out[0], np.sum(shards, axis=0))

    def test_float_close_to_plain_sum(self):
        shards = shards_for(4, 1000, np.float32)
        out = run_both("allreduce", 4, shards)
        np.testing.assert_allclose(out[0], np.sum(shards, axis=0),
                                   rtol=1e-4, atol=1e-5)

    def test_2d_shapes_roundtrip(self):
        shards = [np.arange(60, dtype=np.float32).reshape(5, 12) + r
                  for r in range(4)]
        out = run_both("allreduce", 4, shards)
        ref = TC.numpy_ring_allreduce(shards)
        for a, b in zip(out, ref):
            assert a.shape == (5, 12)
            assert a.tobytes() == b.tobytes()


class TestCycleParity:
    def test_one_engine_transport_matches_simulate_batch(self):
        """World-1 transport is cycle-identical to a bare `simulate_batch`
        of the legalized batch, in both packages, and the two agree."""
        cycles = {}
        for C in (JC, TC):
            fab = fabric(C, 1)
            mod = CORE[C]
            batch = mod.DescriptorBatch.from_arrays(
                np.array([0, 4096, 300, 9000]),
                np.array([16384, 20480, 24576, 28672]),
                np.array([1024, 777, 4096, 63]),
                src_protocol=mod.Protocol.HBM,
                dst_protocol=mod.Protocol.HBM)
            trace = fab.transport([batch])
            eng = fab.engines[0]
            lps = [lp for lp in eng._lower_ports(batch) if len(lp.batch)]
            cat = mod.concat_batches([lp.batch for lp in lps])
            beats = (lps[0].beats if len(lps) == 1 else
                     np.concatenate([lp.beats for lp in lps]))
            ref = mod.simulator.simulate_batch(
                cat, fab.spec.effective_sim_config, fab.spec.src_system,
                fab.spec.dst_system, already_legal=True, beats=beats)
            assert trace.total_cycles == int(ref.cycles)
            cycles[C] = (phases(trace), int(ref.cycles))
        assert cycles[TC] == cycles[JC]

    def test_multi_engine_no_slower_than_per_phase_serial(self):
        shards = shards_for(4, 1 << 14, np.float32)
        got = {}
        for C in (JC, TC):
            fab = fabric(C, 4, region_bytes=1 << 18)
            _, trace = fab.allreduce(shards)
            serial = fab.serial_cycles(trace)
            assert trace.total_cycles <= serial
            assert serial / trace.total_cycles > 1.3
            got[C] = (phases(trace), serial)
        assert got[TC] == got[JC]


class TestFaultsAndCache:
    def test_transient_fault_replay_preserves_bytes(self):
        shards = shards_for(4, 500, np.int32)
        got = {}
        for C in (JC, TC):
            site = CORE[C].FaultSite
            sites = {1: [site(index=2, kind="transient")],
                     3: [site(index=0, kind="stall", stall_cycles=64)]}
            out, trace = fabric(C, 4, fault_sites=sites).allreduce(shards)
            for a, b in zip(out, C.numpy_ring_allreduce(shards)):
                assert a.tobytes() == b.tobytes()
            assert sum(p.backoff_cycles for p in trace.phases) >= 64
            got[C] = ([a.tobytes() for a in out], phases(trace))
        assert got[TC] == got[JC]

    def test_abort_policy_raises_and_posts_error_irq(self):
        got = {}
        for C in (JC, TC):
            core, errors = CORE[C], []
            fab = fabric(
                C, 2, error_policy=core.ErrorPolicy(action="abort"),
                fault_sites={0: [core.FaultSite(index=0, kind="persistent",
                                                hits=99)]})
            fab.engines[0].on_complete(
                lambda vec, evs: errors.extend(
                    e for e in evs if e.status == "error"))
            with pytest.raises(core.TransferError) as err:
                fab.allreduce(shards_for(2, 256, np.float32))
            assert errors, "abort must post an error completion interrupt"
            got[C] = (str(err.value),
                      [dataclasses.astuple(e) for e in errors])
        assert got[TC] == got[JC]

    def test_plan_cache_shared_and_hit_across_iterations(self):
        shards = shards_for(4, 1000, np.float32)
        got = {}
        for C in (JC, TC):
            fab = fabric(C, 4)
            out1, _ = fab.allreduce(shards)
            pc = fab.engines[0].plan_cache
            assert pc is not None and pc is fab.engines[1].plan_cache
            h0 = pc.stats.hits
            out2, t2 = fab.allreduce(shards)
            assert pc.stats.hits > h0
            for a, b in zip(out1, out2):
                assert a.tobytes() == b.tobytes()
            got[C] = (h0, pc.stats.hits, pc.stats.misses, phases(t2))
        assert got[TC] == got[JC]


class TestPhaseEngine:
    def test_completion_interrupts_drive_phases(self):
        got = {}
        for C in (JC, TC):
            fired = {r: 0 for r in range(4)}
            fab = fabric(C, 4)
            for r in range(4):
                fab.engines[r].on_complete(
                    lambda vec, evs, r=r: fired.__setitem__(
                        r, fired[r] + sum(1 for e in evs
                                          if e.status == "done")))
            _, trace = fab.allreduce(shards_for(4, 1024, np.float32))
            assert len(trace.phases) == 2 * (4 - 1)
            for r in range(4):
                assert fired[r] == len(trace.phases)
            got[C] = (dict(fired), phases(trace))
        assert got[TC] == got[JC]

    def test_trace_accounting(self):
        shards = shards_for(2, 512, np.float32)
        got = {}
        for C in (JC, TC):
            _, trace = fabric(C, 2).allreduce(shards)
            assert trace.total_cycles == sum(p.cycles for p in trace.phases)
            assert trace.total_bytes == sum(p.bytes_moved
                                            for p in trace.phases)
            assert trace.total_bytes > 0
            for p in trace.phases:
                assert p.cycles > 0 and p.streams
            got[C] = (trace.total_cycles, trace.total_bytes, phases(trace))
        assert got[TC] == got[JC]

    def test_engine_stats_updated(self):
        got = {}
        for C in (JC, TC):
            fab = fabric(C, 2)
            fab.allreduce(shards_for(2, 512, np.float32))
            for eng in fab.engines:
                assert eng.stats.submitted > 0
                assert eng.stats.completed == eng.stats.submitted
            got[C] = [dataclasses.astuple(e.stats) for e in fab.engines]
        assert got[TC] == got[JC]

    def test_region_overflow_rejected(self):
        fab = TC.CollectiveFabric(2, region_bytes=1 << 12)
        big = shards_for(2, 4096, np.float32)
        with pytest.raises(ValueError, match="region") as err:
            fab.allreduce(big)
        with pytest.raises(ValueError) as jerr:
            JC.CollectiveFabric(2, region_bytes=1 << 12).allreduce(big)
        assert str(err.value) == str(jerr.value)

    def test_world_shard_mismatch_rejected(self):
        with pytest.raises(ValueError) as err:
            fabric(TC, 4).allreduce(shards_for(2, 64, np.float32))
        with pytest.raises(ValueError) as jerr:
            fabric(JC, 4).allreduce(shards_for(2, 64, np.float32))
        assert str(err.value) == str(jerr.value)


def transfers(plan):
    return [[(t.src_addr, t.dst_addr, t.length) for t in step]
            for step in plan]


class TestAnalyticPlans:
    def test_cycles_monotone_in_world_latency_regime(self):
        assert TC.allreduce_cycles(1 << 10, 16) > \
            TC.allreduce_cycles(1 << 10, 4)

    @pytest.mark.parametrize("world", (1, 2, 3, 4, 8, 16, 256))
    def test_plans_and_cycles_equal_the_reference(self, world):
        for nbytes in (0, 1, 1000, 1 << 16, (1 << 20) + 7, 1 << 30):
            assert transfers(TC.ring_allreduce_plan(nbytes, world)) == \
                transfers(JC.ring_allreduce_plan(nbytes, world))
            assert transfers(TC.alltoall_plan(nbytes, world)) == \
                transfers(JC.alltoall_plan(nbytes, world))
            assert TC.allreduce_cycles(nbytes, world) == \
                JC.allreduce_cycles(nbytes, world)
            assert TC.allreduce_seconds(nbytes, world) == \
                JC.allreduce_seconds(nbytes, world)
        assert (TC.BUS_WIDTH_BYTES, TC.LINK_LATENCY_CYCLES, TC.CLOCK_HZ) == \
            (JC.BUS_WIDTH_BYTES, JC.LINK_LATENCY_CYCLES, JC.CLOCK_HZ)

    def test_fabric_spec_shapes(self):
        spec = TC.fabric_spec(4, region_bytes=1 << 16, channels=2)
        assert spec.channels.count == 2
        assert spec.mem_spaces[0][1] == 4 * (1 << 16)
        fab = TC.CollectiveFabric(4, spec=spec)
        assert fab.region_bytes == 1 << 16
        assert len(fab.engines) == 4
        assert fab.engines[0].mem is fab.engines[3].mem
        jspec = JC.fabric_spec(4, region_bytes=1 << 16, channels=2)
        assert spec.name == jspec.name
        assert spec.mem_spaces[0][1] == jspec.mem_spaces[0][1]
        assert spec.backend.bus_width == jspec.backend.bus_width


def test_dist_names_what_waits():
    """`repro_torch.dist` has all six of the reference's submodules —
    `fabric`, `collectives` (with `compressed_psum` exported),
    `checkpoint`, `fault`, `sharding` and `pipeline_parallel` — and an
    unknown name raises `AttributeError`."""
    import repro_torch.dist as dist
    assert dist.collectives is TC and "compressed_psum" in TC.__all__
    assert dist.checkpoint.__name__ == "repro_torch.dist.checkpoint"
    assert dist.fault.__name__ == "repro_torch.dist.fault"
    for name in ("sharding", "pipeline_parallel"):
        assert getattr(dist, name).__name__ == f"repro_torch.dist.{name}"
    assert sorted(dist.__all__) == sorted(
        ["fabric", "collectives", "checkpoint", "fault", "sharding",
         "pipeline_parallel"])
    with pytest.raises(AttributeError):
        dist.nonsense
    assert TC.CollectiveFabric.__module__ == "repro_torch.dist.fabric"
