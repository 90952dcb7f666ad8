"""The port's area / timing / latency models (`repro_torch.core.analytics`)
against the reference's (`repro.core.analytics`), on the cases of
`tests/test_analytics.py` and a sweep of their parameters, plus the burst
and plan-cache profiles of the descriptor plane.

Each case is a function of an analytics module and its core package: the
same port lists and parameters go to both, the case checks what the
reference test checks, and the numbers it returns must be equal.
"""

import itertools

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T

PROTOS = ("AXI4", "AXI_LITE", "AXI_STREAM", "OBI", "TILELINK", "INIT")


def _ports(C, names, read=True, write=True):
    A = C.analytics
    return [A.PortConfig(C.Protocol[n], read, write) for n in names]


def area_32b_32ot_under_25kge(C):
    A = C.analytics
    area = A.area_model(A.base_axi_ports(), aw=32, dw=32, nax=32).as_dict()
    assert area["total"] < 25_000
    return area


def ge_per_outstanding(C):
    A = C.analytics
    ge = [A.ge_per_outstanding(p) for p in
          (A.base_axi_ports(), A.pulp_cluster_ports(), A.cheshire_ports())]
    assert 300 < ge[0] < 500
    return ge


def area_monotone_in_params(C):
    A = C.analytics
    out = [A.area_model(A.base_axi_ports(), aw, dw, nax).as_dict()
           for aw, dw, nax in ((32, 32, 2), (64, 32, 2), (32, 64, 2),
                               (32, 32, 4))]
    assert all(o["total"] > out[0]["total"] for o in out[1:])
    return out


def protocol_contributions(C):
    """Each protocol alone, read-only, write-only and both."""
    A = C.analytics
    out = {(n, r, w): A.area_model(_ports(C, [n], r, w), 32, 32, 2)
           .as_dict() for n in PROTOS for r, w in ((1, 1), (1, 0), (0, 1))}
    assert out["AXI4", 1, 1]["total"] > out["AXI_LITE", 1, 1]["total"]
    assert out["AXI4", 1, 1]["total"] > out["OBI", 1, 1]["total"]
    return out


def decomposition_adds_up(C):
    A = C.analytics
    parts = A.area_model(A.pulp_cluster_ports(), 32, 32, 16).as_dict()
    total = parts.pop("total")
    assert abs(sum(parts.values()) - total) < 1e-6
    return parts, total, A.area_model(A.pulp_cluster_ports(), 32, 32, 16,
                                      has_legalizer=False).as_dict()


def timing_simple_protocols_faster(C):
    A = C.analytics
    f = [A.max_frequency_ghz(_ports(C, names)) for names in
         (["OBI"], ["AXI4"], ["AXI4", "OBI", "TILELINK"])]
    assert f[0] > f[1] > f[2]
    return f


def over_1ghz_at_12nm(C):
    A = C.analytics
    f = A.max_frequency_ghz(A.base_axi_ports(), aw=48, dw=512, nax=32)
    assert f > 1.0
    return f


def timing_sweep(C):
    """The timing model over widths, address widths, outstanding counts
    and protocol mixes."""
    A = C.analytics
    mixes = (["AXI4"], ["OBI"], ["AXI4", "OBI"], list(PROTOS))
    out = {(aw, dw, nax, i): A.timing_model(_ports(C, mix), aw, dw, nax)
           for aw, dw, nax, (i, mix) in itertools.product(
               (32, 48, 64), (32, 64, 512, 1024), (1, 2, 16, 64),
               enumerate(mixes))}
    assert out[32, 32, 2, 0] < out[32, 1024, 2, 0]
    return out


def area_sweep(C):
    A = C.analytics
    mixes = (["AXI4"], ["OBI"], ["AXI4", "OBI"], list(PROTOS))
    return {(aw, dw, nax, i): A.area_model(_ports(C, mix), aw, dw,
                                           nax).as_dict()
            for aw, dw, nax, (i, mix) in itertools.product(
                (32, 64), (32, 512), (2, 32), enumerate(mixes))}


def latency_model_matches_simulator(C):
    A = C.analytics
    out = []
    for midends in (0, 1, 2, 3):
        r = C.simulate([C.Transfer1D(0, 0, 64)],
                       C.EngineConfig(bus_width=8, num_midends=midends),
                       C.SRAM, C.SRAM)
        assert r.first_read_req == A.latency_model(midends)
        out.append((r.first_read_req,
                    A.latency_model(midends, has_legalizer=False),
                    A.latency_model(midends, tensor_nd_zero_latency=True)))
    return out


def burst_profile_of_a_legalized_batch(C):
    rng = np.random.default_rng(4)
    batch = C.DescriptorBatch.from_arrays(
        src_addr=rng.integers(0, 1 << 20, 300).astype(np.int64),
        dst_addr=rng.integers(0, 1 << 20, 300).astype(np.int64),
        length=rng.integers(1, 9000, 300).astype(np.int64))
    out = [C.analytics.burst_profile(C.legalize_batch(batch, bus_width=bw),
                                     bus_width=bw) for bw in (4, 8, 64)]
    empty = C.analytics.burst_profile(C.DescriptorBatch.from_arrays(
        src_addr=np.zeros(0, np.int64), dst_addr=np.zeros(0, np.int64),
        length=np.zeros(0, np.int64)), bus_width=8)
    assert 0 < out[0]["shifter_efficiency"] <= 1
    return out, empty


def plan_cache_profile_after_replays(C):
    AXI = C.Protocol.AXI4
    engine = C.build_engine(C.EngineSpec(
        name="profile", backend=C.BackendSpec(protocols=(AXI,), bus_width=8),
        mem_spaces=((AXI, 1 << 16),)), plan_cache=8)
    for shift in range(4):
        engine.dispatch_batch(C.DescriptorBatch.from_arrays(
            src_addr=np.asarray([0, 512]) + 4096 * shift,
            dst_addr=np.asarray([32768, 33000]) + 4096 * shift,
            length=np.asarray([300, 64])))
        engine.wait_all()
    prof = C.analytics.plan_cache_profile(engine.plan_cache)
    assert prof["hits"] >= 1
    return prof


CASES = [area_32b_32ot_under_25kge, ge_per_outstanding,
         area_monotone_in_params, protocol_contributions,
         decomposition_adds_up, timing_simple_protocols_faster,
         over_1ghz_at_12nm, timing_sweep, area_sweep,
         latency_model_matches_simulator,
         burst_profile_of_a_legalized_batch,
         plan_cache_profile_after_replays]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_port_matches_the_reference(case):
    assert case(T) == case(J)


def test_constants_and_claims_match():
    A, R = T.analytics, J.analytics
    assert A.PAPER_CLAIMS == R.PAPER_CLAIMS
    for name in ("BASE_AW", "BASE_DW", "BASE_NAX", "BASE_NAX_DECOUPLING"):
        assert getattr(A, name) == getattr(R, name)
    assert [(p.protocol.name, p.read, p.write) for p in
            A.pulp_cluster_ports()] == \
        [(p.protocol.name, p.read, p.write) for p in R.pulp_cluster_ports()]
