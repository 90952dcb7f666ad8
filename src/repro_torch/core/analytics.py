"""Area / timing / latency models (paper §4.1–§4.3, Table 4, Fig. 12/13);
the port's copy of `repro.core.analytics`.

The paper fits linear (non-negative least squares) models mapping
(parameterization, protocol port list) → back-end area decomposition, with
< 9 % mean error, and a multiplicative-inverse timing model (< 4 % error).
We re-implement those models with the published Table-4 coefficients as the
anchor data, so third-party instantiations can be estimated exactly the way
the paper intends — and `benchmarks/area_model.py` validates the model
against every number printed in the paper.

Units: GE (gate equivalents).  Base configuration of Table 4:
AW = 32 b, DW = 32 b, NAx = 2 — except the 'decoupling' row, whose quoted
3.7 kGE is for the PULP configuration NAx = 16 (footnote a).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


from .descriptor import DescriptorBatch, Protocol
from .legalizer import legal_latency
from .simulator import beats_array

# Table-4 base parameterization
BASE_AW = 32
BASE_DW = 32
BASE_NAX_DECOUPLING = 16     # footnote a: decoupling row quoted at NAx=16
BASE_NAX = 2

#: (read, write) area contributions per protocol, in GE, at the base config.
#: Rows mirror Table 4. 'state' uses footnote c (max over protocols).
_DECOUPLING: Dict[Protocol, Tuple[float, float]] = {
    Protocol.AXI4: (1400, 1400),
    Protocol.AXI_LITE: (310, 310),
    Protocol.AXI_STREAM: (310, 310),
    Protocol.OBI: (310, 310),
    Protocol.TILELINK: (310, 310),
    Protocol.INIT: (0, 0),
}
_STATE: Dict[Protocol, Tuple[float, float]] = {
    Protocol.AXI4: (710, 710),
    Protocol.AXI_LITE: (200, 200),
    Protocol.AXI_STREAM: (180, 180),
    Protocol.OBI: (180, 180),
    Protocol.TILELINK: (215, 215),
    Protocol.INIT: (21, 0),
}
_PAGE_SPLIT: Dict[Protocol, Tuple[float, float]] = {
    Protocol.AXI4: (95, 105),
    Protocol.AXI_LITE: (7, 8),
    Protocol.AXI_STREAM: (0, 0),
    Protocol.OBI: (5, 5),
    Protocol.TILELINK: (0, 0),
    Protocol.INIT: (0, 0),
}
_POW2_SPLIT: Dict[Protocol, Tuple[float, float]] = {
    Protocol.TILELINK: (20, 20),
}
_MANAGERS: Dict[Protocol, Tuple[float, float]] = {
    Protocol.AXI4: (190, 30),
    Protocol.AXI_LITE: (60, 60),
    Protocol.AXI_STREAM: (60, 60),
    Protocol.OBI: (60, 35),
    Protocol.TILELINK: (230, 150),
    Protocol.INIT: (55, 0),
}
_SHIFTER: Dict[Protocol, Tuple[float, float]] = {
    Protocol.AXI4: (250, 250),
    Protocol.AXI_LITE: (75, 75),
    Protocol.AXI_STREAM: (180, 180),
    Protocol.OBI: (170, 170),
    Protocol.TILELINK: (65, 65),
    Protocol.INIT: (0, 0),
}

_BASE_DECOUPLING = 3700.0     # O(NAx), quoted at NAx=16
_BASE_STATE = 1500.0          # O(AW)
_BASE_DATAFLOW = 1300.0       # O(DW)
_BASE_MANAGER = 70.0
_BASE_SHIFTER = 120.0         # O(DW)


@dataclass(frozen=True)
class PortConfig:
    """One protocol port selection: (protocol, has_read, has_write)."""

    protocol: Protocol
    read: bool = True
    write: bool = True


@dataclass
class AreaBreakdown:
    decoupling: float = 0.0
    state: float = 0.0
    legalizer: float = 0.0
    dataflow: float = 0.0
    managers: float = 0.0
    shifter: float = 0.0

    @property
    def total(self) -> float:
        return (self.decoupling + self.state + self.legalizer +
                self.dataflow + self.managers + self.shifter)

    def as_dict(self) -> Dict[str, float]:
        return {
            "decoupling": self.decoupling, "state": self.state,
            "legalizer": self.legalizer, "dataflow": self.dataflow,
            "managers": self.managers, "shifter": self.shifter,
            "total": self.total,
        }


def area_model(ports: Sequence[PortConfig], aw: int = 32, dw: int = 32,
               nax: int = 2, has_legalizer: bool = True) -> AreaBreakdown:
    """Estimate back-end area in GE (paper's two-stage model: per-protocol
    contributions + parameter scaling).

    Scaling laws from Table 4's big-O column: decoupling ∝ NAx,
    state ∝ AW, dataflow element ∝ DW, shifters ∝ DW; manager and legalizer
    cores are parameter-independent (O(1)); footnote c: contributions marked
    'max over protocols' (state, shifter) take the maximum, others sum.
    """
    f_nax = nax / BASE_NAX_DECOUPLING
    f_aw = aw / BASE_AW
    f_dw = dw / BASE_DW

    bd = AreaBreakdown()
    bd.decoupling = _BASE_DECOUPLING * f_nax
    bd.state = _BASE_STATE * f_aw
    bd.dataflow = _BASE_DATAFLOW * f_dw
    bd.managers = _BASE_MANAGER
    bd.shifter = _BASE_SHIFTER * f_dw

    max_state = 0.0
    max_shift = 0.0
    for p in ports:
        r, w = (1.0 if p.read else 0.0), (1.0 if p.write else 0.0)
        dec = _DECOUPLING.get(p.protocol, (0, 0))
        bd.decoupling += (dec[0] * r + dec[1] * w) * f_nax
        st = _STATE.get(p.protocol, (0, 0))
        max_state = max(max_state, (st[0] * r), (st[1] * w))
        if has_legalizer:
            pg = _PAGE_SPLIT.get(p.protocol, (0, 0))
            bd.legalizer += pg[0] * r + pg[1] * w
            p2 = _POW2_SPLIT.get(p.protocol, (0, 0))
            bd.legalizer += p2[0] * r + p2[1] * w
        mg = _MANAGERS.get(p.protocol, (0, 0))
        bd.managers += mg[0] * r + mg[1] * w
        sh = _SHIFTER.get(p.protocol, (0, 0))
        max_shift = max(max_shift, sh[0] * r, sh[1] * w)
    bd.state += max_state * f_aw
    bd.shifter += max_shift * f_dw
    return bd


def ge_per_outstanding(ports: Sequence[PortConfig], aw: int = 32,
                       dw: int = 32) -> float:
    """Marginal GE per added outstanding-transfer stage (paper: ~400 GE)."""
    a1 = area_model(ports, aw, dw, nax=8).total
    a2 = area_model(ports, aw, dw, nax=9).total
    return a2 - a1


# --------------------------------------------------------------------------
# Descriptor-plane analytics — vectorized over a DescriptorBatch
# --------------------------------------------------------------------------

def burst_profile(batch: DescriptorBatch, bus_width: int = 4
                  ) -> Dict[str, float]:
    """Burst statistics of a (typically legalized) `DescriptorBatch`.

    Pure array arithmetic — used by the descriptor-plane benchmark to
    characterize million-descriptor streams without materializing objects.
    `beats` uses the simulator's head-misalignment padding rule, so
    `bytes / (beats)` is the shifter efficiency and an upper bound on bus
    utilization for the stream.
    """
    n = len(batch)
    if n == 0:
        return {"n_bursts": 0, "bytes": 0, "beats": 0,
                "min_burst": 0.0, "mean_burst": 0.0, "max_burst": 0.0,
                "shifter_efficiency": 1.0}
    length = batch.length
    beats = beats_array(batch.src_addr, length, bus_width)
    total_beats = int(beats.sum())
    total_bytes_ = int(length.sum())
    return {
        "n_bursts": n,
        "bytes": total_bytes_,
        "beats": total_beats,
        "min_burst": float(length.min()),
        "mean_burst": float(length.mean()),
        "max_burst": float(length.max()),
        "shifter_efficiency": (total_bytes_ / (total_beats * bus_width)
                               if total_beats else 1.0),
    }


def plan_cache_profile(cache) -> Dict[str, float]:
    """Transparent hit/miss statistics of a `core.plan.PlanCache`.

    One flat dict (benchmark-/JSON-friendly): lookup counters, hit rate,
    resident plan count, and the aggregate size of the frozen burst
    streams — the compile-once work that replays are amortizing.
    """
    stats = cache.stats
    plans = cache.plans
    replays = sum(p.replays for p in plans)
    return {
        "lookups": stats.lookups,
        "hits": stats.hits,
        "misses": stats.misses,
        "evictions": stats.evictions,
        "bypasses": stats.bypasses,
        "hit_rate": stats.hit_rate,
        "resident_plans": len(plans),
        "resident_bursts": sum(p.n_bursts for p in plans),
        "resident_bytes": sum(p.total_bytes for p in plans),
        "replays_resident": replays,
    }


# --------------------------------------------------------------------------
# Timing model — longest path in ns (multiplicative inverse of frequency)
# --------------------------------------------------------------------------

#: per-protocol intrinsic path depth in ns at the base configuration,
#: GF12LP+ typical corner (calibrated to Fig. 13's grouping: OBI/AXI-Lite
#: fast ≈ 1.25 GHz; AXI and multi-protocol slower ≈ 1.0–1.1 GHz).
_PROTO_PATH_NS: Dict[Protocol, float] = {
    Protocol.OBI: 0.72,
    Protocol.AXI_LITE: 0.74,
    Protocol.AXI_STREAM: 0.78,
    Protocol.TILELINK: 0.82,
    Protocol.AXI4: 0.84,
    Protocol.INIT: 0.70,
}
_NS_PER_DW_BIT = 0.0002       # barrel-shifter depth grows log-ish; fitted
_NS_PER_AW_BIT = 0.0006       # legalizer compare chains grow with addr width
_NS_PER_LOG2_NAX = 0.008      # FIFO management logic (sub-linear)
_NS_MULTIPROTO = 0.05         # in-path arbitration per extra protocol


def timing_model(ports: Sequence[PortConfig], aw: int = 32, dw: int = 32,
                 nax: int = 2) -> float:
    """Longest path in ns."""
    import math
    base = max((_PROTO_PATH_NS.get(p.protocol, 0.8) for p in ports),
               default=0.7)
    n_protos = len({p.protocol for p in ports})
    path = base
    path += _NS_PER_DW_BIT * max(dw - BASE_DW, 0)
    path += _NS_PER_AW_BIT * max(aw - BASE_AW, 0)
    path += _NS_PER_LOG2_NAX * max(math.log2(max(nax, 1)) - 1, 0)
    path += _NS_MULTIPROTO * max(n_protos - 1, 0)
    # routing/placement congestion of the wide dataflow buffer (quadratic
    # tail the paper attributes to physical effects at large DW)
    path += 0.0000002 * max(dw - 256, 0) ** 2
    return path


def max_frequency_ghz(ports: Sequence[PortConfig], aw: int = 32,
                      dw: int = 32, nax: int = 2) -> float:
    return 1.0 / timing_model(ports, aw, dw, nax)


# --------------------------------------------------------------------------
# Latency model — §4.3 (re-exported from legalizer for one-stop shopping)
# --------------------------------------------------------------------------

def latency_model(num_midends: int = 0, has_legalizer: bool = True,
                  tensor_nd_zero_latency: bool = False) -> int:
    return legal_latency(num_midends, has_legalizer, tensor_nd_zero_latency)


# --------------------------------------------------------------------------
# Reference configurations from the paper, for validation
# --------------------------------------------------------------------------

def pulp_cluster_ports() -> List[PortConfig]:
    """PULP-open cluster iDMAE: AXI4 (host) + OBI (TCDM), both r/w."""
    return [PortConfig(Protocol.AXI4), PortConfig(Protocol.OBI)]


def cheshire_ports() -> List[PortConfig]:
    return [PortConfig(Protocol.AXI4)]


def base_axi_ports() -> List[PortConfig]:
    return [PortConfig(Protocol.AXI4)]


PAPER_CLAIMS = {
    # claim id → (value, unit, where)
    "base_32b_32ot_under_25kge": (25_000, "GE", "§1 bullets / §4.4"),
    "ge_per_outstanding": (400, "GE", "§4.4 Fig 12c"),
    "min_area_floor": (2_000, "GE", "§5 / Table 5"),
    "launch_latency": (2, "cycles", "§4.3"),
    "frequency_over_1ghz": (1.0, "GHz", "§6, 12 nm"),
}
