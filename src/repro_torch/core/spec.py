"""Composable instantiation — the paper's modularity story as the API.

The paper's central claim is that iDMA is *modular*: a concrete engine is
a composition of a front-end (control plane, §2.1), a chain of mid-ends
(transfer acceleration, §2.2) and one or more back-ends (data plane,
§2.3), selected independently per instantiation (PULP cluster, Manticore,
Cheshire — §3).  This module makes that composition the repo's public
construction API:

* :class:`FrontendSpec`   — which control plane (``reg`` / ``desc`` /
  ``inst``) with its options (register width / dims, doorbell mode);
* :class:`MidendStage`    — a typed mid-end pipeline stage transforming a
  `DescriptorBatch` into a `DescriptorBatch` *on the vectorized plane*.
  Stages carry a structural ``signature()`` and an address ``modulus()``,
  which is what keeps custom pipelines **plan-cacheable**: the plan cache
  keys captures on the per-stage signatures and widens the address-residue
  modulus by each stage's ``modulus()`` (see `core.plan`), so a pipeline
  like ND → split → dist replays like any built-in lowering.  Object-level
  ``List[Transfer1D]`` callables (the legacy ``midends=`` kwarg) are
  neither vectorized nor cacheable and survive only as a deprecation shim;
* :class:`BackendSpec`    — data-plane shape: port count, address
  boundary, bus width, protocol ports, error policy;
* :class:`ChannelSpec`    — submission channels and their distribution
  scheme;
* :class:`EngineSpec`     — the validated bundle, plus the timing models
  (`EngineConfig`, src/dst `MemSystem`) and default memory spaces that
  make ``build_engine(spec)`` a one-call instantiation;
* named presets           — :func:`pulp_cluster`, :func:`manticore`,
  :func:`cheshire` (§3.1/§3.5/§3.3) and :func:`edge_ai` (this repo's
  TPU-serving flavour), registered in :data:`PRESETS` for
  ``benchmarks/run.py --engine <preset>``.

``build_engine(spec)`` is the front door; ``IDMAEngine(**kwargs)`` remains
as a thin legacy shim that snapshots an equivalent spec (`spec_of`).
Parity is enforced by ``tests/test_spec.py``: every preset's spec-built
engine is byte- and cycle-identical to its hand-wired equivalent, plan
cache on and off.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Tuple, Union

from .descriptor import (DescriptorBatch, NdTransfer, Protocol, RtConfig,
                         concat_batches)
from .engine import ErrorPolicy, IDMAEngine
from .frontend import FRONTENDS, make_frontend
from .midend import mp_dist_batch, mp_split_batch, rt_schedule
from .plan import PlanCache
from .simulator import (HBM, PULP_L2, PULP_TCDM, RPC_DRAM, SRAM,
                        EngineConfig, MemSystem, cheshire_idma_config,
                        manticore_idma_config, pulp_idma_config)

__all__ = [
    "MidendStage", "MpSplitStage", "MpDistStage", "RtReplicateStage",
    "CustomStage", "FrontendSpec", "BackendSpec", "ChannelSpec",
    "IrqSpec", "EngineSpec", "build_engine", "build_frontend", "spec_of",
    "pulp_cluster", "manticore", "cheshire", "edge_ai", "PRESETS",
    "preset", "VMEM_ENDPOINT",
]


#: VMEM as a transport-layer endpoint (same parameters as the Pallas copy
#: engine's estimate endpoint — defined here so specs need no jax import).
VMEM_ENDPOINT = MemSystem("VMEM", latency=2, outstanding=8)


# --------------------------------------------------------------------------
# Mid-end pipeline stages — DescriptorBatch → DescriptorBatch
# --------------------------------------------------------------------------

class MidendStage:
    """One typed mid-end pipeline stage (paper §2.2 on the SoA plane).

    ``apply`` rewrites a `DescriptorBatch` into the stage's output batch —
    always whole-array ops, never per-descriptor Python, so spec pipelines
    stay on the engine's vectorized path.  The two extra methods are what
    make pipelines *plan-cacheable* (`core.plan`):

    * ``signature()`` — a hashable structural key for the stage's
      configuration, or ``None`` when the stage's output cannot be keyed
      structurally (then engines with a plan cache bypass it and surface
      the bypass in ``EngineStats.plan_bypasses``);
    * ``modulus()``   — the address modulus under which the stage's output
      *structure* (row count, cut points, routing) is invariant: rebasing
      every input address by a multiple of this value must not change
      which rows are emitted where.  The plan signature folds it into the
      residue modulus so captured plans replay soundly.

    A cacheable stage must derive its output rows from the input rows via
    gathers/shifts only (as `DescriptorBatch.select`/``rewrite`` do): the
    plan's relocation table maps every emitted burst back to an input
    descriptor through the ``transfer_id`` column.

    **Value stages.**  Most stages are pure *structure*: their output
    addresses are the input addresses plus per-row offsets, which is the
    linear relation plan replay's ``rebind`` assumes.  A stage that
    rewrites address *values* non-linearly (the canonical example is
    `repro_torch.core.vm.TranslateStage`, whose VA→PA mapping is piecewise
    per page) splits its work across two hooks so it stays plan-cacheable:

    * ``apply_structure(batch)`` — only the structural part (row splits/
      routing), leaving addresses on the input (virtual) plane.  Plan
      capture runs this, so captured plans live on the virtual plane and
      ``rebind`` stays linear;
    * ``rebind_values(batch)`` — rewrite the address values of an
      already-structured batch (every row legal w.r.t. the stage's
      structure).  The engine applies this after plan rebind — and after
      the uncached ``apply`` path implicitly via
      ``apply == rebind_values ∘ apply_structure``.

    The default ``apply_structure`` simply runs ``apply`` (pure-structure
    stages).  Stages with a distinct ``rebind_values`` should set a
    truthy ``translates`` class attribute so the engine routes faults and
    value-rebinds for them.
    """

    name: str = "midend"
    #: stages that rewrite address values (see class docstring) set this
    translates: bool = False

    def apply(self, batch: DescriptorBatch) -> DescriptorBatch:
        raise NotImplementedError

    def apply_structure(self, batch: DescriptorBatch) -> DescriptorBatch:
        """The structural part of ``apply`` (plan capture runs this);
        identical to ``apply`` for pure-structure stages."""
        return self.apply(batch)

    def __call__(self, batch: DescriptorBatch) -> DescriptorBatch:
        return self.apply(batch)

    def signature(self) -> Optional[Hashable]:
        return None

    def modulus(self) -> int:
        return 1


@dataclass(frozen=True)
class MpSplitStage(MidendStage):
    """``mp_split`` as a pipeline stage: no emitted row crosses a
    `boundary`-aligned address on the chosen port(s) (MemPool L1 banks)."""

    boundary: int
    which: str = "dst"
    name: str = "mp_split"

    def __post_init__(self) -> None:
        if self.boundary <= 0 or (self.boundary & (self.boundary - 1)):
            raise ValueError("mp_split boundary must be a positive power "
                             f"of two, got {self.boundary}")
        if self.which not in ("src", "dst", "both"):
            raise ValueError(f"unknown mp_split port {self.which!r}")

    def apply(self, batch: DescriptorBatch) -> DescriptorBatch:
        return mp_split_batch(batch, self.boundary, which=self.which)

    def signature(self) -> Hashable:
        return ("mp_split", self.boundary, self.which)

    def modulus(self) -> int:
        # cut points are a function of addr mod boundary
        return self.boundary


@dataclass(frozen=True)
class MpDistStage(MidendStage):
    """``mp_dist`` as a pipeline stage: route rows over `num_ports`
    downstream ports, re-emitted port-major (the flattened binary tree of
    paper Fig. 9 — ordering matches ``mp_dist_batch`` port order)."""

    num_ports: int
    scheme: str = "address"
    boundary: int = 0
    which: str = "dst"
    name: str = "mp_dist"

    def __post_init__(self) -> None:
        if self.num_ports < 1:
            raise ValueError("mp_dist needs num_ports >= 1")
        if self.scheme not in ("address", "round_robin"):
            raise ValueError(f"unknown mp_dist scheme {self.scheme!r}")
        if self.scheme == "address" and self.boundary <= 0:
            raise ValueError("address mp_dist scheme needs the boundary")

    def apply(self, batch: DescriptorBatch) -> DescriptorBatch:
        return concat_batches(
            mp_dist_batch(batch, self.num_ports, scheme=self.scheme,
                          boundary=self.boundary, which=self.which))

    def signature(self) -> Hashable:
        return ("mp_dist", self.num_ports, self.scheme, self.boundary,
                self.which)

    def modulus(self) -> int:
        # address routing reads (addr // boundary) % num_ports, a function
        # of addr mod (boundary * num_ports); round-robin is positional
        if self.scheme == "address":
            return self.boundary * self.num_ports
        return 1


@dataclass(frozen=True)
class RtReplicateStage(MidendStage):
    """The ``rt_3D`` real-time mid-end as a pipeline stage: materialize
    the autonomous re-launches within `horizon` cycles as replicated rows
    (`rt_schedule` decides how many launches fit)."""

    period: int
    horizon: int
    num_launches: int = 0
    name: str = "rt_replicate"

    def __post_init__(self) -> None:
        RtConfig(self.period, self.num_launches)   # validates period
        if self.horizon <= 0:
            raise ValueError(f"rt horizon must be positive, "
                             f"got {self.horizon}")

    def _launches(self) -> int:
        probe = NdTransfer(0, 0, 1)
        return len(rt_schedule(RtConfig(self.period, self.num_launches),
                               probe, self.horizon))

    def apply(self, batch: DescriptorBatch) -> DescriptorBatch:
        n = self._launches()
        if n <= 1:
            return batch
        return concat_batches([batch] * n)

    def signature(self) -> Hashable:
        return ("rt_replicate", self.period, self.horizon,
                self.num_launches)


@dataclass(frozen=True)
class CustomStage(MidendStage):
    """Wrap an arbitrary ``DescriptorBatch → DescriptorBatch`` function.

    Cacheable only when a ``key`` is supplied: the caller asserts that the
    function's output structure is a pure function of the input structure
    and of addresses mod ``address_modulus`` (and that rows derive from
    input rows by gathers, preserving ``transfer_id``).  Without a key the
    stage still runs on the vectorized path but plan-caching engines
    bypass the cache for its submissions.
    """

    fn: Callable[[DescriptorBatch], DescriptorBatch]
    name: str = "custom"
    key: Optional[Hashable] = None
    address_modulus: int = 1

    def __post_init__(self) -> None:
        if self.address_modulus < 1:
            raise ValueError("address_modulus must be >= 1")

    def apply(self, batch: DescriptorBatch) -> DescriptorBatch:
        return self.fn(batch)

    def signature(self) -> Optional[Hashable]:
        if self.key is None:
            return None
        return ("custom", self.name, self.key, self.address_modulus)

    def modulus(self) -> int:
        return self.address_modulus


# --------------------------------------------------------------------------
# The composition spec
# --------------------------------------------------------------------------

#: single source of truth for control-plane kinds: frontend.FRONTENDS
_FRONTEND_KINDS = tuple(FRONTENDS)


@dataclass(frozen=True)
class FrontendSpec:
    """Control-plane selection (paper §2.1, Table 1).

    ``kind``      — ``"reg"`` (core-private register file), ``"desc"``
                    (in-memory descriptor chains/rings, doorbell launch)
                    or ``"inst"`` (Snitch-style custom instructions);
    ``word_bits`` / ``ndims`` — register-file geometry (``reg`` only);
    ``doorbell``  — ``"sync"`` or ``"async"``: whether ``desc`` doorbells
                    execute inline or enqueue on the engine's channel
                    queues (completed by ``engine.wait_all()``);
    ``ring_bytes``— descriptor-buffer size allocated when ``build`` is not
                    handed an explicit memory buffer (``desc`` only).
    """

    kind: str = "reg"
    word_bits: int = 32
    ndims: int = 1
    doorbell: str = "sync"
    ring_bytes: int = 1 << 16

    def __post_init__(self) -> None:
        if self.kind not in _FRONTEND_KINDS:
            raise ValueError(f"unknown front-end kind {self.kind!r}: "
                             f"expected one of {_FRONTEND_KINDS}")
        if self.word_bits not in (32, 64):
            raise ValueError(f"front-end word_bits must be 32 or 64, "
                             f"got {self.word_bits}")
        if self.kind in ("desc", "inst") and self.word_bits != 64:
            # the paper's Table 1 bindings are desc_64 / inst_64 only
            raise ValueError(f"{self.kind} front-ends are 64-bit "
                             f"({self.kind}_64), got word_bits="
                             f"{self.word_bits}")
        if self.ndims < 1:
            raise ValueError("front-end ndims must be >= 1")
        if self.doorbell not in ("sync", "async"):
            raise ValueError(f"doorbell must be 'sync' or 'async', "
                             f"got {self.doorbell!r}")
        if self.doorbell == "async" and self.kind != "desc":
            # only the descriptor control plane has a doorbell to defer;
            # silently dropping the option would misdescribe the build
            raise ValueError(f"doorbell='async' is a desc front-end "
                             f"option; {self.kind} front-ends submit "
                             f"synchronously")
        if self.ring_bytes < 1:
            raise ValueError("ring_bytes must be >= 1")

    @property
    def name(self) -> str:
        if self.kind == "reg":
            suffix = "" if self.ndims == 1 else f"_{self.ndims}d"
            return f"reg_{self.word_bits}{suffix}"
        return f"{self.kind}_{self.word_bits}"

    def build(self, engine: IDMAEngine, memory: Optional[bytearray] = None):
        """Instantiate the front-end against `engine` (see
        `frontend.make_frontend`)."""
        if self.kind == "desc" and memory is None:
            memory = bytearray(self.ring_bytes)
        return make_frontend(self.kind, engine, memory=memory,
                             word_bits=self.word_bits, ndims=self.ndims,
                             async_submit=self.doorbell == "async")


@dataclass(frozen=True)
class BackendSpec:
    """Data-plane shape (paper §2.3 + §3.6 wrapper parameters).

    ``num_ports`` > 1 gives the MemPool-style address-distributed
    multi-back-end (split at ``boundary``); ``protocols`` documents the
    protocol ports the instantiation exposes (used by presets for the
    area/timing models and by `build_engine` to size default memory
    spaces); ``error_policy`` is validated eagerly (§2.3 verbs).
    """

    num_ports: int = 1
    boundary: int = 0
    bus_width: int = 8
    protocols: Tuple[Protocol, ...] = ()
    error_policy: ErrorPolicy = field(default_factory=ErrorPolicy)

    def __post_init__(self) -> None:
        if self.num_ports < 1:
            raise ValueError("back-end num_ports must be >= 1")
        if self.num_ports > 1 and self.boundary <= 0:
            raise ValueError("multi-port back-ends need a positive "
                             "address boundary")
        if self.bus_width < 1 or (self.bus_width & (self.bus_width - 1)):
            raise ValueError(f"bus_width must be a positive power of two, "
                             f"got {self.bus_width}")

    def signature(self) -> Hashable:
        return ("backend", self.num_ports, self.boundary, self.bus_width,
                tuple(self.protocols), self.error_policy.action,
                self.error_policy.max_replays,
                self.error_policy.replay_backoff,
                self.error_policy.backoff_cap)


@dataclass(frozen=True)
class IrqSpec:
    """Completion-interrupt shape (MSI-X style, `core.frontend
    .IrqController`).

    Per-channel completion events are posted to ``vectors`` interrupt
    vectors (``0`` → one vector per channel) and *coalesced*: a vector
    fires once ``coalesce_count`` events are pending, or once the oldest
    pending event is ``coalesce_cycles`` engine cycles older than the
    newest (``0`` disables the cycle threshold).  Whatever is still
    pending when a drain completes is flushed — the timeout kick of a
    real interrupt controller — so no completion is ever lost to
    coalescing.  Delivery never changes timing or byte movement; it only
    batches the callbacks.
    """

    coalesce_count: int = 1
    coalesce_cycles: int = 0
    vectors: int = 0              # 0: one vector per channel

    def __post_init__(self) -> None:
        if self.coalesce_count < 1:
            raise ValueError("irq coalesce_count must be >= 1")
        if self.coalesce_cycles < 0:
            raise ValueError("irq coalesce_cycles must be >= 0")
        if self.vectors < 0:
            raise ValueError("irq vectors must be >= 0")

    def signature(self) -> Hashable:
        return ("irq", self.coalesce_count, self.coalesce_cycles,
                self.vectors)


@dataclass(frozen=True)
class ChannelSpec:
    """Submission-channel shape: how many concurrent channels the control
    plane exposes and how batched dispatches shard across them."""

    count: int = 1
    scheme: str = "round_robin"
    boundary: int = 0

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError("channel count must be >= 1")
        if self.scheme not in ("round_robin", "address"):
            raise ValueError(f"unknown channel scheme {self.scheme!r}")
        if self.scheme == "address" and self.boundary <= 0:
            raise ValueError("address channel scheme needs a positive "
                             "boundary")

    def signature(self) -> Hashable:
        return ("channels", self.count, self.scheme, self.boundary)


@dataclass(frozen=True)
class EngineSpec:
    """One validated iDMA instantiation: front-end × mid-end pipeline ×
    back-end × channels, bundled with the timing models that make the
    composition simulatable and the default memory spaces that make it
    runnable (``build_engine(spec)``).

    ``plan_cache`` — ``False`` (off), ``True`` (LRU cache of default
    capacity) or an ``int`` capacity.  Spec pipelines whose every stage is
    structurally signed stay plan-cacheable; `build_engine` refuses
    nothing here — uncacheable custom stages merely bypass per submission
    (surfaced in ``EngineStats.plan_bypasses``).
    """

    name: str = "custom"
    frontend: FrontendSpec = field(default_factory=FrontendSpec)
    midend: Tuple[MidendStage, ...] = ()
    backend: BackendSpec = field(default_factory=BackendSpec)
    channels: ChannelSpec = field(default_factory=ChannelSpec)
    irq: IrqSpec = field(default_factory=IrqSpec)
    sim_config: Optional[EngineConfig] = None
    src_system: MemSystem = SRAM
    dst_system: MemSystem = SRAM
    plan_cache: Union[bool, int] = False
    #: default `MemoryMap` spaces for `build_engine` (protocol, bytes);
    #: empty means build a timing-only engine unless a mem is passed in.
    mem_spaces: Tuple[Tuple[Protocol, int], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "midend", tuple(self.midend))
        object.__setattr__(self, "mem_spaces",
                           tuple((p, int(s)) for p, s in self.mem_spaces))
        for st in self.midend:
            if not isinstance(st, MidendStage):
                raise TypeError(
                    f"midend entries must be MidendStage instances, got "
                    f"{type(st).__name__} — wrap object-level callables "
                    f"in CustomStage or use the legacy midends= kwarg")
        if isinstance(self.plan_cache, bool):
            pass
        elif isinstance(self.plan_cache, int):
            if self.plan_cache < 1:
                raise ValueError("plan_cache capacity must be >= 1")
        else:
            raise TypeError("plan_cache must be a bool or an int capacity")
        for proto, size in self.mem_spaces:
            if size < 1:
                raise ValueError(f"mem space for {proto} must be >= 1 B")

    @property
    def effective_sim_config(self) -> EngineConfig:
        """The bundled `EngineConfig`, or the same default `IDMAEngine`
        derives: engine bus width, one modeled mid-end per stage."""
        if self.sim_config is not None:
            return self.sim_config
        return EngineConfig(bus_width=self.backend.bus_width,
                            num_midends=len(self.midend))

    def cacheable(self) -> bool:
        """Whether every pipeline stage is structurally signed — i.e.
        whether a plan cache can serve this composition."""
        return all(st.signature() is not None for st in self.midend)

    def signature(self) -> Hashable:
        """Structural signature of the composition — what plan capture is
        keyed on (via the per-stage signatures) plus everything else that
        shapes lowering/timing.  ``None`` stage signatures poison the key
        (uncacheable compositions never share plans)."""
        return (
            "engine_spec", self.name, self.frontend,
            tuple(st.signature() for st in self.midend),
            self.backend.signature(), self.channels.signature(),
            self.irq.signature(),
            self.effective_sim_config, self.src_system, self.dst_system,
        )


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------

def build_engine(spec: EngineSpec,
                 mem: Optional["MemoryMap"] = None,
                 plan_cache: Union[None, bool, int, PlanCache] = None,
                 sanitize: Union[bool, str] = False,
                 ) -> IDMAEngine:
    """Instantiate an `IDMAEngine` from a validated `EngineSpec`.

    ``mem``        — explicit `MemoryMap` (overrides ``spec.mem_spaces``);
    ``plan_cache`` — override the spec's plan-cache choice: ``None`` keeps
    the spec default, ``False`` disables, ``True``/int builds a fresh
    `PlanCache`, an existing `PlanCache` is shared as-is;
    ``sanitize``   — opt into the `repro_torch.sanitize` static analyzer
    on every drain (``True``/``"raise"`` raises `SanitizeError` on a hazard,
    ``"warn"`` warns and drains anyway).
    """
    from .backend import MemoryMap
    if mem is None and spec.mem_spaces:
        mem = MemoryMap.create(dict(spec.mem_spaces))
    if plan_cache is None:
        plan_cache = spec.plan_cache
    if plan_cache is False:
        cache = None
    elif plan_cache is True:
        cache = PlanCache()
    elif isinstance(plan_cache, int):
        cache = PlanCache(capacity=plan_cache)
    else:
        cache = plan_cache
    eng = IDMAEngine(
        mem=mem,
        pipeline=spec.midend,
        num_backends=spec.backend.num_ports,
        backend_boundary=spec.backend.boundary,
        bus_width=spec.backend.bus_width,
        error_policy=spec.backend.error_policy,
        sim_config=spec.effective_sim_config,
        src_system=spec.src_system,
        dst_system=spec.dst_system,
        num_channels=spec.channels.count,
        channel_scheme=spec.channels.scheme,
        channel_boundary=spec.channels.boundary,
        plan_cache=cache,
        irq=spec.irq,
        sanitize=sanitize,
    )
    eng._spec = spec
    return eng


def build_engines(spec: EngineSpec, n: int,
                  mem: Optional["MemoryMap"] = None,
                  plan_cache: Union[None, bool, int, PlanCache] = None
                  ) -> List[IDMAEngine]:
    """Instantiate ``n`` engines of one spec as a shared-memory cluster.

    This is the multi-engine construction path of the paper's §V
    multi-cluster instantiations (and the `repro_torch.dist` collective
    fabric): all ``n`` engines share

    * one `MemoryMap` (built from ``spec.mem_spaces`` unless ``mem`` is
      given) — their functional data planes address the same bytes;
    * the *same* ``spec.src_system``/``spec.dst_system`` `MemSystem`
      objects — `simulate_channels` keys endpoint contention on object
      identity, so the engines contend for the endpoint's outstanding
      credits, data port and request channel;
    * one `PlanCache` (unless disabled): structurally repeated traffic
      — the same collective phase on another engine, or the next
      iteration of the same schedule — replays captured plans across
      engine instances.
    """
    if n < 1:
        raise ValueError("build_engines needs n >= 1")
    from .backend import MemoryMap
    if mem is None and spec.mem_spaces:
        mem = MemoryMap.create(dict(spec.mem_spaces))
    if plan_cache is None:
        plan_cache = spec.plan_cache
    # normalize once so every engine shares a single cache instance
    if plan_cache is True:
        plan_cache = PlanCache()
    elif isinstance(plan_cache, int) and not isinstance(plan_cache, bool):
        plan_cache = PlanCache(capacity=plan_cache)
    return [build_engine(spec, mem=mem, plan_cache=plan_cache)
            for _ in range(n)]


def build_frontend(spec: Union[EngineSpec, FrontendSpec],
                   engine: IDMAEngine,
                   memory: Optional[bytearray] = None):
    """Instantiate the spec's front-end bound to `engine`."""
    fe = spec.frontend if isinstance(spec, EngineSpec) else spec
    return fe.build(engine, memory=memory)


def _bridge_legacy_midend(me: Callable) -> Callable[
        [DescriptorBatch], DescriptorBatch]:
    """Adapt a legacy ``List[Transfer1D] → List[Transfer1D]`` callable to
    the batch plane (object bridge on both sides — slow, uncacheable,
    exactly what the legacy kwarg costs)."""
    def fn(batch: DescriptorBatch) -> DescriptorBatch:
        return DescriptorBatch.from_transfers(me(batch.to_transfers()))
    return fn


def spec_of(engine: IDMAEngine) -> EngineSpec:
    """Snapshot an `EngineSpec` equivalent to a (legacy, kwarg-built)
    engine.  The front-end is not part of engine state, so it snapshots
    as the default; legacy object-level ``midends`` callables are
    wrapped as unsigned (uncacheable) `CustomStage`s over the object
    bridge, so rebuilding via ``build_engine(engine.spec)`` reproduces
    the same lowering at the legacy kwarg's object-path cost."""
    stages = tuple(engine.pipeline)
    if engine.midends:
        stages = stages + tuple(
            CustomStage(fn=_bridge_legacy_midend(me),
                        name=getattr(me, "__name__", "legacy"))
            for me in engine.midends)
    return EngineSpec(
        name="custom",
        midend=stages,
        backend=BackendSpec(
            num_ports=engine.num_backends,
            boundary=engine.backend_boundary,
            bus_width=engine.bus_width,
            error_policy=engine.error_policy,
        ),
        channels=ChannelSpec(count=engine.num_channels,
                             scheme=engine.channel_scheme,
                             boundary=engine.channel_boundary),
        irq=engine.irq_spec if isinstance(engine.irq_spec, IrqSpec)
        else IrqSpec(),
        sim_config=engine.sim_config,
        src_system=engine.src_system,
        dst_system=engine.dst_system,
        plan_cache=engine.plan_cache is not None,
    )


# --------------------------------------------------------------------------
# Named presets — the paper's instantiation matrix (§3) + the TPU flavour
# --------------------------------------------------------------------------

def pulp_cluster(num_channels: int = 1,
                 plan_cache: Union[bool, int] = False) -> EngineSpec:
    """PULP-open cluster iDMAE (§3.1): core-private ``reg_32_3d``
    front-end, ``tensor_ND(3)`` mid-end modeled at zero latency, 64-b AXI
    to L2 / OBI to the TCDM, 16 outstanding."""
    return EngineSpec(
        name="pulp_cluster",
        frontend=FrontendSpec(kind="reg", word_bits=32, ndims=3),
        backend=BackendSpec(bus_width=8,
                            protocols=(Protocol.AXI4, Protocol.OBI)),
        channels=ChannelSpec(count=num_channels),
        sim_config=pulp_idma_config(),
        src_system=PULP_L2,
        dst_system=PULP_TCDM,
        plan_cache=plan_cache,
        mem_spaces=((Protocol.AXI4, 1 << 20), (Protocol.OBI, 1 << 20)),
    )


def manticore(num_channels: int = 1,
              plan_cache: Union[bool, int] = False) -> EngineSpec:
    """Manticore cluster DMA (§3.5): Snitch ``inst_64`` front-end, 512-b
    data path into HBM, 32 outstanding."""
    return EngineSpec(
        name="manticore",
        frontend=FrontendSpec(kind="inst", word_bits=64),
        backend=BackendSpec(bus_width=64, protocols=(Protocol.AXI4,)),
        channels=ChannelSpec(count=num_channels),
        sim_config=manticore_idma_config(),
        src_system=HBM,
        dst_system=SRAM,
        plan_cache=plan_cache,
        mem_spaces=((Protocol.AXI4, 4 << 20),),
    )


def cheshire(num_channels: int = 1,
             plan_cache: Union[bool, int] = False) -> EngineSpec:
    """Cheshire system DMA (§3.3): Linux-style ``desc_64`` front-end
    (chained descriptors, doorbell launch), 64-b AXI, 8 outstanding,
    RPC-DRAM main memory."""
    return EngineSpec(
        name="cheshire",
        frontend=FrontendSpec(kind="desc", word_bits=64),
        backend=BackendSpec(bus_width=8, protocols=(Protocol.AXI4,)),
        channels=ChannelSpec(count=num_channels),
        sim_config=cheshire_idma_config(),
        src_system=RPC_DRAM,
        dst_system=RPC_DRAM,
        plan_cache=plan_cache,
        mem_spaces=((Protocol.AXI4, 2 << 20),),
    )


def edge_ai(num_channels: int = 4,
            plan_cache: Union[bool, int] = 128) -> EngineSpec:
    """This repo's TPU-serving flavour: asynchronous descriptor doorbells
    sharded over concurrent channels, HBM↔VMEM protocol ports, plan cache
    on by default (the paged-KV decode engine of `serve.kvcache`)."""
    return EngineSpec(
        name="edge_ai",
        frontend=FrontendSpec(kind="desc", word_bits=64, doorbell="async"),
        backend=BackendSpec(bus_width=8,
                            protocols=(Protocol.HBM, Protocol.VMEM)),
        channels=ChannelSpec(count=num_channels),
        sim_config=EngineConfig(bus_width=8, n_outstanding=32,
                                buffer_beats=32),
        src_system=HBM,
        dst_system=VMEM_ENDPOINT,
        plan_cache=plan_cache,
        mem_spaces=((Protocol.HBM, 4 << 20), (Protocol.VMEM, 1 << 20)),
    )


#: preset name → spec factory (``benchmarks/run.py --engine <name>``)
PRESETS: Dict[str, Callable[..., EngineSpec]] = {
    "pulp_cluster": pulp_cluster,
    "manticore": manticore,
    "cheshire": cheshire,
    "edge_ai": edge_ai,
}


def preset(name: str, **overrides) -> EngineSpec:
    """Resolve a named preset to its `EngineSpec`."""
    try:
        factory = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown engine preset {name!r}: expected one "
                         f"of {sorted(PRESETS)}") from None
    return factory(**overrides)
