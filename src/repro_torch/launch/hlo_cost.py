"""Per-rank cost of one call of a cell's step: flops, bytes,
transcendentals and collective bytes (the port's twin of
`repro.launch.hlo_cost`).

The reference parses the optimized HLO text of a compiled cell and
weights each computation by the trip count of the `while` loop that runs
it (`hlo_cost.py:1-21`, `:237-258`).  The port never lowers to HLO: a
cell's step is eager PyTorch, each op dispatched as it runs, so an HLO
parser here would have no input.  Instead `count_call` runs the step once
under `CostMode`, a `TorchDispatchMode` that sees every ATen op of the
call, the backward's included, and counts it as the reference's rules
count an HLO instruction.  Every count is per rank.

Rules:
  * flops: `torch.utils.flop_counter`'s formulas for the matmul-like ops
    (mm, bmm, addmm, baddbmm, convolution, sdpa): the same products the
    reference's `dot` and `convolution` rule counts;
  * transcendentals: the output elements of exp, expm1, tanh, log,
    rsqrt, sqrt, pow, sigmoid, sin and cos (the reference's
    `_TRANS_OPS`; silu, gelu and softplus are ops of their own here and
    are not counted);
  * bytes: each op's tensor operands plus its result.  Views, metadata
    ops and factory ops (no tensor operand: the reference's `constant`,
    `iota`) count 0, as the reference's `_META_OPS` do.  This is the
    traffic of eager ATen ops, one kernel each, with no fusion: an
    elementwise chain that XLA fuses into one pass is a pass an op here,
    so these bytes are not the reference's per-fusion count;
  * collectives: the result bytes of each `_c10d_functional` / `c10d`
    collective, by the reference's five kinds (`COLLECTIVE_OPS`;
    broadcasts and point-to-point sends count as collective-permute),
    added to the bytes as well (wire and HBM touch, as there).  A
    collective reaches the mode with its local shapes.

The level of a count.  The mode sees a DTensor op once, at the global
level: the local op it runs on each rank never reaches the mode.  So an
op with a DTensor result counts its flops times the result's local
numel over its global numel, divided by the size of every mesh dim on
which the result is `Partial` (each rank summed 1/n of the contraction);
its bytes count each DTensor operand and the result by their local
shards.  The collectives of a redistribute reach the mode directly, with
local shapes.  A mesh on the CPU (the fake process group of the dry-run)
has DTensor gather a sequence split and chunk it where NCCL would run an
all-to-all (`shard_dim_alltoall`); `alltoall_as_nccl` counts that as the
one all-to-all of the local result that the card's mesh runs.

What the mode cannot see: the CUDA kernels behind the port's `ctypes`
wrappers (flash, decode attention, the SSD, the copy, Init and matmul
engines) are not ATen ops.  The dry-run costs the plain path, as the
reference's does with `RunConfig(kernels="xla")`, so it calls none.

`while_trips` holds the depth rule's (entry, reps) pairs where the
dry-run extrapolates a cell's depth (`launch.dryrun.count_cell`);
`top_bytes` the heaviest sites, (bytes, op, local type, site): the
site is the chain of the port's functions on the Python stack (the
reference's `op_name` is the name stack of its traced functions), and in
the backward the autograd node that ran the op.
"""

from __future__ import annotations

import contextlib
import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: collective op names (of `_c10d_functional`, `c10d`, `_dtensor`) → kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor",
                          "_c10d_functional_autograd")

#: ops that move no data of their own
_FREE_OPS = {"_wrap_tensor_autograd", "wait_tensor", "detach", "alias",
             "lift_fresh", "_unsafe_view", "set_", "resize_",
             "_local_scalar_dense", "device", "empty_like",
             "new_empty", "new_empty_strided"}

_TRANS_OPS = {"exp", "exp_", "expm1", "expm1_", "tanh", "tanh_", "log",
              "log_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "pow", "pow_",
              "sigmoid", "sigmoid_", "sin", "sin_", "cos", "cos_"}


@dataclass
class CostTotals:
    """The reference's totals, per rank, with `temp_bytes`: the peak of
    the live intermediate bytes of the call."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})
    collective_counts: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})
    while_trips: List[Tuple[str, int]] = field(default_factory=list)
    top_bytes: List[Tuple[float, str, str, str]] = field(
        default_factory=list)      # (bytes, op, local type, site)
    temp_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def numbers(self) -> Dict[str, float]:
        """Every additive count, flat: the depth rule combines these."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "transcendentals": self.transcendentals,
               "temp_bytes": self.temp_bytes}
        for k in COLLECTIVE_OPS:
            out["coll_bytes " + k] = self.collective_bytes[k]
            out["coll_counts " + k] = self.collective_counts[k]
        return out

    @classmethod
    def from_numbers(cls, n: Dict[str, float]) -> "CostTotals":
        t = cls(flops=n["flops"], bytes=n["bytes"],
                transcendentals=n["transcendentals"],
                temp_bytes=n["temp_bytes"])
        for k in COLLECTIVE_OPS:
            t.collective_bytes[k] = n["coll_bytes " + k]
            t.collective_counts[k] = n["coll_counts " + k]
        return t


def _is_dtensor(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and hasattr(t, "_local_tensor")


def local_nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes on this rank: a DTensor's local shard."""
    if _is_dtensor(t):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _local_numel(t: torch.Tensor) -> int:
    return (t._local_tensor if _is_dtensor(t) else t).numel()


def _rank_share(out: Any) -> float:
    """The share of a DTensor op's global work that one rank does: its
    result's local numel over its global numel, over the sizes of the
    mesh dims on which the result is partial; 1 for a plain result."""
    first = next((t for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor)), None)
    if first is None or not _is_dtensor(first):
        return 1.0
    if first.numel() == 0:
        return 0.0
    share = first._local_tensor.numel() / first.numel()
    mesh = first.device_mesh
    for dim, p in enumerate(first.placements):
        if p.is_partial():
            share /= mesh.size(dim)
    return share


def _type_str(t: torch.Tensor) -> str:
    local = t._local_tensor if _is_dtensor(t) else t
    return f"{str(local.dtype).split('.')[-1]}{list(local.shape)}"


def _site() -> str:
    """Where the op ran: the chain of the port's functions on the stack
    (outermost first), or in the backward the autograd node."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return "backward:" + node.name()
    names = []
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "launch" not in fn:
            names.append(f.f_code.co_name)
        f = f.f_back
    return "/".join(reversed(names[:8])) or "?"


class CostMode(TorchDispatchMode):
    """Counts every op dispatched under it by the module's rules; the
    totals are `self.totals`.  With `collect_top`, every counted op's
    (bytes, op, type, site) row is kept, and `collect_sites` also keeps
    every collective's, for `debug_collectives`."""

    def __init__(self, collect_top: int = 0,
                 collect_sites: bool = False) -> None:
        super().__init__()
        self.totals = CostTotals()
        self.collect_top = collect_top
        self.collect_sites = collect_sites
        self.byte_rows: List[Tuple[float, str, str, str]] = []
        self.coll_rows: List[Tuple[float, str, str, str]] = []
        self._live = 0
        self._quiet = 0

    # -- live intermediate bytes ------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        n = local_nbytes(t)
        if n == 0:
            return
        self._live += n
        self.totals.temp_bytes = max(self.totals.temp_bytes, self._live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    # -- counting ----------------------------------------------------------

    def record_collective(self, kind: str, nbytes: float,
                          type_str: str) -> None:
        t = self.totals
        t.collective_bytes[kind] += nbytes
        t.collective_counts[kind] += 1
        t.bytes += nbytes
        if self.collect_sites:
            self.coll_rows.append((nbytes, kind, type_str, _site()))

    @contextlib.contextmanager
    def quiet(self):
        """Ops under this count nothing (the fallback inside an
        all-to-all that `alltoall_as_nccl` counts as one)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
        t = self.totals
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                res = [x for x in tree_leaves(out)
                       if isinstance(x, torch.Tensor)]
                nbytes = sum(local_nbytes(x) for x in res)
                self.record_collective(kind, nbytes,
                                       _type_str(res[0]) if res else "?")
                for x in res:
                    self._track(x)
            return
        if name in _FREE_OPS or func.is_view:
            return
        operands = [x for x in tree_leaves((args, kwargs))
                    if isinstance(x, torch.Tensor)]
        results = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if not operands:
            for x in results:           # a factory op: no traffic counted
                self._track(x)
            return
        from torch.utils.flop_counter import flop_registry

        if packet in flop_registry:
            t.flops += flop_registry[packet](*args, **kwargs,
                                             out_val=out) * _rank_share(out)
        if name in _TRANS_OPS:
            t.transcendentals += sum(_local_numel(x) for x in results)
        nbytes = sum(local_nbytes(x) for x in operands + results)
        t.bytes += nbytes
        if self.collect_top:
            self.byte_rows.append((nbytes, name,
                                   _type_str(results[0]) if results
                                   else "?", _site()))
        aliased = func._schema.returns and \
            func._schema.returns[0].alias_info is not None
        if not aliased:
            for x in results:
                self._track(x)


@contextlib.contextmanager
def alltoall_as_nccl(mode: CostMode):
    """DTensor's `shard_dim_alltoall` counted as the all-to-all NCCL runs
    (its local result's bytes), where a CPU mesh gathers and chunks."""
    from torch.distributed.tensor import _collective_utils, placement_types

    inner = _collective_utils.shard_dim_alltoall

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return inner(input, gather_dim, shard_dim, mesh, mesh_dim)
        with mode.quiet():
            out = inner(input, gather_dim, shard_dim, mesh, mesh_dim)
        mode.record_collective("all-to-all", local_nbytes(out),
                               _type_str(out))
        mode._track(out)
        return out

    mods = [m for m in (_collective_utils, placement_types)
            if getattr(m, "shard_dim_alltoall", None) is inner]
    for m in mods:
        m.shard_dim_alltoall = counted
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = inner


def count_call(fn: Callable, *args, collect_top: int = 0,
               collect_sites: bool = False, **kwargs
               ) -> Tuple[Any, CostTotals, CostMode]:
    """(fn(*args, **kwargs), its per-rank `CostTotals`, the mode) for one
    call under `CostMode`; with `collect_top`, the heaviest sites by
    bytes in `totals.top_bytes`."""
    mode = CostMode(collect_top=collect_top, collect_sites=collect_sites)
    with mode, alltoall_as_nccl(mode):
        out = fn(*args, **kwargs)
    if collect_top:
        mode.totals.top_bytes = sorted(mode.byte_rows,
                                       key=lambda r: -r[0])[:collect_top]
    return out, mode.totals, mode
