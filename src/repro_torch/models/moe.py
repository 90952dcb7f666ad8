"""Mixture-of-experts FFN with sort-based capacity dispatch (the port of
`repro.models.moe` on one device).

Dispatch is the `mp_split` + `mp_dist` story (paper §2.2/§3.4) applied to
tokens: the router splits the token stream along expert boundaries
(mp_split ≡ grouping by expert id via one stable argsort) and distributes
the groups to per-expert buffers (mp_dist ≡ scatter into the (E, C, d)
capacity buffer) that the batched expert GEMMs consume.  Top-k routing
with a capacity factor; overflowed (token, expert) pairs are dropped
(contribution zero) and counted; a Switch-style load-balancing loss is
returned.

Three choices keep the port's results equal to the reference's and the
same from run to run on the card:
  * top-k is a stable descending sort, so equal router probabilities go
    to the lower expert id, as `jax.lax.top_k` breaks ties;
  * the dispatch writes each kept pair by index assignment: the kept
    slots are unique, so the buffer is exact;
  * the combine adds a token's k expert outputs one at a time, in
    ascending expert id (the order the reference's scatter-add visits
    them), in the compute dtype, with no atomics.

On a mesh (`dist.sharding.set_moe_mesh`) `moe_forward` takes the mesh
dispatch, the reference's `shard_map` one: each data shard routes,
sorts and scatters ITS tokens (capacity from its local token count), the
expert GEMMs are split over 'model' on d_ff, and one reduction over
'model' finishes them — `psum` of the (E, C, d) outputs, `scatter`
(reduce-scatter over d, combine on the shard, all-gather) or
`combine_first` (combine the partial outputs into (T, d), then sum).
The collectives are DTensor redistributions on the mesh's sub-meshes,
each differentiated as its `shard_map` counterpart is (`_Collective`), so
gradients through the dispatch are the reference's `jax.grad` of its
sharded run: a replicated weight's gradient is summed over the data
ranks once.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig, RunConfig
from repro_torch.core.vm import expert_gather_batch
from repro_torch.dist.sharding import (P, data_axes, moe_mesh, placements,
                                      zip_axis)
from .common import activate, dense, rows_only
from .ffn import FFN, ffn_forward


class MoE(nn.Module):
    """The router (d, E), the stacked expert weights `w_gate` / `w_up`
    (E, d, f) and `w_down` (E, f, d), and with shared experts the
    always-on `shared` FFN of `d_ff_shared` and its sigmoid gate
    `shared_gate` (d, 1).  `dtype` is the compute dtype; all are stored
    in `param_dtype` (`dtype` when None)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device,
                 param_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dtype = dtype
        mc, d = cfg.moe, cfg.d_model
        E, f = mc.n_experts, mc.d_ff_expert
        kw = dict(dtype=param_dtype or dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, E, **kw))
        self.w_gate = nn.Parameter(torch.empty(E, d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(E, d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(E, f, d, **kw))
        if mc.n_shared_experts:
            self.shared = FFN(d, mc.d_ff_shared, dtype, device, param_dtype)
            self.shared_gate = nn.Parameter(torch.empty(d, 1, **kw))


def _capacity(tokens: int, mc: MoEConfig) -> int:
    cap = int(mc.capacity_factor * tokens * mc.top_k / mc.n_experts)
    return max(8, -(-cap // 8) * 8)


class Routing(NamedTuple):
    """One routing of T tokens to k of E experts with capacity C.  The
    pair columns (`e_s`, `t_s`, `g_s`, `keep`, `slot`) are in the stable
    order of their expert id; `slot` is e·C + rank, E·C (the trash row)
    where the pair is dropped."""

    logits: torch.Tensor      # (T, E) fp32
    probs: torch.Tensor       # (T, E) fp32
    expert_idx: torch.Tensor  # (T, k) int64, by falling probability
    e_s: torch.Tensor         # (T·k,)
    t_s: torch.Tensor
    g_s: torch.Tensor         # gates, normalised over a token's k
    keep: torch.Tensor        # (T·k,) bool
    slot: torch.Tensor        # (T·k,) int64
    capacity: int
    order: torch.Tensor       # (T·k,) the pairs' token-major indices


def route(router: torch.Tensor, x2: torch.Tensor, mc: MoEConfig,
          dtype: Optional[torch.dtype] = None) -> Routing:
    """mp_split: the router's top-k of x2 (T, d), grouped by expert id;
    the logits are the product in the compute dtype `dtype` (the
    router's own when None), upcast."""
    T = x2.shape[0]
    E, k = mc.n_experts, mc.top_k
    C = _capacity(T, mc)
    logits = dense(x2, router, dtype=dtype).float()
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: ties go to the lower expert id
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate, expert_idx = gate[:, :k], expert_idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    t_s = torch.div(order, k, rounding_mode="floor")   # repeat(arange(T), k)
    g_s = gate.reshape(-1)[order]
    first = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(T * k, device=x2.device) - first
    keep = rank < C
    slot = torch.where(keep, e_s * C + rank, torch.full_like(e_s, E * C))
    return Routing(logits, probs, expert_idx, e_s, t_s, g_s, keep, slot, C,
                   order)


def dispatch(x2: torch.Tensor, r: Routing, n_experts: int) -> torch.Tensor:
    """mp_dist: the (E, C, d) capacity buffer, each kept pair's token row
    at its slot, zero elsewhere.  Kept slots are unique, so plain index
    assignment writes exactly what the reference's scatter-add does;
    dropped pairs all land on the trash row past the buffer, which is
    cut off (no boolean mask, so the host never waits for the card)."""
    d = x2.shape[1]
    buf = x2.new_zeros(n_experts * r.capacity + 1, d)
    if torch.is_grad_enabled() and x2.requires_grad:
        # the same rows, each token's once per choice, gathered by a
        # permutation: its backward adds no two rows into one place, so
        # the token gradients are the same bits run after run on the card
        # (the backward of x2[t_s] adds a token's k rows by atomics)
        k = r.expert_idx.shape[1]
        buf[r.slot] = x2.repeat_interleave(k, dim=0)[r.order]
    else:
        buf[r.slot] = x2[r.t_s]
    return buf[:-1].view(n_experts, r.capacity, d)


def _combine(out_flat: torch.Tensor, r: Routing, k: int) -> torch.Tensor:
    """y (T, d): each token's k gated expert outputs added one at a time
    in ascending expert id, in the compute dtype."""
    T, EC = r.expert_idx.shape[0], out_flat.shape[0]
    # the pairs token-major, each token's k by ascending expert id (a
    # token's experts are distinct, so the key is unique)
    by_token = torch.argsort(r.t_s * EC + r.e_s)
    slot = r.slot[by_token].view(T, k)
    keep = r.keep[by_token].view(T, k)
    gates = r.g_s[by_token].view(T, k).to(out_flat.dtype)
    y = out_flat.new_zeros(T, out_flat.shape[1])
    for j in range(k):
        yb = out_flat[slot[:, j].clamp(max=EC - 1)]
        yb = torch.where(keep[:, j, None], yb, yb.new_zeros(()))
        y = y + yb * gates[:, j, None]
    return y


def _move(t: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """A local tensor of placements `src` on `mesh` redistributed to
    `dst`, as a local tensor, outside autograd."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, src).redistribute(mesh, dst) \
        .to_local()


class _Collective(torch.autograd.Function):
    """A redistribution of local tensors on `mesh` whose backward is its
    transpose, as the collectives of the reference's `shard_map`
    differentiate: inside the mesh dispatch the local gradient of a value
    replicated over a mesh dim is this rank's part of a sum.  A sum to
    replicated (psum) goes back as a psum, a reduce-scatter as an
    all-gather, an all-gather as a reduce-scatter; a replicated input
    split onto the ranks goes back as the sum of the parts, whole on
    every rank."""

    @staticmethod
    def forward(ctx, t, mesh, src, dst):
        ctx.mesh, ctx.src, ctx.dst = mesh, src, dst
        return _move(t, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate

        back_src = tuple(Partial() if q.is_replicate() else q
                         for q in ctx.dst)
        back_dst = tuple(Replicate() if q.is_partial() else q
                         for q in ctx.src)
        return _move(g.contiguous(), ctx.mesh, back_src, back_dst), None, \
            None, None


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient: a value leaving
    the mesh dispatch replicated over n ranks gets 1/n of the (whole,
    replicated) gradient on each, as `shard_map` divides the cotangent
    of an output by the size of the mesh dims its spec leaves out."""

    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _sum_over(t: torch.Tensor, sub, dst=None) -> torch.Tensor:
    """The sum of `t` over the ranks of the 1-D mesh `sub`; with `dst` a
    placement (``Shard(d)``), reduce-scattered to it."""
    from torch.distributed.tensor import Partial, Replicate

    return _Collective.apply(t, sub, (Partial(),), (dst or Replicate(),))


def moe_dispatch_compute(p, x2: torch.Tensor, mc: MoEConfig, act: str,
                         psum_axis: Optional[str] = None,
                         reduce_mode: str = "psum",
                         comm_dtype: Optional[torch.dtype] = None,
                         dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Routed experts over flat tokens x2 (T, d), in the compute dtype
    `dtype` (the router's when None): the tokens and each weight cast to
    it.  Returns (y (T, d), aux loss, dropped fraction), both fp32
    scalars.

    `psum_axis` names the dim of the installed MoE mesh (`set_moe_mesh`)
    over which `p`'s expert weights are split on d_ff: the expert
    contraction is then summed over it as `reduce_mode` says ("psum",
    "scatter" or "combine_first", see the module docstring), its payload
    cast to `comm_dtype` if given."""
    from torch.distributed.tensor import Replicate, Shard

    E, k = mc.n_experts, mc.top_k
    cdt = dtype or p.router.dtype
    x2 = x2.to(cdt)
    r = route(p.router, x2, mc, cdt)
    buf = dispatch(x2, r, E)
    h = activate(torch.bmm(buf, p.w_gate.to(cdt)), act) * \
        torch.bmm(buf, p.w_up.to(cdt))
    out_buf = torch.bmm(h, p.w_down.to(cdt))              # (E, C, d)
    if comm_dtype is not None:
        out_buf = out_buf.to(comm_dtype)
    EC = E * r.capacity
    if psum_axis is None:
        y = _combine(out_buf.to(cdt).reshape(EC, -1), r, k)
    else:
        mesh = moe_mesh()
        if mesh is None:
            raise ValueError(f"psum_axis={psum_axis!r} needs a mesh: "
                             f"install one with set_moe_mesh")
        sub = mesh[psum_axis]
        if reduce_mode == "combine_first":
            # the combine is linear in the expert outputs, so it commutes
            # with the sum: combine the partial outputs, then sum (T, d)
            y = _sum_over(_combine(out_buf.to(cdt).reshape(EC, -1), r, k),
                          sub)
        elif reduce_mode == "scatter":
            # reduce-scatter d, combine on the shard, all-gather once
            out_buf = _sum_over(out_buf, sub, Shard(2))
            y = _combine(out_buf.to(cdt).reshape(EC, -1), r, k)
            y = _Collective.apply(y, sub, (Shard(1),), (Replicate(),))
        elif reduce_mode == "psum":
            y = _combine(_sum_over(out_buf, sub).to(cdt).reshape(EC, -1),
                         r, k)
        else:
            raise ValueError(f"unknown moe reduce mode {reduce_mode!r}")

    T = x2.shape[0]
    me = r.probs.mean(dim=0)
    top1 = torch.argmax(r.logits, dim=-1)
    ce = (top1[:, None] == torch.arange(E, device=top1.device)).float() \
        .mean(dim=0)                                      # one-hot mean
    aux = E * torch.sum(me * ce)
    dropped = 1.0 - r.keep.float().sum() / (T * k)
    return y, aux, dropped


def moe_expert_gather(token_va: np.ndarray, expert_idx: np.ndarray,
                      mc: MoEConfig, d_bytes: int, expert_buf_va: int,
                      capacity: Optional[int] = None):
    """Descriptor-plane twin of `moe_dispatch_compute`'s dispatch: the
    routed gather as one virtual-address `DescriptorBatch` for the DMA
    engine (`core.vm.expert_gather_batch`), with the same sort-based
    capacity and rank math.  ``token_va`` are per-token source VAs;
    overflowed (token, expert) pairs are dropped as the compute path's
    trash row drops them."""
    tokens = int(np.asarray(token_va).shape[0])
    cap = capacity if capacity is not None else _capacity(tokens, mc)
    return expert_gather_batch(
        token_va, expert_idx, n_experts=mc.n_experts, capacity=cap,
        d_bytes=d_bytes, expert_buf_va=expert_buf_va)


def _mesh_dispatch(p: MoE, x2: torch.Tensor, mc: MoEConfig, act: str,
                   mesh, rcfg: RunConfig, split_data: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mesh dispatch (the reference's `shard_map` one): x2 (T, d)
    split over the data dims, the expert weights over 'model' on d_ff,
    the router whole; each rank runs `moe_dispatch_compute` on its
    shards, and the aux loss is averaged over the data dims.  Takes
    plain tensors (the same on every rank) or DTensors; y comes back
    whole on every rank, or as a DTensor split over the data dims (and
    the aux loss as a replicated DTensor).

    Gradients follow `shard_map`'s: inside, the local gradient of a value
    replicated over a mesh dim is a part of a sum (`_Collective`), so a
    replicated input's local gradient goes out as `Partial()` on the dims
    it was replicated over and is summed there, once (a DTensor's by
    `to_local(grad_placements=...)`, a plain tensor's whole on every
    rank), and the outputs' gradients come in divided over the ranks
    that hold them replicated (`_ScaleGrad`).

    With `split_data` False the tokens stay whole on every data rank (a
    DTensor batch the data dims do not divide): every rank routes all of
    them, as the local path does, and the experts still split on d_ff."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    dp = data_axes(mesh) if split_data else ()
    model = "model" if "model" in mesh.mesh_dim_names else None
    whole = (Replicate(),) * mesh.ndim

    def local(t: torch.Tensor, spec: P) -> torch.Tensor:
        pl = placements(mesh, spec)
        if isinstance(t, DTensor):
            grad = tuple(Partial() if q.is_replicate() else q for q in pl)
            return t.redistribute(mesh, pl).to_local(grad_placements=grad)
        return _Collective.apply(t, mesh, whole, pl)

    shards = SimpleNamespace(
        router=local(p.router, P(None, None)),
        w_gate=local(p.w_gate, P(None, None, model)),
        w_up=local(p.w_up, P(None, None, model)),
        w_down=local(p.w_down, P(None, model, None)))
    comm = torch.bfloat16 if rcfg.moe_comm_dtype == "bfloat16" else None
    y, aux, _dropped = moe_dispatch_compute(
        shards, local(x2, P(dp or None, None)), mc, act, psum_axis=model,
        reduce_mode=rcfg.moe_reduce, comm_dtype=comm, dtype=p.dtype)
    ranks, dp_size = mesh.size(), 1
    if dp:
        sub = mesh[dp]
        dp_size = sub.size()
        aux = _Collective.apply(aux, sub, (Partial(),) * len(dp),
                                (Replicate(),) * len(dp)) / dp_size
    # y is replicated over the dims past the data dims, aux over all
    y = _ScaleGrad.apply(y, dp_size / ranks)
    aux = _ScaleGrad.apply(aux, 1.0 / ranks)
    y = DTensor.from_local(y, mesh, placements(mesh, P(dp or None, None)))
    if not isinstance(x2, DTensor):
        return y.full_tensor(), aux
    return y, DTensor.from_local(aux, mesh, whole)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ArchConfig,
                rcfg: Optional[RunConfig] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), aux loss · router_aux_weight).  With a
    mesh installed (`set_moe_mesh`) and `rcfg.moe_shard_map` (the
    default, also where `rcfg` is None), the routed experts take the
    mesh dispatch when B divides over the data dims, as in the
    reference; else they run locally (a DTensor batch: the mesh dispatch
    with the tokens whole on every data rank, the same values)."""
    mc = cfg.moe
    rcfg = rcfg or RunConfig()
    B, S, d = x.shape
    x2 = rows_only(x).reshape(B * S, d)
    mesh = moe_mesh() if rcfg.moe_shard_map else None
    split = True
    if mesh is not None:
        dp_size = 1
        for name, size in zip_axis(mesh):
            if name in data_axes(mesh):
                dp_size *= size
        if B % dp_size:
            # tiny / indivisible batch: the local path, and for a DTensor
            # batch the mesh dispatch with the tokens whole on every data
            # rank (DTensor has no rule for the local path's index writes)
            split = False
            if not hasattr(x2, "device_mesh"):
                mesh = None
    if mesh is not None:
        y2, aux = _mesh_dispatch(p, x2, mc, cfg.act, mesh, rcfg,
                                 split_data=split)
    else:
        y2, aux, _dropped = moe_dispatch_compute(p, x2, mc, cfg.act,
                                                 dtype=p.dtype)
    y = rows_only(y2.reshape(B, S, d))
    if mc.n_shared_experts:
        shared = ffn_forward(p.shared, x, cfg.act)
        sg = torch.sigmoid(dense(x, p.shared_gate, dtype=p.dtype).float())
        y = y + sg.to(y.dtype) * shared
    return y, aux * mc.router_aux_weight
