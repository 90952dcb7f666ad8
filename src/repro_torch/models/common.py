"""Shared model primitives: dense, norms, softcap, activation, RoPE,
embeddings (the port of `repro.models.common`).

Functions take weights as tensors.  The storage dtype of a weight and
the compute dtype of its product are apart, as in the reference: `dense`,
`embed` and `unembed` take the compute dtype and cast the weight to it at
each use.  A model built for serving stores its matmul weights in the
compute dtype, where the cast is free and computes what a product of the
stored weight does; a train state stores fp32 master weights, and
autograd takes the gradient through the cast back to fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

#: the compute dtypes of `RunConfig.dtype` (and `ssd_compute_dtype`)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@torch.no_grad()
def trunc_normal_fill(p: torch.Tensor, std: float,
                      gen: torch.Generator) -> None:
    """The reference initializers' law: a normal of `std` truncated at
    ±2σ, drawn in fp32 from `gen` and cast to `p`'s dtype."""
    tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                generator=gen)
    p.copy_(tmp)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) (+ b) in the compute dtype `dtype`
    (w's own when None): the activation, the weight and the bias each
    cast to it, as the reference's `dense` does."""
    dtype = dtype or w.dtype
    y = matmul(x.to(dtype), w.to(dtype))
    if b is not None:
        y = y + b.to(dtype)
    return y


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n).  A DTensor x of three or more dims times a
    DTensor w is multiplied on each rank's shards, mesh dim by mesh dim
    as w is laid out: where w splits n, x is whole there and y splits n;
    where w splits k, x splits k and y is a pending sum; where w is
    whole, x keeps its split of a leading dim (the batch, the sequence)
    and y that split.  x is redistributed to that layout first; each
    side's gradient is laid out as its value, or as a pending sum where
    the other side is split and it is whole.  The matmul of DTensor
    itself flattens the leading dims, which torch 2.11 cannot do for two
    split dims (a sequence-parallel residual: the batch over the data
    dims, the sequence over 'model'), in the forward or the backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if x.ndim < 3 or not isinstance(x, DTensor) or \
            not isinstance(w, DTensor) or w.ndim != 2 or \
            any(p.is_partial() for p in w.placements):
        return x @ w
    last = x.ndim - 1
    xt, xg, wg, yp = [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if wp.is_shard(0):                     # k split
            xt.append(Shard(last)), xg.append(Shard(last))
            wg.append(wp), yp.append(Partial())
        elif wp.is_shard():                    # n split
            xt.append(Replicate()), xg.append(Partial())
            wg.append(wp), yp.append(Shard(last))
        elif xp.is_shard() and xp.dim < last:  # x's rows split, w whole
            xt.append(xp), xg.append(xp)
            wg.append(Partial()), yp.append(xp)
        else:
            xt.append(Replicate()), xg.append(Replicate())
            wg.append(Replicate()), yp.append(Replicate())
    if tuple(xt) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, xt)
    y = x.to_local(grad_placements=xg) @ w.to_local(grad_placements=wg)
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(y, x.device_mesh, yp, run_check=False,
                              shape=shape, stride=stride)


class _GradAsValue(torch.autograd.Function):
    """The identity, whose backward lays a DTensor's gradient out as the
    value was (a pending sum as replicated)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def rows_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor (B, S, ...) split at most on its batch: any other split
    gathered, and its gradient laid out the same.  Flattening (B, S)
    into tokens needs it (torch 2.11's DTensor cannot flatten two split
    dims into one); any other tensor unchanged."""
    if not hasattr(x, "device_mesh"):
        return x
    from torch.distributed.tensor import Replicate

    keep = tuple(p if p.is_shard(0) else Replicate() for p in x.placements)
    if keep != tuple(x.placements):
        x = x.redistribute(x.device_mesh, keep)
    return _GradAsValue.apply(x)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the (1 + scale) convention, in fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               fraction: float = 1.0, theta: float = 10000.0
               ) -> torch.Tensor:
    """x (..., S, D); positions (S,).  Pairs (0::2, 1::2) rotate together."""
    D = x.shape[-1]
    rot = int(D * fraction) // 2 * 2
    if rot == 0:
        return x
    freqs = rope_frequencies(D, fraction, theta, x.device)
    angles = positions.to(x.device, torch.float32)[..., None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot = x[..., :rot].float()
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x[..., rot:]], dim=-1)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The rows of `tokens`, cast to `dtype` (the table's own when None).
    The rows are gathered, then cast: the values of the reference's
    cast-then-gather, without casting the whole table each step.
    `F.embedding`, whose backward sums a repeated token's gradients in a
    fixed order: the backward of `table[tokens]` adds them in parallel on
    the CPU, in an order that changes from run to run, and a replayed
    train step would not repeat its weights bit for bit.  On a mesh, a
    vocab-split table's rows come back replicated (`settle_partial`)."""
    rows = settle_partial(F.embedding(tokens, table))
    return rows.to(dtype or table.dtype)


def _replicate_partial(x: torch.Tensor) -> torch.Tensor:
    """`x` with every `Partial` placement reduced to `Replicate`; a tensor
    with none (or no placements) unchanged."""
    placements = getattr(x, "placements", None)
    if placements is None or not any(p.is_partial() for p in placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in placements])


class _SettledGrad(torch.autograd.Function):
    """The identity, whose backward reduces a partial gradient to
    replicated: the backward of the redistribute before it must turn
    the gradient into the lookup's masked partial, which DTensor can do
    from a replicated gradient but not from a pending sum (a tied
    unembedding over a vocab-split table gives the residual stream's
    gradient that)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _replicate_partial(g)


def settle_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with pending sums (a vocab-split table's rows are
    partial on each rank) reduced to replicated on those mesh dims, its
    gradient likewise (`_SettledGrad`); any other tensor unchanged."""
    y = _replicate_partial(x)
    if y is x:
        return x
    return _SettledGrad.apply(y) if y.requires_grad else y


def unembed(table: torch.Tensor, x: torch.Tensor,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Tied unembedding, logits = x @ tableᵀ in fp32, of x and the table
    cast to the compute dtype `dtype` (the table's own when None), as the
    reference's einsum casts them.  The operands are then upcast: the
    products of bf16 values are exact in fp32, so this is the reference's
    bf16 product with fp32 accumulation, where a bf16 matmul would round
    every logit to bf16."""
    dtype = dtype or table.dtype
    return matmul(x.to(dtype).float(), table.to(dtype).float().t())


def plain_path(rcfg) -> bool:
    """Whether a forward takes the plain PyTorch attention and SSD: a
    `RunConfig(kernels="xla")`, training or serving.  No `rcfg` (the
    served default) and `kernels="pallas"` take the kernel ops."""
    if rcfg is None or rcfg.kernels == "pallas":
        return False
    if rcfg.kernels == "xla":
        return True
    raise ValueError(f"unknown kernels {rcfg.kernels!r}")


def needs_grad(*ts: torch.Tensor, what: str) -> None:
    """Raise where autograd would have to differentiate a kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"RunConfig(kernels='pallas') under autograd: the {what} "
            f"kernel has no backward (no kernel has one, in either "
            f"package); train with kernels='xla', as the reference does")
