"""Mamba-2 selective-SSM layer: the full-sequence forward and the
one-token decode step (the port of `repro.models.ssm`).

Layer anatomy per [arXiv:2405.21060]:
  in_proj → [z | x | B | C | dt], causal depthwise conv over [x|B|C],
  dt = softplus(dt + dt_bias), A = -exp(A_log),
  y = SSD(x, dt, A, B, C) + D⊙x, y = RMSNormGated(y, z), out_proj.

The full-sequence path goes to the SSD op, which runs its CUDA kernel on
the card and its plain version on the CPU; a forward passed
`RunConfig(kernels="xla")`, training or serving, takes the plain
`ssd_chunked_ref` on any device, as the reference's does, and
`kernels="pallas"` raises where autograd would need the kernel's
backward.  Decode keeps a recurrent
cache {"conv": last K-1 raw conv inputs, "state": (B, H, N, P) fp32}, so
a step costs the same at any length; it is plain PyTorch, as in the
reference, which has no kernel for it.

`in_proj` and `out_proj` run in the compute dtype; the conv and the
softplus run in fp32, and the small leaves are stored in fp32.  The scan
reads two knobs of the `RunConfig` the layer was built with, as the
reference's forward reads them: its chunk is `ssd_chunk` (the arch's
`ssm.chunk` when 0), and under `ssd_compute_dtype="bfloat16"` its x, B
and C go in as bf16 (the decay path and every product still accumulate
in fp32), else as fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.dist.sharding import hint
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from .common import DTYPES, dense, needs_grad, plain_path, rmsnorm

SSMCache = Dict[str, torch.Tensor]


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, H, P, G, N)."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    P = sc.head_dim
    H = sc.n_heads or d_inner // P
    return d_inner, H, P, sc.n_groups, sc.d_state


def conv_dim(cfg: ArchConfig) -> int:
    d_inner, H, P, G, N = ssm_dims(cfg)
    return d_inner + 2 * G * N


class SSM(nn.Module):
    """The leaves of the reference's `init_ssm`; `LM` draws their values.
    `dtype` is the compute dtype of `in_proj` and `out_proj`, which are
    stored in `param_dtype` (`dtype` when None); `rcfg` gives the scan's
    chunk and x/B/C dtype (`chunk`, `ssd_dtype`)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device,
                 param_dtype: Optional[torch.dtype] = None,
                 rcfg: Optional[RunConfig] = None) -> None:
        super().__init__()
        rcfg = rcfg or RunConfig()
        self.dtype = dtype
        self.chunk = rcfg.ssd_chunk or cfg.ssm.chunk
        self.ssd_dtype = DTYPES[rcfg.ssd_compute_dtype]
        d_inner, H, P, G, N = ssm_dims(cfg)
        d_conv = conv_dim(cfg)
        kw = dict(dtype=param_dtype or dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = nn.Parameter(torch.empty(
            cfg.d_model, 2 * d_inner + 2 * G * N + H, **kw))
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm.conv_kernel, d_conv,
                                               **f32))
        self.conv_b = nn.Parameter(torch.zeros(d_conv, **f32))
        self.A_log = nn.Parameter(torch.empty(H, **f32))
        self.D = nn.Parameter(torch.empty(H, **f32))
        self.dt_bias = nn.Parameter(torch.empty(H, **f32))
        self.gate_norm = nn.Parameter(torch.zeros(d_inner, **f32))
        self.out_proj = nn.Parameter(torch.empty(d_inner, cfg.d_model, **kw))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: xbc (B, S, Cd); w (K, Cd).  A DTensor xbc
    split on its batch and channels only (the `ssm_conv3` layout) is
    convolved on each rank's shard, with its channels of w and b: the
    conv needs nothing from another rank, and torch 2.11's DTensor fails
    to plan the sequence shift's redistribution."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if isinstance(xbc, DTensor) and isinstance(w, DTensor) and all(
            p.is_replicate() or (isinstance(p, Shard) and p.dim in (0, 2))
            for p in xbc.placements) and all(
            p.is_replicate() for p in w.placements + b.placements):
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset as local_box

        mesh = xbc.device_mesh
        shape, offset = local_box(xbc.shape, mesh, xbc.placements)
        grad = [Partial() if isinstance(p, Shard) else q
                for p, q in zip(xbc.placements, w.placements)]
        wl = w.to_local(grad_placements=grad).narrow(1, offset[2], shape[2])
        bl = b.to_local(grad_placements=grad).narrow(0, offset[2], shape[2])
        out = _causal_conv(xbc.to_local(), wl, bl)
        Bb, S, C = xbc.shape
        return DTensor.from_local(out, mesh, xbc.placements, run_check=False,
                                  shape=xbc.shape, stride=(S * C, C, 1))
    K, S = w.shape[0], xbc.shape[1]
    out = xbc * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[K - 1 - i]
    return F.silu(out + b)


def _ssd_on_shards(args, chunk: int, return_state: bool):
    """`ssd_chunked_ref(*args)`; on DTensors split at most on the batch
    and the heads (x, dt, A, D) with B and C whole on the heads (one
    group) and split on the batch as x or not at all, each rank scans its
    own shards: the scan needs nothing from another rank.  On DTensor's
    own dispatch the scan fails: torch 2.11 has no rule for the flip in
    the backward of its cumsum, and with the layout DTensor's own matmul
    gives the in_proj product the gradient of the heads' view of x comes
    back as a strided shard under a DTensor that reads as contiguous,
    whose reshape's backward `view` fails."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    x, dt, A, D, Bg, Cg = args
    if not all(isinstance(t, DTensor) for t in args) or Bg.shape[1] != 1:
        return ssd_chunked_ref(*args, chunk=chunk, return_state=return_state)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_box

    xp, bp = x.placements, Bg.placements
    x_rows = [i for i, p in enumerate(xp) if p.is_shard(0)]
    b_rows = [i for i, p in enumerate(bp) if p.is_shard(0)]
    if not (all(p.is_replicate() or p.is_shard(0) or p.is_shard(1)
                for p in xp) and dt.placements == xp and
            Cg.placements == bp and b_rows in ([], x_rows) and
            all(p.is_replicate() or p.is_shard(0) for p in bp) and
            all(p.is_replicate() for t in (A, D) for p in t.placements)):
        return ssd_chunked_ref(*args, chunk=chunk, return_state=return_state)

    mesh = x.device_mesh
    shape, offset = local_box(x.shape, mesh, xp)
    grad = [Partial() if isinstance(p, Shard) else q
            for p, q in zip(xp, A.placements)]
    bgrad = [Partial() if isinstance(p, Shard) and q.is_replicate() else q
             for p, q in zip(xp, bp)]
    h0, nh = offset[1], shape[1]
    Al = A.to_local(grad_placements=grad).narrow(0, h0, nh)
    Dl = D.to_local(grad_placements=grad).narrow(0, h0, nh)
    Bl, Cl = (t.to_local(grad_placements=bgrad) for t in (Bg, Cg))
    if x_rows and not b_rows:
        Bl, Cl = (t.narrow(0, offset[0], shape[0]) for t in (Bl, Cl))
    res = ssd_chunked_ref(x.to_local(), dt.to_local(), Al, Dl, Bl, Cl,
                          chunk=chunk, return_state=return_state)

    def wrap(o, whole):
        stride = tuple(math.prod(whole[d + 1:]) for d in range(len(whole)))
        return DTensor.from_local(o, mesh, xp, run_check=False,
                                  shape=whole, stride=stride)
    if not return_state:
        return wrap(res, tuple(x.shape))
    y, st = res
    return wrap(y, tuple(x.shape)), wrap(st, tuple(x.shape[:2]) +
                                         tuple(st.shape[2:]))


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    d_inner, H, P, G, N = ssm_dims(cfg)
    return torch.split(proj, [d_inner, conv_dim(cfg), H], dim=-1)


def _gated_out(p: SSM, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = rmsnorm(p.gate_norm, y * F.silu(z.float()))
    return dense(y, p.out_proj, dtype=p.dtype)


def ssm_forward(p: SSM, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False,
                rcfg: Optional[RunConfig] = None):
    """x (B, S, d_model) → (B, S, d_model) [, decode cache].  `rcfg`
    chooses the scan as the module docstring says."""
    sc = cfg.ssm
    Bb, S, _ = x.shape
    d_inner, H, P, G, N = ssm_dims(cfg)
    L = p.chunk

    z, xbc_raw, dt_raw = _split_proj(dense(x, p.in_proj, dtype=p.dtype), cfg)
    # the conv runs along the whole sequence: on a mesh the channels are
    # split, never the sequence
    xbc_raw = hint("ssm_conv3", xbc_raw.float())
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    # pad the sequence to the chunk with zeros: zero dt gives exp(A·0) = 1
    # and no input, so the final state is the state at S
    pad = (-S) % L
    if pad:
        xbc, dt = F.pad(xbc, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    xs, Bs, Cs = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    # (B, H, S, P), (B, H, S), (B, G, S, N) as views of the (B, S, ...)
    # tensors: the kernel reads them through their strides
    # (TP: the SSD heads over 'model' by the sharding hints)
    xh = hint("ssm_x4", xs.reshape(Bb, -1, H, P).transpose(1, 2))
    dth = hint("ssm_dt3", dt.transpose(1, 2))
    Bg = Bs.reshape(Bb, -1, G, N).transpose(1, 2)
    Cg = Cs.reshape(Bb, -1, G, N).transpose(1, 2)
    if p.ssd_dtype != torch.float32:
        xh, Bg, Cg = (t.to(p.ssd_dtype) for t in (xh, Bg, Cg))
    args = (xh, dth, A, p.D, Bg, Cg)
    if plain_path(rcfg):
        res = _ssd_on_shards(args, L, return_state)
    else:
        if rcfg is not None:
            needs_grad(*args, what="SSD")
        res = ssd(*args, chunk=L, return_state=return_state)
    y = hint("ssm_x4", res[0] if return_state else res)
    y = y[:, :, :S].transpose(1, 2).reshape(Bb, S, d_inner)
    out = _gated_out(p, y, z)
    if not return_state:
        return out
    # decode cache: the final state and the last K-1 raw conv inputs,
    # copied out so the cache does not keep the whole (B, S, Cd) alive
    K = sc.conv_kernel
    tail = xbc_raw[:, max(S - (K - 1), 0):].clone()
    if S < K - 1:
        tail = F.pad(tail, (0, 0, K - 1 - S, 0))
    return out, {"conv": tail, "state": res[1]}


def init_ssm_cache(batch: int, cfg: ArchConfig,
                   device: torch.device) -> SSMCache:
    """The cache before any token: zero conv history and state."""
    d_inner, H, P, G, N = ssm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros(batch, cfg.ssm.conv_kernel - 1,
                                conv_dim(cfg), **f32),
            "state": torch.zeros(batch, H, N, P, **f32)}


def _state_read(Ch: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """C·h: (B, H, N), (B, H, N, P) → (B, H, P).  On DTensors split on
    the batch and the heads it is a product and a sum over N: the batched
    matmul of the einsum would flatten those two split dims into one,
    which DTensor cannot (torch 2.11)."""
    if hasattr(h, "device_mesh"):
        return (Ch[..., None] * h).sum(2)
    return torch.einsum("bhn,bhnp->bhp", Ch, h)


def ssm_decode_step(p: SSM, x: torch.Tensor, cache: SSMCache,
                    cfg: ArchConfig) -> Tuple[torch.Tensor, SSMCache]:
    """x (B, 1, d_model) → (y (B, 1, d_model), new cache).  The cache's
    tensors are replaced, not written in place."""
    Bb = x.shape[0]
    d_inner, H, P, G, N = ssm_dims(cfg)

    z, xbc, dt_raw = _split_proj(dense(x, p.in_proj, dtype=p.dtype)[:, 0],
                                 cfg)
    wind = torch.cat([cache["conv"], xbc.float()[:, None]], dim=1)
    # the conv in fp32 whatever conv_w is stored in (a serving cell's
    # inference-cast copy holds it in bf16), as the reference's einsum
    # promotes it
    conv_out = F.silu(torch.einsum("bkc,kc->bc", wind, p.conv_w.float())
                      + p.conv_b)
    xs, Bs, Cs = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)              # (B, H)
    A = -torch.exp(p.A_log)

    xh = xs.reshape(Bb, H, P)
    Bh = Bs.reshape(Bb, G, N).repeat_interleave(H // G, dim=1)  # (B, H, N)
    Ch = Cs.reshape(Bb, G, N).repeat_interleave(H // G, dim=1)
    h = cache["state"] * torch.exp(A[None] * dt)[..., None, None] + \
        dt[..., None, None] * Bh[..., :, None] * xh[..., None, :]
    y = _state_read(Ch, h) + p.D[None, :, None] * xh
    out = _gated_out(p, y.reshape(Bb, 1, d_inner), z[:, None])
    return out, {"conv": wind[:, 1:], "state": h}
