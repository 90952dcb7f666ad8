"""Mamba-2 selective-SSM layer: the full-sequence forward and the
one-token decode step (the port of `repro.models.ssm`).

Layer anatomy per [arXiv:2405.21060]:
  in_proj → [z | x | B | C | dt], causal depthwise conv over [x|B|C],
  dt = softplus(dt + dt_bias), A = -exp(A_log),
  y = SSD(x, dt, A, B, C) + D⊙x, y = RMSNormGated(y, z), out_proj.

The full-sequence path goes to the SSD op, which runs its CUDA kernel on
the card and its plain version on the CPU; a training forward passed
`RunConfig(kernels="xla")` takes the plain `ssd_chunked_ref` on either
device, as the reference's does, and `kernels="pallas"` raises where
autograd would need the kernel's backward.  Decode keeps a recurrent
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
    """Depthwise causal conv: xbc (B, S, Cd); w (K, Cd)."""
    K, S = w.shape[0], xbc.shape[1]
    out = xbc * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[K - 1 - i]
    return F.silu(out + b)


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
    (training) chooses the scan as the module docstring says."""
    sc = cfg.ssm
    Bb, S, _ = x.shape
    d_inner, H, P, G, N = ssm_dims(cfg)
    L = p.chunk

    z, xbc_raw, dt_raw = _split_proj(dense(x, p.in_proj, dtype=p.dtype), cfg)
    xbc_raw = xbc_raw.float()
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
        res = ssd_chunked_ref(*args, chunk=L, return_state=return_state)
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


def ssm_decode_step(p: SSM, x: torch.Tensor, cache: SSMCache,
                    cfg: ArchConfig) -> Tuple[torch.Tensor, SSMCache]:
    """x (B, 1, d_model) → (y (B, 1, d_model), new cache).  The cache's
    tensors are replaced, not written in place."""
    Bb = x.shape[0]
    d_inner, H, P, G, N = ssm_dims(cfg)

    z, xbc, dt_raw = _split_proj(dense(x, p.in_proj, dtype=p.dtype)[:, 0],
                                 cfg)
    wind = torch.cat([cache["conv"], xbc.float()[:, None]], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", wind, p.conv_w) + p.conv_b)
    xs, Bs, Cs = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)              # (B, H)
    A = -torch.exp(p.A_log)

    xh = xs.reshape(Bb, H, P)
    Bh = Bs.reshape(Bb, G, N).repeat_interleave(H // G, dim=1)  # (B, H, N)
    Ch = Cs.reshape(Bb, G, N).repeat_interleave(H // G, dim=1)
    h = cache["state"] * torch.exp(A[None] * dt)[..., None, None] + \
        dt[..., None, None] * Bh[..., :, None] * xh[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, h) + p.D[None, :, None] * xh
    out = _gated_out(p, y.reshape(Bb, 1, d_inner), z[:, None])
    return out, {"conv": wind[:, 1:], "state": h}
