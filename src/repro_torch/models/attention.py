"""Grouped-query attention with SWA / softcap / RoPE: the prefill forward
and the one-token decode step against a KV cache (the port of
`repro.models.attention`, Pallas path).

Prefill attention goes to the flash attention op and decode attention to
the decode attention op; each runs its CUDA kernel on the card and its
plain version on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from .common import apply_rope, dense


class Attention(nn.Module):
    """wq, wk, wv, wo; with `cfg.qkv_bias` also bq, bk, bv, the biases of
    the three input projections, zero at init as in the reference (wo has
    none)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, hq, **kw))
        self.wk = nn.Parameter(torch.empty(d, hkv, **kw))
        self.wv = nn.Parameter(torch.empty(d, hkv, **kw))
        self.wo = nn.Parameter(torch.empty(hq, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(hq, **kw))
            self.bk = nn.Parameter(torch.zeros(hkv, **kw))
            self.bv = nn.Parameter(torch.zeros(hkv, **kw))


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, dh).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _scale(cfg: ArchConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None \
        else 1.0 / math.sqrt(cfg.resolved_head_dim)


def _qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    dh = cfg.resolved_head_dim
    q = _split_heads(dense(x, p.wq, getattr(p, "bq", None)), cfg.n_heads, dh)
    k = _split_heads(dense(x, p.wk, getattr(p, "bk", None)), cfg.n_kv_heads,
                     dh)
    v = _split_heads(dense(x, p.wv, getattr(p, "bv", None)), cfg.n_kv_heads,
                     dh)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def attention_forward(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                      window: int, positions: Optional[torch.Tensor] = None,
                      causal: bool = True, return_kv: bool = False):
    """Full-sequence attention (prefill).  x (B, S, d).  `return_kv` also
    returns the roped (k, v), each (B, Hkv, S, dh), for the decode cache."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        softcap=cfg.attn_softcap, scale=_scale(cfg))
    out = dense(_merge_heads(o), p.wo)
    if return_kv:
        return out, (k, v)
    return out


def attention_decode_step(p: Attention, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, cfg: ArchConfig, *,
                          window: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x (B, 1, d); cache (B, Hkv, max_len, dh); `pos`
    is the current length.  Returns (out, cache_k, cache_v).

    The token's k/v are written into the caches IN PLACE (the reference
    returns updated copies).  A `pos` past the cache raises, where the
    reference's `dynamic_update_slice` would clamp it to the last slot.
    """
    B = x.shape[0]
    max_len = cache_k.shape[2]
    if not 0 <= pos < max_len:
        raise IndexError(f"decode position {pos} outside the KV cache of "
                         f"max_len {max_len}")
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    cache_k[:, :, pos] = k[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, pos] = v[:, :, 0].to(cache_v.dtype)
    o = decode_attention(q[:, :, 0], cache_k, cache_v, kv_len=pos + 1,
                         window=window, softcap=cfg.attn_softcap,
                         scale=_scale(cfg))
    return dense(o.reshape(B, 1, -1), p.wo), cache_k, cache_v
