"""Transformer blocks and the layer loop (the port of `repro.models.blocks`
for the attention kinds).

A block is one residual layer:
  attn_full / attn_swa — [norm → attention → (+)] [norm → FFN → (+)]
with gemma2's optional post-norms on each branch.  The reference scans
stacked parameters per segment; the port keeps its layers in a flat list
in the order they run (`ArchConfig.layer_kinds`) and loops over it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ATTN_FULL, ATTN_SWA
from .attention import Attention, attention_decode_step, attention_forward
from .common import rmsnorm
from .ffn import FFN, ffn_forward

ATTN_KINDS = (ATTN_FULL, ATTN_SWA)
Cache = Dict[str, torch.Tensor]


def check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP.md, queue 1: "
            f"SSM, hybrid and MoE blocks)")


def _window_for(kind: str, cfg: ArchConfig) -> int:
    return cfg.window if kind == ATTN_SWA else 0


def _norm(d: int, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, kind: str, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        check_kind(kind)
        self.kind = kind
        d = cfg.d_model
        self.ln1 = _norm(d, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = _norm(d, device)
        self.ffn = FFN(d, cfg.d_ff, dtype, device)
        if cfg.post_block_norm:
            self.post_ln1 = _norm(d, device)
            self.post_ln2 = _norm(d, device)


def _ffn_branch(p: Block, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = ffn_forward(p.ffn, rmsnorm(p.ln2, x), cfg.act)
    if cfg.post_block_norm:
        h = rmsnorm(p.post_ln2, h)
    return x + h


def block_forward(p: Block, x: torch.Tensor, cfg: ArchConfig, kind: str,
                  positions: Optional[torch.Tensor] = None,
                  collect_cache: bool = False):
    """Returns x, or (x, cache) with the roped k/v when `collect_cache`."""
    h = attention_forward(p.attn, rmsnorm(p.ln1, x), cfg,
                          window=_window_for(kind, cfg), positions=positions,
                          return_kv=collect_cache)
    if collect_cache:
        h, (k, v) = h
    if cfg.post_block_norm:
        h = rmsnorm(p.post_ln1, h)
    x = _ffn_branch(p, x + h, cfg)
    return (x, {"k": k, "v": v}) if collect_cache else x


def block_decode_step(p: Block, x: torch.Tensor, cache: Cache, pos: int,
                      cfg: ArchConfig, kind: str
                      ) -> Tuple[torch.Tensor, Cache]:
    """One token through one layer; the cache is updated in place."""
    h, ck, cv = attention_decode_step(
        p.attn, rmsnorm(p.ln1, x), cache["k"], cache["v"], pos, cfg,
        window=_window_for(kind, cfg))
    if cfg.post_block_norm:
        h = rmsnorm(p.post_ln1, h)
    return _ffn_branch(p, x + h, cfg), {"k": ck, "v": cv}


def segments_forward(layers: Sequence[Block], x: torch.Tensor,
                     cfg: ArchConfig,
                     positions: Optional[torch.Tensor] = None,
                     collect_caches: bool = False):
    """Run every layer in order; returns x, or (x, caches) with one cache
    dict per layer."""
    caches: List[Cache] = []
    for layer, kind in zip(layers, cfg.layer_kinds):
        out = block_forward(layer, x, cfg, kind, positions,
                            collect_cache=collect_caches)
        if collect_caches:
            x, c = out
            caches.append(c)
        else:
            x = out
    return (x, caches) if collect_caches else x
