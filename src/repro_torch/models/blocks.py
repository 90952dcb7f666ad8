"""Transformer, SSM and hybrid blocks and the layer loop (the port of
`repro.models.blocks` for the attention, SSM and hybrid kinds).

A block is one residual layer:
  attn_full / attn_swa — [norm → attention → (+)] [norm → FFN|MoE → (+)]
  ssm                  — [norm → mamba2 → (+)]      (no FFN in Mamba-2)
  hybrid / hybrid_full — [norm → ½(attn ⊕ ssm) → (+)] [norm → FFN → (+)]
with gemma2's optional post-norms on each branch.  A hybrid layer (hymba)
runs attention and the SSM side by side on one normed input, norms each
branch's output and averages the two.  The reference scans stacked
parameters per segment; the port keeps its layers in a flat list in the
order they run (`ArchConfig.layer_kinds`) and loops over it:
`segments_forward` for serving, `train_segments_forward` for training,
which also sums the MoE layers' aux losses.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import (ArchConfig, ATTN_FULL, ATTN_SWA,
                                      HYBRID, HYBRID_FULL, SSM, RunConfig)
from .attention import (Attention, attention_decode_step,
                        attention_decode_step_ring, attention_forward)
from .common import rmsnorm
from .ffn import FFN, ffn_forward
from .moe import MoE, moe_forward
from .ssm import (SSM as SSMMixer, init_ssm_cache, ssm_decode_step,
                  ssm_forward)

HYBRID_KINDS = (HYBRID, HYBRID_FULL)
ATTN_KINDS = (ATTN_FULL, ATTN_SWA) + HYBRID_KINDS
SSM_KINDS = (SSM,) + HYBRID_KINDS
# attention layers: {"k", "v"} (a ring decode's full-attention layers also
# "rk", "rv"); SSM layers: {"conv", "state"}; hybrid layers: all four
Cache = Dict[str, torch.Tensor]


def check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS + (SSM,):
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported (ROADMAP.md, queue 1)")


def _window_for(kind: str, cfg: ArchConfig) -> int:
    return cfg.window if kind in (ATTN_SWA, HYBRID) else 0


def _norm(d: int, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


class Block(nn.Module):
    """One layer of `kind`.  `dtype` is the compute dtype; the matmul
    weights are stored in `param_dtype` (`dtype` when None), the norm
    scales in fp32; `rcfg` gives the SSM's scan knobs."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype: torch.dtype,
                 device: torch.device,
                 param_dtype: Optional[torch.dtype] = None,
                 rcfg: Optional[RunConfig] = None) -> None:
        super().__init__()
        check_kind(kind)
        self.kind = kind
        self.has_ffn = kind != SSM         # Mamba-2 layers have no FFN
        d = cfg.d_model
        self.ln1 = _norm(d, device)
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, dtype, device, param_dtype)
        if kind in SSM_KINDS:
            self.ssm = SSMMixer(cfg, dtype, device, param_dtype, rcfg)
        if kind in HYBRID_KINDS:
            self.attn_out_norm = _norm(d, device)
            self.ssm_out_norm = _norm(d, device)
        if self.has_ffn:
            self.ln2 = _norm(d, device)
            if cfg.moe is not None:
                self.moe = MoE(cfg, dtype, device, param_dtype)
            else:
                self.ffn = FFN(d, cfg.d_ff, dtype, device, param_dtype)
        if cfg.post_block_norm:
            self.post_ln1 = _norm(d, device)
            if self.has_ffn:
                self.post_ln2 = _norm(d, device)


def _ffn_branch(p: Block, x: torch.Tensor, cfg: ArchConfig,
                rcfg: Optional[RunConfig] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x + the FFN or MoE branch, the MoE's aux loss or None); serving
    drops the aux loss, as the reference does."""
    if not p.has_ffn:
        return x, None
    h, aux = rmsnorm(p.ln2, x), None
    if cfg.moe is not None:
        h, aux = moe_forward(p.moe, h, cfg, rcfg)
    else:
        h = ffn_forward(p.ffn, h, cfg.act)
    if cfg.post_block_norm:
        h = rmsnorm(p.post_ln2, h)
    return x + h, aux


def _hybrid_mix(p: Block, a: torch.Tensor, s: torch.Tensor
                ) -> torch.Tensor:
    """The hybrid layer's two branches, each normed, averaged."""
    return 0.5 * (rmsnorm(p.attn_out_norm, a) + rmsnorm(p.ssm_out_norm, s))


def _block(p: Block, x: torch.Tensor, cfg: ArchConfig, kind: str,
           positions: Optional[torch.Tensor], collect_cache: bool,
           rcfg: Optional[RunConfig]):
    """(x, the MoE's aux loss or None, the cache or {})."""
    h = rmsnorm(p.ln1, x)
    cache: Cache = {}
    if kind in ATTN_KINDS:
        a = attention_forward(p.attn, h, cfg, window=_window_for(kind, cfg),
                              positions=positions, return_kv=collect_cache,
                              rcfg=rcfg)
        if collect_cache:
            a, (cache["k"], cache["v"]) = a
    if kind in SSM_KINDS:
        s = ssm_forward(p.ssm, h, cfg, return_state=collect_cache,
                        rcfg=rcfg)
        if collect_cache:
            s, ssm_cache = s
            cache.update(ssm_cache)
    h = _hybrid_mix(p, a, s) if kind in HYBRID_KINDS else \
        (s if kind == SSM else a)
    if cfg.post_block_norm:
        h = rmsnorm(p.post_ln1, h)
    x, aux = _ffn_branch(p, x + h, cfg, rcfg)
    return x, aux, cache


def block_forward(p: Block, x: torch.Tensor, cfg: ArchConfig, kind: str,
                  positions: Optional[torch.Tensor] = None,
                  collect_cache: bool = False,
                  rcfg: Optional[RunConfig] = None):
    """Serving.  Returns x, or (x, cache) when `collect_cache`: the roped
    k/v of an attention layer, the final state and conv tail of an SSM
    layer, both of a hybrid layer.  `rcfg` chooses the attention and the
    SSD (the kernel ops when None)."""
    x, _, cache = _block(p, x, cfg, kind, positions, collect_cache, rcfg)
    return (x, cache) if collect_cache else x


def ring_layer(kind: str, cfg: ArchConfig) -> bool:
    """Whether a ring decode appends this layer's tokens to a ring: full
    attention only; a sliding window keeps the decode kernel."""
    return kind in ATTN_KINDS and _window_for(kind, cfg) == 0


def init_block_cache(batch: int, max_len: int, cfg: ArchConfig, kind: str,
                     dtype: torch.dtype, device: torch.device,
                     ring: int = 0) -> Cache:
    """One layer's empty decode cache: zero k/v of `max_len` rows for
    attention (and with `ring` > 0, for full attention only, the rings
    "rk" / "rv" of `ring` rows), zero conv history and state for the
    SSM."""
    check_kind(kind)
    cache: Cache = {}
    if kind in ATTN_KINDS:
        shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
        if ring > 0 and ring_layer(kind, cfg):
            rshape = shape[:2] + (ring,) + shape[3:]
            cache["rk"] = torch.zeros(rshape, dtype=dtype, device=device)
            cache["rv"] = torch.zeros(rshape, dtype=dtype, device=device)
    if kind in SSM_KINDS:
        cache.update(init_ssm_cache(batch, cfg, device))
    return cache


def block_decode_step(p: Block, x: torch.Tensor, cache: Cache, pos: int,
                      cfg: ArchConfig, kind: str,
                      rcfg: Optional[RunConfig] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """One token through one layer.  An attention cache is written in
    place (a cache with a ring: the ring only, the main cache holding
    [0, base) with base = pos rounded down to the ring's length); an SSM
    cache is replaced by the returned one."""
    h = rmsnorm(p.ln1, x)
    new_cache: Cache = {}
    if kind in ATTN_KINDS and "rk" in cache:
        R = cache["rk"].shape[2]
        a, new_cache["rk"], new_cache["rv"] = attention_decode_step_ring(
            p.attn, h, cache["k"], cache["v"], cache["rk"], cache["rv"],
            pos, (pos // R) * R, cfg)
        new_cache["k"], new_cache["v"] = cache["k"], cache["v"]
    elif kind in ATTN_KINDS:
        a, new_cache["k"], new_cache["v"] = attention_decode_step(
            p.attn, h, cache["k"], cache["v"], pos, cfg,
            window=_window_for(kind, cfg), rcfg=rcfg)
    if kind in SSM_KINDS:
        s, ssm_cache = ssm_decode_step(p.ssm, h, cache, cfg)
        new_cache.update(ssm_cache)
    h = _hybrid_mix(p, a, s) if kind in HYBRID_KINDS else \
        (s if kind == SSM else a)
    if cfg.post_block_norm:
        h = rmsnorm(p.post_ln1, h)
    return _ffn_branch(p, x + h, cfg)[0], new_cache


def _pad_rows(a: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, H, S, D) → (B, H, max_len, D), zero past S."""
    out = a.new_zeros(a.shape[:2] + (max_len,) + a.shape[3:])
    out[:, :, :a.shape[2]] = a
    return out


def segments_forward(layers: Sequence[Block], x: torch.Tensor,
                     cfg: ArchConfig,
                     positions: Optional[torch.Tensor] = None,
                     cache_len: Optional[int] = None,
                     rcfg: Optional[RunConfig] = None):
    """Run every layer in order; returns x, or with `cache_len` (x,
    caches), one cache dict per layer, whose k/v go into caches of
    `cache_len` rows as soon as the layer has run, so the unpadded k/v of
    no more than one layer are held at a time.  `rcfg` as
    `block_forward` reads it."""
    caches: List[Cache] = []
    for layer, kind in zip(layers, cfg.layer_kinds):
        out = block_forward(layer, x, cfg, kind, positions,
                            collect_cache=cache_len is not None, rcfg=rcfg)
        if cache_len is None:
            x = out
            continue
        x, c = out
        caches.append({name: _pad_rows(a, cache_len) if name in ("k", "v")
                       else a for name, a in c.items()})
    return x if cache_len is None else (x, caches)


def train_segments_forward(layers: Sequence[Block], x: torch.Tensor,
                           cfg: ArchConfig, rcfg: RunConfig,
                           positions: Optional[torch.Tensor] = None,
                           constrain: Optional[Callable] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of every layer in order: (x, the sum of the
    MoE layers' aux losses, a 0-d fp32 tensor).  Attention and the SSD go
    where `rcfg.kernels` says; with `rcfg.remat` each layer runs under
    `torch.utils.checkpoint`, its activations recomputed in the backward,
    as the reference's `jax.checkpoint` of the layer scan.  `constrain`
    (the residual stream's sharding, `launch.specs.constrain_fn`) is
    applied where the reference's scan applies it: after the last layer
    of each repeat of a segment's kinds."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ends, i = set(), 0
    for kinds, rep in cfg.pattern:
        for _ in range(rep):
            i += len(kinds)
            ends.add(i - 1)

    def layer_fn(layer, kind, last):
        def run(h):
            h, a, _ = _block(layer, h, cfg, kind, positions, False, rcfg)
            if last and constrain is not None:
                h = constrain(h)
            return h, (a if a is not None else torch.zeros_like(aux))
        return run

    for i, (layer, kind) in enumerate(zip(layers, cfg.layer_kinds)):
        fn = layer_fn(layer, kind, i in ends)
        if rcfg.remat:
            x, a = torch.utils.checkpoint.checkpoint(fn, x,
                                                     use_reentrant=False)
        else:
            x, a = fn(x)
        aux = aux + a
    return x, aux
