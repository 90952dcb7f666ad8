"""Decoder-only LM (the port of `repro.models.lm` for dense attention,
mixture-of-experts, pure SSM and hybrid models, with a tied or an untied
unembedding, qkv biases, and the VLM's patch-embedding projector).

  LM             — the module; weights drawn from a seeded torch.Generator
  lm_forward     — tokens (+ optional patch embeddings) → logits at every
                   position and the MoE aux loss (training)
  lm_loss        — next-token cross entropy (training)
  lm_prefill     — tokens (+ optional patch embeddings) → last-position
                   logits and decode caches padded to `max_len`
  lm_decode_step — one token per row through the caches (attention caches
                   updated in place, SSM caches replaced)
  init_decode_cache   — empty per-layer caches, with rings for the
                        ring-append decode of full-attention layers
  add_decode_rings    — rings for prefilled caches, seeded with the
                        rows past the last whole ring
  flush_decode_caches — every ring into its main cache (every R tokens)

Matmul weights and the embedding table are stored in `param_dtype`,
which defaults to the compute dtype (what serving stores); a train state
stores them in fp32 and every product casts them to the compute dtype at
use, as the reference does.  Norm scales and the SSM's small leaves are
fp32.  Logits are fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.kernels.runtime import resolve_device
from .attention import flush_ring
from .blocks import (ATTN_KINDS, SSM_KINDS, Block, Cache, block_decode_step,
                     init_block_cache, ring_layer, segments_forward,
                     train_segments_forward)
from .ssm import SSM as SSMMixer, ssm_dims
from .common import (DTYPES, dense, embed, rmsnorm, settle_partial,
                     softcap, trunc_normal_fill, unembed)


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder config; LM is decoder-only, "
            f"build it with repro_torch.models.EncDec")


class LM(nn.Module):
    """`rcfg.dtype` is the compute dtype ("bfloat16" or "float32"), and
    `rcfg.ssd_chunk` / `rcfg.ssd_compute_dtype` the SSM layers' scan
    knobs; `param_dtype` the storage dtype of the matmul weights and the
    embedding (the compute dtype when None; `init_train_state` asks for
    fp32).  `device` defaults to the card.  Weights follow the reference's
    initializers (truncated normal at ±2σ; σ = 1/sqrt(fan_in), 0.02 for
    the embedding, the untied head, the MoE router and the shared-expert
    gate; norm scales and qkv biases 0; the SSM leaves by `init_ssm`'s
    law) but are drawn from
    `torch.Generator(device)` seeded with `seed`, so they are not the
    reference's numbers.  `init=False` leaves them unset for a caller
    that copies weights in (the qkv biases are then 0)."""

    def __init__(self, cfg: ArchConfig, rcfg: RunConfig = RunConfig(),
                 seed: int = 0,
                 device: Union[str, torch.device, None] = None,
                 init: bool = True,
                 param_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        cfg.validate()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = DTYPES[rcfg.dtype]
        store = param_dtype or self.dtype
        dev = resolve_device(device)
        self.embed = nn.Parameter(torch.empty(
            cfg.padded_vocab, cfg.d_model, dtype=store, device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, kind, self.dtype, dev, store, rcfg)
            for kind in cfg.layer_kinds)
        self.final_norm = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=torch.float32, device=dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.d_model, cfg.padded_vocab, dtype=store, device=dev))
        if cfg.vision is not None:
            self.vision_proj = nn.Parameter(torch.empty(
                cfg.vision.patch_embed_dim, cfg.d_model, dtype=store,
                device=dev))
        if init:
            self._init_weights(torch.Generator(dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        def fill(p: torch.Tensor, std: float) -> None:
            trunc_normal_fill(p, std, gen)

        def init_ssm(p: SSMMixer) -> None:
            """`init_ssm`'s law: A_log = log(1..H), D = 1, dt_bias the
            inverse softplus of a log-uniform dt in [dt_min, dt_max];
            conv_b and gate_norm stay 0."""
            sc = cfg.ssm
            d_inner, H = ssm_dims(cfg)[:2]
            fill(p.in_proj, 1.0 / math.sqrt(cfg.d_model))
            fill(p.out_proj, 1.0 / math.sqrt(d_inner))
            fill(p.conv_w, 1.0 / math.sqrt(sc.conv_kernel))
            p.A_log.copy_(torch.log(torch.arange(1, H + 1,
                                                 dtype=torch.float32)))
            p.D.fill_(1.0)
            lo, hi = math.log(sc.dt_min), math.log(sc.dt_max)
            u = torch.rand(H, generator=gen, device=p.dt_bias.device)
            dt = torch.exp(u * (hi - lo) + lo)
            p.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

        def init_ffn(f: nn.Module, d_ff: int) -> None:
            for w in (f.w_gate, f.w_up):
                fill(w, 1.0 / math.sqrt(cfg.d_model))
            fill(f.w_down, 1.0 / math.sqrt(d_ff))

        cfg = self.cfg
        dh = cfg.resolved_head_dim
        fill(self.embed, 0.02)
        if not cfg.tie_embeddings:
            fill(self.lm_head, 0.02)
        if cfg.vision is not None:
            fill(self.vision_proj, 1.0 / math.sqrt(cfg.vision.patch_embed_dim))
        for layer in self.layers:
            if layer.kind in SSM_KINDS:
                init_ssm(layer.ssm)
            if layer.kind in ATTN_KINDS:
                a = layer.attn
                for w in (a.wq, a.wk, a.wv):
                    fill(w, 1.0 / math.sqrt(cfg.d_model))
                fill(a.wo, 1.0 / math.sqrt(cfg.n_heads * dh))
            if hasattr(layer, "moe"):
                m, mc = layer.moe, cfg.moe
                fill(m.router, 0.02)
                init_ffn(m, mc.d_ff_expert)     # the stacked experts
                if mc.n_shared_experts:
                    init_ffn(m.shared, mc.d_ff_shared)
                    fill(m.shared_gate, 0.02)
            elif layer.has_ffn:
                init_ffn(layer.ffn, cfg.d_ff)


def _embed_in(model: LM, tokens: torch.Tensor,
              patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The embedding rows, scaled by sqrt(d_model) only where the head is
    tied, as in the reference.  A VLM's `patch_embeds` (B, n,
    patch_embed_dim), projected by `vision_proj` in the compute dtype,
    replace the first n positions; a prompt of fewer than n tokens raises
    (the reference would return a longer sequence)."""
    x = embed(model.embed, tokens, model.dtype)
    if model.cfg.tie_embeddings:
        x = x * x.new_tensor(math.sqrt(model.cfg.d_model))
    if model.cfg.vision is not None and patch_embeds is not None:
        n = patch_embeds.shape[1]
        if n > x.shape[1]:
            raise ValueError(f"{n} patch embeddings exceed the prompt of "
                             f"{x.shape[1]} tokens")
        proj = dense(patch_embeds, model.vision_proj, dtype=model.dtype)
        x = torch.cat([proj, x[:, n:]], dim=1)
    return x


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits.  The untied head is the reference's `dense`: a product
    in the compute dtype (in bf16 each logit rounded to bf16), then
    upcast."""
    cfg = model.cfg
    logits = unembed(model.embed, x, model.dtype) if cfg.tie_embeddings \
        else dense(x, model.lm_head, dtype=model.dtype).float()
    return mask_pad_vocab(softcap(logits, cfg.final_softcap), cfg)


def mask_pad_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The padded vocab rows' logits set to -1e30, out of the softmax; a
    new tensor (autograd may hold the one it is given)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= \
        cfg.vocab_size
    return torch.where(pad, -1e30, logits)


def lm_forward(model: LM, tokens: torch.Tensor, rcfg: RunConfig,
               patch_embeds: Optional[torch.Tensor] = None,
               constrain: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: tokens (B, S) → (logits (B, S, V) fp32 at
    every position, the summed MoE aux loss, 0-d fp32).  Attention and
    the SSD go where `rcfg.kernels` says, each layer under
    `torch.utils.checkpoint` with `rcfg.remat`; `constrain` as
    `train_segments_forward` applies it."""
    x = _embed_in(model, tokens, patch_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, aux = train_segments_forward(model.layers, x, model.cfg, rcfg,
                                    positions=positions, constrain=constrain)
    x = rmsnorm(model.final_norm, x)
    return _logits(model, x), aux


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """(B, S-1) fp32: logsumexp of each position's logits less the logit
    of the token after it."""
    lg = logits[:, :-1]
    picked = settle_partial(_pick(lg, tokens[:, 1:, None].long()))[..., 0]
    return torch.logsumexp(lg, dim=-1) - picked


def _pick(lg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`torch.gather(lg, -1, idx)`.  For a DTensor split at most on its
    batch and its vocab (last) dim, each rank picks from its own shard
    (zero where the target lies on another rank's vocab, the picks then
    a pending sum there): DTensor's own gather builds the backward's
    gradient of the logits at their global size on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    last = lg.ndim - 1
    if not isinstance(lg, DTensor) or not all(
            p.is_replicate() or (isinstance(p, Shard) and p.dim in (0, last))
            for p in lg.placements):
        return torch.gather(lg, -1, idx)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_box

    mesh = lg.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in lg.placements]
    shape, offset = local_box(lg.shape, mesh, lg.placements)
    local = idx.redistribute(mesh, rows).to_local() - offset[last]
    hit = (local >= 0) & (local < shape[last])
    got = torch.gather(lg.to_local(), -1, local.clamp(0, shape[last] - 1))
    got = torch.where(hit, got, got.new_zeros(()))
    out = [Partial() if isinstance(p, Shard) and p.dim == last else q
           for p, q in zip(lg.placements, rows)]
    return DTensor.from_local(got, mesh, out, run_check=False,
                              shape=idx.shape, stride=idx.stride())


def lm_loss(model: LM, batch: Dict[str, torch.Tensor], rcfg: RunConfig,
            constrain: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over `batch` = {"tokens": (B, S)[,
    "patch_embeds"]}: (loss + aux, {"loss", "aux_loss", "tokens"}).  A
    VLM does not train on the positions its patches fill."""
    tokens = batch["tokens"]
    logits, aux = lm_forward(model, tokens, rcfg,
                             patch_embeds=batch.get("patch_embeds"),
                             constrain=constrain)
    nll = next_token_nll(logits, tokens)
    mask = torch.ones_like(nll)
    if model.cfg.vision is not None:
        mask[:, :max(model.cfg.vision.n_patches - 1, 0)] = 0.0
    count = mask.sum()
    loss = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    return loss + aux, {"loss": loss, "aux_loss": aux, "tokens": count}


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor,
               max_len: Optional[int] = None,
               patch_embeds: Optional[torch.Tensor] = None,
               rcfg: Optional[RunConfig] = None
               ) -> Tuple[torch.Tensor, List[Cache]]:
    """tokens (B, S) (+ a VLM's patch embeddings, see `_embed_in`) →
    (last-position logits (B, V) fp32, caches), one cache per layer:
    {"k", "v"} of an attention layer, each (B, Hkv, max_len, dh) and zero
    past S; {"conv", "state"} of an SSM layer; all four of a hybrid
    layer.  `rcfg.kernels="xla"` takes the plain attention and SSD, as
    the reference's serving step does; None (or "pallas") the kernel
    ops."""
    B, S = tokens.shape
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    x = _embed_in(model, tokens, patch_embeds)
    positions = torch.arange(S, device=tokens.device)
    x, caches = segments_forward(model.layers, x, model.cfg,
                                 positions=positions, cache_len=max_len,
                                 rcfg=rcfg)
    x = rmsnorm(model.final_norm, x[:, -1:])
    return _logits(model, x)[:, 0], caches


@torch.no_grad()
def lm_decode_step(model: LM, caches: List[Cache], tokens: torch.Tensor,
                   pos: int, rcfg: Optional[RunConfig] = None
                   ) -> Tuple[torch.Tensor, List[Cache]]:
    """tokens (B, 1); `pos` — the current cache fill.  Returns (logits
    (B, V) fp32, caches): attention caches are updated in place, SSM
    caches replaced, so use the returned list.  `rcfg` as `lm_prefill`
    reads it."""
    x = _embed_in(model, tokens)
    new_caches: List[Cache] = []
    for layer, kind, cache in zip(model.layers, model.cfg.layer_kinds,
                                  caches):
        x, c = block_decode_step(layer, x, cache, pos, model.cfg, kind,
                                 rcfg)
        new_caches.append(c)
    x = rmsnorm(model.final_norm, x)
    return _logits(model, x)[:, 0], new_caches


def init_decode_cache(batch: int, max_len: int, cfg: ArchConfig,
                      dtype: torch.dtype = torch.bfloat16, ring: int = 0,
                      device: Union[str, torch.device, None] = None
                      ) -> List[Cache]:
    """One empty cache per layer (`blocks.init_block_cache`) on `device`
    (the card unless it says otherwise); with `ring` > 0 the
    full-attention layers also get rings of `ring` rows, and
    `lm_decode_step` appends to those (see
    `attention_decode_step_ring`)."""
    dev = resolve_device(device)
    return [init_block_cache(batch, max_len, cfg, kind, dtype, dev,
                             ring=ring) for kind in cfg.layer_kinds]


def add_decode_rings(caches: List[Cache], cfg: ArchConfig, ring: int,
                     pos: int) -> List[Cache]:
    """Rings of `ring` rows for the full-attention layers of caches
    filled to `pos` (a prefill's), IN PLACE: each holds the rows [base,
    pos) of its main cache, base = pos rounded down to `ring`, as if
    they had been decoded into it."""
    base = (pos // ring) * ring
    for kind, c in zip(cfg.layer_kinds, caches):
        if ring_layer(kind, cfg):
            k, v = c["k"], c["v"]
            shape = k.shape[:2] + (ring,) + k.shape[3:]
            c["rk"] = k.new_zeros(shape)
            c["rv"] = v.new_zeros(shape)
            c["rk"][:, :, :pos - base] = k[:, :, base:pos]
            c["rv"][:, :, :pos - base] = v[:, :, base:pos]
    return caches


def flush_decode_caches(caches: List[Cache], base: int) -> List[Cache]:
    """Merge every layer's ring into its main cache at `base`, IN PLACE
    (call every R decoded tokens, with base = the first position the
    ring holds); returns the caches."""
    for c in caches:
        if "rk" in c:
            flush_ring(c["k"], c["v"], c["rk"], c["rv"], base)
    return caches
