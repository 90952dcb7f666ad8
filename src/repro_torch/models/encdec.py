"""Encoder-decoder backbone (seamless-m4t-large-v2), the port of
`repro.models.encdec`.

The speech frontend is a stub: the encoder takes precomputed frame
embeddings (B, S_enc, d).  Encoder = bidirectional attention blocks;
decoder = causal self-attention + cross-attention to the encoder output
+ FFN.  The reference scans stacked layers; the port keeps one module a
layer and loops.

Serving: `encdec_prepare_cross` runs the encoder once and returns every
decoder layer's cross-attention K/V; `encdec_decode_step` feeds one token
a row through the self-attention cache (written in place) and the cross
K/V.  Their attention goes to the flash and decode ops: the CUDA kernels
on the card (flash non-causal over the frames in the encoder, and with
one query row against the frames in each step's cross-attention).
Training: `encdec_forward` / `encdec_loss` take a `RunConfig`, whose
`kernels` chooses the attention as in `lm_forward`.

Weights are stored as `LM` stores them: matmul weights and the embedding
in `param_dtype` (the compute dtype when None; fp32 in a train state),
cast to the compute dtype at each use; norm scales in fp32.  The residual
streams keep the dtype of what enters them, as in the reference: the
frames' in the encoder, the embedding's in the decoder.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.kernels.runtime import resolve_device
from .attention import (Attention, attention_decode_step, attention_forward,
                        cross_kv)
from .common import dense, embed, rmsnorm, trunc_normal_fill
from .ffn import FFN, ffn_forward
from .lm import DTYPES, mask_pad_vocab, next_token_nll

CrossKV = Tuple[torch.Tensor, torch.Tensor]


def _norm(d: int, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


class EncLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device,
                 param_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype, device, param_dtype)
        self.ln2 = _norm(cfg.d_model, device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, dtype, device, param_dtype)


class DecLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device,
                 param_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.self_attn = Attention(cfg, dtype, device, param_dtype)
        self.ln_cross = _norm(cfg.d_model, device)
        self.cross_attn = Attention(cfg, dtype, device, param_dtype)
        self.ln2 = _norm(cfg.d_model, device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, dtype, device, param_dtype)


class EncDec(nn.Module):
    """`embed`, `enc_layers`, `dec_layers`, `enc_norm`, `final_norm` and
    the untied `lm_head`.  `rcfg.dtype` is the compute dtype,
    `param_dtype` the storage dtype of the matmul weights and the
    embedding (the compute dtype when None); `device` defaults to the
    card.  Weights follow `LM`'s laws (truncated normal at
    ±2σ; σ 0.02 for the embedding and the head, 1/sqrt(fan_in) for the
    rest; norm scales 0), drawn from `torch.Generator(device)` seeded with
    `seed`; `init=False` leaves them unset."""

    def __init__(self, cfg: ArchConfig, rcfg: RunConfig = RunConfig(),
                 seed: int = 0,
                 device: Union[str, torch.device, None] = None,
                 init: bool = True,
                 param_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        cfg.validate()
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder; build it with "
                             f"repro_torch.models.LM")
        self.cfg = cfg
        self.dtype = DTYPES[rcfg.dtype]
        store = param_dtype or self.dtype
        dev = resolve_device(device)
        d = cfg.d_model
        self.embed = nn.Parameter(torch.empty(cfg.padded_vocab, d,
                                              dtype=store, device=dev))
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, self.dtype, dev, store)
            for _ in range(cfg.encoder.n_layers))
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, self.dtype, dev, store)
            for _ in range(cfg.n_layers))
        self.enc_norm = _norm(d, dev)
        self.final_norm = _norm(d, dev)
        self.lm_head = nn.Parameter(torch.empty(d, cfg.padded_vocab,
                                                dtype=store, device=dev))
        if init:
            self._init_weights(torch.Generator(dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        d, dh = cfg.d_model, cfg.resolved_head_dim

        def fill(p: torch.Tensor, std: float) -> None:
            trunc_normal_fill(p, std, gen)

        def init_attn(a: Attention) -> None:
            for w in (a.wq, a.wk, a.wv):
                fill(w, 1.0 / math.sqrt(d))
            fill(a.wo, 1.0 / math.sqrt(cfg.n_heads * dh))

        def init_ffn(f: FFN) -> None:
            fill(f.w_gate, 1.0 / math.sqrt(d))
            fill(f.w_up, 1.0 / math.sqrt(d))
            fill(f.w_down, 1.0 / math.sqrt(cfg.d_ff))

        fill(self.embed, 0.02)
        fill(self.lm_head, 0.02)
        for layer in self.enc_layers:
            init_attn(layer.attn)
            init_ffn(layer.ffn)
        for layer in self.dec_layers:
            init_attn(layer.self_attn)
            init_attn(layer.cross_attn)
            init_ffn(layer.ffn)


def _layers(fn, layers, h: torch.Tensor, rcfg: Optional[RunConfig]
            ) -> torch.Tensor:
    """h through fn(layer, h) for each layer; with `rcfg.remat` under
    autograd, each under `torch.utils.checkpoint`."""
    remat = rcfg is not None and rcfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            h = torch.utils.checkpoint.checkpoint(fn, layer, h,
                                                  use_reentrant=False)
        else:
            h = fn(layer, h)
    return h


def encode(model: EncDec, frames: torch.Tensor,
           rcfg: Optional[RunConfig] = None) -> torch.Tensor:
    """frames (B, S_enc, d_model), precomputed embeddings (the stub) →
    the normed encoder output.  `rcfg` — a training forward's, as
    `attention_forward` reads it."""
    cfg = model.cfg

    def layer(lp: EncLayer, h: torch.Tensor) -> torch.Tensor:
        h = h + attention_forward(lp.attn, rmsnorm(lp.ln1, h), cfg,
                                  window=0, causal=False, rcfg=rcfg)
        return h + ffn_forward(lp.ffn, rmsnorm(lp.ln2, h), cfg.act)

    return rmsnorm(model.enc_norm, _layers(layer, model.enc_layers, frames,
                                           rcfg))


def decode_stack(model: EncDec, x: torch.Tensor, enc_out: torch.Tensor,
                 rcfg: Optional[RunConfig] = None) -> torch.Tensor:
    """The decoder over every position of x (B, S, d): causal
    self-attention, cross-attention to `enc_out`, FFN; normed."""
    cfg = model.cfg
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(lp: DecLayer, h: torch.Tensor) -> torch.Tensor:
        h = h + attention_forward(lp.self_attn, rmsnorm(lp.ln1, h), cfg,
                                  window=0, positions=positions, rcfg=rcfg)
        ckv = cross_kv(lp.cross_attn, enc_out, cfg)
        h = h + attention_forward(lp.cross_attn, rmsnorm(lp.ln_cross, h),
                                  cfg, window=0, kv_override=ckv, rcfg=rcfg)
        return h + ffn_forward(lp.ffn, rmsnorm(lp.ln2, h), cfg.act)

    return rmsnorm(model.final_norm, _layers(layer, model.dec_layers, x,
                                             rcfg))


def _head(model: EncDec, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits: the head's product in the compute dtype, upcast, the
    pad rows masked."""
    return mask_pad_vocab(dense(h, model.lm_head, dtype=model.dtype).float(),
                          model.cfg)


def encdec_forward(model: EncDec, frames: torch.Tensor,
                   tokens: torch.Tensor, rcfg: RunConfig) -> torch.Tensor:
    """The training forward: (frames, decoder tokens (B, S)) → logits
    (B, S, V) fp32 at every position."""
    enc_out = encode(model, frames, rcfg)
    h = decode_stack(model, embed(model.embed, tokens, model.dtype), enc_out,
                     rcfg)
    return _head(model, h)


def encdec_loss(model: EncDec, batch: Dict[str, torch.Tensor],
                rcfg: RunConfig, constrain: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy of `batch` = {"frames", "tokens"}: (loss,
    {"loss", "aux_loss": 0}).  `constrain` is accepted and not applied,
    as in the reference."""
    logits = encdec_forward(model, batch["frames"], batch["tokens"], rcfg)
    loss = torch.mean(next_token_nll(logits, batch["tokens"]))
    return loss, {"loss": loss, "aux_loss": loss.new_zeros(())}


# --------------------------------------------------------------------------
# Decode (one token at a time): self-attention cache + precomputed cross K/V
# --------------------------------------------------------------------------

@torch.no_grad()
def encdec_prepare_cross(model: EncDec, frames: torch.Tensor,
                         rcfg: Optional[RunConfig] = None) -> CrossKV:
    """The encoder pass and every decoder layer's cross K/V, stacked:
    each (L, B, Hkv, S_enc, dh).  `rcfg.kernels="xla"` takes the plain
    attention, None the flash op."""
    enc_out = encode(model, frames, rcfg)
    kv = [cross_kv(lp.cross_attn, enc_out, model.cfg)
          for lp in model.dec_layers]
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def init_encdec_cache(batch: int, max_len: int, cfg: ArchConfig,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Union[str, torch.device, None] = None
                      ) -> Dict[str, torch.Tensor]:
    """The decoder's self-attention cache, zero: {"k", "v"}, each (L, B,
    Hkv, max_len, dh), on the card unless `device` says otherwise."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def encdec_decode_step(model: EncDec, cache: Dict[str, torch.Tensor],
                       cross: CrossKV, tokens: torch.Tensor, pos: int,
                       rcfg: Optional[RunConfig] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, 1) at position `pos` → (logits (B, V) fp32, cache).  The
    token's k/v are written into the cache in place, where the reference
    returns an updated copy.  `rcfg.kernels="xla"` takes the plain
    attention, None the kernel ops."""
    cfg = model.cfg
    h = embed(model.embed, tokens, model.dtype)
    cross_k, cross_v = cross
    for i, lp in enumerate(model.dec_layers):
        a, _, _ = attention_decode_step(lp.self_attn, rmsnorm(lp.ln1, h),
                                        cache["k"][i], cache["v"][i], pos,
                                        cfg, window=0, rcfg=rcfg)
        h = h + a
        h = h + attention_forward(lp.cross_attn, rmsnorm(lp.ln_cross, h),
                                  cfg, window=0,
                                  kv_override=(cross_k[i], cross_v[i]),
                                  causal=False, rcfg=rcfg)
        h = h + ffn_forward(lp.ffn, rmsnorm(lp.ln2, h), cfg.act)
    h = rmsnorm(model.final_norm, h)
    return _head(model, h)[:, 0], cache
