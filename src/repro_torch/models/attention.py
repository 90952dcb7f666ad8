"""Grouped-query attention with SWA / softcap / RoPE: the full-sequence
forward (prefill, training, an encoder's bidirectional attention and a
decoder's cross-attention) and the one-token decode step against a KV
cache (the port of `repro.models.attention`).

Serving with no `rcfg` (or `kernels="pallas"`) sends prefill attention to
the flash attention op and decode attention to the decode attention op;
each runs its CUDA kernel on the card and its plain version on the CPU,
and raises on any other device.  The ring-append decode of full-attention
layers (`attention_decode_step_ring`, `flush_ring`) is plain PyTorch, as
in the reference.  A forward passed a `RunConfig` follows the
reference's: `kernels="xla"` takes `chunked_flash` and
`decode_attention_ref`, plain PyTorch that autograd differentiates, on any
device (the dry-run costs that path on meta tensors); `kernels="pallas"`
takes the ops, and raises where autograd would need a kernel's backward,
which no kernel has.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.dist.sharding import hint
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from .common import apply_rope, dense, needs_grad, plain_path


class Attention(nn.Module):
    """wq, wk, wv, wo; with `cfg.qkv_bias` also bq, bk, bv, the biases of
    the three input projections, zero at init as in the reference (wo has
    none).  `dtype` is the compute dtype of the projections; the weights
    are stored in `param_dtype` (`dtype` when None)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device,
                 param_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dtype = dtype
        d, dh = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
        kw = dict(dtype=param_dtype or dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, hq, **kw))
        self.wk = nn.Parameter(torch.empty(d, hkv, **kw))
        self.wv = nn.Parameter(torch.empty(d, hkv, **kw))
        self.wo = nn.Parameter(torch.empty(hq, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(hq, **kw))
            self.bk = nn.Parameter(torch.zeros(hkv, **kw))
            self.bv = nn.Parameter(torch.zeros(hkv, **kw))


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n·dh) → (B, n, S, dh).  On a mesh whose 'model' dim the
    heads do not divide, the `attn_proj` hint first moves a projection
    split on its features to a split on the sequence: DTensor cannot
    unflatten a feature split into n heads unless the split divides n,
    where XLA pads it."""
    B, S, _ = x.shape
    return hint("attn_proj", x).reshape(B, S, n, dh).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) → (B, S, H·D), in `attn_proj`'s layout: the backward
    of the merge is a split of the heads, which a gradient split on its
    features (from the out projection) cannot take either."""
    B, H, S, D = x.shape
    return hint("attn_proj", x.transpose(1, 2).reshape(B, S, H * D))


def _scale(cfg: ArchConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None \
        else 1.0 / math.sqrt(cfg.resolved_head_dim)


def _proj(p: Attention, x: torch.Tensor, which: str) -> torch.Tensor:
    """The q, k or v projection of x, with its bias where it has one, in
    the compute dtype."""
    return dense(x, getattr(p, "w" + which), getattr(p, "b" + which, None),
                 p.dtype)


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    return dense(o, p.wo, dtype=p.dtype)


def _qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    dh = cfg.resolved_head_dim
    q = _split_heads(_proj(p, x, "q"), cfg.n_heads, dh)
    k = _split_heads(_proj(p, x, "k"), cfg.n_kv_heads, dh)
    v = _split_heads(_proj(p, x, "v"), cfg.n_kv_heads, dh)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


NEG_INF = -1e30


def chunked_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, softcap_v: float, scale: float,
                  chunk_q: int, chunk_k: int, q_offset: int = 0
                  ) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → (B, Hq, Sq, D): the
    reference's XLA-path attention, the flash kernel's online softmax over
    (chunk_q, chunk_k) tiles as a loop over key chunks, in plain PyTorch
    that autograd differentiates.  Scores, softmax and the accumulator are
    fp32; q·scale stays in q's dtype and the probabilities are cast to
    v's before their product, as in the reference."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq, bk = min(chunk_q, Sq), min(chunk_k, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    Sq_p, Sk_p = nq * bq, nk * bk
    dev = q.device

    qf = q * torch.tensor(scale, dtype=q.dtype)
    if Sq_p != Sq:
        qf = F.pad(qf, (0, 0, 0, Sq_p - Sq))
    # k/v in attn_kv5's layout before the key-chunk split: a sequence
    # split over 'model' need not divide into nk chunks
    kf, vf = hint("attn_kv4", k), hint("attn_kv4", v)
    if Sk_p != Sk:
        kf, vf = F.pad(kf, (0, 0, 0, Sk_p - Sk)), F.pad(vf, (0, 0, 0, Sk_p - Sk))
    # sharding hints keep attention parallel on heads when they divide
    # the model dim, on q-sequence blocks (context parallelism) otherwise
    qf = hint("attn_q6", qf.reshape(B, Hkv, G, nq, bq, D)).float()
    kf = hint("attn_kv5", kf.reshape(B, Hkv, nk, bk, D))
    vf = hint("attn_kv5", vf.reshape(B, Hkv, nk, bk, D))
    rows = (q_offset + torch.arange(Sq_p, device=dev)).reshape(nq, bq, 1)
    tiles = functools.partial(_flash_tiles, Sk=Sk, causal=causal,
                              window=window, softcap_v=softcap_v)
    out = on_local_shards(tiles, qf, (kf, vf), (3,), rows)
    out = out.reshape(B, Hq, Sq_p, D)[:, :, :Sq]
    return hint("attn_out", out.to(q.dtype))


def _flash_tiles(qf, kf, vf, rows, *, Sk: int, causal: bool, window: int,
                 softcap_v: float) -> torch.Tensor:
    """`chunked_flash`'s loop over key chunks: qf (B, Hkv, G, nq, bq, D)
    fp32, kf/vf (B, Hkv, nk, bk, D), rows (nq, bq, 1) the q positions →
    the normalised output (B, Hkv, G, nq, bq, D) fp32."""
    B, Hkv, G, nq, bq, D = qf.shape
    bk = kf.shape[3]
    dev = qf.device
    m = torch.full((B, Hkv, G, nq, bq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, nq, bq), device=dev)
    acc = torch.zeros((B, Hkv, G, nq, bq, D), device=dev)
    for j in range(kf.shape[2]):
        kc, vc = kf[:, :, j], vf[:, :, j]
        cols = j * bk + torch.arange(bk, device=dev)
        s = torch.einsum("bhgqtd,bhkd->bhgqtk", qf, kc.float())
        if softcap_v > 0:
            s = softcap_v * torch.tanh(s / softcap_v)
        mask = cols < Sk
        if causal:
            mask = mask & (cols <= rows)
        if window > 0:
            mask = mask & (cols > rows - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqtk,bhkd->bhgqtd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    denom = torch.where(l == 0.0, 1.0, l)
    return acc / denom[..., None]


def on_local_shards(fn, q, kv, q_split=(), *extra):
    """fn(q, *kv, *extra) → a tensor (or tuple) laid out as q, run on
    each rank's shards where that needs nothing from another rank: q and
    kv DTensors, q split on its batch (dim 0) and heads (dim 1), and on
    its dims `q_split` (a context-parallel split of the q blocks), kv
    split on the batch and the heads as q is, or whole there (then cut
    to q's rows and kv heads), and on nothing else.  A kv that is whole
    where q is split takes a pending-sum gradient there (each rank's
    part).  `extra` (plain tensors) is cut to q's shard on its first
    `q_split` dim (the q positions).  Any other input runs `fn` as it
    is, on DTensor's dispatch.  DTensor cannot flatten a batch and a head
    dim split on two mesh dims into one (torch 2.11), which the products'
    batched matmuls do, nor does the attention need it."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if not isinstance(q, DTensor) or not all(isinstance(t, DTensor)
                                              for t in kv):
        return fn(q, *kv, *extra)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_box

    mesh, qp, kp = q.device_mesh, q.placements, kv[0].placements
    G = q.shape[1] // kv[0].shape[1]
    shape, offset = local_box(q.shape, mesh, qp)
    ok = all(t.placements == kp for t in kv) and all(
        p.is_replicate() or p.is_shard(0) or p.is_shard(1) for p in kp) \
        and all(p.is_replicate() or (isinstance(p, Shard) and p.dim in
                                     (0, 1, *q_split)) for p in qp)
    cuts = {}                          # kv dim → (start, length) of q's
    for d in (0, 1):
        q_on = [i for i, p in enumerate(qp) if p.is_shard(d)]
        kv_on = [i for i, p in enumerate(kp) if p.is_shard(d)]
        if kv_on == q_on:
            continue
        lo, n = offset[d], shape[d]
        if kv_on or (d == 1 and (lo % G or n % G)):
            ok = False
        else:
            cuts[d] = (lo // G, n // G) if d == 1 else (lo, n)
    if not ok:
        return fn(q, *kv, *extra)
    grad = [Partial() if p.is_replicate() and isinstance(pq, Shard)
            else p for p, pq in zip(kp, qp)]
    local_kv = []
    for t in kv:
        t = t.to_local(grad_placements=grad)
        for d, (lo, n) in cuts.items():
            t = t.narrow(d, lo, n)
        local_kv.append(t)
    cut = [e.narrow(0, offset[q_split[0]], shape[q_split[0]])
           if q_split else e for e in extra]
    out = fn(q.to_local(), *local_kv, *cut)
    split = {p.dim for p in qp if isinstance(p, Shard)}

    def wrap(o):
        whole = tuple(q.shape[d] if d in split else n
                      for d, n in enumerate(o.shape))
        stride = tuple(math.prod(whole[d + 1:]) for d in range(len(whole)))
        return DTensor.from_local(o, mesh, qp, run_check=False,
                                  shape=whole, stride=stride)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _attend(q, k, v, *, causal: bool, window: int, softcap_v: float,
            scale: float, rcfg: Optional[RunConfig]) -> torch.Tensor:
    """`chunked_flash` under `kernels="xla"`, else the flash op."""
    if plain_path(rcfg):
        return chunked_flash(q, k, v, causal, window, softcap_v, scale,
                             rcfg.attn_chunk_q, rcfg.attn_chunk_k)
    if rcfg is not None:
        needs_grad(q, k, v, what="flash attention")
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap_v, scale=scale)


def attention_forward(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                      window: int, positions: Optional[torch.Tensor] = None,
                      causal: bool = True,
                      kv_override: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None,
                      return_kv: bool = False,
                      rcfg: Optional[RunConfig] = None):
    """Full-sequence attention (prefill, training).  x (B, S, d).
    `kv_override` — the encoder output's (k, v) from `cross_kv`: no RoPE
    on q or on them, and no causal mask.  `return_kv` also returns the
    roped (k, v), each (B, Hkv, S, dh), for the decode cache.  `rcfg`
    chooses the attention as `_attend` says."""
    S = x.shape[1]
    if kv_override is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q, k, v = _qkv(p, x, cfg, positions)
    else:
        q = _split_heads(_proj(p, x, "q"), cfg.n_heads,
                         cfg.resolved_head_dim)
        k, v = kv_override
    o = _attend(q, k, v, causal=causal and kv_override is None,
                window=window, softcap_v=cfg.attn_softcap,
                scale=_scale(cfg), rcfg=rcfg)
    out = _out(p, _merge_heads(o))
    if return_kv:
        return out, (k, v)
    return out


def cross_kv(p: Attention, enc_out: torch.Tensor, cfg: ArchConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K/V of the encoder output, each (B, Hkv,
    S_enc, dh), without RoPE."""
    dh = cfg.resolved_head_dim
    k = _split_heads(_proj(p, enc_out, "k"), cfg.n_kv_heads, dh)
    v = _split_heads(_proj(p, enc_out, "v"), cfg.n_kv_heads, dh)
    return k, v


def attention_decode_step(p: Attention, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, cfg: ArchConfig, *,
                          window: int, rcfg: Optional[RunConfig] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x (B, 1, d); cache (B, Hkv, max_len, dh); `pos`
    is the current length.  Returns (out, cache_k, cache_v).  Under
    `kernels="xla"` the attention is `decode_attention_ref`, else the
    decode op.

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
    kw = dict(kv_len=pos + 1, window=window, softcap=cfg.attn_softcap,
              scale=_scale(cfg))
    if plain_path(rcfg):
        o = on_local_shards(functools.partial(decode_attention_ref, **kw),
                            q[:, :, 0], (cache_k, cache_v))
    else:
        o = decode_attention(q[:, :, 0], cache_k, cache_v, **kw)
    return _out(p, o.reshape(B, 1, -1)), cache_k, cache_v


# --------------------------------------------------------------------------
# Ring-append decode — the mp_split fix for sequence-sharded caches
# --------------------------------------------------------------------------
# Writing one token into a sequence-SHARDED cache costs a guarded write of
# the whole buffer.  Instead, appends go to a small REPLICATED ring
# (B, Hkv, R, dh), and `flush_ring` merges the ring into the main cache
# every R tokens.  Attention combines the two partial softmaxes (the flash
# combine).

def _partial_softmax_attend(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid_len: int, scale: float,
                            softcap_v: float):
    """(num (B, Hq, D), max (B, Hq, 1), denom (B, Hq, 1)), fp32, of one
    query per head over k/v rows [0, valid_len).  Scores and sums in
    fp32; the probabilities cast to v's dtype before their product, as
    in the reference."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) * scale
    if softcap_v > 0:
        s = softcap_v * torch.tanh(s / softcap_v)
    mask = torch.arange(S, device=q.device) < valid_len
    s = torch.where(mask, s, NEG_INF)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF + 1)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    num = torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype).float(), v.float())
    return (num.reshape(B, Hq, D), m.reshape(B, Hq, 1),
            l.reshape(B, Hq, 1))


def attention_decode_step_ring(p: Attention, x: torch.Tensor,
                               cache_k: torch.Tensor, cache_v: torch.Tensor,
                               ring_k: torch.Tensor, ring_v: torch.Tensor,
                               pos: int, base: int, cfg: ArchConfig
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Ring decode (full attention only).  The main cache holds [0,
    base), the ring [base, pos]; the token goes to ring slot pos − base,
    written IN PLACE.  Returns (out, ring_k, ring_v); the main cache is
    not touched."""
    B = x.shape[0]
    slot = pos - base
    if not 0 <= slot < ring_k.shape[2]:
        raise IndexError(f"ring slot {slot} (pos {pos}, base {base}) "
                         f"outside the ring of {ring_k.shape[2]}")
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    ring_k[:, :, slot] = k[:, :, 0].to(ring_k.dtype)
    ring_v[:, :, slot] = v[:, :, 0].to(ring_v.dtype)
    q1, scale = q[:, :, 0], _scale(cfg)
    n1, m1, l1 = on_local_shards(functools.partial(
        _partial_softmax_attend, valid_len=base, scale=scale,
        softcap_v=cfg.attn_softcap), q1, (cache_k, cache_v))
    n2, m2, l2 = on_local_shards(functools.partial(
        _partial_softmax_attend, valid_len=slot + 1, scale=scale,
        softcap_v=cfg.attn_softcap), q1, (ring_k, ring_v))
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    denom = l1 * a1 + l2 * a2
    denom = torch.where(denom == 0.0, 1.0, denom)
    o = ((n1 * a1 + n2 * a2) / denom).to(q1.dtype)
    return _out(p, o.reshape(B, 1, -1)), ring_k, ring_v


def flush_ring(cache_k: torch.Tensor, cache_v: torch.Tensor,
               ring_k: torch.Tensor, ring_v: torch.Tensor, base: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the whole ring into the main cache at rows [base, base + R),
    IN PLACE (every R steps).  The sequence dim is ndim − 2.  A ring past
    the cache's end raises, where the reference's update would clamp."""
    axis, R = cache_k.ndim - 2, ring_k.shape[-2]
    if not 0 <= base <= cache_k.shape[axis] - R:
        raise IndexError(f"ring of {R} at {base} outside the cache of "
                         f"{cache_k.shape[axis]}")
    cache_k.narrow(axis, base, R).copy_(ring_k)
    cache_v.narrow(axis, base, R).copy_(ring_v)
    return cache_k, cache_v
