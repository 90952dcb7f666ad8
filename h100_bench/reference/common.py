"""Plain float32 pieces of the references: products, norms, RoPE,
attention, the gated FFN, and the loop that runs a family's layers over
whole sequences.

A reference reads the weights the harness drew, by the names of its
family's `layout`, and works everything else out from them and from the
configuration file.  It computes in float32 with TF32 off, one sequence
at a time, layer by layer, so that it fits beside the served weights.
It imports nothing of the program.

`Float32` computes every product in float32.  `Fp8` is the control: the
same forward with both operands of every weight product rounded to
float8 e4m3 first (a scale a weight column and a token row, the
accumulation in float32), the lower precision a served bf16 model would
be tempted into.

`Follow` lets a family's reference take a discrete choice of the
program's (an MoE router's top-k) where its own lies within a limit of
a tie, and counts each time it does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
NEG_INF = float("-inf")
FP8_MAX = 448.0                      # largest finite float8_e4m3fn


def padded_vocab(cfg: Dict) -> int:
    """Rows of the embedding and columns of the head: the vocabulary
    padded to a multiple of 128, as the served model stores them; only
    the first `vocab_size` are ever read or compared."""
    return -(-cfg["vocab_size"] // 128) * 128


class Float32:
    """Weight products in float32."""

    name = "float32"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.float()

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w


class Fp8(Float32):
    """Weight products of operands rounded to float8 e4m3."""

    name = "fp8_e4m3"

    @staticmethod
    def _round(t: torch.Tensor, dim: int) -> torch.Tensor:
        scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / \
            FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return self._round(w.float(), -2)            # a scale a column

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._round(x, -1) @ w                # a scale a row


def topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(T, k) indices of the k highest scores of each row, the highest
    first; equal scores go to the lower index."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[:, :k]


class Follow:
    """Top-k choices at one site a step (the s-th call in layer order),
    the program's taken near the reference's own ties.

    `theirs[s][j]` is the program's (T, k) choice at site s for the j-th
    sequence the reference visits there, by the same positions.  Where
    the program's set of k differs from the reference's own, the
    reference's margin is its k-th best score less its score of the
    program's lowest choice: the program's choice is taken where that
    margin is at most `limit`, and counted (`flips`); `margin` keeps the
    widest over every choice that differed, taken or not.  With no
    `theirs` the reference's own choices are kept in `own`, in the same
    form, for another reference run to follow (the control's)."""

    def __init__(self, theirs: Optional[Dict] = None, limit: float = 0.0
                 ) -> None:
        self.theirs, self.limit = theirs, limit
        self.own: Dict[int, List[torch.Tensor]] = {}
        self.flips, self.margin = 0, 0.0

    def topk(self, site: int, scores: torch.Tensor, k: int
             ) -> torch.Tensor:
        """(T, k) indices into the scores' last dim, the highest first;
        equal scores go to the lower index."""
        own = topk(scores, k)
        seen = self.own.setdefault(site, [])
        seen.append(own)
        if self.theirs is None:
            return own
        theirs = self.theirs[site][len(seen) - 1].to(scores.device)
        differ = (theirs.sort(-1).values != own.sort(-1).values).any(-1)
        margin = scores.gather(1, own[:, -1:])[:, 0] - \
            scores.gather(1, theirs).min(-1).values
        take = differ & (margin <= self.limit)
        self.flips += int(take.sum())
        if bool(differ.any()):
            self.margin = max(self.margin, float(margin[differ].max()))
        return torch.where(take[:, None], theirs, own)

    def numbers(self, name: str) -> Dict[str, float]:
        return {f"{name}_flips": self.flips, f"{name}_margin": self.margin}


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + scale)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.float())


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (T, H, D): the pairs (0::2, 1::2) of each head rotated by
    position · theta^(−2i/D)."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = positions.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
              window: int, mm: Float32, block: int = 512) -> torch.Tensor:
    """Causal grouped-query self-attention of one sequence h (T, d) over
    its positions 0..T−1, every position attended (pads included), the
    last `window` keys of each query where `window` > 0; queries in
    blocks of `block`."""
    T = h.shape[0]
    hq, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    pos = torch.arange(T, device=h.device)
    q = rope(mm(h, lw["wq"]).reshape(T, hq, dh), pos, cfg["rope_theta"])
    k = rope(mm(h, lw["wk"]).reshape(T, hkv, dh), pos, cfg["rope_theta"])
    v = mm(h, lw["wv"]).reshape(T, hkv, dh)
    G = hq // hkv
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (Hq, T, dh)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(dh)
    out = torch.empty_like(q)
    for a in range(0, T, block):
        b = min(a + block, T)
        lo = max(0, a - window + 1) if window > 0 else 0
        s = q[:, a:b] @ k[:, lo:b].transpose(1, 2)           # (Hq, bq, nk)
        rows = torch.arange(a, b, device=h.device)[:, None]
        cols = torch.arange(lo, b, device=h.device)[None, :]
        keep = cols <= rows
        if window > 0:
            keep &= cols > rows - window
        s = torch.where(keep, s, NEG_INF)
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, lo:b]
    return mm(out.transpose(0, 1).reshape(T, hq * dh), lw["wo"])


def ffn(lw: Dict[str, torch.Tensor], h: torch.Tensor, mm: Float32
        ) -> torch.Tensor:
    """silu(h·W_gate) ⊙ (h·W_up) · W_down."""
    return mm(F.silu(mm(h, lw["w_gate"])) * mm(h, lw["w_up"]),
              lw["w_down"])


def layer_weights(weights: Weights, prefix: str, names: Sequence[str],
                  products: Sequence[str], mm: Float32
                  ) -> Dict[str, torch.Tensor]:
    """One layer's weights under their short names: the products' ready
    for `mm`, the rest in float32."""
    out = {}
    for n in names:
        w = weights[prefix + n]
        out[n.split(".")[-1]] = mm.weight(w) if n in products else w.float()
    return out


def forward(cfg: Dict, weights: Weights,
            seqs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            layer: Callable, mm: Float32) -> List[torch.Tensor]:
    """Each (tokens (T,), positions (n,)) sequence through the embedding,
    every layer (`layer(cfg, i, weights, mm)` gives layer i as a function
    of h (T, d)), the final norm and the head: float32 logits (n,
    vocab_size) at the asked positions.  Layer by layer over all
    sequences, so that a layer's weights are prepared once."""
    embed = weights["embed"]
    hs = [embed[t].float() for t, _ in seqs]
    for i in range(cfg["num_hidden_layers"]):
        fn = layer(cfg, i, weights, mm)
        hs = [fn(h) for h in hs]
        del fn
    head = mm.weight(weights["lm_head"][:, :cfg["vocab_size"]])
    eps = cfg["rms_norm_eps"]
    return [mm(rmsnorm(weights["final_norm"], h[p], eps), head)
            for h, (_, p) in zip(hs, seqs)]


def no_tf32() -> Tuple[bool, bool]:
    """Turn TF32 off for products and convolutions; returns the settings
    to put back."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old
