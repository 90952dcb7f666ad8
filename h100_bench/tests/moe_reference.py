"""Plain float32 forward of the test family (`moe_family.py`): each layer
    x += attention(rmsnorm(x));  x += moe(rmsnorm(x))
with the dense family's attention, an MoE of the port's semantics (a
softmax router, the k highest by falling probability, the gates those
probabilities renormalised over the k, SwiGLU experts, every pair kept,
and an always-on SwiGLU shared expert under a sigmoid gate), and a tied
head: the embedding scaled by sqrt(hidden_size) on the way in, its rows
the unembedding.  With `follow` the router's top-k of layer i is
`follow.topk(i, ...)`.  It imports nothing of the port."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference import common

ATTN = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
EXPERTS = ("moe.router", "moe.w_gate", "moe.w_up", "moe.w_down")
SHARED = ("w_gate", "w_up", "w_down")


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    d, dh, V = cfg["hidden_size"], cfg["head_dim"], common.padded_vocab(cfg)
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E, f = cfg["num_local_experts"], cfg["moe_intermediate_size"]
    fs = cfg["shared_expert_intermediate_size"]
    out = [("embed", (V, d), "embed")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), "norm"),
                (p + "attn.wq", (d, hq * dh), "matmul"),
                (p + "attn.wk", (d, hkv * dh), "matmul"),
                (p + "attn.wv", (d, hkv * dh), "matmul"),
                (p + "attn.wo", (hq * dh, d), "matmul"),
                (p + "ln2", (d,), "norm"),
                (p + "moe.router", (d, E), "matmul"),
                (p + "moe.w_gate", (E, d, f), "matmul"),
                (p + "moe.w_up", (E, d, f), "matmul"),
                (p + "moe.w_down", (E, f, d), "matmul"),
                (p + "moe.shared.w_gate", (d, fs), "matmul"),
                (p + "moe.shared.w_up", (d, fs), "matmul"),
                (p + "moe.shared.w_down", (fs, d), "matmul"),
                (p + "moe.shared_gate", (d, 1), "matmul")]
    return out + [("final_norm", (d,), "norm")]


def moe(cfg: Dict, i: int, lw: Dict[str, torch.Tensor],
        sw: Dict[str, torch.Tensor], h: torch.Tensor, mm: common.Float32,
        follow: Optional[common.Follow]) -> torch.Tensor:
    k = cfg["num_experts_per_tok"]
    scores = mm(h, lw["router"])                               # (T, E)
    idx = common.topk(scores, k) if follow is None else \
        follow.topk(i, scores, k)
    gates = torch.softmax(scores, dim=-1).gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(h)
    for e in range(scores.shape[1]):
        tok, j = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            x = h[tok]
            out = mm(F.silu(mm(x, lw["w_gate"][e])) * mm(x, lw["w_up"][e]),
                     lw["w_down"][e])
            y.index_add_(0, tok, out * gates[tok, j, None])
    shared = common.ffn(sw, h, mm)
    return y + torch.sigmoid(mm(h, sw["shared_gate"])) * shared


def layer(cfg: Dict, i: int, weights: common.Weights, mm: common.Float32,
          follow: Optional[common.Follow]):
    p = f"layers.{i}."
    lw = common.layer_weights(weights, p, ATTN + EXPERTS + ("ln1", "ln2"),
                              ATTN + EXPERTS, mm)
    sw = common.layer_weights(weights, p + "moe.", [
        "shared." + n for n in SHARED] + ["shared_gate"],
        ["shared." + n for n in SHARED] + ["shared_gate"], mm)
    eps = cfg["rms_norm_eps"]

    def run(h: torch.Tensor) -> torch.Tensor:
        h = h + common.attention(cfg, lw, common.rmsnorm(lw["ln1"], h, eps),
                                 0, mm)
        return h + moe(cfg, i, lw, sw, common.rmsnorm(lw["ln2"], h, eps),
                       mm, follow)
    return run


def logits(cfg: Dict, weights: common.Weights, seqs,
           mm: common.Float32 = common.Float32(),
           follow: Optional[common.Follow] = None) -> List[torch.Tensor]:
    """float32 logits (n, vocab_size) at each sequence's asked
    positions, layer by layer over all sequences."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    hs = [weights["embed"][t].float() * math.sqrt(d) for t, _ in seqs]
    for i in range(cfg["num_hidden_layers"]):
        fn = layer(cfg, i, weights, mm, follow)
        hs = [fn(h) for h in hs]
    head = mm.weight(weights["embed"][:V].t())
    eps = cfg["rms_norm_eps"]
    return [mm(common.rmsnorm(weights["final_norm"], h[p], eps), head)
            for h, (_, p) in zip(hs, seqs)]
