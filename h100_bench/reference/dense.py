"""Plain float32 forward of the dense decoder family (InternLM2,
arXiv:2403.17297, and its kin): each layer
    x += attention(rmsnorm(x));  x += ffn(rmsnorm(x))
with causal grouped-query attention under RoPE (no biases, no softcap,
scale 1/sqrt(head_dim)), a SwiGLU FFN, RMSNorm with the (1 + scale)
convention, and an untied head.  Left padding is token 0, attended like
any other token, as the served engine does."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from h100_bench.reference import common

ATTN = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
FFN = ("ffn.w_gate", "ffn.w_up", "ffn.w_down")


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, law) of every weight the forward reads.  The laws
    are `h100_bench.weights`'s."""
    d, dh, V = cfg["hidden_size"], cfg["head_dim"], common.padded_vocab(cfg)
    hq, hkv, ff = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["intermediate_size"]
    out = [("embed", (V, d), "embed")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), "norm"),
                (p + "attn.wq", (d, hq * dh), "matmul"),
                (p + "attn.wk", (d, hkv * dh), "matmul"),
                (p + "attn.wv", (d, hkv * dh), "matmul"),
                (p + "attn.wo", (hq * dh, d), "matmul"),
                (p + "ln2", (d,), "norm"),
                (p + "ffn.w_gate", (d, ff), "matmul"),
                (p + "ffn.w_up", (d, ff), "matmul"),
                (p + "ffn.w_down", (ff, d), "matmul")]
    return out + [("final_norm", (d,), "norm"), ("lm_head", (d, V), "head")]


def layer(cfg: Dict, i: int, weights: common.Weights, mm: common.Float32):
    """Layer i as a function of h (T, d)."""
    p = f"layers.{i}."
    lw = common.layer_weights(weights, p, ATTN + FFN + ("ln1", "ln2"),
                              ATTN + FFN, mm)
    eps = cfg["rms_norm_eps"]

    def run(h: torch.Tensor) -> torch.Tensor:
        h = h + common.attention(cfg, lw, common.rmsnorm(lw["ln1"], h, eps),
                                 0, mm)
        return h + common.ffn(lw, common.rmsnorm(lw["ln2"], h, eps), mm)
    return run


def logits(cfg: Dict, weights: common.Weights, seqs,
           mm: common.Float32 = common.Float32()) -> List[torch.Tensor]:
    """`common.forward` of this family."""
    return common.forward(cfg, weights, seqs, layer, mm)
