"""Plain float32 forward of the Granite 4.0-H family (`model_type`
granitemoehybrid, such as granite-4.0-h-small):

    x = embedding_multiplier · embed(tokens)
    each layer:  x += residual_multiplier · mixer(rmsnorm(x))
                 h = rmsnorm(x)
                 x += residual_multiplier · (moe(h) + shared(h))
    logits = rmsnorm(x) · embedᵀ / logits_scaling         (a tied head)

The mixer is the layer's `layer_types` entry:

  mamba      a Mamba-2 mixer: in_proj → [z | xBC | dt], a causal
             depthwise conv of `mamba_d_conv` taps with its bias over
             xBC, then silu; dt = softplus(dt + dt_bias), A = −exp(A_log);
             per head the recurrence h_t = exp(A·dt_t)·h_{t−1} +
             dt_t·B_t ⊗ x_t, y_t = C_t·h_t + D·x_t, evaluated in its
             quadratic form over blocks of `BLOCK` positions with the state
             carried from block to block; y · silu(z) through the gated
             RMSNorm over the whole inner width (one group), out_proj
  attention  causal grouped-query attention with no positional encoding
             (`position_embedding_type` "nope") at the softmax scale
             `attention_multiplier`, no biases

The MoE: a router's top `num_experts_per_tok` of `num_local_experts`
logits, the gates a softmax over the chosen logits, SwiGLU experts of
`intermediate_size`, every pair kept; the shared MLP a SwiGLU of
`shared_intermediate_size`, ungated.  RMSNorm takes the (1 + scale)
convention and `rms_norm_eps`, the gated norm too.  Left padding is
token 0, which runs through every layer, the recurrence included, as the
served engine does.  With `follow` the router's top-k of layer i is
`follow.topk(i, ...)`.  It imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference import common

BLOCK = 64                 # positions a block of the recurrence's scan
ATTN = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
MAMBA = ("ssm.in_proj", "ssm.out_proj")
MAMBA_SMALL = ("ssm.conv_w", "ssm.conv_b", "ssm.A_log", "ssm.D",
               "ssm.dt_bias", "ssm.gate_norm")
EXPERTS = ("moe.router", "moe.w_gate", "moe.w_up", "moe.w_down")
SHARED = ("w_gate", "w_up", "w_down")      # under "moe.shared."


def mamba_dims(cfg: Dict) -> Tuple[int, int, int, int, int]:
    """(inner width, heads, head width, groups, state width)."""
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    return H * P, H, P, cfg["mamba_n_groups"], cfg["mamba_d_state"]


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, law) of every weight the forward reads.  The laws
    are `h100_bench.weights`'s."""
    d, V = cfg["hidden_size"], common.padded_vocab(cfg)
    dh = cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E, f = cfg["num_local_experts"], cfg["intermediate_size"]
    fs = cfg["shared_intermediate_size"]
    di, H, _, G, N = mamba_dims(cfg)
    conv = di + 2 * G * N
    out = [("embed", (V, d), "embed")]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        out.append((p + "ln1", (d,), "norm"))
        if kind == "mamba":
            out += [(p + "ssm.in_proj", (d, 2 * di + 2 * G * N + H), "matmul"),
                    (p + "ssm.conv_w", (cfg["mamba_d_conv"], conv), "conv_w"),
                    (p + "ssm.conv_b", (conv,), "small"),
                    (p + "ssm.A_log", (H,), "A_log"),
                    (p + "ssm.D", (H,), "D"),
                    (p + "ssm.dt_bias", (H,), "dt_bias"),
                    (p + "ssm.gate_norm", (di,), "norm"),
                    (p + "ssm.out_proj", (di, d), "matmul")]
        else:
            out += [(p + "attn.wq", (d, hq * dh), "matmul"),
                    (p + "attn.wk", (d, hkv * dh), "matmul"),
                    (p + "attn.wv", (d, hkv * dh), "matmul"),
                    (p + "attn.wo", (hq * dh, d), "matmul")]
        out += [(p + "ln2", (d,), "norm"),
                (p + "moe.router", (d, E), "matmul"),
                (p + "moe.w_gate", (E, d, f), "matmul"),
                (p + "moe.w_up", (E, d, f), "matmul"),
                (p + "moe.w_down", (E, f, d), "matmul"),
                (p + "moe.shared.w_gate", (d, fs), "matmul"),
                (p + "moe.shared.w_up", (d, fs), "matmul"),
                (p + "moe.shared.w_down", (fs, d), "matmul")]
    return out + [("final_norm", (d,), "norm")]


def scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         B: torch.Tensor, C: torch.Tensor, block: int = BLOCK
         ) -> torch.Tensor:
    """y_t = C_t · h_t of the recurrence h_t = exp(A·dt_t)·h_{t−1} +
    dt_t·B_t ⊗ x_t from h = 0, for x (T, H, P), dt (T, H), A (H,), B and
    C (T, G, N), heads in G equal groups: within a block of positions
    the sum over its earlier positions in closed form, the state of the
    blocks before it carried in."""
    T, H, P = x.shape
    G, N = B.shape[1:]
    group = torch.arange(H, device=x.device) // (H // G)
    Bh, Ch = B[:, group], C[:, group]                       # (T, H, N)
    h = x.new_zeros(H, N, P)
    y = torch.empty_like(x)
    for a in range(0, T, block):
        b = min(a + block, T)
        l = b - a
        cs = torch.cumsum(A * dt[a:b], dim=0)               # (l, H)
        # decay from position s to t of the block, t ≥ s
        diff = cs.t()[:, :, None] - cs.t()[:, None, :]      # (H, t, s)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
        cb = torch.einsum("thn,shn->hts", Ch[a:b], Bh[a:b])
        w = decay * cb * dt[a:b].t()[:, None, :]            # (H, t, s)
        xb = x[a:b].transpose(0, 1)                         # (H, l, P)
        inner = torch.bmm(w, xb)
        carried = torch.einsum("thn,hnp->htp", Ch[a:b], h) * \
            torch.exp(cs).t()[:, :, None]
        y[a:b] = (inner + carried).transpose(0, 1)
        last = torch.exp(cs[-1][None, :] - cs)              # (l, H)
        h = h * torch.exp(cs[-1])[:, None, None] + torch.einsum(
            "sh,shn,shp->hnp", last * dt[a:b], Bh[a:b], x[a:b])
    return y


def mamba(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
          mm: common.Float32) -> torch.Tensor:
    """The Mamba-2 mixer of one sequence h (T, d)."""
    T = h.shape[0]
    di, H, P, G, N = mamba_dims(cfg)
    z, xbc, dt = torch.split(mm(h, lw["in_proj"]), [di, di + 2 * G * N, H],
                             dim=-1)
    K = lw["conv_w"].shape[0]
    xbc = F.conv1d(xbc.t()[None], lw["conv_w"].t()[:, None, :],
                   lw["conv_b"], padding=K - 1, groups=xbc.shape[1])
    xbc = F.silu(xbc[0, :, :T].t())
    xs, B, C = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + lw["dt_bias"])
    A = -torch.exp(lw["A_log"])
    x = xs.reshape(T, H, P)
    y = scan(x, dt, A, B.reshape(T, G, N), C.reshape(T, G, N))
    y = (y + lw["D"][:, None] * x).reshape(T, di)
    y = common.rmsnorm(lw["gate_norm"], y * F.silu(z), cfg["rms_norm_eps"])
    return mm(y, lw["out_proj"])


def attention(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
              mm: common.Float32, block: int = 512) -> torch.Tensor:
    """Causal grouped-query attention of one sequence h (T, d) with no
    positional encoding, every position attended (pads included), at
    the scale `attention_multiplier`; queries in blocks of `block`."""
    T = h.shape[0]
    hq, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    G = hq // hkv
    q = mm(h, lw["wq"]).reshape(T, hq, dh).transpose(0, 1) * \
        cfg["attention_multiplier"]
    k = mm(h, lw["wk"]).reshape(T, hkv, dh).repeat_interleave(G, 1) \
        .transpose(0, 1)
    v = mm(h, lw["wv"]).reshape(T, hkv, dh).repeat_interleave(G, 1) \
        .transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, T, block):
        b = min(a + block, T)
        s = q[:, a:b] @ k[:, :b].transpose(1, 2)              # (Hq, bq, b)
        rows = torch.arange(a, b, device=h.device)[:, None]
        keep = torch.arange(b, device=h.device)[None, :] <= rows
        s = torch.where(keep, s, common.NEG_INF)
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
    return mm(out.transpose(0, 1).reshape(T, hq * dh), lw["wo"])


def moe(cfg: Dict, i: int, lw: Dict[str, torch.Tensor],
        sw: Dict[str, torch.Tensor], h: torch.Tensor, mm: common.Float32,
        follow: Optional[common.Follow]) -> torch.Tensor:
    """The routed experts, every pair kept, and the ungated shared MLP."""
    k = cfg["num_experts_per_tok"]
    scores = mm(h, lw["router"])                               # (T, E)
    idx = common.topk(scores, k) if follow is None else \
        follow.topk(i, scores, k)
    gates = torch.softmax(scores.gather(1, idx), dim=-1)
    y = torch.zeros_like(h)
    for e in range(scores.shape[1]):
        tok, j = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            x = h[tok]
            out = mm(F.silu(mm(x, lw["w_gate"][e])) * mm(x, lw["w_up"][e]),
                     lw["w_down"][e])
            y.index_add_(0, tok, out * gates[tok, j, None])
    return y + common.ffn(sw, h, mm)


def layer(cfg: Dict, i: int, weights: common.Weights, mm: common.Float32,
          follow: Optional[common.Follow]):
    """Layer i as a function of h (T, d), its weights in float32."""
    p = f"layers.{i}."
    mixer = MAMBA if cfg["layer_types"][i] == "mamba" else ATTN
    small = MAMBA_SMALL if mixer == MAMBA else ()
    lw = common.layer_weights(weights, p, mixer + small + ("ln1", "ln2"),
                              mixer, mm)
    mw = common.layer_weights(weights, p, EXPERTS, EXPERTS, mm)
    sw = common.layer_weights(weights, p + "moe.shared.", SHARED, SHARED, mm)
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]

    def run(h: torch.Tensor) -> torch.Tensor:
        a = common.rmsnorm(lw["ln1"], h, eps)
        a = mamba(cfg, lw, a, mm) if mixer == MAMBA else \
            attention(cfg, lw, a, mm)
        h = h + r * a
        return h + r * moe(cfg, i, mw, sw,
                           common.rmsnorm(lw["ln2"], h, eps), mm, follow)
    return run


def logits(cfg: Dict, weights: common.Weights, seqs,
           mm: common.Float32 = common.Float32(),
           follow: Optional[common.Follow] = None) -> List[torch.Tensor]:
    """float32 logits (n, vocab_size) at each sequence's asked positions,
    layer by layer over all sequences."""
    V = cfg["vocab_size"]
    hs = [weights["embed"][t].float() * cfg["embedding_multiplier"]
          for t, _ in seqs]
    for i in range(cfg["num_hidden_layers"]):
        fn = layer(cfg, i, weights, mm, follow)
        hs = [fn(h) for h in hs]
        del fn
    head = mm.weight(weights["embed"][:V].t())
    eps = cfg["rms_norm_eps"]
    return [mm(common.rmsnorm(weights["final_norm"], h[p], eps), head) /
            cfg["logits_scaling"] for h, (_, p) in zip(hs, seqs)]
