"""The yardstick: the H100's peaks, the least time of a kernel call's work,
and the model flops a request needs.  Nothing here reads the program.

`bound`, `flash_live_pairs` and `ssd_flops_bytes` are frozen copies of
`chip_smoke.py`'s functions of the same names (the repository root), kept
here so that the yardstick does not move when the program does.  One
change: `bound` takes a single peak for every kernel, 989 TFLOP/s (the
dense bf16 tensor-core rate), where `chip_smoke.py` also took 67 TFLOP/s
for fp32 and 164.9 for 3xTF32.  A share of the highest peak is one that
no later kernel, on any route, can read above 100%.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, Tuple

from h100_bench import families

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, and HBM3
PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds of the work, what bounds it)."""
    t_ops = flops / PEAK_FLOPS
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


@functools.lru_cache(maxsize=None)
def flash_live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(row, col) pairs the mask keeps, for one head."""
    n = 0
    for r in range(Sq):
        hi = min(r, Sk - 1) if causal else Sk - 1
        lo = max(0, r - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def ssd_flops_bytes(B, H, G, S, P, N, elt):
    """The least work that gives y and the final state, by the recurrence
    h_t = exp(A·dt_t)·h_{t-1} + B_t ⊗ (dt_t·x_t), y_t = C_t·h_t + D·x_t:
    per step and head a multiply and a multiply-add for each of the N·P
    state elements, a multiply-add each for C·h, a multiply for dt·x and a
    multiply-add for D·x over P.  Each input read once and each output
    written once."""
    flops = B * H * S * (5 * N * P + 3 * P)
    nbytes = (2 * B * H * S * P + 2 * B * G * S * N) * elt + \
        4 * (B * H * S + 2 * H + B * H * N * P)
    return flops, nbytes


# ---------------------------------------------------------------------------
# A kernel call's work, from the shapes the op received
# ---------------------------------------------------------------------------

def flash_work(call: Dict) -> Tuple[float, float]:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D): 4·D flops a live pair and
    head; q, k and v read once and the output written once."""
    B, Hq, Sq, D = call["q"]
    _, Hkv, Sk, _ = call["k"]
    pairs = flash_live_pairs(Sq, Sk, call["causal"], call["window"])
    elt = call["elt"]
    flops = 4 * D * pairs * B * Hq
    nbytes = (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D) * elt
    return flops, nbytes


def decode_attn_work(call: Dict) -> Tuple[float, float]:
    """q (B, Hq, D) against the live keys of a (B, Hkv, S, D) cache:
    `kv_len` of them, the last `window` where it is set."""
    B, Hq, D = call["q"]
    _, Hkv, S, _ = call["k"]
    live = call["kv_len"]
    if call["window"] > 0:
        live = min(live, call["window"])
    elt = call["elt"]
    flops = 4 * B * Hq * live * D
    nbytes = (2 * B * Hkv * live * D + 2 * B * Hq * D) * elt
    return flops, nbytes


def ssd_work(call: Dict) -> Tuple[float, float]:
    """x (B, H, S, P), B/C (B, G, S, N)."""
    Bb, H, S, P = call["x"]
    G, N = call["B"][1], call["B"][3]
    return ssd_flops_bytes(Bb, H, G, S, P, N, call["elt"])


# ---------------------------------------------------------------------------
# Model flops from the configuration's shapes (the family module counts
# the weights a token goes through and the attention layers)
# ---------------------------------------------------------------------------


def _keys(n_tokens: int, start: int, window: int) -> int:
    """Keys the tokens at positions start .. start + n_tokens − 1 of one
    sequence attend (each its own and those before it, the last `window`
    of them where a window is set)."""
    first, last = start + 1, start + n_tokens     # keys of the first, last
    if window <= 0 or last <= window:
        return (first + last) * n_tokens // 2
    if first > window:
        return window * n_tokens
    return (first + window) * (window - first + 1) // 2 + \
        (last - window) * window


def token_flops(cfg: Dict, n_tokens: int, start: int, logits: int) -> float:
    """Model flops of `n_tokens` useful tokens of one sequence at positions
    start.. of its own tokens (pads are no part of it), `logits` of which
    are unembedded: 2 a weight of each product, 4·D·Hq an attended key."""
    family = families.of(cfg)
    d, dh, hq = cfg["hidden_size"], cfg["head_dim"], \
        cfg["num_attention_heads"]
    flops = 2 * family.matmul_params(cfg) * n_tokens
    flops += 2 * d * cfg["vocab_size"] * logits
    full, windowed = family.attention_layers(cfg)
    per_key = 4 * dh * hq
    flops += per_key * full * _keys(n_tokens, start, 0)
    if windowed:
        flops += per_key * windowed * _keys(n_tokens, start,
                                            cfg["sliding_window"])
    return flops


def prefill_flops(cfg: Dict, prompt_lens: Iterable[int]) -> float:
    """A batch prefill: each prompt's own tokens, one unembedded row."""
    return sum(token_flops(cfg, n, 0, 1) for n in prompt_lens)


def decode_flops(cfg: Dict, contexts: Iterable[int]) -> float:
    """A decode step: one token each for the rows still serving, whose
    own tokens before it number `contexts`."""
    return sum(token_flops(cfg, 1, c, 1) for c in contexts)
