"""The traffic files' draws repeat for a seed, and the yardstick's
operation, byte and model-flop counts match sums by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from h100_bench.tests import tiny
from h100_bench import traffic, yardstick
from h100_bench.families import dense

MIXES = sorted((tiny.HERE / "traffic").glob("*.json"))


def _draws(mix, seed):
    t = traffic.Traffic(mix, seed, 1000)
    return [[(r.prompt, r.max_new_tokens, r.temperature) for r in t.batch()]
            for _ in range(2)]


@pytest.mark.parametrize("path", MIXES, ids=[p.stem for p in MIXES])
def test_traffic_repeats_for_a_seed(path: Path):
    mix = json.loads(path.read_text())
    seed = 2**31 + 12345                  # larger than 32 signed bits hold
    a, b = _draws(mix, seed), _draws(mix, seed)
    assert a == b
    other = _draws(mix, seed + 1)
    assert other != a
    # another seed, the same work: lengths and hot rows in another order
    for x, y in zip(a, other):
        assert sorted(len(p) for p, _, _ in x) == \
            sorted(len(p) for p, _, _ in y)
        assert sorted(m for _, m, _ in x) == sorted(m for _, m, _ in y)
        assert sorted(t for _, _, t in x) == sorted(t for _, _, t in y)
        assert len(x) == mix["batch"]
        assert all(0 <= tok < 1000 for p, _, _ in x for tok in p)


def test_quantiles():
    assert traffic.quantiles(dict(law="uniform", low=16, high=48), 8) == \
        [18, 22, 26, 30, 34, 38, 42, 46]
    lo = traffic.quantiles(dict(law="loguniform", low=2048, high=4096), 8)
    assert lo[0] == round(2048 * 2 ** (1 / 16))
    assert lo[-1] == round(2048 * 2 ** (15 / 16))


@pytest.mark.parametrize("window,pairs", [(0, 36), (3, 21)])
def test_flash_work(window, pairs):
    """q (2, 4, 8, 16), k/v (2, 2, 8, 16), causal: 36 live pairs a head
    (1 + ... + 8), or 21 with a window of 3 (1 + 2 + 3 · 6)."""
    assert yardstick.flash_live_pairs(8, 8, True, window) == pairs
    call = dict(q=(2, 4, 8, 16), k=(2, 2, 8, 16), causal=True,
                window=window, elt=2)
    flops, nbytes = yardstick.flash_work(call)
    assert flops == 4 * 16 * pairs * 2 * 4
    assert nbytes == (2 * 2 * 4 * 8 * 16 + 2 * 2 * 2 * 8 * 16) * 2


@pytest.mark.parametrize("window,live", [(0, 30), (10, 10)])
def test_decode_attention_work(window, live):
    call = dict(q=(2, 4, 16), k=(2, 2, 50, 16), kv_len=30, window=window,
                elt=2)
    flops, nbytes = yardstick.decode_attn_work(call)
    assert flops == 4 * 2 * 4 * live * 16
    assert nbytes == (2 * 2 * 2 * live * 16 + 2 * 2 * 4 * 16) * 2


@pytest.mark.parametrize("shape,want", [
    ((1, 2, 4, 3, 1, 5), (672, 520)),
    ((2, 4, 8, 2, 2, 3), (2 * 4 * 8 * (5 * 3 * 2 + 3 * 2),
                          (2 * 2 * 4 * 8 * 2 + 2 * 2 * 2 * 8 * 3) * 4 +
                          4 * (2 * 4 * 8 + 2 * 4 + 2 * 4 * 3 * 2)))])
def test_ssd_work(shape, want):
    """Shapes (B, H, S, P, G, N), fp32."""
    B, H, S, P, G, N = shape
    call = dict(x=(B, H, S, P), B=(B, G, S, N), elt=4)
    assert yardstick.ssd_work(call) == want


def _dense(**kw):
    cfg = dict(family="dense", num_hidden_layers=1, hidden_size=4,
               num_attention_heads=2, num_key_value_heads=1, head_dim=2,
               intermediate_size=3, vocab_size=10, sliding_window=0)
    cfg.update(kw)
    return cfg


def test_model_flops():
    """One layer, d 4, 2 q / 1 kv heads of 2, d_ff 3, vocab 10: 84
    weights a token (16 + 16 + 16 + 36), 80 flops a logit row, 16 an
    attended key."""
    cfg = _dense()
    assert dense.matmul_params(cfg) == 84
    assert yardstick.prefill_flops(cfg, [3]) == 2 * 84 * 3 + 80 + 16 * 6
    assert yardstick.decode_flops(cfg, [3]) == 2 * 84 + 80 + 16 * 4
    # a window of 2 on every layer but one of two
    win = _dense(num_hidden_layers=2, sliding_window=2,
                 full_attention_layers=[0])
    assert yardstick.prefill_flops(win, [3]) == \
        2 * 2 * 84 * 3 + 80 + 16 * (6 + 5)
    for start in range(0, 9):
        for n in range(1, 9):
            assert yardstick._keys(n, start, 3) == sum(
                min(p + 1, 3) for p in range(start, start + n))


def test_bound():
    assert yardstick.bound(989e12, 1.0) == (1.0, "operations")
    assert yardstick.bound(1.0, 3.35e12) == (1.0, "bytes")
