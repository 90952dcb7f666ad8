"""The slices end to end on the CPU: the port's `ServeEngine` and JAX's
`ServeEngine` (Pallas kernels in interpret mode, float32) answer the same
requests on reduced gemma2, reduced mamba2, reduced hymba (two hybrid
layers, untied head), reduced qwen2.5-32b (qkv bias, RoPE theta 1e6) and
reduced chatglm3-6b (qkv bias, RoPE on half the head) with the same
weights.

Greedy token streams must be equal.  Each step's top-2 logit margin is
asserted to exceed the two frameworks' logit disagreement (1e-4 of
max|logit|) many times over, so a near-tie cannot flip a token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.models import init_lm
from repro.serve import Request as JRequest, ServeEngine as JServeEngine
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm_from_numpy
from repro_torch.serve import Request, ServeEngine, greedy_sample, \
    temperature_sample

MAX_LEN = 128
# 90 and 70 exceed the reduced window of 64, so the local layer masks
PROMPT_LENS = (90, 70, 40, 12)
NEW_TOKENS = 8


class RecordingEngine(ServeEngine):
    """Keeps the logits of every sampling step."""

    def generate(self, requests):
        self.seen = []
        return super().generate(requests)

    def _sample(self, logits, requests, gens):
        self.seen.append(logits.clone())
        return super()._sample(logits, requests, gens)


def seeded_params(jcfg, seed):
    """`init_lm`'s tree with every leaf redrawn from a seeded numpy
    stream at the reference initializer's scale (truncated normal at
    ±2σ; σ 0.02 for the embedding, 1/sqrt(fan_in) for a kernel or the SSM
    conv; norm scales and the conv bias stay 0; the SSM's A_log and D are
    deterministic and stay, its dt_bias is redrawn by `init_ssm`'s
    log-uniform law; the qkv biases, 0 at init, are drawn at σ 0.5 so
    that they matter).  `init_lm` salts its keys with Python's `hash()`,
    which differs between processes; these weights do not, so the token
    streams and their top-2 margins are the same in every run."""
    rng = np.random.default_rng(seed)
    sc = jcfg.ssm

    def redraw(path, leaf):
        a = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']") and "['attn']" in name:
            return jnp.asarray((rng.standard_normal(a.shape) * 0.5)
                               .astype(a.dtype))
        if not np.any(a) or "A_log" in name or "['D']" in name:
            return leaf
        if "dt_bias" in name:
            lo, hi = np.log(sc.dt_min), np.log(sc.dt_max)
            dt = np.exp(rng.uniform(size=a.shape) * (hi - lo) + lo)
            return jnp.asarray((dt + np.log(-np.expm1(-dt))).astype(a.dtype))
        std = 0.02 if "embed" in name else 1.0 / np.sqrt(a.shape[-2])
        w = np.clip(rng.standard_normal(a.shape), -2.0, 2.0) * std
        return jnp.asarray(w.astype(a.dtype))

    return jax.tree_util.tree_map_with_path(
        redraw, init_lm(jax.random.PRNGKey(seed), jcfg))


def _setup(arch, seed):
    jcfg = j_reduced(j_get(arch))
    params = seeded_params(jcfg, seed)
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg)})
    model = lm_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)]
               for n in PROMPT_LENS]
    j_engine = JServeEngine(
        jcfg, JRunConfig(kernels="pallas", dtype="float32", remat=False),
        params, max_len=MAX_LEN)
    j_out = [r.output for r in j_engine.generate(
        [JRequest(prompt=list(p), max_new_tokens=NEW_TOKENS)
         for p in prompts])]
    return model, prompts, j_out


@pytest.fixture(scope="module")
def setup():
    return _setup("gemma2-2b", 0)


@pytest.fixture(scope="module")
def mamba2_setup():
    """Seed 1: its smallest top-2 margin is 68x the disagreement bound."""
    return _setup("mamba2-1.3b", 1)


@pytest.fixture(scope="module")
def hymba_setup():
    """Seed 0: its smallest top-2 margin is 47x the disagreement bound."""
    return _setup("hymba-1.5b", 0)


@pytest.fixture(scope="module")
def qwen_setup():
    """Seed 1: its smallest top-2 margin is 110x the disagreement bound."""
    return _setup("qwen2.5-32b", 1)


@pytest.fixture(scope="module")
def chatglm_setup():
    """Seed 1: its smallest top-2 margin is 64x the disagreement bound."""
    return _setup("chatglm3-6b", 1)


@pytest.mark.parametrize("which", ["setup", "mamba2_setup", "hymba_setup",
                                   "qwen_setup", "chatglm_setup"])
def test_greedy_streams_equal_jax(request, which):
    model, prompts, j_out = request.getfixturevalue(which)
    engine = RecordingEngine(model, max_len=MAX_LEN)
    out = [r.output for r in engine.generate(
        [Request(prompt=list(p), max_new_tokens=NEW_TOKENS)
         for p in prompts])]
    assert out == j_out
    assert len(engine.seen) == NEW_TOKENS
    for logits in engine.seen:
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > 10 * 1e-4 * float(logits.abs().max()), margin


def test_greedy_row_unchanged_by_hot_neighbour(setup):
    model, prompts, _ = setup
    engine = ServeEngine(model, max_len=MAX_LEN, seed=5)
    pure = engine.generate([Request(prompt=list(prompts[0]),
                                    max_new_tokens=6)])
    mixed = engine.generate([
        Request(prompt=list(prompts[0]), max_new_tokens=6),
        Request(prompt=list(prompts[0]), max_new_tokens=6,
                temperature=1.3)])
    assert mixed[0].output == pure[0].output
    assert len(mixed[1].output) == 6
    again = engine.generate([
        Request(prompt=list(prompts[0]), max_new_tokens=6),
        Request(prompt=list(prompts[0]), max_new_tokens=6,
                temperature=1.3)])
    # row 1's stream goes on from the first call, as the reference's key
    assert again[1].output != mixed[1].output
    assert again[0].output == pure[0].output


def _hot(prompt, n=8, temperature=1.0):
    return Request(prompt=list(prompt), max_new_tokens=n,
                   temperature=temperature)


def test_repeated_calls_draw_new_streams(setup):
    """The same hot request, sent three times to one engine, gets three
    different streams (the draws go on across calls)."""
    model, prompts, _ = setup
    engine = ServeEngine(model, max_len=MAX_LEN, seed=3)
    outs = [engine.generate([_hot(prompts[1])])[0].output for _ in range(3)]
    assert all(len(o) == 8 for o in outs)
    assert outs[0] != outs[1] and outs[1] != outs[2] and outs[0] != outs[2]


def test_fresh_engine_with_the_same_seed_repeats_its_calls(setup):
    """Two engines of one seed give the same first call and the same
    second call; another seed gives another stream."""
    model, prompts, _ = setup

    def two_calls(seed):
        engine = ServeEngine(model, max_len=MAX_LEN, seed=seed)
        return [[r.output for r in engine.generate(
            [_hot(prompts[2]), _hot(prompts[3], temperature=0.7)])]
            for _ in range(2)]

    first = two_calls(7)
    assert two_calls(7) == first
    assert first[0] != first[1]
    assert two_calls(8)[0] != first[0]


def test_greedy_row_unchanged_by_hot_neighbours_across_calls(setup):
    """A greedy row between two hot rows (one prompt for all three, so no
    row is padded) equals the same request served alone, on the first
    call and on the next, while its neighbours' streams move on."""
    model, prompts, _ = setup
    alone = ServeEngine(model, max_len=MAX_LEN).generate(
        [Request(prompt=list(prompts[1]), max_new_tokens=8)])[0].output
    engine = ServeEngine(model, max_len=MAX_LEN, seed=11)
    calls = [engine.generate([_hot(prompts[1], temperature=1.5),
                              Request(prompt=list(prompts[1]),
                                      max_new_tokens=8),
                              _hot(prompts[1], temperature=0.9)])
             for _ in range(2)]
    for out in calls:
        assert out[1].output == alone
    assert calls[0][0].output != calls[1][0].output


def test_stop_tokens_end_generation_early(setup):
    model, prompts, _ = setup
    engine = ServeEngine(model, max_len=MAX_LEN)
    full = engine.generate([Request(prompt=list(prompts[2]),
                                    max_new_tokens=8)])[0]
    stop = full.output[2]
    stopped = engine.generate([Request(prompt=list(prompts[2]),
                                       max_new_tokens=8,
                                       stop_tokens=(stop,))])[0]
    assert stopped.finished
    first = full.output.index(stop)
    assert stopped.output == full.output[:first + 1]


def test_decode_past_max_len_raises(setup):
    model, prompts, _ = setup
    engine = ServeEngine(model, max_len=len(prompts[3]) + 2)
    with pytest.raises(IndexError):
        engine.generate([Request(prompt=list(prompts[3]),
                                 max_new_tokens=5)])
    with pytest.raises(ValueError):
        ServeEngine(model, max_len=8).generate(
            [Request(prompt=list(prompts[3]), max_new_tokens=2)])


def test_sampling():
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    assert int(greedy_sample(logits)[0]) == 1
    gen = torch.Generator().manual_seed(0)
    assert int(temperature_sample(gen, logits, temperature=1e-6)[0]) == 1
    assert int(temperature_sample(gen, logits, temperature=0.0)[0]) == 1
