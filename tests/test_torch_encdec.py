"""The port's encoder-decoder (reduced seamless-m4t-large-v2) against the
reference's, on the CPU in one process, from the same seeded weights: the
training forward, loss and gradients (`RunConfig(kernels="xla")` in both
packages), the serving steps (the reference's with its Pallas kernels in
interpret mode, as `tests/test_torch_serve.py` runs them), one train
step, and the serving engine's refusal.

The reference's encoder-decoder calls `ffn_forward` without a compute
dtype, whose default is bfloat16, so its FFNs round to bf16 in a float32
run (its decoder-only blocks pass the run's dtype).  The port computes
them in the run's dtype, as its blocks do.  So every comparison here runs
the reference with that default set to float32 (`ffn_in_run_dtype`), and
`test_the_references_ffn_rounds_to_bf16_in_fp32` measures the quirk.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.models import encdec as j_encdec
from repro.models.encdec import (encdec_forward as j_forward,
                                 encdec_loss as j_loss, init_encdec,
                                 init_encdec_cache as j_init_cache)
from repro.optim import cosine_schedule as j_cosine
from repro.serve.serve_step import (make_decode_step as j_make_decode,
                                    make_prefill_step as j_make_prefill)
from repro.train.train_step import (init_train_state as j_init_state,
                                    make_train_step as j_make_train_step)
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import (LM, EncDec, encdec_forward,
                                encdec_from_numpy, encdec_loss,
                                init_encdec_cache)
from repro_torch.serve import (ServeEngine, make_decode_step,
                               make_prefill_step)
from repro_torch.train import make_train_step
from repro_torch.train.train_step import train_state

ARCH = "seamless-m4t-large-v2"
RCFG = RunConfig(kernels="xla", dtype="float32", remat=False,
                 learning_rate=1e-3)
J_RCFG = JRunConfig(kernels="xla", dtype="float32", remat=False,
                    learning_rate=1e-3)
J_SERVE = JRunConfig(kernels="pallas", dtype="float32", remat=False)
LOGITS_TOL = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
B, S_ENC, S = 2, 24, 12
DECODE_STEPS, MAX_LEN = 8, 16


def seeded_encdec(jcfg, seed):
    """`init_encdec`'s tree with every leaf redrawn from a seeded numpy
    stream at the reference initializer's scale (σ 0.02 for the
    embedding and the head, 1/sqrt(fan_in) for a kernel; the norm scales,
    0 at init, drawn at σ 0.1 so that they matter).  `init_encdec` salts
    its keys with Python's `hash()`; these weights are the same in every
    process."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        a = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return jnp.asarray((rng.standard_normal(a.shape) * 0.1)
                               .astype(a.dtype))
        std = 0.02 if "embed" in name or "lm_head" in name else \
            1.0 / np.sqrt(a.shape[-2])
        w = np.clip(rng.standard_normal(a.shape), -2.0, 2.0) * std
        return jnp.asarray(w.astype(a.dtype))

    return jax.tree_util.tree_map_with_path(
        redraw, init_encdec(jax.random.PRNGKey(seed), jcfg))


J_FFN = j_encdec.ffn_forward


@pytest.fixture(autouse=True)
def ffn_in_run_dtype(monkeypatch):
    """The reference's encoder-decoder FFNs in float32, the dtype of
    every reference run here (see the module docstring)."""
    monkeypatch.setattr(j_encdec, "ffn_forward",
                        functools.partial(J_FFN, compute_dtype=jnp.float32))


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced(j_get(ARCH))
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg)})
    params = seeded_encdec(jcfg, 0)
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(1)
    batch = {"frames": rng.standard_normal((B, S_ENC, jcfg.d_model))
             .astype(np.float32),
             "tokens": rng.integers(0, jcfg.vocab_size, (B, S))
             .astype(np.int32)}
    return jcfg, cfg, params, tree, batch


def rel_err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(np.max(np.abs(want)), 1e-30))


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_model(cfg, tree):
    model = encdec_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, tree),
                              device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


def test_config_is_the_references():
    from repro_torch.configs import get
    cfg, jcfg = get(ARCH), j_get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.encoder.n_layers, cfg.encoder.subsample) == (24, 4)


def test_the_references_ffn_rounds_to_bf16_in_fp32(setup, monkeypatch):
    """The quirk the other tests set aside: the reference's float32
    forward with its bf16 FFNs is off its float32 FFNs' by over 1e-3 of
    max|logit| (6e-3 at this seed); the port is within LOGITS_TOL of the
    latter."""
    jcfg, cfg, params, tree, batch = setup
    args = (params, jnp.asarray(batch["frames"]),
            jnp.asarray(batch["tokens"]), jcfg, J_RCFG)
    fp32 = np.asarray(j_forward(*args))
    monkeypatch.setattr(j_encdec, "ffn_forward", J_FFN)
    bf16 = np.asarray(j_forward(*args))
    V = cfg.vocab_size
    assert rel_err(bf16[..., :V], fp32[..., :V]) > 1e-3
    got = encdec_forward(encdec_from_numpy(cfg, tree, device="cpu"),
                         *tb(batch).values(), RCFG)
    assert rel_err(got[..., :V], fp32[..., :V]) < LOGITS_TOL


def test_encdec_forward_matches_the_reference(setup):
    jcfg, cfg, params, tree, batch = setup
    want = j_forward(params, jnp.asarray(batch["frames"]),
                     jnp.asarray(batch["tokens"]), jcfg, J_RCFG)
    model = encdec_from_numpy(cfg, tree, device="cpu")
    got = encdec_forward(model, *tb(batch).values(), RCFG)
    V = cfg.vocab_size
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got[..., :V], np.asarray(want)[..., :V]) < LOGITS_TOL


def test_encdec_loss_and_gradients_match_the_reference(setup):
    jcfg, cfg, params, tree, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (wl, wm), wg = jax.value_and_grad(
        lambda p: j_loss(p, jb, jcfg, J_RCFG), has_aux=True)(params)
    model = encdec_from_numpy(cfg, tree, device="cpu")
    loss, m = encdec_loss(model, tb(batch), RCFG)
    loss.backward()
    assert rel_err(loss, wl) < LOSS_TOL
    assert float(m["aux_loss"]) == float(wm["aux_loss"]) == 0.0
    want = as_model(cfg, wg)
    worst = {n: rel_err(p.grad, want[n].numpy())
             for n, p in model.named_parameters()}
    assert max(worst.values()) < GRAD_TOL, max(worst.items(),
                                               key=lambda kv: kv[1])


def test_prepare_cross_and_decode_steps_match_the_reference(setup):
    """`make_prefill_step` (frames → every layer's cross K/V) and
    DECODE_STEPS `make_decode_step` calls over a MAX_LEN cache, fed the
    same seeded tokens, in both packages: the cross K/V and each step's
    logits within LOGITS_TOL, and the self-attention caches too."""
    jcfg, cfg, params, tree, batch = setup
    model = encdec_from_numpy(cfg, tree, device="cpu")
    frames = batch["frames"]
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32)

    jcross = j_make_prefill(jcfg, J_SERVE)(params, jnp.asarray(frames),
                                           None)
    cross = make_prefill_step(model)(torch.from_numpy(frames))
    for got, want in zip(cross, jcross):
        assert got.shape == want.shape
        assert rel_err(got, want) < LOGITS_TOL

    jstep, step = j_make_decode(jcfg, J_SERVE), make_decode_step(model)
    jcache = j_init_cache(B, MAX_LEN, jcfg, dtype=jnp.float32)
    cache = init_encdec_cache(B, MAX_LEN, cfg, dtype=torch.float32,
                              device="cpu")
    for pos in range(DECODE_STEPS):
        t = toks[:, pos:pos + 1]
        want, jcache = jstep(params, jcache, jcross, jnp.asarray(t),
                             jnp.int32(pos))
        got, cache = step(cache, cross, torch.from_numpy(t), pos)
        V = cfg.vocab_size
        assert rel_err(got[:, :V], np.asarray(want)[:, :V]) < LOGITS_TOL, \
            pos
    for name in ("k", "v"):
        assert rel_err(cache[name], jcache[name]) < LOGITS_TOL


def test_one_train_step_matches_the_reference(setup):
    """One `make_train_step` step of the audio family from the same
    weights: loss, grad norm, lr and the parameters, held as
    `tests/test_torch_train.py` holds them."""
    jcfg, cfg, params, tree, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = j_init_state(jax.random.PRNGKey(0), jcfg)
    jstate["params"] = params
    _, g0 = jax.value_and_grad(
        lambda p: j_loss(p, jb, jcfg, J_RCFG), has_aux=True)(params)
    jstate, jm = jax.jit(j_make_train_step(jcfg, J_RCFG))(jstate, jb)
    state = train_state(encdec_from_numpy(cfg, tree, device="cpu"))
    state, m = make_train_step(cfg, RCFG)(state, tb(batch))
    assert rel_err(m["loss"], jm["loss"]) < LOSS_TOL
    assert rel_err(m["grad_norm"], jm["grad_norm"]) < 1e-4
    lr = float(m["lr"])
    assert np.float32(lr) == np.float32(j_cosine(
        0, peak_lr=1e-3, warmup_steps=100, total_steps=10_000))
    want, grads = as_model(cfg, jstate["params"]), as_model(cfg, g0)
    for name, p in state["params"].named_parameters():
        diff = (p.detach() - want[name]).abs()
        g = grads[name].abs()
        big = g > 1e-4 * g.max()
        # and one rounding of the weight itself: 1e-3 of one step's lr
        # is below a weight's ulp
        ulp = torch.finfo(torch.float32).eps * want[name].abs()
        assert bool((diff <= 1e-3 * lr + ulp)[big].all()), name
        assert float(diff.max()) <= 2 * lr, name


def test_remat_gives_the_same_gradients(setup):
    jcfg, cfg, params, tree, batch = setup
    grads = []
    for remat in (False, True):
        model = encdec_from_numpy(cfg, tree, device="cpu")
        loss, _ = encdec_loss(model, tb(batch),
                              dataclasses.replace(RCFG, remat=remat))
        loss.backward()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_serving_engine_refuses_the_audio_family(setup):
    """The reference's `ServeEngine` would call the audio prefill without
    its frames; the port's refuses the model and names the steps that
    serve it."""
    jcfg, cfg, params, tree, batch = setup
    model = encdec_from_numpy(cfg, tree, device="cpu")
    with pytest.raises(ValueError, match="make_prefill_step"):
        ServeEngine(model)
    with pytest.raises(NotImplementedError, match="EncDec"):
        LM(cfg, RunConfig(dtype="float32"), device="cpu")


def test_seeded_init_follows_the_reference_law(setup):
    jcfg, cfg, params, tree, batch = setup
    a = EncDec(cfg, RunConfig(dtype="float32"), seed=3, device="cpu")
    b = EncDec(cfg, RunConfig(dtype="float32"), seed=3, device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    std = {"embed": 0.02, "lm_head": 0.02,
           "dec_layers.0.cross_attn.wo": 1 / np.sqrt(cfg.d_model),
           "enc_layers.1.ffn.w_down": 1 / np.sqrt(cfg.d_ff)}
    params_a = dict(a.named_parameters())
    for name, s in std.items():
        w = params_a[name].detach()
        assert float(w.abs().max()) <= 2 * s + 1e-7, name
        assert abs(float(w.std()) / s - 0.88) < 0.05, name   # ±2σ cut
    assert not params_a["enc_norm"].any()


def test_converter_refuses_a_missing_leaf(setup):
    jcfg, cfg, params, tree, batch = setup
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["dec_layers"]["ln_cross"]
    with pytest.raises(ValueError, match="ln_cross"):
        encdec_from_numpy(cfg, bad, device="cpu")
