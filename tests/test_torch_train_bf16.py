"""bf16 training over fp32 master weights, the port against the
reference, on the CPU in one process: `RunConfig()`, the reference's
default (bf16 compute, remat on), on reduced gemma2-2b, mamba2-1.3b,
qwen2-moe-a2.7b and seamless-m4t-large-v2.  Both packages start from the
same fp32 weights (the port's through `convert.py` with fp32 storage,
copied without rounding): the loss, every gradient and three AdamW steps
agree at the bf16 tolerance, rel 2e-2.  Also the port's own contract:
fp32 leaves whatever the compute dtype, remat and a replayed fault bit
for bit in bf16, and a model built with other numerics refused."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.models import lm_loss as j_lm_loss
from repro.models.encdec import encdec_loss as j_encdec_loss
from repro.train.train_step import (init_train_state as j_init_state,
                                    make_train_step as j_make_train_step)
from repro_torch.configs import get
from repro_torch.configs.base import ArchConfig, RunConfig, reduced
from repro_torch.dist.fault import FaultConfig, FaultInjector
from repro_torch.models import encdec_from_numpy, lm_from_numpy
from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                               make_train_step)
from repro_torch.train.train_step import loss_fn_for, train_state
from test_torch_encdec import seeded_encdec
from test_torch_serve import seeded_params

ARCHS = ("gemma2-2b", "mamba2-1.3b", "qwen2-moe-a2.7b",
         "seamless-m4t-large-v2")
RCFG = RunConfig(learning_rate=1e-3)
J_RCFG = JRunConfig(learning_rate=1e-3)
TOL = 2e-2          # bf16 compute, relative to the largest |value|
B, S, S_ENC = 2, 40, 24


def rel_err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(np.max(np.abs(want)), 1e-30))


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def build(cfg, tree, rcfg=RCFG):
    """The port's model holding `tree`'s fp32 weights in fp32."""
    conv = encdec_from_numpy if cfg.family == "audio" else lm_from_numpy
    return conv(cfg, jax.tree_util.tree_map(np.asarray, tree), rcfg,
                device="cpu", param_dtype=torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = j_reduced(j_get(arch))
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(7)
    if jcfg.family == "audio":
        params = seeded_encdec(jcfg, 0)
        batch = {"frames": rng.standard_normal((B, S_ENC, jcfg.d_model))
                 .astype(np.float32),
                 "tokens": rng.integers(0, jcfg.vocab_size, (B, S))
                 .astype(np.int32)}
    else:
        params = seeded_params(jcfg, 0)
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S))
                 .astype(np.int32)}
    return arch, jcfg, cfg, params, batch


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def j_loss_fn(jcfg):
    return j_encdec_loss if jcfg.family == "audio" else j_lm_loss


def as_named(cfg, tree):
    """A reference-layout tree (params or gradients) by port name."""
    return {n: p.detach() for n, p in build(cfg, tree).named_parameters()}


def test_the_leaves_are_fp32_and_the_compute_bf16(setup):
    arch, jcfg, cfg, params, batch = setup
    state = init_train_state(0, cfg, RCFG, device="cpu", init=False)
    model = state["params"]
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {t.dtype for t in state["opt"]["mu"].values()} == {torch.float32}
    # the reference's state is fp32 too
    jstate = jax.eval_shape(lambda: j_init_state(jax.random.PRNGKey(0),
                                                 jcfg))
    assert {a.dtype for a in jax.tree_util.tree_leaves(
        jstate["params"])} == {jnp.dtype(jnp.float32)}


def norm_err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def runs(setup):
    """The reference's loss and gradients in bf16 and in fp32 and three
    of its jitted bf16 steps; the port's loss and gradients, and three of
    its steps, from the same fp32 weights on the same batch."""
    arch, jcfg, cfg, params, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_grads(rcfg):
        return jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(jcfg)(p, jb, jcfg, rcfg), has_aux=True))(
                params)

    (wl, wm), wg = j_grads(J_RCFG)
    _, wg32 = j_grads(dataclasses.replace(J_RCFG, dtype="float32"))

    def j_steps(rcfg):
        jstep = jax.jit(j_make_train_step(jcfg, rcfg))
        jstate = j_init_state(jax.random.PRNGKey(0), jcfg)
        jstate["params"] = params
        jms = []
        for _ in range(3):
            jstate, jm = jstep(jstate, jb)
            jms.append(jm)
        return jstate, jms

    jstate, jms = j_steps(J_RCFG)
    jstate32, _ = j_steps(dataclasses.replace(J_RCFG, dtype="float32"))

    model = build(cfg, params)
    loss, m = loss_fn_for(cfg)(model, tb(batch), RCFG)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    state = train_state(build(cfg, params))
    step = make_train_step(cfg, RCFG)
    ms = []
    for _ in range(3):
        state, sm = step(state, tb(batch))
        ms.append(sm)
    return dict(loss=(loss, m, wl, wm), grads=grads,
                want=as_named(cfg, wg), want32=as_named(cfg, wg32),
                steps=(ms, jms), state=state,
                jparams=as_named(cfg, jstate["params"]),
                jparams32=as_named(cfg, jstate32["params"]))


def test_loss_and_gradients_match_the_reference(runs):
    """The bf16 loss at 2e-2 of the reference's bf16 loss, the whole
    gradient (every leaf, fp32) within 2e-2 in norm, and each leaf within
    2e-2 in norm or, where the reference's own bf16 gradient is further
    than 1e-2 from its fp32 one (the bf16 noise of a bias or a router,
    whose terms cancel), within twice that distance."""
    loss, m, wl, wm = runs["loss"]
    assert loss.dtype == torch.float32
    assert rel_err(loss, wl) < TOL
    assert rel_err(m["loss"], wm["loss"]) < TOL
    want, want32 = runs["want"], runs["want32"]
    got_all, want_all, worst = [], [], {}
    for name, g in runs["grads"].items():
        assert g.dtype == torch.float32, name
        w = want[name].numpy()
        if not np.any(w):
            assert not g.any(), name
            continue
        got_all.append(g.numpy().ravel())
        want_all.append(w.ravel())
        noise = norm_err(w, want32[name])
        worst[name] = norm_err(g, w) / max(TOL, 2 * noise)
    assert norm_err(np.concatenate(got_all), np.concatenate(want_all)) < TOL
    assert max(worst.values()) < 1.0, max(worst.items(),
                                          key=lambda kv: kv[1])


def test_three_train_steps_match_the_reference(runs):
    """Three `make_train_step(cfg, RunConfig())` steps from the same
    state on the same batch: loss and grad norm per step at 2e-2.  Adam
    moves a weight by about lr times the sign of its gradient, so a
    weight whose first gradient is over a tenth of its leaf's largest
    must move as the reference's does: within 2e-2 of Σlr and one fp32
    ulp of the weight, or, in a leaf where the reference's own bf16 steps
    move such weights further than 1e-2·Σlr from its fp32 steps (the
    bf16 noise of an encoder or a router), within twice that.  A smaller
    gradient's sign may differ between two bf16 runs, so every weight is
    held within 2·Σlr."""
    ms, jms = runs["steps"]
    for i, (m, jm) in enumerate(zip(ms, jms)):
        assert rel_err(m["loss"], jm["loss"]) < TOL, i
        assert rel_err(m["grad_norm"], jm["grad_norm"]) < TOL, i
    lr = sum(float(m["lr"]) for m in ms)
    want, want32, g0 = runs["jparams"], runs["jparams32"], runs["want"]
    for name, p in runs["state"]["params"].named_parameters():
        assert p.dtype == torch.float32, name
        diff = (p.detach() - want[name]).abs()
        g = g0[name].abs()
        big = g > 0.1 * g.max()
        noise = float((want[name] - want32[name]).abs()[big].max()) / lr
        ulp = torch.finfo(torch.float32).eps * want[name].abs()
        allowed = max(TOL, 2 * noise) * lr
        assert bool((diff <= allowed + ulp)[big].all()), (name, noise)
        assert float(diff.max()) <= 2 * lr, name


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b",
                                  "qwen2-moe-a2.7b"])
def test_remat_recomputes_the_same_casts(arch):
    """bf16 over fp32 leaves with `remat` on and off: the same loss and
    gradients, bit for bit."""
    cfg = reduced(get(arch), n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=1, d_ff=128, vocab=128)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 128, (2, 32)).astype(np.int32))
    grads = []
    for remat in (False, True):
        rcfg = dataclasses.replace(RCFG, remat=remat)
        model = init_train_state(0, cfg, rcfg, device="cpu")["params"]
        loss, _ = loss_fn_for(cfg)(model, {"tokens": tokens}, rcfg)
        loss.backward()
        grads.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_a_replayed_fault_is_exact_in_bf16():
    """The trainer's replay verb under bf16 compute: the same history and
    fp32 weights as a run without the fault, bit for bit."""
    cfg = reduced(get("gemma2-2b"), n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=1, d_ff=128, vocab=128)
    rcfg = dataclasses.replace(RCFG, remat=False)

    def run(injector):
        tr = Trainer(cfg, rcfg, TrainerConfig(
            total_steps=4, seed=0, fault=FaultConfig(policy="replay")),
            seq_len=32, global_batch=4, injector=injector, device="cpu")
        return tr, tr.run()

    tf, sf = run(FaultInjector(fail_steps=[2], kind="step"))
    tc, sc = run(None)
    assert tf.stats.replays == 1 and tf.history == tc.history
    pf, pc = dict(sf["params"].named_parameters()), \
        dict(sc["params"].named_parameters())
    assert all(torch.equal(pf[n], pc[n]) for n in pf)
    assert {p.dtype for p in pf.values()} == {torch.float32}


def test_a_model_built_with_other_numerics_is_refused():
    """The model reads its compute dtype and SSD knobs when it is built;
    a step whose RunConfig says otherwise raises."""
    cfg = reduced(get("mamba2-1.3b"), n_layers=1, d_model=64, vocab=128)
    batch = {"tokens": torch.zeros((1, 32), dtype=torch.int32)}
    for other in (dict(dtype="float32"), dict(ssd_chunk=64),
                  dict(ssd_compute_dtype="bfloat16")):
        state = init_train_state(0, cfg, RCFG, device="cpu")
        with pytest.raises(ValueError, match="build it with"):
            make_train_step(cfg, dataclasses.replace(RCFG, **other))(
                state, batch)
