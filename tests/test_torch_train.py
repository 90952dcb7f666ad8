"""The port's training path against the reference's, on the CPU in one
process: the pipeline, the trainer's fault verbs (every case of
`tests/test_train_fault.py`, run against the port), and on reduced
gemma2-2b, mamba2-1.3b, qwen2-moe-a2.7b (its aux loss) and internvl2-26b
(its patch mask) the training forward, the loss, its gradients and three
train steps from the same weights, with `RunConfig(kernels="xla",
dtype="float32", remat=False)` in both packages, as the reference's
launcher trains."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.data import SyntheticLMSource as JSource
from repro.models import lm_forward as j_lm_forward, lm_loss as j_lm_loss
from repro.optim import cosine_schedule as j_cosine
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get
from repro_torch.configs.base import ArchConfig, RunConfig, reduced
from repro_torch.data import SyntheticLMSource, make_pipeline
from repro_torch.dist.fault import FaultConfig, FaultInjector
from repro_torch.models import lm_forward, lm_from_numpy, lm_loss
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                               make_train_step)
from repro_torch.train.train_step import train_state
from test_torch_serve import seeded_params

RCFG = RunConfig(kernels="xla", dtype="float32", remat=False,
                 learning_rate=1e-3)
J_RCFG = JRunConfig(kernels="xla", dtype="float32", remat=False,
                    learning_rate=1e-3)

LOGITS_TOL = 2e-5      # fp32 forward, relative to max|logit|
GRAD_TOL = 1e-4        # each leaf's gradient, relative to its max|g|
LOSS_TOL = 1e-5
GNORM_TOL = 1e-4


def small_trainer(tmp_path=None, steps=6, injector=None, policy="replay",
                  arch="gemma2-2b", seed=0):
    cfg = reduced(get(arch), n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=1, d_ff=128, vocab=128)
    tcfg = TrainerConfig(
        total_steps=steps, checkpoint_every=2,
        checkpoint_dir=str(tmp_path) if tmp_path else None,
        seed=seed, fault=FaultConfig(policy=policy))
    return Trainer(cfg, RCFG, tcfg, seq_len=32, global_batch=4,
                   injector=injector, device="cpu")


def params_equal(a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    return all(torch.equal(pa[n], pb[n]) for n in pa)


def seeded_tokens(B, S, vocab, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32))


# --------------------------------------------------------------------------
# tests/test_train_fault.py, against the port
# --------------------------------------------------------------------------

class TestPipeline:
    def test_deterministic_and_seekable(self):
        src = SyntheticLMSource(1000, 16, 4, seed=3)
        b1 = src.batch(5)
        b2 = src.batch(5)
        assert np.array_equal(b1["tokens"], b2["tokens"])
        pf = make_pipeline(1000, 16, 4, seed=3)
        for _ in range(3):
            step, batch = next(pf)
        pf.seek(2)
        step2, batch2 = next(pf)
        assert step2 == 2 and step == 2
        assert np.array_equal(batch["tokens"], batch2["tokens"])

    def test_prefetch_lookahead(self):
        pf = make_pipeline(100, 8, 2, start_step=10)
        assert len(pf._queue) == pf.lookahead
        step, _ = next(pf)
        assert step == 10

    @pytest.mark.parametrize("vocab,seq,batch,seed,step", [
        (1000, 16, 4, 3, 5), (128, 32, 4, 0, 0), (256_000, 512, 4, 0, 4),
        (50_280, 7, 3, 11, 1_000_003)])
    def test_batches_equal_the_reference(self, vocab, seq, batch, seed,
                                         step):
        got = SyntheticLMSource(vocab, seq, batch, seed).batch(step)
        want = JSource(vocab, seq, batch, seed).batch(step)
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        assert np.array_equal(got["tokens"], want["tokens"])
        assert SyntheticLMSource(vocab, seq, batch, seed).descriptor() \
            .dims[0].reps == batch


class TestOptim:
    def test_adamw_reduces_toy_loss(self):
        w = {"w": torch.tensor([2.0, -3.0])}
        st = adamw_init(w)

        def loss(p):
            return torch.sum(p["w"] ** 2)

        for _ in range(50):
            x = w["w"].detach().requires_grad_()
            loss({"w": x}).backward()
            adamw_update({"w": x.grad}, st, w, lr=0.1, weight_decay=0.0)
        assert float(loss(w)) < 0.2

    def test_grad_clip(self):
        w = {"w": torch.ones(4)}
        st = adamw_init(w)
        g = {"w": torch.full((4,), 100.0)}
        _, _, m = adamw_update(g, st, w, lr=0.1, grad_clip=1.0)
        assert float(m["grad_norm"]) == pytest.approx(200.0)


class TestTrainerFaults:
    def test_loss_decreases_on_fixed_batch(self):
        """Overfit one batch: the loss must drop."""
        cfg = reduced(get("gemma2-2b"), n_layers=2, d_model=64, n_heads=2,
                      n_kv_heads=1, d_ff=128, vocab=128)
        state = init_train_state(0, cfg, RCFG, device="cpu")
        step = make_train_step(cfg, RCFG, total_steps=40)
        batch = {"tokens": seeded_tokens(4, 32, 128)}
        first = None
        for _ in range(12):
            state, m = step(state, batch)
            first = first if first is not None else float(m["loss"])
        assert float(m["loss"]) < first - 0.2

    def test_replay_is_exact(self):
        """A replayed step produces the same state as a fault-free run."""
        inj = FaultInjector(fail_steps=[2], kind="step")
        tr_f = small_trainer(steps=4, injector=inj)
        s_f = tr_f.run()
        tr_c = small_trainer(steps=4)
        s_c = tr_c.run()
        assert tr_f.stats.replays == 1
        assert params_equal(s_f["params"], s_c["params"])
        assert tr_f.history == tr_c.history

    def test_continue_skips(self):
        inj = FaultInjector(fail_steps=[1], kind="step")
        tr = small_trainer(steps=4, injector=inj, policy="continue")
        tr.run()
        assert tr.stats.skipped == 1

    def test_abort_raises(self):
        from repro_torch.dist.fault import StepFault
        inj = FaultInjector(fail_steps=[1], kind="step")
        tr = small_trainer(steps=4, injector=inj, policy="abort")
        with pytest.raises(StepFault):
            tr.run()

    def test_node_failure_restores_from_checkpoint(self, tmp_path):
        inj = FaultInjector(fail_steps=[4], kind="node")
        tr = small_trainer(tmp_path, steps=6, injector=inj)
        state = tr.run()
        assert tr.stats.node_failures == 1
        assert int(state["step"]) == 6
        # restored the latest checkpoint, step 4's: steps 0-3, then 4-5
        assert len(tr.history) == 6
        # equal to an uninterrupted run, bit for bit: the restore is exact
        # and the replayed steps see the same batches
        tr2 = small_trainer(steps=6)
        s2 = tr2.run()
        assert params_equal(state["params"], s2["params"])
        for name in ("mu", "nu"):
            for n, t in state["opt"][name].items():
                assert torch.equal(t, s2["opt"][name][n]), (name, n)

    def test_restart_from_checkpoint_continues(self, tmp_path):
        tr = small_trainer(tmp_path, steps=4)
        tr.run()
        # "new process": fresh trainer picks up at step 4
        tr2 = small_trainer(tmp_path, steps=6)
        state = tr2.run()
        assert int(state["step"]) == 6


class TestMicrobatch:
    def test_grad_accumulation_matches_full_batch(self):
        cfg = reduced(get("internlm2-20b"), n_layers=2, d_model=64,
                      n_heads=2, n_kv_heads=1, d_ff=128, vocab=128)
        batch = {"tokens": seeded_tokens(4, 32, 128)}
        s1, m1 = make_train_step(cfg, RCFG)(
            init_train_state(0, cfg, RCFG, device="cpu"), batch)
        rc2 = dataclasses.replace(RCFG, microbatch=2)
        s2, m2 = make_train_step(cfg, rc2)(
            init_train_state(0, cfg, RCFG, device="cpu"), batch)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-5)
        p1, p2 = dict(s1["params"].named_parameters()), \
            dict(s2["params"].named_parameters())
        for n in p1:
            np.testing.assert_allclose(p1[n].detach().numpy(),
                                       p2[n].detach().numpy(),
                                       rtol=2e-4, atol=2e-6)


# --------------------------------------------------------------------------
# The port's training path against the reference's
# --------------------------------------------------------------------------

ARCHS = ("gemma2-2b", "mamba2-1.3b", "qwen2-moe-a2.7b", "internvl2-26b")
B, S = 2, 40     # S > internvl2's 16 reduced patches


def rel_err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(np.max(np.abs(want)), 1e-30))


def _setup(arch, seed=0):
    jcfg = j_reduced(j_get(arch))
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg)})
    params = seeded_params(jcfg, seed)
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed + 100)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S))
             .astype(np.int32)}
    if jcfg.vision is not None:
        batch["patch_embeds"] = rng.standard_normal(
            (B, jcfg.vision.n_patches, jcfg.vision.patch_embed_dim)) \
            .astype(np.float32)
    return jcfg, cfg, params, tree, batch


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    return (request.param,) + _setup(request.param)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_model(cfg, tree):
    """A reference-layout tree (params or gradients) as the port's module,
    whose named parameters are then comparable one by one."""
    model = lm_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, tree),
                          device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


def test_lm_forward_matches_the_reference(arch_setup):
    arch, jcfg, cfg, params, tree, batch = arch_setup
    want, waux = j_lm_forward(params, jnp.asarray(batch["tokens"]), jcfg,
                              J_RCFG,
                              patch_embeds=None if "patch_embeds" not in
                              batch else jnp.asarray(batch["patch_embeds"]))
    model = lm_from_numpy(cfg, tree, device="cpu")
    tb = torch_batch(batch)
    got, aux = lm_forward(model, tb["tokens"], RCFG,
                          patch_embeds=tb.get("patch_embeds"))
    V = cfg.vocab_size
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got[..., :V], np.asarray(want)[..., :V]) < LOGITS_TOL
    assert bool((got[..., V:] == -1e30).all())
    if cfg.moe is not None:
        assert float(waux) > 0
        assert rel_err(aux, waux) < LOSS_TOL
    else:
        assert float(aux) == float(waux) == 0.0


def test_lm_loss_and_gradients_match_the_reference(arch_setup):
    """The loss (its aux part and its token count) at LOSS_TOL, and each
    parameter's gradient within GRAD_TOL of its max|g|."""
    arch, jcfg, cfg, params, tree, batch = arch_setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (wl, wm), wg = jax.value_and_grad(
        lambda p: j_lm_loss(p, jb, jcfg, J_RCFG), has_aux=True)(params)
    model = lm_from_numpy(cfg, tree, device="cpu")
    loss, m = lm_loss(model, torch_batch(batch), RCFG)
    loss.backward()
    assert rel_err(loss, wl) < LOSS_TOL
    assert rel_err(m["loss"], wm["loss"]) < LOSS_TOL
    assert float(m["tokens"]) == float(wm["tokens"])
    if cfg.vision is not None:
        assert float(m["tokens"]) == B * (S - cfg.vision.n_patches)
    want = as_model(cfg, wg)
    worst = {}
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if not np.any(w):
            assert not p.grad.any(), name
            continue
        worst[name] = rel_err(p.grad, w)
    assert max(worst.values()) < GRAD_TOL, max(worst.items(),
                                               key=lambda kv: kv[1])


def test_three_train_steps_match_the_reference(arch_setup, capsys):
    """Three `make_train_step` steps from the same state on the same
    batch: loss, grad norm and lr per step at LOSS_TOL, GNORM_TOL and
    exactly (see the lr's comment).  Then the parameters: Adam moves a
    weight by about lr times the sign of its gradient, so a weight whose
    first gradient is not small (|g| > 1e-4 of its leaf's max) must agree
    within 1e-3 of Σlr and one fp32 ulp of the weight.  Below
    that, where |g| nears Adam's eps (1e-8), the update is about g/eps and
    carries g's fp32 error, about 1e-7 of the leaf's max|g| in either
    package: weights with |g| at 1e-6 to 1e-5 of the max differ by up to
    1e-2 of Σlr, and a sign may differ between two correct runs, so they
    are held within 2·Σlr.  The count of such weights is printed."""
    arch, jcfg, cfg, params, tree, batch = arch_setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(j_make_train_step(jcfg, J_RCFG))
    from repro.train.train_step import init_train_state as j_init_state
    jstate = j_init_state(jax.random.PRNGKey(0), jcfg)
    jstate["params"] = params
    _, g0 = jax.value_and_grad(
        lambda p: j_lm_loss(p, jb, jcfg, J_RCFG), has_aux=True)(params)

    state = train_state(lm_from_numpy(cfg, tree, device="cpu"))
    step = make_train_step(cfg, RCFG)
    tb = torch_batch(batch)
    lrs = []
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert rel_err(m["loss"], jm["loss"]) < LOSS_TOL, i
        assert rel_err(m["grad_norm"], jm["grad_norm"]) < GNORM_TOL, i
        # the reference's schedule exactly; its jitted step's lr within
        # 2 ulp: XLA's fp32 division by the warmup differs from IEEE's
        # (3.0000003e-05 for 3e-3 / 100 at step 2, where it is
        # 3.0000001e-05)
        assert np.float32(m["lr"]) == np.float32(j_cosine(
            i, peak_lr=1e-3, warmup_steps=100, total_steps=10_000)), i
        assert abs(float(m["lr"]) - float(jm["lr"])) <= \
            2 * float(np.spacing(np.float32(jm["lr"]))), i
        lrs.append(float(m["lr"]))
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert int(state["opt"]["count"]) == 3
    lr = sum(lrs)
    want, grads = as_model(cfg, jstate["params"]), as_model(cfg, g0)
    loose = total = 0
    for name, p in state["params"].named_parameters():
        diff = (p.detach() - want[name]).abs()
        g = grads[name].abs()
        big = g > 1e-4 * g.max()
        total += p.numel()
        loose += int((~big).sum())
        # and one rounding of the weight itself: 1e-3 of one step's lr
        # is below a weight's ulp
        ulp = torch.finfo(torch.float32).eps * want[name].abs()
        assert bool((diff <= 1e-3 * lr + ulp)[big].all()), name
        assert float(diff.max()) <= 2 * lr, name
    with capsys.disabled():
        print(f"\n[train] {arch}: {loose} of {total} weights with a first "
              f"gradient under 1e-4 of their leaf's max, held within 2·Σlr")


# --------------------------------------------------------------------------
# The port's own contract
# --------------------------------------------------------------------------

def _tiny(arch):
    return reduced(get(arch), n_layers=2, d_model=64, n_heads=2,
                   n_kv_heads=1, d_ff=128, vocab=128)


@pytest.mark.parametrize("arch,what", [("gemma2-2b", "flash attention"),
                                       ("mamba2-1.3b", "SSD")])
def test_pallas_kernels_under_autograd_raise(arch, what):
    """No kernel has a backward: a training forward that asks for the
    kernels with gradients on raises, and without them runs."""
    cfg = _tiny(arch)
    model = init_train_state(0, cfg, RCFG, device="cpu")["params"]
    pallas = dataclasses.replace(RCFG, kernels="pallas")
    batch = {"tokens": seeded_tokens(2, 32, 128)}
    with pytest.raises(NotImplementedError, match=what):
        lm_loss(model, batch, pallas)
    with torch.no_grad():
        got, _ = lm_loss(model, batch, pallas)
        want, _ = lm_loss(model, batch, RCFG)
    assert rel_err(got, want) < LOSS_TOL
    with pytest.raises(ValueError, match="kernels"):
        lm_loss(model, batch, dataclasses.replace(RCFG, kernels="other"))


def test_bf16_training_raises():
    """bf16 training no longer raises: it keeps fp32 master weights
    (`tests/test_torch_train_bf16.py` holds it against the reference).
    A compute dtype neither package has still raises."""
    bf16 = dataclasses.replace(RCFG, dtype="bfloat16")
    state = init_train_state(0, _tiny("gemma2-2b"), bf16, device="cpu")
    assert {p.dtype for p in state["params"].parameters()} == \
        {torch.float32}
    make_train_step(_tiny("gemma2-2b"), bf16)
    fp16 = dataclasses.replace(RCFG, dtype="float16")
    with pytest.raises(ValueError, match="unknown compute dtype"):
        make_train_step(_tiny("gemma2-2b"), fp16)
    with pytest.raises(ValueError, match="unknown compute dtype"):
        init_train_state(0, _tiny("gemma2-2b"), fp16, device="cpu")


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b",
                                  "qwen2-moe-a2.7b"])
def test_remat_gives_the_same_gradients(arch):
    """`rcfg.remat` recomputes each layer in the backward: the same loss
    and gradients, bit for bit."""
    cfg = _tiny(arch)
    batch = {"tokens": seeded_tokens(2, 32, 128, seed=1)}
    grads = []
    for remat in (False, True):
        model = init_train_state(0, cfg, RCFG, device="cpu")["params"]
        loss, _ = lm_loss(model, batch,
                          dataclasses.replace(RCFG, remat=remat))
        loss.backward()
        grads.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_chunked_flash_matches_the_plain_attention():
    """Tiles smaller than the sequence (several q and k chunks, a ragged
    last one, causal, windowed and capped), forward and gradient, against
    `attention_ref`."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.attention import chunked_flash
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in ((2, 4, 37, 16), (2, 2, 37, 16),
                                           (2, 2, 37, 16)))
    for causal, window, cap in ((True, 0, 0.0), (True, 9, 0.0),
                                (False, 0, 5.0)):
        got = chunked_flash(q, k, v, causal, window, cap, 0.25, 8, 16)
        want = attention_ref(q, k, v, causal=causal, window=window,
                             softcap=cap, scale=0.25)
        assert rel_err(got, want.detach()) < 1e-6
        gg = torch.autograd.grad(got.square().sum(), (q, k, v))
        gw = torch.autograd.grad(want.square().sum(), (q, k, v))
        for a, b in zip(gg, gw):
            assert rel_err(a, b) < 1e-5


def test_trainer_cannot_train_the_audio_family():
    """As in the reference: the pipeline yields no frames, which
    `encdec_loss` reads."""
    cfg = reduced(get("seamless-m4t-large-v2"), n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab=64)
    tr = Trainer(cfg, RCFG, TrainerConfig(total_steps=1), seq_len=8,
                 global_batch=2, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        tr.run()
