"""The mixture-of-experts slice (qwen2-moe-a2.7b, mixtral-8x7b): the port
against the JAX package on the CPU.

Each config reduced (2 layers, d 128; qwen2-moe: 4 experts top-2 with one
shared expert, mixtral: 4 experts top-2 and a 64-row window), in float32,
with weights redrawn from a seeded numpy stream (`seeded_params`: the
router at σ 1/sqrt(d), so that routing is far from uniform).  `reduced`
sets capacity factor 8, which never drops a pair at these sizes, so every
comparison that matters for the drop path also runs at the real factor
1.25 on inputs that overflow an expert (rows repeated as left padding
repeats them) and asserts that pairs were dropped.  The JAX side runs its
Pallas kernels in interpret mode.

Error is relative to max|reference|: 2e-5 in float32, 2e-2 in bfloat16.
Routing, slots and the dispatch buffer are compared exactly.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.core.vm import expert_gather_batch as j_expert_gather_batch
from repro.models import lm_decode_step as j_lm_decode
from repro.models import lm_prefill as j_lm_prefill
from repro.models import moe as j_moe
from repro.models.common import dense as j_dense
from repro.serve import Request as JRequest, ServeEngine as JServeEngine
from repro_torch.configs import get
from repro_torch.configs.base import ATTN_FULL, ATTN_SWA, ArchConfig, \
    RunConfig, reduced
from repro_torch.core.vm import expert_gather_on_engine
from repro_torch.models import LM, lm_decode_step, lm_from_numpy, lm_prefill
from repro_torch.models import moe as t_moe
from repro_torch.serve import Request
from test_torch_serve import RecordingEngine, seeded_params

RCFG = JRunConfig(kernels="pallas", dtype="float32", remat=False)
BF16 = JRunConfig(kernels="pallas", dtype="bfloat16", remat=False)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")
# (params, padded vocab, experts, top-k, shared experts, kind) of the full
# configs
FULL = {"qwen2-moe-a2.7b": (14_315_784_192, 151_936, 60, 4, 4, ATTN_FULL),
        "mixtral-8x7b": (46_702_792_704, 32_000, 8, 2, 0, ATTN_SWA)}
B, S, MAX_LEN, STEPS = 2, 90, 128, 4
CAPACITY = (8.0, 1.25)


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def with_capacity(jcfg, factor):
    return dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=factor))


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-6))


def _build(arch, factor=8.0, seed=0):
    """(jcfg, JAX params, numpy tree, float32 port LM) at `factor`."""
    jcfg = with_capacity(j_reduced(j_get(arch)), factor)
    params = seeded_params(jcfg, seed)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, tree, lm_from_numpy(port_cfg(jcfg), tree,
                                             device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def moe_lm(request):
    return _build(request.param)


def _layer_moe(params, tree, model, layer=0):
    jp = jax.tree_util.tree_map(lambda a: a[layer],
                                params["segments"][0][0]["moe"])
    return jp, model.layers[layer].moe


def _tokens_x(d, T=120, pads=0, seed=7):
    """(T, d) float32 rows; the first `pads` all equal, as left padding's
    rows are once attention has averaged them."""
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)
    x[:pads] = x[0]
    return x


def _j_routing(jp, x2, mc):
    """The reference's routing (moe.py:83-86): top-k of the fp32 softmax
    of the router's product, ties to the lower index."""
    logits = j_dense(jp["router"], jnp.asarray(x2), jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1),
                           mc.top_k)
    return np.asarray(idx)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_the_reference(arch):
    cfg, jcfg = get(arch), j_get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(j_reduced(jcfg))
    n_params, vocab, E, k, shared, kind = FULL[arch]
    mc = cfg.moe
    assert (mc.n_experts, mc.top_k, mc.n_shared_experts) == (E, k, shared)
    assert (mc.capacity_factor, reduced(cfg).moe.capacity_factor) == \
        (1.25, 8.0)
    assert cfg.layer_kinds == (kind,) * cfg.n_layers
    assert cfg.padded_vocab == vocab and cfg.resolved_head_dim == 128
    model = LM(cfg, RunConfig(), device="meta", init=False)
    assert sum(p.numel() for p in model.parameters()) == n_params
    m = model.layers[0].moe
    assert m.w_gate.shape == (E, cfg.d_model, mc.d_ff_expert)
    assert m.w_down.shape == (E, mc.d_ff_expert, cfg.d_model)
    assert hasattr(m, "shared") == bool(shared)
    assert not hasattr(model.layers[0], "ffn")


@pytest.mark.parametrize("factor", CAPACITY)
def test_dispatch_compute_matches_the_reference(moe_lm, factor):
    """y, aux, dropped and the routing of one layer's routed experts,
    over 120 tokens, 100 of them one repeated row: at factor 1.25 they
    overflow their experts and pairs are dropped."""
    jcfg, params, tree, model = moe_lm
    mc = dataclasses.replace(jcfg.moe, capacity_factor=factor)
    jp, tp = _layer_moe(params, tree, model)
    x = _tokens_x(jcfg.d_model, pads=100)
    y, aux, dropped = j_moe.moe_dispatch_compute(
        jp, jnp.asarray(x), mc, jcfg.act, jnp.float32)
    with torch.no_grad():
        ty, taux, tdropped = t_moe.moe_dispatch_compute(
            tp, torch.from_numpy(x), mc, jcfg.act)
        r = t_moe.route(tp.router, torch.from_numpy(x), mc)
    assert rel_err(ty, y) < TOL["float32"]
    assert abs(float(taux) - float(aux)) <= TOL["float32"] * abs(float(aux))
    assert float(tdropped) == pytest.approx(float(dropped), abs=1e-7)
    assert (float(tdropped) > 0) == (factor < 2)
    idx = _j_routing(jp, x, mc)
    assert np.array_equal(r.expert_idx.numpy(), idx)
    # the kept pairs, in expert order, against the reference's gather
    batch = j_expert_gather_batch(np.arange(len(x)), idx, mc.n_experts,
                                  r.capacity, 1, 0)
    keep = r.keep.numpy()
    assert np.array_equal(r.t_s.numpy()[keep], batch.src_addr)
    assert np.array_equal(r.slot.numpy()[keep], batch.dst_addr)
    assert np.all(r.slot.numpy()[~keep] == mc.n_experts * r.capacity)


def test_moe_forward_with_and_without_shared_experts(moe_lm):
    """`moe_forward` over (B, S, d): qwen2-moe adds its sigmoid-gated
    shared expert, mixtral has none; y and the weighted aux loss."""
    jcfg, params, tree, model = moe_lm
    jp, tp = _layer_moe(params, tree, model, layer=1)
    assert hasattr(tp, "shared") == bool(jcfg.moe.n_shared_experts)
    x = np.random.default_rng(8).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    y, aux = j_moe.moe_forward(jp, jnp.asarray(x), jcfg, RCFG)
    with torch.no_grad():
        ty, taux = t_moe.moe_forward(tp, torch.from_numpy(x),
                                     port_cfg(jcfg))
    assert ty.shape == (B, S, jcfg.d_model)
    assert rel_err(ty, y) < TOL["float32"]
    assert abs(float(taux) - float(aux)) <= TOL["float32"] * abs(float(aux))
    assert float(taux) > 0


@pytest.mark.parametrize("factor", CAPACITY)
def test_lm_prefill_and_decode(moe_lm, factor):
    """Prefill logits and every layer's k/v cache, then 4 decode steps'
    logits, each within 2e-5 of the reference."""
    arch = moe_lm[0].name
    jcfg, params, _, model = moe_lm if factor == 8.0 else \
        _build(arch, factor)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    want, jcaches = j_lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                 RCFG, max_len=MAX_LEN)
    got, caches = lm_prefill(model, torch.from_numpy(toks[:, :S]).long(),
                             max_len=MAX_LEN)
    assert rel_err(got, want) < TOL["float32"]
    for layer, c in enumerate(caches):
        for name in ("k", "v"):
            assert rel_err(c[name], jcaches[0][0][name][layer]) < \
                TOL["float32"], (layer, name)
    for step in range(STEPS):
        pos = S + step
        want, jcaches = j_lm_decode(params, jcaches,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos), jcfg, RCFG)
        got, caches = lm_decode_step(
            model, caches, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            pos)
        assert rel_err(got, want) < TOL["float32"], step


def _record_dropped(monkeypatch):
    """Each `moe_dispatch_compute` call's dropped fraction, in order."""
    seen = []
    inner = t_moe.moe_dispatch_compute

    def record(*args, **kw):
        out = inner(*args, **kw)
        seen.append(float(out[2]))
        return out
    monkeypatch.setattr(t_moe, "moe_dispatch_compute", record)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_left_padded_batch_at_the_real_capacity(arch, monkeypatch):
    """The serving engine's batch: a 90-token prompt beside a 12-token one
    left-padded with token 0.  At factor 1.25 the pad rows, all one
    vector, fill their experts and drop real tokens of the row behind
    them (a reference quirk the port matches); the logits still match
    the reference within 2e-5."""
    jcfg, params, _, model = _build(arch, 1.25, seed=1)
    rng = np.random.default_rng(9)
    toks = np.zeros((B, S), np.int32)
    toks[0] = rng.integers(1, jcfg.vocab_size, S)
    toks[1, S - 12:] = rng.integers(1, jcfg.vocab_size, 12)
    seen = _record_dropped(monkeypatch)
    want, jcaches = j_lm_prefill(params, jnp.asarray(toks), jcfg, RCFG,
                                 max_len=MAX_LEN)
    got, caches = lm_prefill(model, torch.from_numpy(toks).long(),
                             max_len=MAX_LEN)
    assert len(seen) == jcfg.n_layers and seen[0] > 0
    assert rel_err(got, want) < TOL["float32"]
    nxt = np.array(jnp.argmax(want, -1), np.int32)[:, None]
    want, _ = j_lm_decode(params, jcaches, jnp.asarray(nxt), jnp.int32(S),
                          jcfg, RCFG)
    got, _ = lm_decode_step(model, caches, torch.from_numpy(nxt).long(), S)
    assert rel_err(got, want) < TOL["float32"]


def test_a_rows_output_depends_on_its_neighbours_at_capacity():
    """A reference quirk the port matches: capacity is shared by the whole
    flattened batch and ranks go in flat token order, so at factor 1.25 a
    row's prefill depends on the rows beside it.  On reduced
    qwen2-moe-a2.7b (seeded_params seed 0), an S-token prompt alone and
    beside a 1-token prompt left-padded to S, for S = 2..9 drawn in turn
    from one stream: the smallest input that shows it is S = 9 (C 8 alone,
    16 beside); S = 2-8 show no change."""
    jcfg, params, _, model = _build("qwen2-moe-a2.7b", 1.25, seed=0)
    rng = np.random.default_rng(0)
    for S in range(2, 10):
        toks = np.zeros((2, S), np.int32)
        toks[0] = rng.integers(1, 512, S)
        toks[1, -1] = rng.integers(1, 512)
        got = {}
        for name, t in (("alone", toks[:1]), ("beside", toks)):
            want, _ = j_lm_prefill(params, jnp.asarray(t), jcfg, RCFG,
                                   max_len=S)
            got[name], _ = lm_prefill(model, torch.from_numpy(t).long(),
                                      max_len=S)
            assert rel_err(got[name], want) < TOL["float32"], (S, name)
        change = rel_err(got["beside"][:1], got["alone"])
        if S < 9:
            assert change < TOL["float32"], (S, change)
        else:
            assert change > 0.1, change


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_against_jax(arch):
    """The serving dtype in both packages, the same weights: the
    prefill's and 4 decode steps' logits within 2e-2."""
    jcfg, params, tree, _ = _build(arch, 1.25)
    model = lm_from_numpy(port_cfg(jcfg), tree,
                          rcfg=RunConfig(dtype="bfloat16"), device="cpu")
    assert model.layers[0].moe.w_gate.dtype == torch.bfloat16
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    want, jcaches = j_lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                 BF16, max_len=MAX_LEN)
    got, caches = lm_prefill(model, torch.from_numpy(toks[:, :S]).long(),
                             max_len=MAX_LEN)
    for step in range(STEPS + 1):
        assert rel_err(got, want) < TOL["bfloat16"], step
        if step == STEPS:
            break
        pos = S + step
        want, jcaches = j_lm_decode(params, jcaches,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos), jcfg, BF16)
        got, caches = lm_decode_step(
            model, caches, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            pos)


def _streams(arch, factor, seed):
    jcfg, params, _, model = _build(arch, factor, seed)
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)]
               for n in (90, 70, 40, 12)]
    j_engine = JServeEngine(jcfg, RCFG, params, max_len=MAX_LEN)
    j_out = [r.output for r in j_engine.generate(
        [JRequest(prompt=list(p), max_new_tokens=8) for p in prompts])]
    engine = RecordingEngine(model, max_len=MAX_LEN)
    out = [r.output for r in engine.generate(
        [Request(prompt=list(p), max_new_tokens=8) for p in prompts])]
    return out, j_out, engine.seen


@pytest.mark.parametrize("arch,factor", [("qwen2-moe-a2.7b", 8.0),
                                         ("qwen2-moe-a2.7b", 1.25),
                                         ("mixtral-8x7b", 1.25)])
def test_greedy_streams_equal_jax(arch, factor):
    """`ServeEngine.generate` of four left-padded prompts, 8 new tokens
    each: the greedy streams equal JAX's, each step's top-2 margin far
    above the two frameworks' disagreement (1e-4 of max|logit|)."""
    out, j_out, seen = _streams(arch, factor, seed=2)
    assert out == j_out
    for logits in seen:
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin > 10 * 1e-4 * float(logits.abs().max()), margin


@pytest.mark.parametrize("factor", CAPACITY)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_buffer_equals_the_engines_gather(moe_lm, factor, dtype):
    """The (E, C, d) buffer `moe_dispatch_compute` builds equals, byte for
    byte, the one the port's `IDMAEngine` fills over the same token bytes
    from `expert_gather_batch`'s descriptors at the capacity
    `moe_expert_gather` gives it (`expert_gather_on_engine`: the equality
    `expert_gather_batch` promises), and `moe_expert_gather`'s batch
    equals the reference's."""
    jcfg, _, _, model = moe_lm
    mc = dataclasses.replace(jcfg.moe, capacity_factor=factor)
    tp = model.layers[0].moe
    x = torch.from_numpy(_tokens_x(jcfg.d_model, pads=100)).to(dtype)
    built = []
    inner = t_moe.dispatch

    def record(x2, r, n):
        built.append((inner(x2, r, n), r))
        return built[-1][0]
    t_moe.dispatch = record
    try:
        with torch.no_grad():
            t_moe.moe_dispatch_compute(copy.deepcopy(tp).to(dtype), x, mc,
                                       jcfg.act)
    finally:
        t_moe.dispatch = inner
    (buf, r), = built
    assert (float(r.keep.float().mean()) < 1) == (factor < 2)
    rows = x.view(torch.uint8).numpy().reshape(len(x), -1)
    idx = r.expert_idx.numpy()
    assert r.capacity == t_moe._capacity(len(x), mc)
    got = expert_gather_on_engine(rows, idx, mc.n_experts, r.capacity)
    assert np.array_equal(got, buf.view(torch.uint8).numpy().reshape(
        got.shape))
    row = rows.shape[1]
    va = np.arange(len(x)) * row
    ours = t_moe.moe_expert_gather(va, idx, mc, row, 1 << 20)
    ref = j_moe.moe_expert_gather(va, idx, mc, row, 1 << 20)
    for col in ("src_addr", "dst_addr", "length"):
        assert np.array_equal(getattr(ours, col), getattr(ref, col))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_give_equal_bits(moe_lm, dtype):
    """No atomics in the combine: the same inputs twice give the same
    bits, at the real capacity with pairs dropped."""
    jcfg, _, _, model = moe_lm
    mc = dataclasses.replace(jcfg.moe, capacity_factor=1.25)
    tp = copy.deepcopy(model.layers[0].moe).to(dtype)
    x = torch.from_numpy(_tokens_x(jcfg.d_model, pads=100)).to(dtype)
    with torch.no_grad():
        a = t_moe.moe_dispatch_compute(tp, x, mc, jcfg.act)
        b = t_moe.moe_dispatch_compute(tp, x, mc, jcfg.act)
    assert float(a[2]) > 0
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_top_k_ties_go_to_the_lower_expert(moe_lm):
    """Equal router probabilities pick the lower expert ids, as
    `jax.lax.top_k` does: a router whose columns are pairwise equal."""
    jcfg, _, _, model = moe_lm
    mc = jcfg.moe
    d, E = jcfg.d_model, mc.n_experts
    rng = np.random.default_rng(13)
    cols = rng.standard_normal((d, E // 2)).astype(np.float32)
    router = np.repeat(cols, 2, axis=1)            # experts 2i, 2i+1 equal
    x = rng.standard_normal((40, d)).astype(np.float32)
    r = t_moe.route(torch.from_numpy(router), torch.from_numpy(x), mc)
    idx = _j_routing({"router": {"kernel": jnp.asarray(router)}}, x, mc)
    assert np.array_equal(r.expert_idx.numpy(), idx)
    top = r.expert_idx.numpy()[:, 0]
    assert np.all(top % 2 == 0)                     # the lower of each pair


def test_psum_axis_raises(moe_lm):
    """A reduction over a mesh dim with no mesh given or installed raises
    (`tests/test_torch_dist_mesh.py` runs it on four ranks)."""
    jcfg, _, _, model = moe_lm
    x = torch.zeros(8, jcfg.d_model)
    with pytest.raises(ValueError, match="needs a mesh"):
        t_moe.moe_dispatch_compute(model.layers[0].moe, x, jcfg.moe,
                                   jcfg.act, psum_axis="model")


def test_converter_places_the_moe_leaves(moe_lm):
    jcfg, _, tree, model = moe_lm
    ref = tree["segments"][0][0]["moe"]
    for layer in range(jcfg.n_layers):
        m = model.layers[layer].moe
        pairs = [(m.router, ref["router"]["kernel"]),
                 (m.w_gate, ref["w_gate"]), (m.w_up, ref["w_up"]),
                 (m.w_down, ref["w_down"])]
        if jcfg.moe.n_shared_experts:
            pairs += [(m.shared.w_gate, ref["shared"]["w_gate"]["kernel"]),
                      (m.shared.w_up, ref["shared"]["w_up"]["kernel"]),
                      (m.shared.w_down, ref["shared"]["w_down"]["kernel"]),
                      (m.shared_gate, ref["shared_gate"]["kernel"])]
        for got, want in pairs:
            assert np.array_equal(got.detach().numpy(), want[layer])


@pytest.mark.parametrize("edit", ["no router", "no shared_gate",
                                  "extra moe leaf"])
def test_converter_refuses_unplaced_moe_leaves(edit):
    jcfg = j_reduced(j_get("qwen2-moe-a2.7b"))
    tree = jax.tree_util.tree_map(np.asarray, seeded_params(jcfg, 0))
    moe = tree["segments"][0][0]["moe"]
    if edit == "no router":
        del moe["router"]
    elif edit == "no shared_gate":
        del moe["shared_gate"]
    else:
        moe["bias"] = np.zeros((2, jcfg.d_model), np.float32)
    with pytest.raises(ValueError):
        lm_from_numpy(port_cfg(jcfg), tree, device="cpu")


@torch.no_grad()
@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_follows_the_reference_law(arch):
    """`init_moe`'s law: the router and the shared gate at σ 0.02,
    w_gate / w_up at 1/sqrt(d), w_down at 1/sqrt(f), each truncated at
    ±2σ; one seed gives one model."""
    cfg = reduced(get(arch))
    a, b = (LM(cfg, RunConfig(dtype="float32"), seed=3, device="cpu")
            for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    m, mc = a.layers[0].moe, cfg.moe
    laws = [(m.router, 0.02), (m.w_gate, cfg.d_model ** -0.5),
            (m.w_up, cfg.d_model ** -0.5), (m.w_down, mc.d_ff_expert ** -0.5)]
    if mc.n_shared_experts:
        laws += [(m.shared_gate, 0.02),
                 (m.shared.w_down, mc.d_ff_shared ** -0.5)]
    for w, std in laws:
        assert float(w.abs().max()) <= 2 * std
        if w.numel() > 1000:
            assert abs(float(w.std()) / std - 0.88) < 0.05
