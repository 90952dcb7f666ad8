"""hymba-1.5b's hybrid layers and untied head: the port against the JAX
package on the CPU.

Reduced hymba-1.5b (2 layers: `hybrid_full` then `hybrid`, d 128, 4 q and
2 kv heads of 32, window 64, SSM d_state 32, 16 heads of 16, chunk 32,
untied head) and a variant at hymba's own GQA group 5 and d_state 16 with
20 SSM heads (not a multiple of the SSD kernel's 8-head blocks), weights
from `repro.models.init_lm` carried over by `lm_from_numpy`.  The JAX side
runs its Pallas kernels in interpret mode (`RunConfig(kernels="pallas")`).

Error is relative to max|reference|: 2e-5 in float32, for one block and
for the whole LM alike (two hybrid layers), 2e-2 in bfloat16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.models import blocks as j_blocks
from repro.models import init_lm, lm_decode_step as j_lm_decode
from repro.models import lm_forward as j_lm_forward
from repro.models import lm_prefill as j_lm_prefill
from repro_torch.configs import get
from repro_torch.configs.base import (ArchConfig, HYBRID, HYBRID_FULL,
                                      RunConfig, reduced)
from repro_torch.models import LM, lm_decode_step, lm_from_numpy, lm_prefill
from repro_torch.models import blocks as t_blocks
from repro_torch.models import lm as t_lm
from repro_torch.models.common import rmsnorm
from repro_torch.models.ssm import ssm_dims

RCFG = JRunConfig(kernels="pallas", dtype="float32", remat=False)
BF16 = JRunConfig(kernels="pallas", dtype="bfloat16", remat=False)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S, MAX_LEN, STEPS = 2, 90, 128, 4   # S > window 64, S % chunk 32 != 0


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-6))


def _build(jcfg, seed):
    params = init_lm(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, tree, lm_from_numpy(port_cfg(jcfg), tree,
                                             device="cpu")


@pytest.fixture(scope="module")
def hymba_lm():
    return _build(j_reduced(j_get("hymba-1.5b")), 0)


@pytest.fixture(scope="module")
def hymba_dims_lm():
    """GQA group 5 (5 q heads on 1 kv head) and d_state 16 as in
    hymba-1.5b; d_inner 320 in 20 SSM heads of 16."""
    jcfg = j_reduced(j_get("hymba-1.5b"), d_model=160, n_heads=5,
                     n_kv_heads=1)
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             d_state=16))
    return _build(jcfg, 1)


def _tokens(jcfg, seed=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)


def test_full_config_matches_the_reference():
    cfg, jcfg = get("hymba-1.5b"), j_get("hymba-1.5b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    kinds = cfg.layer_kinds
    assert len(kinds) == 32
    assert [i for i, k in enumerate(kinds) if k == HYBRID_FULL] == \
        [0, 15, 31]
    assert kinds.count(HYBRID) == 29
    assert (cfg.padded_vocab, cfg.tie_embeddings) == (32128, False)
    assert ssm_dims(cfg) == (3200, 50, 64, 1, 16)
    assert [t_blocks._window_for(k, cfg) for k in kinds[:2]] == [0, 1024]
    # about 1.6 B parameters, counted on the meta device
    model = LM(cfg, RunConfig(), device="meta", init=False)
    n = sum(p.numel() for p in model.parameters())
    assert 1.5e9 < n < 1.7e9, n
    assert model.lm_head.shape == (1600, 32128)


def test_reduced_config_keeps_both_hybrid_kinds(hymba_lm):
    jcfg = hymba_lm[0]
    cfg = port_cfg(jcfg)
    assert dataclasses.asdict(reduced(get("hymba-1.5b"))) == \
        dataclasses.asdict(jcfg)
    assert cfg.layer_kinds == (HYBRID_FULL, HYBRID)
    assert [t_blocks._window_for(k, cfg) for k in cfg.layer_kinds] == \
        [0, 64]
    names = {n.split(".", 2)[2].split(".")[0]
             for n, _ in hymba_lm[3].named_parameters()
             if n.startswith("layers")}
    assert names == {"ln1", "attn", "ssm", "attn_out_norm", "ssm_out_norm",
                     "ln2", "ffn"}


@pytest.mark.parametrize("layer", [0, 1])
def test_hybrid_block_forward_and_decode(hymba_lm, layer):
    """One hybrid block (full, then windowed) against the reference's:
    its output and cache (k, v, the SSM's conv tail and state) after a
    90-token forward, then 3 decode steps from that cache."""
    jcfg, params, _, model = hymba_lm
    cfg, kind = port_cfg(jcfg), port_cfg(jcfg).layer_kinds[layer]
    p = jax.tree_util.tree_map(lambda a: a[0], params["segments"][layer][0])
    x = np.random.default_rng(7).standard_normal(
        (B, S + 3, jcfg.d_model)).astype(np.float32)
    want, _, jcache = j_blocks.block_forward(
        p, jnp.asarray(x[:, :S]), jcfg, RCFG, kind,
        positions=jnp.arange(S), collect_cache=True)
    got, cache = t_blocks.block_forward(
        model.layers[layer], torch.from_numpy(x[:, :S]), cfg, kind,
        positions=torch.arange(S), collect_cache=True)
    assert sorted(cache) == ["conv", "k", "state", "v"]
    assert rel_err(got, want) < TOL["float32"]
    for name, ref in (("k", jcache["k"]), ("v", jcache["v"]),
                      ("conv", jcache["ssm"]["conv"]),
                      ("state", jcache["ssm"]["state"])):
        assert rel_err(cache[name], ref) < TOL["float32"], name
    pad = ((0, 0), (0, 0), (0, MAX_LEN - S), (0, 0))
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad),
                  v=jnp.pad(jcache["v"], pad))
    cache = dict(cache, k=torch.nn.functional.pad(cache["k"],
                                                  (0, 0, 0, MAX_LEN - S)),
                 v=torch.nn.functional.pad(cache["v"],
                                           (0, 0, 0, MAX_LEN - S)))
    for t in range(S, S + 3):
        want, jcache = j_blocks.block_decode_step(
            p, jnp.asarray(x[:, t:t + 1]), jcache, jnp.int32(t), jcfg,
            RCFG, kind)
        k = cache["k"]
        got, cache = t_blocks.block_decode_step(
            model.layers[layer], torch.from_numpy(x[:, t:t + 1]), cache, t,
            cfg, kind)
        assert cache["k"] is k                 # written in place
        assert rel_err(got, want) < TOL["float32"], t
        assert rel_err(cache["state"], jcache["ssm"]["state"]) < \
            TOL["float32"], t
        assert rel_err(cache["k"], jcache["k"]) < TOL["float32"], t


@pytest.mark.parametrize("which", ["hymba_lm", "hymba_dims_lm"])
def test_hybrid_lm_forward_prefill_and_decode(request, which):
    """Logits at every position of a 90-token prompt against
    `lm_forward`'s, the prefill's last-position logits and caches, then 4
    decode steps against `lm_decode_step`'s, each within 2e-5."""
    jcfg, params, _, model = request.getfixturevalue(which)
    cfg, toks = port_cfg(jcfg), _tokens(jcfg)
    prompt = torch.from_numpy(toks[:, :S]).long()
    want, _ = j_lm_forward(params, jnp.asarray(toks[:, :S]), jcfg, RCFG)
    with torch.no_grad():
        x = t_blocks.segments_forward(model.layers,
                                      t_lm._embed_in(model, prompt), cfg,
                                      positions=torch.arange(S))
        every = t_lm._logits(model, rmsnorm(model.final_norm, x))
    assert rel_err(every, want) < TOL["float32"]
    want, jcaches = j_lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                 RCFG, max_len=MAX_LEN)
    got, caches = lm_prefill(model, prompt, max_len=MAX_LEN)
    assert got.dtype == torch.float32 and \
        got.shape == (B, cfg.padded_vocab)
    assert bool((got[:, cfg.vocab_size:] == -1e30).all())
    assert rel_err(got, want) < TOL["float32"]
    for c in caches:
        assert c["k"].shape == (B, cfg.n_kv_heads, MAX_LEN,
                                cfg.resolved_head_dim)
        assert not torch.any(c["k"][:, :, S:])
        assert c["state"].shape == (B,) + ssm_dims(cfg)[1:2] + \
            (cfg.ssm.d_state, cfg.ssm.head_dim)
    for step in range(STEPS):
        pos = S + step
        want, jcaches = j_lm_decode(params, jcaches,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos), jcfg, RCFG)
        got, caches = lm_decode_step(
            model, caches, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            pos)
        assert rel_err(got, want) < TOL["float32"], step


def test_untied_head_in_bf16_against_jax(hymba_lm):
    """The serving dtype: the same weights in bf16 in both packages, the
    prefill's and 4 decode steps' logits within 2e-2 over the real vocab
    rows.  The untied head is a bf16 product, as the reference's `dense`,
    so every logit is a bf16 value upcast."""
    jcfg, params, tree, _ = hymba_lm
    cfg, toks = port_cfg(jcfg), _tokens(jcfg, seed=9)
    model = lm_from_numpy(cfg, tree, rcfg=RunConfig(dtype="bfloat16"),
                          device="cpu")
    assert model.lm_head.dtype == torch.bfloat16
    V = cfg.vocab_size
    want, jcaches = j_lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                 BF16, max_len=MAX_LEN)
    got, caches = lm_prefill(model, torch.from_numpy(toks[:, :S]).long(),
                             max_len=MAX_LEN)
    for step in range(STEPS + 1):
        assert got.dtype == torch.float32
        assert torch.equal(got[:, :V], got[:, :V].bfloat16().float())
        assert rel_err(got[:, :V], want[:, :V]) < TOL["bfloat16"], step
        if step == STEPS:
            break
        pos = S + step
        want, jcaches = j_lm_decode(params, jcaches,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos), jcfg, BF16)
        got, caches = lm_decode_step(
            model, caches, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            pos)


def test_untied_embedding_is_not_scaled(hymba_lm):
    """The reference scales the embedding by sqrt(d_model) only where the
    head is tied."""
    model = hymba_lm[3]
    tokens = torch.tensor([[1, 5, 9]])
    assert torch.equal(t_lm._embed_in(model, tokens), model.embed[tokens])
    tied = LM(dataclasses.replace(model.cfg, tie_embeddings=True),
              RunConfig(dtype="float32"), device="cpu")
    assert not hasattr(tied, "lm_head")
    assert torch.allclose(t_lm._embed_in(tied, tokens),
                          tied.embed[tokens] * np.sqrt(model.cfg.d_model))


def test_converter_places_every_hybrid_leaf(hymba_lm):
    jcfg, params, tree, model = hymba_lm
    assert np.array_equal(model.lm_head.detach().numpy(),
                          tree["lm_head"]["kernel"])
    for layer in range(2):
        seg = tree["segments"][layer][0]
        lp = model.layers[layer]
        for got, want in ((lp.attn_out_norm, seg["attn_out_norm"]["scale"]),
                          (lp.ssm_out_norm, seg["ssm_out_norm"]["scale"]),
                          (lp.attn.wk, seg["attn"]["wk"]["kernel"]),
                          (lp.ssm.A_log, seg["ssm"]["A_log"]),
                          (lp.ffn.w_down, seg["ffn"]["w_down"]["kernel"])):
            assert np.array_equal(got.detach().numpy(), want[0])


@pytest.mark.parametrize("edit", ["no lm_head", "no ssm_out_norm",
                                  "extra top-level leaf",
                                  "lm_head into a tied model"])
def test_converter_refuses_unplaced_leaves(hymba_lm, edit):
    jcfg, params, _, _ = hymba_lm
    cfg = port_cfg(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    if edit == "no lm_head":
        del tree["lm_head"]
    elif edit == "no ssm_out_norm":
        del tree["segments"][1][0]["ssm_out_norm"]
    elif edit == "extra top-level leaf":
        tree["vision_proj"] = {"kernel": np.zeros((4, 4), np.float32)}
    else:
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    with pytest.raises(ValueError):
        lm_from_numpy(cfg, tree, device="cpu")


@torch.no_grad()
def test_seeded_hybrid_init_follows_the_reference_law():
    cfg = reduced(get("hymba-1.5b"))
    f32 = RunConfig(dtype="float32")
    a, b = (LM(cfg, f32, seed=4, device="cpu") for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert bool(torch.isfinite(pa).all()), name
    head = a.lm_head
    assert float(head.abs().max()) <= 0.04
    assert abs(float(head.std()) / 0.02 - 0.88) < 0.05    # ±2σ truncation
    H = ssm_dims(cfg)[1]
    for layer in a.layers:
        assert not torch.any(layer.attn_out_norm)
        assert not torch.any(layer.ssm_out_norm)
        assert torch.equal(layer.ssm.A_log,
                           torch.log(torch.arange(1., H + 1)))
        std = cfg.d_model ** -0.5
        for w in (layer.attn.wq, layer.ssm.in_proj, layer.ffn.w_gate):
            assert float(w.abs().max()) <= 2 * std
            assert float(w.std()) > 0.8 * std
