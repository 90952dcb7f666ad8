"""The dense and VLM configs (internlm2-20b, chatglm3-6b, qwen2.5-32b,
internvl2-26b): the port against the JAX package on the CPU.

Each config reduced (2 full-attention layers, d 128, 4 q and 2 kv heads
of 32, untied head), and a variant at each config's own GQA group
(internlm2-20b 6, chatglm3-6b 16, qwen2.5-32b 5: one kv head of 32), with
the config's own RoPE fraction and theta.  Weights come from
`repro.models.init_lm` with every leaf that is not constant redrawn from
a seeded numpy stream at its own std (`redraw_leaves`: `init_lm`'s keys
change with the process's hash salt), carried over by `lm_from_numpy`;
the qkv biases, which `init_lm` makes zero, are replaced in the numpy
tree by seeded normal values, so that a bias that is dropped or
misplaced shows.
The JAX side runs its Pallas kernels in interpret mode
(`RunConfig(kernels="pallas")`).

Error is relative to max|reference|: 2e-5 in float32, for one block and
for the whole LM alike (two layers), 2e-2 in bfloat16.
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
from repro.models import lm_prefill as j_lm_prefill
from repro_torch.configs import get
from repro_torch.configs.base import ATTN_FULL, ArchConfig, RunConfig, reduced
from repro_torch.models import LM, lm_decode_step, lm_from_numpy, lm_prefill
from repro_torch.models import blocks as t_blocks

RCFG = JRunConfig(kernels="pallas", dtype="float32", remat=False)
BF16 = JRunConfig(kernels="pallas", dtype="bfloat16", remat=False)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S, MAX_LEN, STEPS = 2, 90, 128, 4
ARCHS = ("internlm2-20b", "chatglm3-6b", "qwen2.5-32b", "internvl2-26b")
# (params, padded vocab, GQA group) of the full configs
FULL = {"internlm2-20b": (19_861_149_696, 92_544, 6),
        "chatglm3-6b": (6_243_584_000, 65_024, 16),
        "qwen2.5-32b": (32_763_876_352, 152_064, 5),
        "internvl2-26b": (19_882_383_360, 92_672, 6)}
BIAS_STD = 0.5


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-6))


def redraw_leaves(tree, rng):
    """Every leaf of `tree` that is not constant redrawn from `rng` at
    its own initializer's std: 0.02 for the embedding and the untied
    head, 1/sqrt(fan_in) for any other kernel (`repro/models/lm.py:
    init_lm`, `common.py:dense_init`).  Leaves of all
    ones or all zeros (norm scales, biases) stay.  `init_lm` salts its
    per-leaf keys with `hash()` (`fold_keys`), so its weights change
    with every process; these do not."""
    def redraw(path, a):
        if np.all(a == a.flat[0]):
            return a
        name = jax.tree_util.keystr(path)
        std = 0.02 if "embed" in name or "lm_head" in name else \
            1.0 / np.sqrt(a.shape[-2])
        return (rng.standard_normal(a.shape) * std).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _build(jcfg, seed):
    """The reference's init, every leaf that is not constant redrawn from
    a numpy stream of `seed` (`redraw_leaves`), and the qkv biases drawn
    from it after; returns (jcfg, JAX params, numpy tree, port LM)."""
    rng = np.random.default_rng(seed)
    tree = redraw_leaves(jax.tree_util.tree_map(
        np.asarray, init_lm(jax.random.PRNGKey(seed), jcfg)), rng)
    for stack in tree["segments"][0]:
        for name in ("wq", "wk", "wv"):
            w = stack["attn"][name]
            if "bias" in w:
                w["bias"] = (rng.standard_normal(w["bias"].shape)
                             * BIAS_STD).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, params, tree, lm_from_numpy(port_cfg(jcfg), tree,
                                             device="cpu")


def _group_variant(arch, group):
    """`group` q heads of 32 on one kv head."""
    return j_reduced(j_get(arch), d_model=32 * group, n_heads=group,
                     n_kv_heads=1)


FIXTURES = {
    **{arch: (lambda arch=arch: j_reduced(j_get(arch))) for arch in ARCHS},
    "internlm2-20b G6": lambda: _group_variant("internlm2-20b", 6),
    "chatglm3-6b G16": lambda: _group_variant("chatglm3-6b", 16),
    "qwen2.5-32b G5": lambda: _group_variant("qwen2.5-32b", 5),
}


@pytest.fixture(scope="module", params=list(FIXTURES))
def dense_lm(request):
    return _build(FIXTURES[request.param](),
                  list(FIXTURES).index(request.param))


@pytest.fixture(scope="module")
def internvl2_lm():
    return _build(j_reduced(j_get("internvl2-26b")), 20)


def _tokens(jcfg, seed=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_the_reference(arch):
    cfg, jcfg = get(arch), j_get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(j_reduced(jcfg))
    n_params, vocab, group = FULL[arch]
    assert cfg.layer_kinds == (ATTN_FULL,) * cfg.n_layers
    assert (cfg.padded_vocab, cfg.resolved_head_dim) == (vocab, 128)
    assert cfg.n_heads // cfg.n_kv_heads == group
    assert not cfg.tie_embeddings
    model = LM(cfg, RunConfig(), device="meta", init=False)
    assert sum(p.numel() for p in model.parameters()) == n_params
    attn = model.layers[0].attn
    assert hasattr(attn, "bq") == cfg.qkv_bias
    assert hasattr(model, "vision_proj") == (cfg.vision is not None)


def test_dense_lm_takes_what_the_configs_need(dense_lm):
    jcfg, _, _, model = dense_lm
    attn = model.layers[0].attn
    if jcfg.qkv_bias:
        assert attn.bq.shape == (jcfg.n_heads * jcfg.resolved_head_dim,)
        assert attn.bk.shape == attn.bv.shape == \
            (jcfg.n_kv_heads * jcfg.resolved_head_dim,)
        assert float(attn.bk.detach().abs().max()) > 0.1   # seeded
    else:
        assert not hasattr(attn, "bq")
    assert not hasattr(attn, "bo")


@pytest.mark.parametrize("layer", [0, 1])
def test_attention_block_forward_and_decode(dense_lm, layer):
    """One block: its output and k/v cache after a 90-token forward, then
    3 decode steps from that cache, each within 2e-5 of the reference."""
    jcfg, params, _, model = dense_lm
    cfg = port_cfg(jcfg)
    p = jax.tree_util.tree_map(lambda a: a[layer],
                               params["segments"][0][0])
    x = np.random.default_rng(7).standard_normal(
        (B, S + 3, jcfg.d_model)).astype(np.float32)
    want, _, jcache = j_blocks.block_forward(
        p, jnp.asarray(x[:, :S]), jcfg, RCFG, ATTN_FULL,
        positions=jnp.arange(S), collect_cache=True)
    got, cache = t_blocks.block_forward(
        model.layers[layer], torch.from_numpy(x[:, :S]), cfg, ATTN_FULL,
        positions=torch.arange(S), collect_cache=True)
    assert sorted(cache) == ["k", "v"]
    assert rel_err(got, want) < TOL["float32"]
    for name in ("k", "v"):
        assert rel_err(cache[name], jcache[name]) < TOL["float32"], name
    pad = ((0, 0), (0, 0), (0, MAX_LEN - S), (0, 0))
    jcache = {n: jnp.pad(jcache[n], pad) for n in ("k", "v")}
    cache = {n: torch.nn.functional.pad(cache[n], (0, 0, 0, MAX_LEN - S))
             for n in ("k", "v")}
    for t in range(S, S + 3):
        want, jcache = j_blocks.block_decode_step(
            p, jnp.asarray(x[:, t:t + 1]), jcache, jnp.int32(t), jcfg,
            RCFG, ATTN_FULL)
        k = cache["k"]
        got, cache = t_blocks.block_decode_step(
            model.layers[layer], torch.from_numpy(x[:, t:t + 1]), cache, t,
            cfg, ATTN_FULL)
        assert cache["k"] is k                 # written in place
        assert rel_err(got, want) < TOL["float32"], t
        for name in ("k", "v"):
            assert rel_err(cache[name], jcache[name]) < TOL["float32"], t


def test_lm_prefill_and_decode(dense_lm):
    """The prefill's last-position logits and every layer's k/v cache,
    then 4 decode steps' logits, each within 2e-5 of the reference."""
    jcfg, params, _, model = dense_lm
    cfg, toks = port_cfg(jcfg), _tokens(jcfg)
    want, jcaches = j_lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                 RCFG, max_len=MAX_LEN)
    got, caches = lm_prefill(model, torch.from_numpy(toks[:, :S]).long(),
                             max_len=MAX_LEN)
    assert got.dtype == torch.float32 and \
        got.shape == (B, cfg.padded_vocab)
    assert rel_err(got, want) < TOL["float32"]
    for layer, c in enumerate(caches):
        assert sorted(c) == ["k", "v"]
        for name in ("k", "v"):
            assert c[name].shape == (B, cfg.n_kv_heads, MAX_LEN,
                                     cfg.resolved_head_dim)
            assert not torch.any(c[name][:, :, S:])
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


def bf16_rounding_only(got, want, want_f32) -> None:
    """What is left between the port's bf16 logits `got` and the
    reference's `want` is bf16 rounding: `got` is no further from the
    reference's fp32 logits than 1.5x the reference's own bf16 ones."""
    own = rel_err(want, want_f32)
    assert rel_err(got, want_f32) <= 1.5 * own, (rel_err(got, want_f32),
                                                 own)


def test_bf16_prefill_and_decode_against_jax(dense_lm):
    """The serving dtype: the same weights, biases included, in bf16 in
    both packages; the prefill's and 4 decode steps' logits within 2e-2
    over the real vocab rows, and no further from the reference's fp32
    logits than 1.5x its own bf16 ones (`bf16_rounding_only`)."""
    jcfg, params, tree, _ = dense_lm
    cfg, toks = port_cfg(jcfg), _tokens(jcfg, seed=9)
    model = lm_from_numpy(cfg, tree, rcfg=RunConfig(dtype="bfloat16"),
                          device="cpu")
    if cfg.qkv_bias:
        assert model.layers[0].attn.bq.dtype == torch.bfloat16
    V = cfg.vocab_size
    prompt = jnp.asarray(toks[:, :S])
    want, jcaches = j_lm_prefill(params, prompt, jcfg, BF16,
                                 max_len=MAX_LEN)
    want32, jcaches32 = j_lm_prefill(params, prompt, jcfg, RCFG,
                                     max_len=MAX_LEN)
    got, caches = lm_prefill(model, torch.from_numpy(toks[:, :S]).long(),
                             max_len=MAX_LEN)
    for step in range(STEPS + 1):
        assert rel_err(got[:, :V], want[:, :V]) < TOL["bfloat16"], step
        bf16_rounding_only(got[:, :V], want[:, :V], want32[:, :V])
        if step == STEPS:
            break
        pos = S + step
        tok = jnp.asarray(toks[:, pos:pos + 1])
        want, jcaches = j_lm_decode(params, jcaches, tok, jnp.int32(pos),
                                    jcfg, BF16)
        want32, jcaches32 = j_lm_decode(params, jcaches32, tok,
                                        jnp.int32(pos), jcfg, RCFG)
        got, caches = lm_decode_step(
            model, caches, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            pos)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen2.5-32b"])
def test_biases_move_the_logits(arch):
    """The seeded biases matter: zeroing them moves the prefill's logits
    far past the tolerance, so a port that dropped them would fail."""
    jcfg, _, tree, model = _build(j_reduced(j_get(arch)), 0)
    toks = torch.from_numpy(_tokens(jcfg)[:, :S]).long()
    with_bias, _ = lm_prefill(model, toks)
    bare = lm_from_numpy(port_cfg(jcfg), tree, device="cpu")
    with torch.no_grad():
        for layer in bare.layers:
            for b in (layer.attn.bq, layer.attn.bk, layer.attn.bv):
                b.zero_()
    without, _ = lm_prefill(bare, toks)
    assert rel_err(without, with_bias) > 100 * TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_with_patch_embeddings(internvl2_lm, dtype):
    """16 patch embeddings of width 64 replace the first 16 positions
    (projected by `vision_proj` in the compute dtype): the prefill's
    logits and caches against `lm_prefill(patch_embeds=...)`, then 4
    decode steps, which take no patches; and the same tokens without
    patches against the reference's text-only prefill."""
    jcfg, params, tree, model = internvl2_lm
    cfg, toks = port_cfg(jcfg), _tokens(jcfg, seed=12)
    if dtype == "bfloat16":
        model = lm_from_numpy(cfg, tree, rcfg=RunConfig(dtype=dtype),
                              device="cpu")
    jr, tol, V = (RCFG if dtype == "float32" else BF16), TOL[dtype], \
        cfg.vocab_size
    n, width = cfg.vision.n_patches, cfg.vision.patch_embed_dim
    assert (n, width) == (16, 64)
    patches = np.random.default_rng(13).standard_normal(
        (B, n, width)).astype(np.float32)
    prompt = toks[:, :S]
    want, jcaches = j_lm_prefill(params, jnp.asarray(prompt), jcfg, jr,
                                 max_len=MAX_LEN,
                                 patch_embeds=jnp.asarray(patches))
    got, caches = lm_prefill(model, torch.from_numpy(prompt).long(),
                             max_len=MAX_LEN,
                             patch_embeds=torch.from_numpy(patches))
    assert rel_err(got[:, :V], want[:, :V]) < tol
    assert bool((got[:, V:] == -1e30).all())
    with_patches = got
    for layer, c in enumerate(caches):
        assert rel_err(c["k"], jcaches[0][0]["k"][layer]) < tol, layer
    for step in range(STEPS):
        pos = S + step
        want, jcaches = j_lm_decode(params, jcaches,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos), jcfg, jr)
        got, caches = lm_decode_step(
            model, caches, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            pos)
        assert rel_err(got[:, :V], want[:, :V]) < tol, step
    text, _ = j_lm_prefill(params, jnp.asarray(prompt), jcfg, jr,
                           max_len=MAX_LEN)
    got_text, _ = lm_prefill(model, torch.from_numpy(prompt).long(),
                             max_len=MAX_LEN)
    assert rel_err(got_text[:, :V], text[:, :V]) < tol
    assert rel_err(got_text[:, :V], with_patches[:, :V]) > tol   # matter


def test_vlm_prompt_shorter_than_the_patches_raises(internvl2_lm):
    """The reference would build a sequence longer than the prompt; the
    port refuses."""
    model = internvl2_lm[3]
    patches = torch.zeros(1, 16, 64)
    with pytest.raises(ValueError, match="patch"):
        lm_prefill(model, torch.zeros(1, 15, dtype=torch.long),
                   patch_embeds=patches)
    logits, _ = lm_prefill(model, torch.zeros(1, 16, dtype=torch.long),
                           patch_embeds=patches)
    assert bool(torch.isfinite(logits).all())


def test_converter_places_biases_and_projector(internvl2_lm, dense_lm):
    for jcfg, _, tree, model in (internvl2_lm, dense_lm):
        assert np.array_equal(model.lm_head.detach().numpy(),
                              tree["lm_head"]["kernel"])
        if jcfg.vision is not None:
            assert np.array_equal(model.vision_proj.detach().numpy(),
                                  tree["vision_proj"]["kernel"])
        if jcfg.qkv_bias:
            for layer in range(2):
                attn = tree["segments"][0][0]["attn"]
                for name, got in (("wq", model.layers[layer].attn.bq),
                                  ("wk", model.layers[layer].attn.bk),
                                  ("wv", model.layers[layer].attn.bv)):
                    assert np.array_equal(got.detach().numpy(),
                                          attn[name]["bias"][layer])


@pytest.mark.parametrize("edit", ["no bq", "no bv", "no vision_proj",
                                  "bias into a model without one"])
def test_converter_refuses_unplaced_leaves(edit):
    arch = {"no bq": "qwen2.5-32b", "no bv": "chatglm3-6b",
            "no vision_proj": "internvl2-26b",
            "bias into a model without one": "internlm2-20b"}[edit]
    jcfg = j_reduced(j_get(arch))
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_lm(jax.random.PRNGKey(0), jcfg))
    attn = tree["segments"][0][0]["attn"]
    if edit == "no bq":
        del attn["wq"]["bias"]
    elif edit == "no bv":
        del attn["wv"]["bias"]
    elif edit == "no vision_proj":
        del tree["vision_proj"]
    else:
        attn["wk"]["bias"] = np.zeros(attn["wk"]["kernel"].shape[::2],
                                      np.float32)
    with pytest.raises(ValueError):
        lm_from_numpy(port_cfg(jcfg), tree, device="cpu")


@torch.no_grad()
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "internvl2-26b"])
def test_seeded_init_follows_the_reference_law(arch):
    """qkv biases 0 as `dense_init(bias=True)` makes them; the projector
    at σ = 1/sqrt(patch_embed_dim), truncated at ±2σ."""
    cfg = reduced(get(arch))
    a, b = (LM(cfg, RunConfig(dtype="float32"), seed=3, device="cpu")
            for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    for layer in a.layers:
        for name in ("bq", "bk", "bv"):
            assert hasattr(layer.attn, name) == cfg.qkv_bias
            if cfg.qkv_bias:
                assert not torch.any(getattr(layer.attn, name))
    if cfg.vision is not None:
        std = cfg.vision.patch_embed_dim ** -0.5
        w = a.vision_proj
        assert w.shape == (cfg.vision.patch_embed_dim, cfg.d_model)
        assert float(w.abs().max()) <= 2 * std
        assert abs(float(w.std()) / std - 0.88) < 0.05
