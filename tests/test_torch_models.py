"""Each model module of the port against its JAX counterpart at float32 on
reduced gemma2 and reduced mamba2, with the weights carried over from
`repro.models.init_lm` through `lm_from_numpy`.  The JAX side runs the Pallas kernels in
interpret mode (`RunConfig(kernels="pallas")`).

Error is relative to max|reference|: 2e-5 for one module (the float32
rule of tests/test_kernels.py), 1e-4 for whole-LM logits, where two
frameworks sum in different orders across the stacked layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import (ATTN_FULL, ATTN_SWA, RunConfig as JRunConfig,
                                reduced as j_reduced)
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro.models import ssm as j_ssm
from repro.models import init_lm, lm_decode_step as j_lm_decode
from repro.models import lm_prefill as j_lm_prefill
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import (LM, attention as t_attn, common as t_common,
                                ffn as t_ffn, lm_decode_step, lm_from_numpy,
                                lm_prefill, ssm as t_ssm)

RCFG = JRunConfig(kernels="pallas", dtype="float32", remat=False)
MODULE_TOL = 2e-5
LM_TOL = 1e-4


def port_cfg(jcfg) -> ArchConfig:
    """The port's config with the reference config's numbers."""
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-6))


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _build(jcfg, seed=0):
    params = init_lm(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, lm_from_numpy(port_cfg(jcfg), tree, device="cpu")


@pytest.fixture(scope="module")
def reduced_lm():
    jcfg = j_reduced(j_get("gemma2-2b"))
    params, model = _build(jcfg)
    return jcfg, params, model


@pytest.fixture(scope="module")
def mamba2_lm():
    """Reduced mamba2: 2 SSM layers, d 128, 16 heads of 16, d_state 32,
    chunk 32."""
    jcfg = j_reduced(j_get("mamba2-1.3b"))
    params, model = _build(jcfg, seed=2)
    return jcfg, params, model


@pytest.fixture(scope="module")
def stacked_lm():
    """Four layers in the reference's stacked layout ((SWA, FULL), 2)."""
    jcfg = dataclasses.replace(
        j_reduced(j_get("gemma2-2b"), n_layers=4),
        layer_pattern=(((ATTN_SWA, ATTN_FULL), 2),))
    params, model = _build(jcfg, seed=3)
    return jcfg, params, model


def test_dense():
    rng = np.random.default_rng(0)
    x, w = randn(rng, 2, 5, 128), randn(rng, 128, 256, scale=0.1)
    want = j_common.dense({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                          jnp.float32)
    got = t_common.dense(torch.from_numpy(x), torch.from_numpy(w))
    assert rel_err(got, want) < MODULE_TOL


def test_rmsnorm():
    rng = np.random.default_rng(1)
    x, s = randn(rng, 3, 7, 128, scale=3.0), randn(rng, 128, scale=0.2)
    want = j_common.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))
    got = t_common.rmsnorm(torch.from_numpy(s), torch.from_numpy(x))
    assert rel_err(got, want) < MODULE_TOL


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 4, 40, 32)
    pos = np.arange(40, dtype=np.int32) + 90
    want = j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction)
    got = t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              fraction)
    assert rel_err(got, want) < MODULE_TOL


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_activate_and_softcap(act):
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    want = j_common.softcap(j_common.activate(jnp.asarray(x), act), 30.0)
    got = t_common.softcap(t_common.activate(torch.from_numpy(x), act), 30.0)
    assert rel_err(got, want) < MODULE_TOL


def test_ffn_forward(reduced_lm):
    jcfg, params, model = reduced_lm
    rng = np.random.default_rng(3)
    x = randn(rng, 2, 9, jcfg.d_model)
    p = jax.tree_util.tree_map(lambda a: a[0], params["segments"][0][0])
    want = j_ffn.ffn_forward(p["ffn"], jnp.asarray(x), jcfg.act, jnp.float32)
    got = t_ffn.ffn_forward(model.layers[0].ffn, torch.from_numpy(x),
                            jcfg.act)
    assert rel_err(got, want) < MODULE_TOL


@pytest.mark.parametrize("layer,window", [(0, 64), (1, 0)])
def test_attention_forward(reduced_lm, layer, window):
    """S = 90 > window 64, so the local layer's mask bites."""
    jcfg, params, model = reduced_lm
    rng = np.random.default_rng(4)
    x = randn(rng, 2, 90, jcfg.d_model)
    p = jax.tree_util.tree_map(lambda a: a[0],
                               params["segments"][layer][0])
    want, (wk, wv) = j_attn.attention_forward(
        p["attn"], jnp.asarray(x), jcfg, RCFG, window=window,
        return_kv=True)
    got, (k, v) = t_attn.attention_forward(
        model.layers[layer].attn, torch.from_numpy(x), port_cfg(jcfg),
        window=window, return_kv=True)
    assert rel_err(got, want) < MODULE_TOL
    assert rel_err(k, wk) < MODULE_TOL and rel_err(v, wv) < MODULE_TOL


@pytest.mark.parametrize("layer,window", [(0, 64), (1, 0)])
def test_attention_decode_step(reduced_lm, layer, window):
    jcfg, params, model = reduced_lm
    rng = np.random.default_rng(5)
    B, Hkv, S, dh, pos = 2, jcfg.n_kv_heads, 128, jcfg.resolved_head_dim, 97
    x = randn(rng, B, 1, jcfg.d_model)
    ck, cv = randn(rng, B, Hkv, S, dh), randn(rng, B, Hkv, S, dh)
    p = jax.tree_util.tree_map(lambda a: a[0],
                               params["segments"][layer][0])
    want, wk, wv = j_attn.attention_decode_step(
        p["attn"], jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(pos), jcfg, RCFG, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, k2, v2 = t_attn.attention_decode_step(
        model.layers[layer].attn, torch.from_numpy(x), tk, tv, pos,
        port_cfg(jcfg), window=window)
    assert k2 is tk and v2 is tv           # updated in place
    assert rel_err(got, want) < MODULE_TOL
    assert rel_err(tk, wk) < MODULE_TOL and rel_err(tv, wv) < MODULE_TOL
    with pytest.raises(IndexError):
        t_attn.attention_decode_step(
            model.layers[layer].attn, torch.from_numpy(x), tk, tv, S,
            port_cfg(jcfg), window=window)


def test_converter_layer_order(stacked_lm):
    """Stacked ((SWA, FULL), 2) → swa[0], full[0], swa[1], full[1]."""
    jcfg, params, model = stacked_lm
    kinds = port_cfg(jcfg).layer_kinds
    assert kinds == (ATTN_SWA, ATTN_FULL, ATTN_SWA, ATTN_FULL)
    seg = params["segments"][0]
    for layer in range(4):
        r, ki = divmod(layer, 2)
        want = np.asarray(seg[ki]["attn"]["wq"]["kernel"][r])
        got = model.layers[layer].attn.wq.detach().numpy()
        assert np.array_equal(got, want)
        assert model.layers[layer].kind == kinds[layer]


def test_converter_rejects_missing_leaf(reduced_lm):
    jcfg, params, _ = reduced_lm
    tree = jax.tree_util.tree_map(np.asarray, params)
    del tree["segments"][0][0]["post_ln2"]
    with pytest.raises(ValueError):
        lm_from_numpy(port_cfg(jcfg), tree, device="cpu")


@pytest.mark.parametrize("which", ["reduced_lm", "stacked_lm", "mamba2_lm"])
def test_lm_prefill_and_decode(request, which):
    """Whole-LM logits: prefill of a 90-token prompt (> window 64; not a
    multiple of mamba2's chunk 32), then four decode steps, each within
    1e-4 of the reference."""
    jcfg, params, model = request.getfixturevalue(which)
    rng = np.random.default_rng(6)
    B, S, max_len = 2, 90, 128
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 4)).astype(np.int32)
    want, jcaches = j_lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                 RCFG, max_len=max_len)
    got, caches = lm_prefill(model, torch.from_numpy(toks[:, :S]).long(),
                             max_len=max_len)
    assert got.dtype == torch.float32 and got.shape == (B, jcfg.vocab_size)
    assert rel_err(got, want) < LM_TOL
    for c, kind in zip(caches, port_cfg(jcfg).layer_kinds):
        if kind == "ssm":
            assert sorted(c) == ["conv", "state"]
        else:
            assert c["k"].shape == (B, jcfg.n_kv_heads, max_len,
                                    jcfg.resolved_head_dim)
    for step in range(4):
        pos = S + step
        want, jcaches = j_lm_decode(params, jcaches,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos), jcfg, RCFG)
        got, caches = lm_decode_step(
            model, caches, torch.from_numpy(toks[:, pos:pos + 1]).long(),
            pos)
        assert rel_err(got, want) < LM_TOL, step


def test_seeded_init_is_reproducible():
    cfg = port_cfg(j_reduced(j_get("gemma2-2b")))
    f32 = RunConfig(dtype="float32")
    a, b = (LM(cfg, f32, seed=7, device="cpu") for _ in range(2))
    c = LM(cfg, f32, seed=8, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if "ln" not in name and "norm" not in name:
            assert not torch.equal(pa, pc), name
    std = 1.0 / np.sqrt(cfg.d_model)
    w = a.layers[0].attn.wq.detach()
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / std - 0.88) < 0.05   # ±2σ truncation


def test_unported_kinds_raise():
    """Every layer kind of the reference is ported (attention, SSM and,
    since hymba-1.5b, hybrid), and since qwen2-moe-a2.7b the MoE blocks,
    a config's `moe`; a kind outside them, and the encoder of an
    encoder-decoder config, still raise."""
    base = port_cfg(j_reduced(j_get("gemma2-2b")))
    cfg = dataclasses.replace(base, layer_pattern=(
        (("cross_attn",), 1), ((ATTN_FULL,), 1)))
    with pytest.raises(NotImplementedError, match="cross_attn"):
        LM(cfg, RunConfig(dtype="float32"), device="cpu")
    encdec = port_cfg(j_reduced(j_get("seamless-m4t-large-v2")))
    with pytest.raises(NotImplementedError, match="encoder"):
        LM(encdec, RunConfig(dtype="float32"), device="cpu")
    moe = port_cfg(j_reduced(j_get("mixtral-8x7b")))
    assert LM(moe, RunConfig(dtype="float32"), device="cpu").layers[0].moe


def _layer(params, layer=0):
    """One layer's tree out of the reference's stacked single-kind
    segment."""
    return jax.tree_util.tree_map(lambda a: a[layer],
                                  params["segments"][0][0])


def test_ssm_forward_and_decode(mamba2_lm):
    """A 90-token sequence (not a multiple of the chunk 32, so the scan
    input is padded), its decode cache, then three decode steps from it."""
    jcfg, params, model = mamba2_lm
    rng = np.random.default_rng(7)
    B, S = 2, 90
    x = randn(rng, B, S + 3, jcfg.d_model)
    p = _layer(params, 1)["ssm"]
    want, jcache = j_ssm.ssm_forward(p, jnp.asarray(x[:, :S]), jcfg, RCFG,
                                     return_state=True)
    got, cache = t_ssm.ssm_forward(model.layers[1].ssm,
                                   torch.from_numpy(x[:, :S]),
                                   port_cfg(jcfg), return_state=True)
    assert rel_err(got, want) < MODULE_TOL
    assert rel_err(cache["state"], jcache["state"]) < MODULE_TOL
    assert rel_err(cache["conv"], jcache["conv"]) < MODULE_TOL
    # the conv tail owns its storage: a view would keep every layer's
    # whole (B, S, conv_dim) input alive for as long as the cache lives
    conv = cache["conv"]
    assert conv.untyped_storage().nbytes() == conv.numel() * 4
    for t in range(S, S + 3):
        want, jcache = j_ssm.ssm_decode_step(p, jnp.asarray(x[:, t:t + 1]),
                                             jcache, jcfg, RCFG)
        got, cache = t_ssm.ssm_decode_step(model.layers[1].ssm,
                                           torch.from_numpy(x[:, t:t + 1]),
                                           cache, port_cfg(jcfg))
        assert rel_err(got, want) < MODULE_TOL, t
        assert rel_err(cache["state"], jcache["state"]) < MODULE_TOL, t


@pytest.mark.parametrize("S", [1, 2, 3, 40])
@torch.no_grad()
def test_ssm_short_prompts_and_empty_cache(mamba2_lm, S):
    """Prompts shorter than the conv kernel (a zero-padded conv tail), and
    a decode step from `init_ssm_cache` equal to the forward of the same
    token."""
    jcfg, params, model = mamba2_lm
    cfg, p = port_cfg(jcfg), model.layers[0].ssm
    x = randn(np.random.default_rng(8), 2, S, jcfg.d_model)
    want, jcache = j_ssm.ssm_forward(_layer(params)["ssm"], jnp.asarray(x),
                                     jcfg, RCFG, return_state=True)
    got, cache = t_ssm.ssm_forward(p, torch.from_numpy(x), cfg,
                                   return_state=True)
    assert cache["conv"].shape == (2, cfg.ssm.conv_kernel - 1,
                                   t_ssm.conv_dim(cfg))
    assert rel_err(got, want) < MODULE_TOL
    assert rel_err(cache["conv"], jcache["conv"]) < MODULE_TOL
    empty = t_ssm.init_ssm_cache(2, cfg, torch.device("cpu"))
    first, _ = t_ssm.ssm_decode_step(p, torch.from_numpy(x[:, :1]), empty,
                                     cfg)
    assert rel_err(first, got[:, :1]) < MODULE_TOL


def test_ssm_blocks_have_no_ffn(mamba2_lm):
    """Mamba-2 layers are norm → mixer → residual: reduced mamba2 keeps
    the reduced d_ff 256, as the reference does, and builds no FFN."""
    jcfg, params, model = mamba2_lm
    assert jcfg.d_ff > 0
    names = {n.split(".", 2)[2].split(".")[0]
             for n, _ in model.named_parameters() if n.startswith("layers")}
    assert names == {"ln1", "ssm"}
    assert set(_layer(params)) == {"ln1", "ssm"}


@pytest.mark.parametrize("leaf", ["dt_bias", "gate_norm"])
def test_converter_rejects_missing_ssm_leaf(mamba2_lm, leaf):
    jcfg, params, _ = mamba2_lm
    tree = jax.tree_util.tree_map(np.asarray, params)
    del tree["segments"][0][0]["ssm"][leaf]
    with pytest.raises(ValueError):
        lm_from_numpy(port_cfg(jcfg), tree, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["segments"][0][0]["ssm"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unported"):
        lm_from_numpy(port_cfg(jcfg), tree, device="cpu")


@torch.no_grad()
def test_seeded_ssm_init_follows_the_reference_law():
    cfg = port_cfg(j_reduced(j_get("mamba2-1.3b")))
    a = LM(cfg, RunConfig(dtype="float32"), seed=3, device="cpu")
    b = LM(cfg, RunConfig(dtype="float32"), seed=3, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    d_inner, H = t_ssm.ssm_dims(cfg)[:2]
    sc = cfg.ssm
    for layer in a.layers:
        p = layer.ssm
        assert p.in_proj.shape == (cfg.d_model, 2 * d_inner + 2 *
                                   sc.n_groups * sc.d_state + H)
        assert torch.equal(p.A_log, torch.log(torch.arange(1., H + 1)))
        assert torch.equal(p.D, torch.ones(H))
        dt = torch.nn.functional.softplus(p.dt_bias)
        assert float(dt.min()) >= sc.dt_min * 0.999
        assert float(dt.max()) <= sc.dt_max * 1.001
        assert not torch.any(p.conv_b) and not torch.any(p.gate_norm)
        for w, std in ((p.in_proj, cfg.d_model ** -0.5),
                       (p.out_proj, d_inner ** -0.5),
                       (p.conv_w, sc.conv_kernel ** -0.5)):
            assert float(w.abs().max()) <= 2 * std
        assert all(t.dtype == torch.float32 for t in (
            p.conv_w, p.conv_b, p.A_log, p.D, p.dt_bias, p.gate_norm))
