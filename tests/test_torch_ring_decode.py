"""The ring-append decode (`attention_decode_step_ring`, `flush_ring`,
`init_decode_cache(ring=)`, `flush_decode_caches`) against the full
forward and against the reference's ring decode, step by step, on the
CPU; and a prefill's caches given rings (`add_decode_rings`) against the
plain decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.models import (init_decode_cache as j_init_decode_cache,
                          lm_decode_step as j_lm_decode_step)
from repro.models.lm import flush_decode_caches as j_flush
from repro_torch.configs.base import (ATTN_FULL, ArchConfig, HYBRID_FULL,
                                      RunConfig)
from repro_torch.models import (add_decode_rings, flush_decode_caches,
                                init_decode_cache, lm_decode_step,
                                lm_forward, lm_from_numpy, lm_prefill)
from repro_torch.models.attention import (attention_decode_step_ring,
                                          flush_ring)
from test_torch_serve import seeded_params

RCFG = RunConfig(kernels="xla", dtype="float32", remat=False)
J_RCFG = JRunConfig(kernels="xla", dtype="float32", remat=False,
                    scan_layers=True)
T, R, MAX_LEN = 13, 4, 32
FORWARD_TOL = 1e-4      # `tests/test_archs_smoke.py`'s, absolute
F32_RTOL = 2e-5         # against the reference, relative to max|logit|


def _setup(arch, seed):
    jcfg = j_reduced(j_get(arch))
    params = seeded_params(jcfg, seed)
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg)})
    model = lm_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                          device="cpu")
    toks = np.random.default_rng(seed + 50).integers(
        0, jcfg.vocab_size, (1, T)).astype(np.int32)
    return jcfg, cfg, params, model, toks


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "gemma2-2b", "hymba-1.5b"])
def test_ring_decode_matches_forward_and_the_reference(arch):
    """T 13 tokens, a ring of 4 flushed every 4 steps: each step's logits
    within 1e-4 of the full forward's at that position, and within f32
    rtol 2e-5 of the reference's ring decode.  qwen2.5's layers are all
    full attention (all on rings); gemma2's sliding-window layers and
    hymba's windowed hybrid layer keep the plain cache."""
    jcfg, cfg, params, model, toks = _setup(arch, 21)
    V = cfg.vocab_size
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        full, _ = lm_forward(model, tt, RCFG)
    caches = init_decode_cache(1, MAX_LEN, cfg, torch.float32, ring=R,
                               device="cpu")
    jcache = j_init_decode_cache(1, MAX_LEN, jcfg, jnp.float32, ring=R)
    jstep = jax.jit(lambda p, c, t, pos: j_lm_decode_step(
        p, c, t, pos, jcfg, J_RCFG))
    fwd, ref = [], []
    for t in range(T):
        lg, caches = lm_decode_step(model, caches, tt[:, t:t + 1], t)
        jlg, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        fwd.append(float((lg[:, :V] - full[:, t, :V]).abs().max()))
        ref.append(rel_err(lg[:, :V], np.asarray(jlg)[:, :V]))
        if (t + 1) % R == 0:
            caches = flush_decode_caches(caches, t + 1 - R)
            jcache = j_flush(jcache, jnp.int32(t + 1 - R))
    assert max(fwd) < FORWARD_TOL, fwd
    assert max(ref) < F32_RTOL, ref
    rings = [i for i, c in enumerate(caches) if "rk" in c]
    full_layers = [i for i, k in enumerate(cfg.layer_kinds)
                   if k in (ATTN_FULL, HYBRID_FULL)]
    assert rings == full_layers and rings


def test_prefill_then_ring_decode_matches_plain_decode():
    """gemma2's prefill of 6 tokens, its full-attention caches given rings
    holding rows [4, 6), then 7 ring steps flushed at 8 and 12: the
    logits equal the plain decode's within 1e-4 and the main caches hold
    the same rows after each flush."""
    jcfg, cfg, params, model, toks = _setup("gemma2-2b", 22)
    tt = torch.from_numpy(toks).long()
    S0 = 6
    _, plain = lm_prefill(model, tt[:, :S0], max_len=MAX_LEN)
    _, ringed = lm_prefill(model, tt[:, :S0], max_len=MAX_LEN)
    add_decode_rings(ringed, cfg, R, S0)
    for c, p in zip(ringed, plain):
        if "rk" in c:
            assert torch.equal(c["rk"][:, :, :S0 - 4], p["k"][:, :, 4:S0])
            assert not c["rk"][:, :, S0 - 4:].any()
    for pos in range(S0, T):
        want, plain = lm_decode_step(model, plain, tt[:, pos:pos + 1], pos)
        got, ringed = lm_decode_step(model, ringed, tt[:, pos:pos + 1], pos)
        assert float((got - want).abs().max()) < FORWARD_TOL, pos
        if (pos + 1) % R == 0:
            flush_decode_caches(ringed, pos + 1 - R)
            for c, p in zip(ringed, plain):
                assert torch.equal(c["k"][:, :, :pos + 1],
                                   p["k"][:, :, :pos + 1])


def test_init_decode_cache_layout():
    """Rings only on full-attention layers, zero, of `ring` rows; no ring
    at 0; an SSM layer's conv history and state."""
    cfg = j_reduced(j_get("hymba-1.5b"))
    cfg = ArchConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})
    caches = init_decode_cache(2, 16, cfg, torch.bfloat16, ring=4,
                               device="cpu")
    for kind, c in zip(cfg.layer_kinds, caches):
        assert c["k"].shape == (2, cfg.n_kv_heads, 16, cfg.resolved_head_dim)
        assert c["k"].dtype == torch.bfloat16
        assert ("rk" in c) == (kind == HYBRID_FULL)
        if "rk" in c:
            assert c["rk"].shape == (2, cfg.n_kv_heads, 4,
                                     cfg.resolved_head_dim)
            assert not c["rk"].any() and not c["rv"].any()
        assert c["state"].dtype == torch.float32 and not c["state"].any()
    plain = init_decode_cache(2, 16, cfg, torch.bfloat16, device="cpu")
    assert not any("rk" in c for c in plain)


def test_ring_bounds_raise():
    """A flush past the cache and a ring slot outside the ring raise,
    where the reference's update would clamp."""
    k = torch.zeros(1, 2, 8, 4)
    ring = torch.ones(1, 2, 4, 4)
    with pytest.raises(IndexError, match="outside the cache"):
        flush_ring(k, k.clone(), ring, ring, 6)
    flush_ring(k, k.clone(), ring, ring, 4)
    assert bool((k[:, :, 4:] == 1).all()) and not k[:, :, :4].any()
    jcfg, cfg, params, model, toks = _setup("qwen2.5-32b", 23)
    caches = init_decode_cache(1, MAX_LEN, cfg, torch.float32, ring=R,
                               device="cpu")
    c = caches[0]
    with pytest.raises(IndexError, match="ring slot"):
        attention_decode_step_ring(
            model.layers[0].attn, torch.zeros(1, 1, cfg.d_model), c["k"],
            c["v"], c["rk"], c["rv"], pos=5, base=0, cfg=cfg)
