"""Serving under `RunConfig(kernels="xla")`: the port's prefill and decode
steps on the plain attention and SSD against the reference's
`kernels="xla"` steps, from the same seeded weights, in float32 on the
CPU (reduced gemma2-2b, mamba2-1.3b and seamless-m4t-large-v2): the
prefill's logits and 4 decode steps' within 2e-5 of max|logit|.

The reference's serving steps honour `rcfg.kernels` (the dry-run costs
them with "xla"); the port's take the same setting, and with none they
keep the kernel ops: on the meta device the plain path runs, the kernel
path raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.models.encdec import init_encdec_cache as j_init_encdec_cache
from repro.serve.serve_step import (make_decode_step as j_make_decode,
                                    make_prefill_step as j_make_prefill)
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import (LM, EncDec, encdec_from_numpy,
                                init_decode_cache, init_encdec_cache,
                                lm_from_numpy)
from repro_torch.serve import make_decode_step, make_prefill_step
from test_torch_encdec import ffn_in_run_dtype, seeded_encdec  # noqa: F401
from test_torch_serve import seeded_params

TOL = 2e-5
B, S, STEPS, MAX_LEN = 2, 24, 4, 32
J_XLA = JRunConfig(kernels="xla", dtype="float32", remat=False)
XLA = RunConfig(kernels="xla", dtype="float32", remat=False)
SEAMLESS = "seamless-m4t-large-v2"


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def rel_err(got, want) -> float:
    got = np.asarray(got.detach(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("arch,seed", [("gemma2-2b", 50),
                                       ("mamba2-1.3b", 51)])
def test_lm_prefill_and_decode_on_the_plain_path(arch, seed):
    jcfg = j_reduced(j_get(arch))
    params = seeded_params(jcfg, seed)
    model = lm_from_numpy(port_cfg(jcfg), jax.tree_util.tree_map(
        np.asarray, params), device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    V = jcfg.vocab_size
    want, jcaches = j_make_prefill(jcfg, J_XLA, max_len=MAX_LEN)(
        params, jnp.asarray(toks[:, :S]))
    got, caches = make_prefill_step(model, max_len=MAX_LEN, rcfg=XLA)(
        torch.from_numpy(toks[:, :S]))
    jstep, step = j_make_decode(jcfg, J_XLA), make_decode_step(model, XLA)
    for i in range(STEPS + 1):
        assert rel_err(got[:, :V], np.asarray(want)[:, :V]) < TOL, i
        if i == STEPS:
            break
        pos = S + i
        t = toks[:, pos:pos + 1]
        want, jcaches = jstep(params, jcaches, jnp.asarray(t),
                              jnp.int32(pos))
        got, caches = step(caches, torch.from_numpy(t), pos)


def test_encdec_prefill_and_decode_on_the_plain_path():
    jcfg = j_reduced(j_get(SEAMLESS))
    cfg = port_cfg(jcfg)
    params = seeded_encdec(jcfg, 52)
    model = encdec_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                          params),
                              device="cpu")
    rng = np.random.default_rng(53)
    frames = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    jcross = j_make_prefill(jcfg, J_XLA)(params, jnp.asarray(frames), None)
    cross = make_prefill_step(model, rcfg=XLA)(torch.from_numpy(frames))
    for got, want in zip(cross, jcross):
        assert rel_err(got, want) < TOL
    jstep, step = j_make_decode(jcfg, J_XLA), make_decode_step(model, XLA)
    jcache = j_init_encdec_cache(B, MAX_LEN, jcfg, dtype=jnp.float32)
    cache = init_encdec_cache(B, MAX_LEN, cfg, dtype=torch.float32,
                              device="cpu")
    V = cfg.vocab_size
    for pos in range(STEPS):
        t = toks[:, pos:pos + 1]
        want, jcache = jstep(params, jcache, jcross, jnp.asarray(t),
                             jnp.int32(pos))
        got, cache = step(cache, cross, torch.from_numpy(t), pos)
        assert rel_err(got[:, :V], np.asarray(want)[:, :V]) < TOL, pos


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b", SEAMLESS])
def test_the_setting_chooses_the_path_on_meta(arch):
    """On the meta device (no kernel there) "xla" runs the prefill and a
    decode step; with no `rcfg` the kernel ops refuse the device."""
    cfg = port_cfg(j_reduced(j_get(arch)))
    meta = torch.device("meta")
    tokens = torch.empty((B, S), dtype=torch.long, device=meta)
    if cfg.encoder is not None:
        model = EncDec(cfg, XLA, device=meta, init=False)
        frames = torch.empty((B, S, cfg.d_model), device=meta)
        cross = make_prefill_step(model, rcfg=XLA)(frames)
        cache = init_encdec_cache(B, MAX_LEN, cfg, dtype=torch.float32,
                                  device=meta)
        logits, _ = make_decode_step(model, XLA)(cache, cross,
                                                 tokens[:, :1], S)
        with pytest.raises(ValueError, match="device meta"):
            make_prefill_step(model)(frames)
    else:
        model = LM(cfg, XLA, device=meta, init=False)
        logits, caches = make_prefill_step(model, max_len=MAX_LEN,
                                           rcfg=XLA)(tokens)
        logits, _ = make_decode_step(model, XLA)(caches, tokens[:, :1], S)
        with pytest.raises(ValueError, match="device meta"):
            make_prefill_step(model, max_len=MAX_LEN)(tokens)
        if cfg.family != "ssm":         # decode attention's kernel op
            with pytest.raises(ValueError, match="device meta"):
                make_decode_step(model)(
                    init_decode_cache(B, MAX_LEN, cfg, device=meta),
                    tokens[:, :1], S)
    assert logits.shape == (B, cfg.padded_vocab)
