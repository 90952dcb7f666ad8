"""The port's `RunConfig` against the reference's, and the knobs this
adds to the model: every field with the reference's default; the SSD's
`ssd_chunk` and `ssd_compute_dtype` against the reference's forward on
reduced mamba2-1.3b and hymba-1.5b (the training forward and the serving
prefill); the SSD kernel's refusal of a chunk no route holds; and serving
with the storage dtype left to its default computing what it computed
before the compute dtype and the storage dtype came apart, bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get as j_get
from repro.configs.base import RunConfig as JRunConfig, reduced as j_reduced
from repro.models import lm_forward as j_lm_forward, lm_prefill as j_prefill
from repro_torch.configs import get
from repro_torch.configs.base import ArchConfig, RunConfig, reduced
from repro_torch.kernels.ssd import ssd as ssd_op
from repro_torch.models import (EncDec, LM, encdec_decode_step,
                                encdec_prepare_cross, init_encdec_cache,
                                lm_decode_step, lm_forward, lm_from_numpy,
                                lm_prefill)
from repro_torch.models import attention, common, encdec, ffn, lm, moe, ssm
from test_torch_serve import seeded_params

F32_TOL, BF16_TOL = 2e-5, 2e-2
B, S = 2, 40          # padded to every chunk below


def rel_err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(np.max(np.abs(want)), 1e-30))


def test_every_field_of_the_references_with_its_default():
    ours = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    assert ours == ref


# --------------------------------------------------------------------------
# ssd_chunk and ssd_compute_dtype
# --------------------------------------------------------------------------

KNOBS = [dict(ssd_chunk=64), dict(ssd_chunk=256),
         dict(ssd_compute_dtype="bfloat16"),
         dict(ssd_chunk=64, ssd_compute_dtype="bfloat16")]


@pytest.fixture(scope="module", params=["mamba2-1.3b", "hymba-1.5b"])
def ssm_setup(request):
    jcfg = j_reduced(j_get(request.param))
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg)})
    params = seeded_params(jcfg, 2)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, params, tokens


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(
    f"{n}={v}" for n, v in k.items()))
def test_ssd_knobs_change_the_forward_as_the_references_do(ssm_setup, knobs):
    """fp32 compute with each knob: the training forward's logits and the
    serving prefill's last logits against the reference's (f32 2e-5, or
    2e-2 where x, B and C go in as bf16); the layers read the knobs."""
    jcfg, cfg, params, tokens = ssm_setup
    rcfg = RunConfig(kernels="xla", dtype="float32", remat=False, **knobs)
    jrcfg = JRunConfig(kernels="xla", dtype="float32", remat=False, **knobs)
    tol = BF16_TOL if "ssd_compute_dtype" in knobs else F32_TOL
    model = lm_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                          rcfg, device="cpu")
    mixers = [layer.ssm for layer in model.layers if hasattr(layer, "ssm")]
    assert mixers and all(
        m.chunk == (knobs.get("ssd_chunk") or cfg.ssm.chunk) and
        m.ssd_dtype == common.DTYPES[rcfg.ssd_compute_dtype]
        for m in mixers)
    want, _ = j_lm_forward(params, jnp.asarray(tokens), jcfg, jrcfg)
    with torch.no_grad():
        got, _ = lm_forward(model, torch.from_numpy(tokens), rcfg)
        last, _ = lm_prefill(model, torch.from_numpy(tokens))
    V = cfg.vocab_size
    assert rel_err(got[..., :V], np.asarray(want)[..., :V]) < tol
    jlast, _ = j_prefill(params, jnp.asarray(tokens), jcfg, jrcfg)
    assert rel_err(last[:, :V], np.asarray(jlast)[:, :V]) < tol


def test_ssd_knobs_move_the_logits(ssm_setup):
    """The knobs are not ignored: a chunk of 64 changes the fp32 logits
    by rounding only, bf16 x/B/C by more."""
    jcfg, cfg, params, tokens = ssm_setup
    tree = jax.tree_util.tree_map(np.asarray, params)
    out = {}
    for name, knobs in (("base", {}), ("chunk", dict(ssd_chunk=64)),
                        ("bf16", dict(ssd_compute_dtype="bfloat16"))):
        rcfg = RunConfig(kernels="xla", dtype="float32", remat=False,
                         **knobs)
        with torch.no_grad():
            out[name] = lm_forward(lm_from_numpy(cfg, tree, rcfg,
                                                 device="cpu"),
                                   torch.from_numpy(tokens), rcfg)[0]
    V = cfg.vocab_size
    assert 0 < rel_err(out["chunk"][..., :V], out["base"][..., :V]) < F32_TOL
    assert rel_err(out["bf16"][..., :V], out["base"][..., :V]) > F32_TOL


@pytest.mark.parametrize("chunk,dtype,route", [
    (128, torch.float32, "tensor_cores"), (64, torch.float32, "tensor_cores"),
    (64, torch.bfloat16, "tensor_cores"), (256, torch.float32, "cuda_cores"),
    (256, torch.bfloat16, "cuda_cores")])
def test_ssd_route_and_refusal_at_mamba2s_state(chunk, dtype, route):
    """At mamba2-1.3b's N 128, P 64: chunks 64 and 128 take the tensor
    cores in both dtypes and fit; a chunk of 256 goes to the CUDA-core
    route, whose block would need 332,800 bytes of shared memory, and is
    refused before launch with an error naming the chunk and N.  On the
    CPU the op runs the plain version at any chunk."""
    import importlib
    sk = importlib.import_module("repro_torch.kernels.ssd.ssd")
    H, P, N = 4, 64, 128
    x = torch.zeros((1, H, chunk, P), dtype=dtype)
    Bm = torch.zeros((1, 1, chunk, N), dtype=dtype)
    assert sk.route(x, Bm, Bm, chunk) == route
    if chunk <= sk.MAX_L:
        sk.check_fits(route, chunk, N, P, dtype)
    else:
        assert sk.smem_bytes(route, chunk, N, P, dtype) == 332_800
        with pytest.raises(ValueError, match=f"chunk {chunk} at N {N}"):
            sk.check_fits(route, chunk, N, P, dtype)
    y = ssd_op(x, torch.zeros((1, H, chunk)), -torch.ones(H),
               torch.ones(H), Bm, Bm, chunk=chunk)
    assert y.shape == x.shape


# --------------------------------------------------------------------------
# Serving with the storage dtype left to its default
# --------------------------------------------------------------------------

def _old_dense(x, w, b=None, dtype=None):
    y = x.to(w.dtype) @ w
    if b is not None:
        y = y + b.to(w.dtype)
    return y


def _old_embed(table, tokens, dtype=None):
    return common.settle_partial(F.embedding(tokens, table))


def _old_unembed(table, x, dtype=None):
    return x.float() @ table.float().t()


SERVED = ("gemma2-2b", "mamba2-1.3b", "hymba-1.5b", "qwen2-moe-a2.7b",
          "internvl2-26b", "chatglm3-6b")


def _serve(model, cfg, tokens, patches):
    with torch.no_grad():
        lg, caches = lm_prefill(model, tokens, max_len=S + 3,
                                patch_embeds=patches)
        out = [lg]
        for i in range(3):
            lg, caches = lm_decode_step(model, caches, tokens[:, i:i + 1],
                                        S + i)
            out.append(lg)
    return torch.stack(out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serving_is_unchanged_bit_for_bit(dtype, monkeypatch):
    """For six served archs, a prefill and 3 decode steps of a model
    built for serving (storage = compute dtype): the matmul weights are
    stored in the compute dtype (no served model grows), and the logits
    equal, bit for bit, those of the products without the new casts."""
    rcfg = RunConfig(dtype=dtype)
    got, want = {}, {}
    rng = np.random.default_rng(5)
    for arch in SERVED:
        cfg = reduced(get(arch))
        model = LM(cfg, rcfg, seed=1, device="cpu")
        assert model.embed.dtype == common.DTYPES[dtype]
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        patches = None
        if cfg.vision is not None:
            patches = torch.from_numpy(rng.standard_normal(
                (B, cfg.vision.n_patches, cfg.vision.patch_embed_dim))
                .astype(np.float32))
        got[arch] = _serve(model, cfg, tokens, patches)
        with monkeypatch.context() as m:
            for mod in (attention, ffn, moe, ssm, lm, encdec):
                if hasattr(mod, "dense"):
                    m.setattr(mod, "dense", _old_dense)
            for mod in (lm, encdec):
                m.setattr(mod, "embed", _old_embed)
            m.setattr(lm, "unembed", _old_unembed)
            want[arch] = _serve(model, cfg, tokens, patches)
        assert torch.equal(got[arch], want[arch]), arch


def test_encdec_serving_is_unchanged_bit_for_bit(monkeypatch):
    cfg = reduced(get("seamless-m4t-large-v2"))
    model = EncDec(cfg, RunConfig(), seed=1, device="cpu")
    assert model.lm_head.dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.standard_normal((B, 24, cfg.d_model))
                              .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 4)))

    def run():
        with torch.no_grad():
            cross = encdec_prepare_cross(model, frames)
            cache = init_encdec_cache(B, 8, cfg, device="cpu")
            out = []
            for i in range(4):
                lg, cache = encdec_decode_step(model, cache, cross,
                                               tokens[:, i:i + 1], i)
                out.append(lg)
        return torch.stack(out)

    got = run()
    monkeypatch.setattr(encdec, "dense", _old_dense)
    monkeypatch.setattr(encdec, "embed", _old_embed)
    monkeypatch.setattr(attention, "dense", _old_dense)
    monkeypatch.setattr(ffn, "dense", _old_dense)
    assert torch.equal(got, run())
