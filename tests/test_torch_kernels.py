"""The port's attention ops on the CPU (their plain versions) against the
JAX Pallas kernels in interpret mode and the JAX references, on the cases
of tests/test_kernels.py plus gemma2's head_dim 256 with softcap 50.

Inputs are drawn once in float32 with numpy and rounded to the working
dtype by each framework (both round to nearest even, so the operands are
identical).  Error is relative to max|reference|: 2e-5 for float32 and
2e-2 for bfloat16, the rule of tests/test_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (decode_attention as j_decode,
                                            decode_attention_ref as j_dref)
from repro.kernels.flash_attention import (attention_ref as j_fref,
                                           flash_attention as j_flash)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

FLASH_CASES = [
    dict(B=2, Hq=4, Hkv=2, S=256, D=64, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=4, Hkv=4, S=512, D=64, causal=True, window=128, cap=0.0),
    dict(B=1, Hq=2, Hkv=1, S=256, D=128, causal=True, window=0, cap=50.0),
    dict(B=1, Hq=2, Hkv=2, S=128, D=64, causal=False, window=0, cap=0.0),
    # gemma2: head_dim 256, softcap 50, query scale 1/16, local window
    dict(B=1, Hq=2, Hkv=1, S=256, D=256, causal=True, window=64, cap=50.0,
         scale=1 / 16),
]
DECODE_CASES = [
    dict(B=2, Hq=8, Hkv=2, S=512, D=64, kvlen=300, win=0, cap=0.0),
    dict(B=1, Hq=4, Hkv=4, S=1024, D=128, kvlen=1024, win=0, cap=0.0),
    dict(B=2, Hq=8, Hkv=4, S=2048, D=64, kvlen=1500, win=256, cap=0.0),
    dict(B=1, Hq=8, Hkv=4, S=256, D=256, kvlen=200, win=64, cap=50.0,
         scale=1 / 16),
]


def _inputs(shapes, dtype, seed=42, scale=0.5):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _rel_err(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                     jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else
                      jnp.asarray(want, jnp.float32), np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-6))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas_and_ref(case, dtype):
    B, Hq, Hkv, S, D = (case[k] for k in ("B", "Hq", "Hkv", "S", "D"))
    kw = dict(causal=case["causal"], window=case["window"],
              softcap=case["cap"], scale=case.get("scale"))
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    out = flash_attention(q, k, v, **kw)
    assert out.dtype == TDT[dtype] and out.shape == q.shape
    pallas = j_flash(jq, jk, jv, block_q=128, block_k=128,
                     backend="pallas", interpret=True, **kw)
    ref = j_fref(jq, jk, jv, **kw)
    assert _rel_err(out, pallas) < TOL[dtype]
    assert _rel_err(out, ref) < TOL[dtype]
    assert _rel_err(attention_ref(q, k, v, **kw), out) == 0.0


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_pallas_and_ref(case, dtype):
    B, Hq, Hkv, S, D = (case[k] for k in ("B", "Hq", "Hkv", "S", "D"))
    kw = dict(window=case["win"], softcap=case["cap"],
              scale=case.get("scale"))
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    out = decode_attention(q, k, v, kv_len=case["kvlen"], **kw)
    assert out.dtype == TDT[dtype] and out.shape == q.shape
    pallas = j_decode(jq, jk, jv, kv_len=case["kvlen"], block_k=256,
                      backend="pallas", interpret=True, **kw)
    ref = j_dref(jq, jk, jv, kv_len=case["kvlen"], **kw)
    assert _rel_err(out, pallas) < TOL[dtype]
    assert _rel_err(out, ref) < TOL[dtype]
    assert _rel_err(decode_attention_ref(q, k, v, kv_len=case["kvlen"],
                                         **kw), out) == 0.0


@pytest.mark.parametrize("kvlen", [17, 100, 256])
def test_decode_kv_len_tensor(kvlen):
    """kv_len may be a 0-d int32 tensor (decode loops never read it on
    the host)."""
    (jq, jk, jv), (q, k, v) = _inputs(
        [(1, 4, 64), (1, 2, 256, 64), (1, 2, 256, 64)], "float32", scale=1)
    out = decode_attention(q, k, v,
                           kv_len=torch.tensor(kvlen, dtype=torch.int32))
    pallas = j_decode(jq, jk, jv, kv_len=jnp.int32(kvlen), block_k=128,
                      backend="pallas", interpret=True)
    assert _rel_err(out, pallas) < TOL["float32"]
    assert _rel_err(out, decode_attention(q, k, v, kv_len=kvlen)) == 0.0


def test_group_mismatch_raises():
    q = torch.zeros(1, 3, 8, 64)
    kv = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], kv, kv, kv_len=4)


def test_unsupported_device_raises():
    q = torch.zeros(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], q, q, kv_len=4)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a plain version: a CPU tensor is an
    error there, not a fallback."""
    import importlib
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    da = importlib.import_module(
        "repro_torch.kernels.decode_attention.decode_attention")
    q = torch.zeros(1, 2, 8, 64)
    before = (fa.launches, da.launches)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q[:, :, 0], q, q, kv_len=4)
    assert (fa.launches, da.launches) == before


def test_device_resolution_and_missing_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import runtime
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert runtime.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            runtime.resolve_device()
    # a build without nvcc raises instead of falling back
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        runtime.load("decode_attention")
    assert runtime.library_path("decode_attention").name.startswith(
        "libdecode_attention-")
