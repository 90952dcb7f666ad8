"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: run them where there is a GPU with

    PYTHONPATH=src python3 -m pytest -m cuda tests/test_torch_kernels_cuda.py

Elsewhere every test skips from inside the `cuda` fixture.  This file
imports only torch and repro_torch (the machine with the card has no JAX).

Error is relative to max|plain|: 2e-2 for bfloat16; 1e-4 for float32,
since the kernel sums up to 4,608 keys in another order than the plain
version (both in fp32, TF32 off).
"""

import importlib

import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

pytestmark = pytest.mark.cuda

FA = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
DA = importlib.import_module(
    "repro_torch.kernels.decode_attention.decode_attention")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]

FLASH_CASES = [
    dict(B=2, Hq=4, Hkv=2, S=256, D=64, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=4, Hkv=4, S=512, D=64, causal=True, window=128, cap=0.0),
    dict(B=1, Hq=2, Hkv=1, S=256, D=128, causal=True, window=0, cap=50.0),
    dict(B=1, Hq=2, Hkv=2, S=128, D=64, causal=False, window=0, cap=0.0),
    dict(B=1, Hq=2, Hkv=1, S=256, D=256, causal=True, window=64, cap=50.0),
    # ragged lengths, Sq != Sk, and a window without causality
    dict(B=2, Hq=8, Hkv=4, S=333, D=256, causal=True, window=100, cap=50.0),
    dict(B=1, Hq=4, Hkv=2, S=200, Sk=277, D=128, causal=True, window=0,
         cap=0.0),
    dict(B=1, Hq=4, Hkv=2, S=190, D=64, causal=False, window=50, cap=0.0),
    # gemma2 main path: full and local layers of a 4,608-token prefill
    dict(B=4, Hq=8, Hkv=4, S=4608, D=256, causal=True, window=0, cap=50.0),
    dict(B=4, Hq=8, Hkv=4, S=4608, D=256, causal=True, window=4096,
         cap=50.0),
]
DECODE_CASES = [
    dict(B=2, Hq=8, Hkv=2, S=512, D=64, kvlen=300, win=0, cap=0.0),
    dict(B=1, Hq=4, Hkv=4, S=1024, D=128, kvlen=1024, win=0, cap=0.0),
    dict(B=2, Hq=8, Hkv=4, S=2048, D=64, kvlen=1500, win=256, cap=0.0),
    dict(B=1, Hq=8, Hkv=1, S=300, D=128, kvlen=299, win=0, cap=30.0),
] + [
    # gemma2 main path: a cache of max_len 4,640
    dict(B=4, Hq=8, Hkv=4, S=4640, D=256, kvlen=n, win=w, cap=50.0)
    for n in (1, 17, 4097, 4608) for w in (4096, 0)
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _rel_err(got, want) -> float:
    torch.cuda.synchronize()
    want = want.float()
    return float((got.float() - want).abs().max() /
                 want.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_vs_plain(cuda, case, dtype):
    B, Hq, Hkv, S, D = (case[k] for k in ("B", "Hq", "Hkv", "S", "D"))
    Sk = case.get("Sk", S)
    q = _randn((B, Hq, S, D), dtype, cuda, 1)
    k = _randn((B, Hkv, Sk, D), dtype, cuda, 2)
    v = _randn((B, Hkv, Sk, D), dtype, cuda, 3)
    kw = dict(causal=case["causal"], window=case["window"],
              softcap=case["cap"], scale=D ** -0.5)
    before = FA.launches
    out = flash_attention(q, k, v, **kw)
    assert FA.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _rel_err(out, attention_ref(q, k, v, **kw)) < TOL[dtype]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_vs_plain(cuda, case, dtype):
    B, Hq, Hkv, S, D = (case[k] for k in ("B", "Hq", "Hkv", "S", "D"))
    q = _randn((B, Hq, D), dtype, cuda, 4)
    k = _randn((B, Hkv, S, D), dtype, cuda, 5)
    v = _randn((B, Hkv, S, D), dtype, cuda, 6)
    kw = dict(window=case["win"], softcap=case["cap"])
    want = decode_attention_ref(q, k, v, kv_len=case["kvlen"], **kw)
    before = DA.launches
    out = decode_attention(q, k, v, kv_len=case["kvlen"], **kw)
    dev_len = torch.tensor(case["kvlen"], dtype=torch.int32, device=cuda)
    out_dev = decode_attention(q, k, v, kv_len=dev_len, **kw)
    assert DA.launches == before + 2
    assert out.dtype == dtype and out.shape == q.shape
    assert _rel_err(out, want) < TOL[dtype]
    assert torch.equal(out, out_dev)


def test_decode_unaligned_and_strided_inputs(cuda):
    """A cache slice that is not 16-byte aligned, and a strided q."""
    q = _randn((2, 4, 2, 128), torch.bfloat16, cuda, 7)[:, :, 1]
    big = _randn((2 * 2 * 65 * 128 + 1,), torch.bfloat16, cuda, 8)
    k = big[1:].view(2, 2, 65, 128)
    v = _randn((2, 2, 65, 128), torch.bfloat16, cuda, 9)
    out = decode_attention(q, k, v, kv_len=40)
    want = decode_attention_ref(q, k, v, kv_len=40)
    assert _rel_err(out, want) < TOL[torch.bfloat16]


def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    fops = importlib.import_module(
        "repro_torch.kernels.flash_attention.ops")
    dops = importlib.import_module(
        "repro_torch.kernels.decode_attention.ops")

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fops, "attention_ref", refuse)
    monkeypatch.setattr(dops, "decode_attention_ref", refuse)
    q = _randn((1, 2, 64, 64), torch.float32, cuda, 10)
    flash_attention(q, q[:, :1], q[:, :1])
    decode_attention(q[:, :, 0], q[:, :1], q[:, :1], kv_len=3)


def test_unsupported_shapes_raise(cuda):
    q = torch.zeros(1, 2, 16, 96, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    h = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(h, h, h)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], q, q, kv_len=3)
