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
from repro_torch.kernels.ssd import ssd, ssd_chunked_ref, ssd_ref

pytestmark = pytest.mark.cuda

FA = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
DA = importlib.import_module(
    "repro_torch.kernels.decode_attention.decode_attention")
SK = importlib.import_module("repro_torch.kernels.ssd.ssd")
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

SSD_CASES = [
    dict(B=2, H=4, G=2, S=256, P=32, N=64, chunk=64),
    dict(B=1, H=8, G=1, S=128, P=64, N=32, chunk=32),
    # reduced mamba2 (chunk 32, N 32, P 16); four groups at the full
    # chunk; chunk 96, whose second 64-row tile is partial, with P and N
    # off the 64-wide output tiles
    dict(B=2, H=16, G=1, S=96, P=16, N=32, chunk=32),
    dict(B=2, H=8, G=4, S=384, P=64, N=128, chunk=128),
    dict(B=1, H=4, G=1, S=192, P=48, N=80, chunk=96),
    # mamba2-1.3b main path: 4 x 4,608 tokens, 64 heads, one group
    dict(B=4, H=64, G=1, S=4608, P=64, N=128, chunk=128),
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
    sops = importlib.import_module("repro_torch.kernels.ssd.ops")

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fops, "attention_ref", refuse)
    monkeypatch.setattr(dops, "decode_attention_ref", refuse)
    monkeypatch.setattr(sops, "ssd_chunked_ref", refuse)
    q = _randn((1, 2, 64, 64), torch.float32, cuda, 10)
    flash_attention(q, q[:, :1], q[:, :1])
    decode_attention(q[:, :, 0], q[:, :1], q[:, :1], kv_len=3)
    ssd(*_ssd_inputs(dict(B=1, H=2, G=1, S=64, P=16, N=16), torch.float32,
                     cuda, 16), chunk=32, return_state=True)


def test_unsupported_shapes_raise(cuda):
    q = torch.zeros(1, 2, 16, 96, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    h = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(h, h, h)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], q, q, kv_len=3)


def _ssd_inputs(case, dtype, dev, seed):
    B, H, G, S, P, N = (case[k] for k in "BHGSPN")
    g = torch.Generator(dev).manual_seed(seed)

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)
    x = torch.randn((B, H, S, P), generator=g, device=dev).to(dtype)
    dt = uniform(0.001, 0.1, (B, H, S))
    A = -uniform(0.5, 2.0, (H,))
    D = torch.randn((H,), generator=g, device=dev)
    Bm = (0.3 * torch.randn((B, G, S, N), generator=g, device=dev)).to(dtype)
    Cm = (0.3 * torch.randn((B, G, S, N), generator=g, device=dev)).to(dtype)
    return x, dt, A, D, Bm, Cm


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_vs_plain(cuda, case, dtype):
    args = _ssd_inputs(case, dtype, cuda, 11)
    want_y, want_state = ssd_chunked_ref(*args, chunk=case["chunk"],
                                         return_state=True)
    before = SK.launches
    y, state = ssd(*args, chunk=case["chunk"], return_state=True)
    assert SK.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    assert state.dtype == torch.float32
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


def test_ssd_kernel_vs_sequential_scan(cuda):
    """The ground truth: the step-by-step recurrence, state included."""
    case = SSD_CASES[0]
    args = _ssd_inputs(case, torch.float32, cuda, 12)
    want_y, want_state = ssd_ref(*args, return_state=True)
    y, state = ssd(*args, chunk=case["chunk"], return_state=True)
    assert _rel_err(y, want_y) < TOL[torch.float32]
    assert _rel_err(state, want_state) < TOL[torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_reads_views_of_the_model_layout(cuda, dtype):
    """x, dt, B and C as the SSM layer passes them: (B, H, S, ...) views of
    one (B, S, conv_dim) tensor and a (B, S, H) one, read through their
    strides without copies; y comes back as a view of (B, S, H, P)."""
    B, H, G, S, P, N, chunk = 2, 8, 2, 256, 32, 64, 64
    g = torch.Generator(cuda).manual_seed(16)
    xbc = (0.3 * torch.randn((B, S, H * P + 2 * G * N), generator=g,
                             device=cuda)).to(dtype)
    dt = 0.001 + 0.099 * torch.rand((B, S, H), generator=g, device=cuda)
    xs, Bs, Cs = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x = xs.reshape(B, S, H, P).transpose(1, 2)
    Bm = Bs.reshape(B, S, G, N).transpose(1, 2)
    Cm = Cs.reshape(B, S, G, N).transpose(1, 2)
    A = -torch.arange(1, H + 1, device=cuda, dtype=torch.float32)
    D = torch.ones(H, device=cuda)
    args = (x, dt.transpose(1, 2), A, D, Bm, Cm)
    want_y, want_state = ssd_chunked_ref(*args, chunk=chunk,
                                         return_state=True)
    y, state = ssd(*args, chunk=chunk, return_state=True)
    assert y.shape == x.shape and y.transpose(1, 2).is_contiguous()
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]
    same_y, same_state = ssd(*(t.contiguous() for t in args), chunk=chunk,
                             return_state=True)
    assert torch.equal(y, same_y) and torch.equal(state, same_state)


def test_ssd_zero_dt_padding_keeps_the_state(cuda):
    """Steps padded with zero dt, x, B and C leave the final state as it
    was at the last real step (the model pads S to the chunk so)."""
    case = dict(B=1, H=4, G=1, S=96, P=64, N=128, chunk=32)
    x, dt, A, D, Bm, Cm = _ssd_inputs(case, torch.float32, cuda, 13)
    _, want = ssd(x, dt, A, D, Bm, Cm, chunk=32, return_state=True)
    pad = [torch.nn.functional.pad(t, (0, 0, 0, 64)) for t in (x, Bm, Cm)]
    _, got = ssd(pad[0], torch.nn.functional.pad(dt, (0, 64)), A, D,
                 pad[1], pad[2], chunk=32, return_state=True)
    assert _rel_err(got, want) < TOL[torch.float32]


def test_ssd_unsupported_shapes_raise(cuda):
    case = dict(B=1, H=2, G=1, S=64, P=16, N=16, chunk=32)
    args = _ssd_inputs(case, torch.float32, cuda, 14)
    with pytest.raises(ValueError):
        ssd(*args, chunk=48)              # S % chunk
    with pytest.raises(ValueError):
        SK.ssd_cuda(*args, chunk=16)      # chunk not a multiple of 32
    x, dt, A, D, Bm, Cm = args
    with pytest.raises(TypeError):
        ssd(x.half(), dt, A, D, Bm.half(), Cm.half(), chunk=32)
    big = dict(B=1, H=1, G=1, S=256, P=256, N=256, chunk=256)
    with pytest.raises(RuntimeError):     # tiles over 227 KB of smem
        ssd(*_ssd_inputs(big, torch.float32, cuda, 15), chunk=256)
