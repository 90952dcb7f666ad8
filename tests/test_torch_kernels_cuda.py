"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: run them where there is a GPU with

    PYTHONPATH=src python3 -m pytest -m cuda tests/test_torch_kernels_cuda.py

Elsewhere every test skips from inside the `cuda` fixture.  This file
imports only torch and repro_torch (the machine with the card has no JAX).

Error is relative to max|plain|: 2e-2 for bfloat16; 1e-4 for float32,
since the kernel sums up to 4,608 keys in another order than the plain
version (both in fp32, TF32 off).  Flash attention's error is taken row by
row, each output row's against its own max|plain|, so that no row's
error hides under the largest row.  The copy and Init kernels move or make
bytes with at most one rounding, so they must equal their plain versions
bit for bit.
"""

import functools
import importlib

import pytest
import torch

from repro_torch.core import instream
from repro_torch.kernels.copy_engine import (copy_2d, copy_2d_ref,
                                             strided_copy_nd,
                                             strided_copy_nd_ref)

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.init_engine import (iota_fill, iota_fill_ref,
                                             memset, memset_ref, prng_fill,
                                             prng_fill_ref)
from repro_torch.kernels import runtime
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
    # the bf16 route's TMA tiles: Sq and Sk off the 128-row q and 64-row kv
    # tiles with Sk > Sq, so the last kv tile of a head is zero-filled past
    # Sk; D 64 and 128 at GQA groups 2 and 4; windows narrower than a kv
    # tile; B·Hq 264 and 288, more blocks than the card holds at once
    dict(B=2, Hq=4, Hkv=2, S=130, Sk=257, D=64, causal=False, window=0,
         cap=50.0),
    dict(B=2, Hq=4, Hkv=2, S=130, Sk=257, D=256, causal=True, window=0,
         cap=50.0),
    dict(B=2, Hq=8, Hkv=2, S=300, D=64, causal=True, window=0, cap=30.0),
    dict(B=1, Hq=8, Hkv=4, S=384, D=128, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=8, Hkv=2, S=200, Sk=321, D=128, causal=False, window=0,
         cap=50.0),
    dict(B=1, Hq=4, Hkv=2, S=300, D=128, causal=True, window=16, cap=50.0),
    dict(B=1, Hq=2, Hkv=1, S=250, D=64, causal=False, window=40, cap=0.0),
    dict(B=33, Hq=8, Hkv=4, S=200, D=128, causal=True, window=0, cap=50.0),
    dict(B=3, Hq=96, Hkv=24, S=257, D=64, causal=True, window=100,
         cap=0.0),
    # gemma2 main path: full and local layers of a 4,608-token prefill
    dict(B=4, Hq=8, Hkv=4, S=4608, D=256, causal=True, window=0, cap=50.0),
    dict(B=4, Hq=8, Hkv=4, S=4608, D=256, causal=True, window=4096,
         cap=50.0),
    # scores that reach the cap: q times qmul makes s·scale ~ N(0, qmul²),
    # |s| from about 10 to past 100, where cap·tanh(s/cap) is far from s
    # (at randn scale the two differ by s³/(3·cap²), too little to see)
    dict(B=2, Hq=4, Hkv=2, S=300, D=128, causal=True, window=0, cap=50.0,
         qmul=30.0),
    dict(B=1, Hq=4, Hkv=1, S=190, Sk=257, D=64, causal=False, window=0,
         cap=30.0, qmul=30.0),
    dict(B=1, Hq=4, Hkv=2, S=333, D=256, causal=True, window=100, cap=50.0,
         qmul=30.0),
    dict(B=4, Hq=8, Hkv=4, S=4608, D=256, causal=True, window=0, cap=50.0,
         qmul=30.0),
    # hymba-1.5b: GQA group 5 at head_dim 64 with a window, then its main
    # path, the windowed and full hybrid layers of a 4,608-token prefill
    dict(B=1, Hq=10, Hkv=2, S=256, D=64, causal=True, window=64, cap=0.0),
    dict(B=4, Hq=25, Hkv=5, S=4608, D=64, causal=True, window=1024,
         cap=0.0),
    dict(B=4, Hq=25, Hkv=5, S=4608, D=64, causal=True, window=0, cap=0.0),
    # the dense configs' layouts at head_dim 128, no softcap, S off the
    # 128-row q tile: GQA 5 (qwen2.5-32b), 6 (internlm2-20b,
    # internvl2-26b) and 16 (chatglm3-6b)
    dict(B=2, Hq=10, Hkv=2, S=333, D=128, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=12, Hkv=2, S=700, D=128, causal=True, window=0, cap=0.0),
    dict(B=2, Hq=32, Hkv=2, S=257, D=128, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=16, Hkv=1, S=190, Sk=321, D=128, causal=False, window=0,
         cap=0.0),
    # the MoE configs' main paths at head_dim 128: qwen2-moe-a2.7b's GQA
    # group 1 (16 q on 16 kv heads), causal, and mixtral-8x7b's group 4
    # with its window of 4,096, over a 4,608-token prefill; group 1 off
    # the q tile too
    dict(B=4, Hq=16, Hkv=16, S=4608, D=128, causal=True, window=0, cap=0.0),
    dict(B=4, Hq=32, Hkv=8, S=4608, D=128, causal=True, window=4096,
         cap=0.0),
    dict(B=2, Hq=4, Hkv=4, S=333, D=128, causal=True, window=0, cap=0.0),
    # the front door's admissions: one request's prefill at B 1 and its
    # own ragged length; hymba-1.5b (25 / 5 heads of 64) windowed past the
    # window and not, then full; chatglm3-6b (32 / 2 of 128, GQA 16);
    # qwen2-moe-a2.7b (16 / 16 of 128, GQA 1)
    dict(B=1, Hq=25, Hkv=5, S=33, D=64, causal=True, window=1024, cap=0.0),
    dict(B=1, Hq=25, Hkv=5, S=1200, D=64, causal=True, window=1024,
         cap=0.0),
    dict(B=1, Hq=25, Hkv=5, S=700, D=64, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=32, Hkv=2, S=33, D=128, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=32, Hkv=2, S=2500, D=128, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=16, Hkv=16, S=700, D=128, causal=True, window=0, cap=0.0),
    dict(B=1, Hq=16, Hkv=16, S=33, D=128, causal=True, window=0, cap=0.0),
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
] + [
    # GQA groups 5, 6 and 16 at each head_dim: kv_len 1, kv_len below the
    # key splits (64 at B·Hkv 1 over S 2,048; 16 over S 512; 33 at B 2,
    # Hkv 2, G 16 over S 4,640), windows that cut, a full cache
    dict(B=2, Hq=10, Hkv=2, S=700, D=64, kvlen=1, win=0, cap=0.0),
    dict(B=1, Hq=5, Hkv=1, S=2048, D=128, kvlen=5, win=0, cap=30.0),
    dict(B=2, Hq=5, Hkv=1, S=1000, D=256, kvlen=999, win=300, cap=50.0),
    dict(B=1, Hq=12, Hkv=2, S=4096, D=64, kvlen=4000, win=1000, cap=0.0),
    dict(B=3, Hq=12, Hkv=2, S=777, D=128, kvlen=1, win=16, cap=50.0),
    dict(B=1, Hq=6, Hkv=1, S=512, D=256, kvlen=9, win=0, cap=0.0),
    dict(B=1, Hq=16, Hkv=1, S=3000, D=64, kvlen=3000, win=0, cap=0.0),
    dict(B=2, Hq=32, Hkv=2, S=4640, D=128, kvlen=10, win=0, cap=50.0),
    dict(B=1, Hq=16, Hkv=1, S=1500, D=256, kvlen=1400, win=500, cap=50.0),
] + [
    # hymba-1.5b main path: group 5 at head_dim 64 over a 4,640-row cache
    dict(B=4, Hq=25, Hkv=5, S=4640, D=64, kvlen=n, win=w, cap=0.0)
    for n in (1, 4608) for w in (1024, 0)
] + [
    # the MoE configs' main paths over a 4,640-row cache: qwen2-moe-a2.7b
    # at GQA group 1 (16 / 16 heads of 128), mixtral-8x7b at group 4
    # (32 / 8) with its window of 4,096
    dict(B=4, Hq=16, Hkv=16, S=4640, D=128, kvlen=n, win=0, cap=0.0)
    for n in (1, 4097, 4608)
] + [
    dict(B=4, Hq=32, Hkv=8, S=4640, D=128, kvlen=n, win=4096, cap=0.0)
    for n in (17, 4608)
] + [
    # the front door's decode calls: one request a call (B 1, so its own
    # key splits) over a 4,640-row cache, after the shortest prompt and
    # after a long one; hymba-1.5b windowed and full, chatglm3-6b,
    # qwen2-moe-a2.7b
    dict(B=1, Hq=Hq, Hkv=Hkv, S=4640, D=D, kvlen=n, win=w, cap=0.0)
    for Hq, Hkv, D, w in ((25, 5, 64, 1024), (25, 5, 64, 0),
                          (32, 2, 128, 0), (16, 16, 128, 0))
    for n in (34, 2516)
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
    # hymba-1.5b's d_state 16 with a partial last 8-head block (10 = 8 + 2),
    # then its main path: 50 heads (6 x 8 + 2), N 16
    dict(B=2, H=10, G=1, S=96, P=64, N=16, chunk=32),
    dict(B=4, H=50, G=1, S=4608, P=64, N=16, chunk=128),
    # hymba-1.5b behind the front door: one request's 700-token prompt,
    # padded to the chunk
    dict(B=1, H=50, G=1, S=768, P=64, N=16, chunk=128),
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


def _row_rel_err(got, want) -> float:
    """The largest over rows of max|got − want| / max|want| in the row (a
    row with no live key is 0 on both sides)."""
    torch.cuda.synchronize()
    want = want.float()
    return float(((got.float() - want).abs().amax(-1) /
                  want.abs().amax(-1).clamp_min(1e-6)).max())


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_vs_plain(cuda, case, dtype):
    B, Hq, Hkv, S, D = (case[k] for k in ("B", "Hq", "Hkv", "S", "D"))
    Sk = case.get("Sk", S)
    q = _randn((B, Hq, S, D), torch.float32, cuda, 1)
    q = (q * case.get("qmul", 1.0)).to(dtype)
    k = _randn((B, Hkv, Sk, D), dtype, cuda, 2)
    v = _randn((B, Hkv, Sk, D), dtype, cuda, 3)
    kw = dict(causal=case["causal"], window=case["window"],
              softcap=case["cap"], scale=D ** -0.5)
    before = FA.launches
    out = flash_attention(q, k, v, **kw)
    assert FA.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _row_rel_err(out, attention_ref(q, k, v, **kw)) < TOL[dtype]


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


def test_decode_split_counters_return_to_zero(cuda):
    """The last block of each (b, kv head) returns its counter to 0, so a
    run of split calls on one stream gives the same output every time."""
    q = _randn((2, 16, 128), torch.bfloat16, cuda, 17)
    k = _randn((2, 1, 4640, 128), torch.bfloat16, cuda, 18)
    v = _randn((2, 1, 4640, 128), torch.bfloat16, cuda, 19)
    assert DA.num_splits(4, 4640, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    outs = [decode_attention(q, k, v, kv_len=n) for n in (4000, 4000, 77,
                                                          4000)]
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    counters, _ = DA._WORK[(cuda.index or 0, stream)]
    assert int(counters.abs().sum()) == 0
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[3])
    want = decode_attention_ref(q, k, v, kv_len=77)
    assert _rel_err(outs[2], want) < TOL[torch.bfloat16]


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
    g3 = torch.zeros(1, 3, 64, device=cuda)      # GQA group 3: no config
    before = DA.launches
    with pytest.raises(ValueError, match="group"):
        decode_attention(g3, q[:, :1, :, :64], q[:, :1, :, :64], kv_len=3)
    assert DA.launches == before


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


SSD_ROUTES = ["tensor_cores", "cuda_cores"]


def _ssd_view_inputs(B, H, G, S, P, N, dtype, dev, seed, off=0, A=None,
                     dt=None):
    """x, B and C as views of one (B, S, H·P + 2·G·N) tensor starting `off`
    elements in, dt of a (B, S, H) one: the SSM layer's layout.  A and dt
    default to mamba2's ranges; a number fills them."""
    g = torch.Generator(dev).manual_seed(seed)
    width = H * P + 2 * G * N
    flat = 0.3 * torch.randn(B * S * width + off, generator=g, device=dev)
    xbc = flat.to(dtype)[off:].view(B, S, width)
    xs, Bs, Cs = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    dtv = 0.001 + 0.099 * torch.rand((B, S, H), generator=g, device=dev)
    if dt is not None:
        dtv.fill_(dt)
    Av = -torch.arange(1, H + 1, device=dev, dtype=torch.float32) \
        if A is None else torch.tensor(A, device=dev).expand(H).contiguous()
    return (xs.reshape(B, S, H, P).transpose(1, 2), dtv.transpose(1, 2), Av,
            torch.ones(H, device=dev),
            *(t.reshape(B, S, G, N).transpose(1, 2) for t in (Bs, Cs)))


def _ssd_on(args, chunk, route):
    """ssd_cuda on `route`, checking that it counted one launch there."""
    before = dict(SK.launches_by_route)
    out = SK.ssd_cuda(*args, chunk=chunk, kernel_route=route)
    assert SK.launches_by_route[route] == before[route] + 1
    return out


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", SSD_ROUTES)
def test_ssd_kernel_on_each_route(cuda, case, dtype, route):
    """Every case on every route that takes it; the tensor-core route
    refuses, before any launch, what `route` would not give it."""
    args = _ssd_inputs(case, dtype, cuda, 21)
    chunk = case["chunk"]
    if route == "tensor_cores" and \
            SK.route(args[0], args[4], args[5], chunk) != route:
        before = SK.launches
        with pytest.raises(ValueError, match="route"):
            SK.ssd_cuda(*args, chunk=chunk, kernel_route=route)
        assert SK.launches == before
        return
    want_y, want_state = ssd_chunked_ref(*args, chunk=chunk,
                                         return_state=True)
    y, state = _ssd_on(args, chunk, route)
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", SSD_ROUTES)
def test_ssd_one_chunk(cuda, dtype, route):
    """S = L: no recurrence across chunks, the final state is the chunk's
    own."""
    args = _ssd_view_inputs(2, 8, 2, 128, 64, 128, dtype, cuda, 22)
    want_y, want_state = ssd_chunked_ref(*args, chunk=128, return_state=True)
    y, state = _ssd_on(args, 128, route)
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


@pytest.mark.parametrize("route", SSD_ROUTES)
def test_ssd_36_chunks_vs_sequential_scan(cuda, route):
    """mamba2-1.3b's 36 chunks of 128 against the step-by-step recurrence
    (the ground truth, not the chunked form the kernels share)."""
    args = _ssd_view_inputs(1, 4, 1, 36 * 128, 64, 128, torch.float32, cuda,
                            23)
    want_y, want_state = ssd_ref(*args, return_state=True)
    y, state = _ssd_on(args, 128, route)
    assert _rel_err(y, want_y) < TOL[torch.float32]
    assert _rel_err(state, want_state) < TOL[torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", SSD_ROUTES)
def test_ssd_decay_past_exp_overflow(cuda, dtype, route):
    """A −40 and dt 0.1: cum_t − cum_s reaches 508 above the diagonal,
    where exp overflows; both routes mask before the exponential."""
    args = _ssd_view_inputs(1, 4, 1, 512, 64, 128, dtype, cuda, 24, A=-40.0,
                            dt=0.1)
    want_y, want_state = ssd_ref(*args, return_state=True)
    y, state = _ssd_on(args, 128, route)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_route_follows_the_view(cuda, dtype):
    """The model's views take the tensor cores; the same views one element
    off a 16-byte boundary take the CUDA cores, with the same result."""
    shape = (2, 8, 1, 256, 64, 128)
    for off, want in ((0, "tensor_cores"), (1, "cuda_cores")):
        args = _ssd_view_inputs(*shape, dtype, cuda, 25, off=off)
        assert SK.route(args[0], args[4], args[5], 128) == want
        ref_y, ref_state = ssd_chunked_ref(*args, chunk=128,
                                           return_state=True)
        before = dict(SK.launches_by_route)
        y, state = ssd(*args, chunk=128, return_state=True)
        assert SK.launches_by_route[want] == before[want] + 1
        assert _rel_err(y, ref_y) < TOL[dtype]
        assert _rel_err(state, ref_state) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_main_shape_on_the_tensor_cores(cuda, dtype):
    """mamba2-1.3b's prefill shape on the model's views, through `ssd`."""
    args = _ssd_view_inputs(4, 64, 1, 4608, 64, 128, dtype, cuda, 26)
    before = dict(SK.launches_by_route)
    y, state = ssd(*args, chunk=128, return_state=True)
    assert SK.launches_by_route["tensor_cores"] == \
        before["tensor_cores"] + 1
    want_y, want_state = ssd_chunked_ref(*args, chunk=128, return_state=True)
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_hymba_shape_on_the_tensor_cores(cuda, dtype):
    """hymba-1.5b's prefill shape (50 heads, so a last block of 2 heads;
    d_state 16, so one warp's rows of N) on the model's views, through
    `ssd`, and again against the sequential scan over 4 heads."""
    args = _ssd_view_inputs(4, 50, 1, 4608, 64, 16, dtype, cuda, 27)
    assert SK.route(args[0], args[4], args[5], 128) == "tensor_cores"
    before = dict(SK.launches_by_route)
    y, state = ssd(*args, chunk=128, return_state=True)
    assert SK.launches_by_route["tensor_cores"] == \
        before["tensor_cores"] + 1
    want_y, want_state = ssd_chunked_ref(*args, chunk=128, return_state=True)
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]
    args = _ssd_view_inputs(1, 10, 1, 1024, 64, 16, dtype, cuda, 28)
    want_y, want_state = ssd_ref(*args, return_state=True)
    y, state = _ssd_on(args, 128, "tensor_cores")
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


@pytest.mark.parametrize("S", [128, 2560])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_front_door_shape_on_the_tensor_cores(cuda, dtype, S):
    """hymba-1.5b's SSD behind the front door: one request (B 1) on the
    model's views, its 33- and 2,500-token prompts padded to the chunk,
    through `ssd` on the tensor cores."""
    args = _ssd_view_inputs(1, 50, 1, S, 64, 16, dtype, cuda, 29)
    assert SK.route(args[0], args[4], args[5], 128) == "tensor_cores"
    before = dict(SK.launches_by_route)
    y, state = ssd(*args, chunk=128, return_state=True)
    assert SK.launches_by_route["tensor_cores"] == \
        before["tensor_cores"] + 1
    want_y, want_state = ssd_chunked_ref(*args, chunk=128, return_state=True)
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


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
    before = SK.launches
    with pytest.raises(ValueError, match="shared memory"):  # over 227 KB
        ssd(*_ssd_inputs(big, torch.float32, cuda, 15), chunk=256)
    assert SK.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_mamba2_chunk_64_on_the_tensor_cores(cuda, dtype):
    """`RunConfig(ssd_chunk=64)` at mamba2-1.3b's prefill shape on the
    model's views: the tensor-core route, against the plain version at
    chunk 64."""
    args = _ssd_view_inputs(4, 64, 1, 4608, 64, 128, dtype, cuda, 29)
    assert SK.route(args[0], args[4], args[5], 64) == "tensor_cores"
    before = dict(SK.launches_by_route)
    y, state = ssd(*args, chunk=64, return_state=True)
    assert SK.launches_by_route["tensor_cores"] == \
        before["tensor_cores"] + 1
    want_y, want_state = ssd_chunked_ref(*args, chunk=64, return_state=True)
    assert _rel_err(y, want_y) < TOL[dtype]
    assert _rel_err(state, want_state) < TOL[dtype]


@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_bf16_compute_on_the_tensor_cores(cuda, chunk):
    """`RunConfig(ssd_compute_dtype="bfloat16")` hands the scan x, B and C
    cast to bf16 (fresh dense tensors) and dt in fp32: the tensor-core
    route, against the plain version of the same operands."""
    view = _ssd_view_inputs(4, 64, 1, 4608, 64, 128, torch.float32, cuda,
                            30)
    x, dt, A, D, Bm, Cm = view
    args = (x.bfloat16(), dt, A, D, Bm.bfloat16(), Cm.bfloat16())
    assert SK.route(args[0], args[4], args[5], chunk) == "tensor_cores"
    before = dict(SK.launches_by_route)
    y, state = ssd(*args, chunk=chunk, return_state=True)
    assert SK.launches_by_route["tensor_cores"] == \
        before["tensor_cores"] + 1
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want_y, want_state = ssd_chunked_ref(*args, chunk=chunk,
                                         return_state=True)
    assert _rel_err(y, want_y) < TOL[torch.bfloat16]
    assert _rel_err(state, want_state) < TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunk_256_at_mamba2s_state_is_refused(cuda, dtype):
    """`ssd_chunk=256` at N 128, P 64: over the tensor-core route's chunk
    of 128, and the CUDA-core route would need 332,800 bytes of shared
    memory a block; refused before launch with an error naming it, and
    never sent to the plain version."""
    args = _ssd_view_inputs(1, 8, 1, 512, 64, 128, dtype, cuda, 31)
    before = (SK.launches, dict(SK.launches_by_route))
    with pytest.raises(ValueError, match="chunk 256 at N 128"):
        ssd(*args, chunk=256)
    assert (SK.launches, dict(SK.launches_by_route)) == before


# --------------------------------------------------------------------------
# The copy and Init engines: kernel == plain version, bit for bit
# --------------------------------------------------------------------------

EVERY_DTYPE = [torch.float32, torch.bfloat16, torch.float16, torch.int8,
               torch.uint8, torch.bool, torch.int16, torch.uint16,
               torch.int32, torch.uint32]
FLOATS = (torch.float32, torch.bfloat16, torch.float16)
SHAPES = [(8, 128), (100, 300), (3, 5), (256, 512)]
CE = importlib.import_module("repro_torch.kernels.copy_engine.copy_engine")
IE = importlib.import_module("repro_torch.kernels.init_engine.init_engine")


def _bits_equal(got, want) -> bool:
    torch.cuda.synchronize()
    return got.shape == want.shape and got.dtype == want.dtype and \
        bool(torch.equal(got.contiguous().view(torch.uint8),
                         want.contiguous().view(torch.uint8)))


def _any(shape, dtype, dev, seed):
    x = _randn(shape, torch.float32, dev, seed) * 100
    return x.to(dtype) if dtype in FLOATS else x.to(torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", EVERY_DTYPE)
@pytest.mark.parametrize("shape", SHAPES)
def test_memset_kernel_vs_plain(cuda, shape, dtype):
    for value in (2.5, 300, -1, 0):
        before = IE.memset_launches
        got = memset(shape, value, dtype, cuda)
        assert IE.memset_launches == before + 1
        assert _bits_equal(got, memset_ref(shape, value, dtype, cuda))


@pytest.mark.parametrize("dtype", EVERY_DTYPE)
@pytest.mark.parametrize("shape", SHAPES)
def test_iota_kernel_vs_plain(cuda, shape, dtype):
    for start in (3, (1 << 24) + (1 << 16) + 1, (1 << 31) - 700, -9):
        assert _bits_equal(iota_fill(shape, start, dtype, cuda),
                           iota_fill_ref(shape, start, dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.uint32, torch.float32,
                                   torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", SHAPES + [(256000, 2304)])
def test_prng_kernel_vs_plain(cuda, shape, dtype):
    """The last shape writes 2.36 GB in f32: byte offsets above 2^31."""
    for seed in (11, (1 << 32) - 1):
        assert _bits_equal(prng_fill(shape, seed, dtype, cuda),
                           prng_fill_ref(shape, seed, dtype, cuda))


def _copy_views(shape, dtype, dev, seed):
    x = _any((shape[0], shape[1] + 1), dtype, dev, seed)
    n = shape[0] * shape[1]
    return {"dense": x[:, 1:].contiguous(),
            "offset 1": x.reshape(-1)[1:1 + n].view(shape),
            "row tail view": x[:, 1:],
            "transposed": x[:, 1:].contiguous().t()}


@pytest.mark.parametrize("dtype", EVERY_DTYPE)
@pytest.mark.parametrize("shape", SHAPES)
def test_copy_2d_kernel_vs_plain(cuda, shape, dtype):
    transforms = [(None, None), (instream.identity, None),
                  (instream.zero, None)]
    if dtype in FLOATS:
        transforms += [(functools.partial(instream.scale, factor=f), None)
                       for f in (3.0, 0.1, -2)]
        transforms += [(functools.partial(instream.cast, dtype=to), to)
                       for to in FLOATS]
    for label, x in _copy_views(shape, dtype, cuda, 20).items():
        for t, out in transforms:
            got = copy_2d(x, t, out)
            assert got.is_contiguous(), label
            assert _bits_equal(got, copy_2d_ref(x, t, out)), (label, t)


def test_copy_2d_cast_above_2_31_bytes(cuda):
    """gemma2-2b's embedding table upcast, 2.36 GB written."""
    x = _randn((256000, 2304), torch.bfloat16, cuda, 21)
    up = functools.partial(instream.cast, dtype=torch.float32)
    assert _bits_equal(copy_2d(x, up, torch.float32),
                       copy_2d_ref(x, up, torch.float32))
    assert _bits_equal(copy_2d(x), copy_2d_ref(x))


# The copy's bulk route (the TMA's bulk copies): byte counts around a
# chunk (forced onto the route below its size threshold), every dtype on
# the route chosen, views it must refuse, sizes past 2^31 bytes; memset
# around a block's span (256 threads x 16 bytes), every dtype, past 2^31

SB = CE.BULK_CHUNK_BYTES
FB = 256 * 16
# ≥ 16 MiB (the copy's threshold) in every dtype, ragged 16-byte tails
ROWS, COLS = 4097, 4099
FILL_ROWS, FILL_COLS = 8193, 8195


def _route_count(counts, route, before):
    """One launch more than `before`, on `route`."""
    return counts[route] == before[route] + 1 and \
        sum(counts.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("nbytes", [7, 16, SB - 16, SB + 16, 3 * SB + 48,
                                    16 * 1000 + 7, 2000 * SB + 48])
def test_copy_bulk_byte_counts(cuda, nbytes):
    """One chunk or less, a chunk ± 16 bytes, ragged tails, and 2,001
    blocks, more than an SM's worth on every SM."""
    x = _any((1, nbytes), torch.int8, cuda, 30)
    before = dict(CE.copy_2d_launches_by_route)
    got = CE.copy_2d_cuda(x, kernel_route="bulk")
    assert _route_count(CE.copy_2d_launches_by_route, "bulk", before)
    assert _bits_equal(got, copy_2d_ref(x))


def test_copy_bulk_zero_bytes_writes_nothing(cuda):
    x = torch.ones(64, dtype=torch.uint8, device=cuda)
    y = torch.zeros(64, dtype=torch.uint8, device=cuda)
    lib = CE._lib()
    err = lib.copy_bulk(x.data_ptr(), y.data_ptr(), 0,
                        torch.cuda.current_stream().cuda_stream)
    assert err == 0 and int(y.sum()) == 0


@pytest.mark.parametrize("dtype", EVERY_DTYPE)
def test_copy_bulk_every_dtype(cuda, dtype):
    x = _any((ROWS, COLS), dtype, cuda, 31)
    assert CE.route(x) == "bulk"
    before = dict(CE.copy_2d_launches_by_route)
    got = copy_2d(x)
    assert _route_count(CE.copy_2d_launches_by_route, "bulk", before)
    assert _bits_equal(got, copy_2d_ref(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_copy_bulk_refuses_a_view_at_element_offset_1(cuda, dtype):
    x = _any((ROWS * COLS + 1,), dtype, cuda, 32)[1:].view(ROWS, COLS)
    assert CE.routes(x) == ("gather",)
    with pytest.raises(ValueError, match="does not take"):
        CE.copy_2d_cuda(x, kernel_route="bulk")
    before = dict(CE.copy_2d_launches_by_route)
    got = copy_2d(x)
    assert _route_count(CE.copy_2d_launches_by_route, "gather", before)
    assert _bits_equal(got, copy_2d_ref(x))


def test_copy_bulk_above_2_31_bytes(cuda):
    """2,147,581,953 bytes: chunk offsets past 2^31 and a 1-byte tail."""
    x = _any((65537, 32769), torch.int8, cuda, 33)
    before = dict(CE.copy_2d_launches_by_route)
    got = copy_2d(x)
    assert _route_count(CE.copy_2d_launches_by_route, "bulk", before)
    assert _bits_equal(got, copy_2d_ref(x))


def test_bulk_entries_refuse_unaligned_addresses(cuda):
    """The C entry returns an error, and the wrapper's check raises."""
    x = torch.zeros(1024, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    clib = CE._lib()
    for err in (clib.copy_bulk(x.data_ptr() + 1, x.data_ptr() + 512, 64,
                               stream),
                clib.copy_bulk(x.data_ptr(), x.data_ptr() + 520, 64,
                               stream)):
        assert err != 0
        with pytest.raises(RuntimeError, match="launch failed"):
            runtime.check(clib, err, "bulk")


MEMSET_PATTERNS = [(torch.bfloat16, -0.0), (torch.int8, 300),
                   (torch.float32, 2.5)]
MEMSET_BYTES = [16, FB - 16, FB + 16, 3 * FB + 48, 1056 * FB + 48,
                16 * 1000 + 6, 16 * 1000 + 7, 6]


@pytest.mark.parametrize("dtype,value,nbytes", [
    (dt, v, n) for dt, v in MEMSET_PATTERNS for n in MEMSET_BYTES
    if n % torch.empty((), dtype=dt).element_size() == 0])
def test_memset_around_a_block_span(cuda, dtype, value, nbytes):
    """Patterns whose bytes differ (bf16 −0.0 is 00 80, f32 2.5 00 00 20
    40), a block's span ± 16 bytes, ragged tails, and 1,057 blocks."""
    shape = (1, nbytes // torch.empty((), dtype=dtype).element_size())
    before = IE.memset_launches
    got = IE.memset_cuda(shape, value, dtype, cuda)
    assert IE.memset_launches == before + 1
    assert _bits_equal(got, memset_ref(shape, value, dtype, cuda))


@pytest.mark.parametrize("dtype", EVERY_DTYPE)
def test_memset_every_dtype(cuda, dtype):
    shape = (FILL_ROWS, FILL_COLS)
    for value in (2.5, 300, -1, -0.0):
        got = memset(shape, value, dtype, cuda)
        assert _bits_equal(got, memset_ref(shape, value, dtype, cuda))


def test_memset_above_2_31_bytes(cuda):
    """2,147,614,722 bytes of bf16 −0.0: offsets past 2^31, a 2-byte
    tail."""
    shape = (32769, 32769)
    got = memset(shape, -0.0, torch.bfloat16, cuda)
    assert _bits_equal(got, memset_ref(shape, -0.0, torch.bfloat16, cuda))


def _strided_views(dev):
    base = _any((4, 6, 5, 8, 12), torch.float32, dev, 22)
    shifted = _any((11521,), torch.bfloat16, dev, 23)[1:] \
        .view(4, 6, 5, 8, 12)
    xbc = _randn((2, 256, 4352), torch.float32, dev, 24)
    return {
        "5-D transposed": base.permute(4, 2, 0, 3, 1),
        "5-D offset 1": shifted,
        "5-D offset 1 transposed": shifted.permute(3, 1, 4, 0, 2),
        "expanded": base[0, 0, 0, 0, :1].expand(300, 257),
        "expanded rows": base[0, 0, :1].expand(7, 8, 12),
        "int8 sliced": base.to(torch.int8)[:, 1:, :, ::2, 3:],
        "uint16 step": base.to(torch.int64).to(torch.uint16)[..., ::3],
        "ssm heads": xbc[..., :4096].reshape(2, 256, 64, 64)
        .transpose(1, 2),
        "1-D": base.reshape(-1)[5:901],
        "0-D": base[1, 2, 3, 4, 5],
        "8 dims": _randn((2,) * 9, torch.float32, dev, 25)
        .permute(8, 6, 4, 2, 0, 1, 3, 5, 7)[..., 0],
    }


@pytest.mark.parametrize("view", ["5-D transposed", "5-D offset 1",
                                  "5-D offset 1 transposed", "expanded",
                                  "expanded rows", "int8 sliced",
                                  "uint16 step", "ssm heads", "1-D", "0-D",
                                  "8 dims"])
def test_strided_copy_nd_kernel_vs_plain(cuda, view):
    x = _strided_views(cuda)[view]
    before = CE.strided_copy_nd_launches
    got = strided_copy_nd(x)
    assert CE.strided_copy_nd_launches == before + 1
    assert got.is_contiguous()
    assert _bits_equal(got, strided_copy_nd_ref(x))


def test_strided_copy_nd_above_2_31_elements(cuda):
    """A stride-0 view of 2^31 + 2^24 one-byte elements: no wider unit,
    so the kernel takes its 64-bit index path."""
    rows = _any((2 ** 15 + 2 ** 8, 1), torch.int8, cuda, 26)
    x = rows.expand(rows.shape[0], 2 ** 16)
    got = strided_copy_nd(x)
    assert CE.gather_geometry(x)[2] == 1 and x.numel() > 2 ** 31
    assert _bits_equal(got, strided_copy_nd_ref(x))


def test_copy_and_init_refusals_on_card(cuda):
    x = torch.zeros(8, 128, device=cuda)
    before = (CE.copy_2d_launches, CE.strided_copy_nd_launches)
    with pytest.raises(NotImplementedError, match="fuses only"):
        copy_2d(x, lambda v: v + 1)
    with pytest.raises(NotImplementedError):
        copy_2d(x.to(torch.int32), functools.partial(instream.scale,
                                                     factor=2))
    with pytest.raises(ValueError, match="Invalid dtype for `swap`"):
        copy_2d(x, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Invalid dtype for `swap`"):
        copy_2d(x, instream.cast)
    with pytest.raises(ValueError, match="unsupported itemsize 8"):
        copy_2d(x.double())
    with pytest.raises(ValueError, match="unsupported itemsize 8"):
        strided_copy_nd(x.to(torch.int64))
    with pytest.raises(ValueError, match="2-D"):
        copy_2d(x[0])
    assert (CE.copy_2d_launches, CE.strided_copy_nd_launches) == before
    with pytest.raises(NotImplementedError, match="prng fill"):
        prng_fill((8, 128), 1, torch.float16, cuda)
    with pytest.raises(ValueError, match="unsupported itemsize 8"):
        memset((8, 128), 1, torch.int64, cuda)
    assert copy_2d(x, instream.cast, torch.bfloat16).dtype == torch.bfloat16


def test_copy_and_init_never_reach_the_plain_version(cuda, monkeypatch):
    cops = importlib.import_module("repro_torch.kernels.copy_engine.ops")
    iops = importlib.import_module("repro_torch.kernels.init_engine.ops")

    def refuse(*a, **k):
        raise AssertionError("plain version called on the card")

    for mod in (cops, iops):
        monkeypatch.setattr(mod, "ref", type("Refuse", (), {
            "__getattr__": lambda self, name: refuse})())
    x = _randn((8, 128), torch.float32, cuda, 27)
    copy_2d(x, functools.partial(instream.scale, factor=2.0))
    strided_copy_nd(x.t())
    memset((8, 128), 1.0, torch.float32, cuda)
    # the bulk routes
    copy_2d(_randn((2048, 2048), torch.float32, cuda, 28))
    memset((4096, 4096), 1.0, torch.float32, cuda)
    iota_fill((8, 128), 0, torch.int32, cuda)
    prng_fill((8, 128), 0, torch.float32)



# --------------------------------------------------------------------------
# The blocked matmul: fp32 sums, so 1e-4 for a float32 output and 2e-2 for
# a bfloat16 one (the output's rounding)
# --------------------------------------------------------------------------

MM = importlib.import_module("repro_torch.kernels.matmul_dma.matmul_dma")
MM_SHAPES = [(1, 1, 1), (1, 300, 257), (100, 200, 90), (129, 33, 130),
             (300, 700, 300), (64, 576, 64), (1100, 512, 300),
             (257, 1000, 383)]
MM_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32,
                                                torch.float32),
             (torch.bfloat16, torch.float32), (torch.float32,
                                               torch.bfloat16)]


def _mm_check(x, w, out_dtype=None, epilogue=None):
    from repro_torch.kernels.matmul_dma import matmul, matmul_ref
    before = MM.launches
    got = matmul(x, w, out_dtype, epilogue)
    want = matmul_ref(x, w, out_dtype, epilogue)
    assert MM.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < TOL[want.dtype]


@pytest.mark.parametrize("dtypes", MM_DTYPES)
@pytest.mark.parametrize("mkn", MM_SHAPES)
def test_matmul_kernel_vs_plain(cuda, mkn, dtypes):
    """Ragged M, N and K in every dtype pair, with x's dtype and with a
    float32 output; (300, 700, 300) and (64, 576, 64) are the shapes where
    the Pallas kernel gives NaN (K ragged across tiles)."""
    M, K, N = mkn
    x = _randn((M, K), dtypes[0], cuda, 30)
    w = _randn((K, N), dtypes[1], cuda, 31)
    _mm_check(x, w)
    _mm_check(x, w, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_kernel_reads_views(cuda, dtype):
    """Transposed, sliced, stepped and offset views of both operands."""
    big = _randn((300, 520), dtype, cuda, 32)
    x, w = big[:, :256], big[:256, 3:259]
    for xv, wv in ((x, w), (x.t()[:, :200], w[:200]), (x, w.t()),
                   (x.t(), w.t()), (big[1:, 1:257], w), (x, big[7:263, ::2]),
                   (big[::2, :256], big[:256, :300].t()[:, ::3])):
        xv, wv = xv[:, :wv.shape[0]], wv[:xv.shape[1]]
        _mm_check(xv, wv)
        _mm_check(xv, wv, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_kernel_fused_epilogues(cuda, dtype):
    import torch.nn.functional as F
    x = _randn((300, 700), dtype, cuda, 33)
    w = _randn((700, 260), dtype, cuda, 34) * 0.05
    for epi in (None, torch.relu, F.relu, F.silu,
                functools.partial(F.gelu, approximate="tanh"),
                instream.scale, functools.partial(instream.scale,
                                                  factor=-0.3)):
        _mm_check(x, w, None, epi)
        _mm_check(x, w, torch.float32, epi)


def test_matmul_kernel_decode_unembed(cuda):
    """gemma2's decode unembed at a cut vocabulary: x (4, 2,304) bf16 @
    table.t() into fp32, the table read k-major through its strides."""
    x = _randn((4, 2304), torch.bfloat16, cuda, 35)
    table = _randn((5003, 2304), torch.bfloat16, cuda, 36)
    _mm_route_check(x, table.t(), "wgmma_small_m", torch.float32)
    assert MM.tile_geometry(x, table.t()) == (True, True, True, True)


def _mm_route_check(x, w, route, out_dtype=None, epilogue=None):
    """_mm_check, and the launch went to `route`."""
    before = MM.launches_by_route[route]
    assert MM.route(x, w) == route
    _mm_check(x, w, out_dtype, epilogue)
    assert MM.launches_by_route[route] == before + 1


def _mm_weight(K, N, layout, dev, seed):
    """w (K, N): row-major (N-major, the models' weights) or the transpose
    of a row-major (N, K) table (K-major, the tied unembed)."""
    if layout == "n-major":
        return _randn((K, N), torch.bfloat16, dev, seed) * K ** -0.5
    return (_randn((N, K), torch.bfloat16, dev, seed) * K ** -0.5).t()


@pytest.mark.parametrize("w_layout", ["n-major", "k-major"])
@pytest.mark.parametrize("mkn", [(1000, 600, 392), (129, 1000, 264),
                                 (300, 72, 136)])
def test_matmul_wgmma_route_ragged_tiles(cuda, mkn, w_layout):
    """The wgmma route at shapes ragged against its 128 x 256 x 64 tiles
    but legal for TMA, into bf16 and fp32, with each fused epilogue."""
    import torch.nn.functional as F
    M, K, N = mkn
    x = _randn((M, K), torch.bfloat16, cuda, 40)
    w = _mm_weight(K, N, w_layout, cuda, 41)
    for epi in (None, torch.relu, F.relu, F.silu,
                functools.partial(F.gelu, approximate="tanh"),
                instream.scale, functools.partial(instream.scale,
                                                  factor=-0.3)):
        _mm_route_check(x, w, "wgmma", None, epi)
        _mm_route_check(x, w, "wgmma", torch.float32, epi)


@pytest.mark.parametrize("w_layout", ["n-major", "k-major"])
def test_matmul_wgmma_route_transposed_x(cuda, w_layout):
    """x M-major (a transposed view, wgmma's tnspA), at M 1,000 and at M
    64, where an M-major x stays on the large-M route."""
    for M in (1000, 64):
        x = _randn((600, M), torch.bfloat16, cuda, 42).t()
        w = _mm_weight(600, 392, w_layout, cuda, 43)
        _mm_route_check(x, w, "wgmma")
        _mm_route_check(x, w, "wgmma", torch.float32)


@pytest.mark.parametrize("w_layout", ["n-major", "k-major"])
@pytest.mark.parametrize("M", [1, 4, 16, 33, 64, 65, 128])
def test_matmul_small_m_threshold(cuda, M, w_layout):
    """Around the small-M threshold: M ≤ SMALL_M takes wgmma_small_m, M
    above it wgmma; K 2,304 as the models' d_model, N 1,000 ragged
    against both routes' tiles."""
    import torch.nn.functional as F
    x = _randn((M, 2304), torch.bfloat16, cuda, 44)
    w = _mm_weight(2304, 1000, w_layout, cuda, 45)
    route = "wgmma_small_m" if M <= MM.SMALL_M else "wgmma"
    _mm_route_check(x, w, route)
    _mm_route_check(x, w, route, torch.float32)
    _mm_route_check(x, w, route, None,
                    functools.partial(F.gelu, approximate="tanh"))


def test_matmul_routes_agree(cuda):
    """Every route that takes the operands gives the same product, each
    counted on its own route; a route that does not take them raises
    before any launch."""
    from repro_torch.kernels.matmul_dma import matmul_ref
    x = _randn((48, 1000), torch.bfloat16, cuda, 46)
    w = _mm_weight(1000, 264, "n-major", cuda, 47)
    assert MM.routes(x, w) == ("wgmma_small_m", "wgmma", "mma_sync")
    want = matmul_ref(x, w, torch.float32)
    for name in MM.routes(x, w):
        before = MM.launches_by_route[name]
        got = MM.matmul_cuda(x, w, torch.float32, kernel_route=name)
        assert MM.launches_by_route[name] == before + 1
        assert _rel_err(got, want) < TOL[torch.float32]
    before = dict(MM.launches_by_route)
    with pytest.raises(ValueError, match="route"):
        MM.matmul_cuda(x, w, kernel_route="fp32")
    with pytest.raises(ValueError, match="route"):
        MM.matmul_cuda(x[:, 1:], w[1:], kernel_route="wgmma")
    assert MM.launches_by_route == before


def test_matmul_refusals_raise_before_launch(cuda):
    from repro_torch.kernels.matmul_dma import matmul
    x, w = torch.ones(4, 8, device=cuda), torch.ones(8, 3, device=cuda)
    before = MM.launches
    with pytest.raises(ValueError, match="fuses only"):
        matmul(x, w, epilogue=lambda v: v + 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul(x.int(), w.int())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul(x, w, torch.float16)
    with pytest.raises(ValueError, match="contraction mismatch"):
        matmul(x, w.t())
    with pytest.raises(ValueError, match="2-D"):
        matmul(x[0], w)
    with pytest.raises(ValueError):
        matmul(x, w.cpu())
    assert MM.launches == before
    assert matmul(x[:0], w).shape == (0, 3) and MM.launches == before
    assert torch.equal(matmul(x[:, :0], w[:0]), torch.zeros(4, 3,
                                                            device=cuda))


def test_matmul_never_reaches_the_plain_version(cuda, monkeypatch):
    from repro_torch.kernels.matmul_dma import matmul
    mops = importlib.import_module("repro_torch.kernels.matmul_dma.ops")

    def refuse(*a, **k):
        raise AssertionError("plain version called on the card")

    monkeypatch.setattr(mops, "ref", type("Refuse", (), {
        "__getattr__": lambda self, name: refuse})())
    x = _randn((64, 96), torch.bfloat16, cuda, 37)
    assert matmul(x, x.t()).shape == (64, 64)
    assert matmul(x.float(), x.t(), torch.float32).dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_dispatch_gives_equal_bits_twice(cuda, dtype):
    """No atomics in the MoE combine: one full-width qwen2-moe-a2.7b MoE
    layer (60 experts top 4, capacity factor 1.25) over 512 tokens, the
    first 200 one repeated row so that pairs are dropped, twice on the
    card: y, the aux loss and the dropped share equal bit for bit."""
    from repro_torch.configs import get
    from repro_torch.models import moe
    cfg = get("qwen2-moe-a2.7b")
    mc = cfg.moe
    assert mc.capacity_factor == 1.25
    p = moe.MoE(cfg, dtype, cuda)
    g = torch.Generator(cuda).manual_seed(41)
    with torch.no_grad():
        for w in p.parameters():
            w.copy_(torch.randn(w.shape, generator=g, device=cuda)
                    * w.shape[-2] ** -0.5)
    x = _randn((512, cfg.d_model), dtype, cuda, 42)
    x[:200] = x[0]
    with torch.no_grad():
        a = moe.moe_dispatch_compute(p, x, mc, cfg.act)
        b = moe.moe_dispatch_compute(p, x, mc, cfg.act)
    assert 0 < float(a[2]) < 1
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_traced_decode_step_adds_no_synchronize(cuda):
    """The spans of a decode step read shapes, never values: a traced
    `lm_decode_step` (the profiler recording, so every span site records)
    of a reduced internlm2-20b (head size 128, GQA 2, bf16) through the
    flash and decode kernels runs under `set_sync_debug_mode("error")`,
    which raises on any synchronize."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.models import LM, lm_decode_step, lm_prefill

    cfg = reduced(get("internlm2-20b"), n_layers=2, d_model=512, n_heads=4,
                  n_kv_heads=2, d_ff=1024, vocab=512)
    model = LM(cfg, RunConfig(dtype="bfloat16"), seed=7, device=cuda)
    tokens = torch.randint(1, 512, (3, 40), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(8))
    _, caches = lm_prefill(model, tokens, max_len=64)
    nxt = tokens[:, -1:]
    lm_decode_step(model, caches, nxt, 40)          # warm: lazy set-up
    torch.cuda.synchronize()
    spans.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                lm_decode_step(model, caches, nxt, 41)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        names = [r.name for r in spans.records()]
    finally:
        spans.clear()
    assert names.count("repro_torch.lm.decode_step") == 1
    assert names.count("repro_torch.lm.block") == 2
    assert names.count("repro_torch.lm.attend") == 2
    assert names.count("repro_torch.lm.dense") == 2 * 7 + 1


def test_traced_granite_moe_adds_no_synchronize(cuda):
    """The counter `moe.route` keeps the grouped products' expert ends on
    the device and reads nothing: `_count_route` alone, and a traced
    `moe_forward` of a reduced granite-4.0-h-small's dropless MoE (bf16;
    routing, the grouped products over ragged groups whose ends stay on
    the device, the combine and the ungated shared MLP) at a prefill's and
    a decode step's rows, inside `spans.recording()` so its span and
    counter record, run under `set_sync_debug_mode("error")`, which
    raises on any synchronize; the ends then read as the routing's
    cumulative pairs."""
    from repro_torch import spans
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.models import LM
    from repro_torch.models.moe import (_count_route, expert_ends,
                                        moe_forward, route)

    cfg = reduced(get("granite-4.0-h-small"), n_layers=1, d_model=512,
                  n_heads=4, n_kv_heads=2, d_ff=1024, vocab=512)
    moe = LM(cfg, RunConfig(dtype="bfloat16"), seed=7,
             device=cuda).layers[0].moe
    mc = cfg.moe
    xs = [_randn((B, S, cfg.d_model), torch.bfloat16, cuda, 9 + S)
          for B, S in ((3, 40), (3, 1))]
    r = route(moe.router, xs[0].reshape(-1, cfg.d_model), mc)
    ends = expert_ends(r, mc.n_experts)
    with torch.no_grad():                           # as it serves
        for x in xs:
            moe_forward(moe, x, cfg)                # warm: lazy set-up
    torch.cuda.synchronize()
    spans.clear()
    try:
        with spans.recording(), torch.no_grad():
            torch.cuda.set_sync_debug_mode("error")
            try:
                _count_route(r, ends)
                for x in xs:
                    moe_forward(moe, x, cfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        recs = spans.records()
    finally:
        spans.clear()
    assert [x.name for x in recs].count("repro_torch.lm.moe") == 2
    route_recs = [x.attrs for x in recs if x.name == "repro_torch.moe.route"]
    want = torch.bincount(r.expert_idx.reshape(-1),
                          minlength=mc.n_experts).cumsum(0).tolist()
    assert route_recs[0] == dict(pairs=120 * mc.top_k, ends=want)
    assert route_recs[1] == route_recs[0]
    assert route_recs[2]["pairs"] == 3 * mc.top_k
    assert route_recs[2]["ends"][-1] == 3 * mc.top_k
