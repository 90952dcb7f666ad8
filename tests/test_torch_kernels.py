"""The port's attention and SSD ops on the CPU (their plain versions)
against the JAX Pallas kernels in interpret mode and the JAX references,
on the cases of tests/test_kernels.py plus gemma2's head_dim 256 with
softcap 50 and reduced mamba2's SSD shape; and the copy and Init engines'
plain versions, which must equal the Pallas kernels bit for bit (the
transform v·3 + 1, whose multiply-add XLA may fuse, within the float32
rule below), on the cases of tests/test_kernels.py plus torch views and
Init edge cases.

Inputs are drawn once in float32 with numpy and rounded to the working
dtype by each framework (both round to nearest even, so the operands are
identical).  Error is relative to max|reference|: 2e-5 for float32 and
2e-2 for bfloat16, the rule of tests/test_kernels.py.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.kernels import copy_engine as jce
from repro.kernels import init_engine as jie
from repro.kernels.decode_attention import (decode_attention as j_decode,
                                            decode_attention_ref as j_dref)
from repro.kernels.flash_attention import (attention_ref as j_fref,
                                           flash_attention as j_flash)
from repro.kernels.ssd import (ssd as j_ssd, ssd_chunked_ref as j_ssd_chunked_ref,
                               ssd_ref as j_ssd_ref)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels import copy_engine as tce
from repro_torch.kernels import init_engine as tie
from repro_torch.kernels.ssd import ssd, ssd_chunked_ref, ssd_ref

CE = importlib.import_module("repro_torch.kernels.copy_engine.copy_engine")
IE = importlib.import_module("repro_torch.kernels.init_engine.init_engine")

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
    # the groups of the configs still to port: 5 (hymba-1.5b, qwen2.5-32b),
    # 6 (internlm2-20b, internvl2-26b) and 16 (chatglm3-6b)
    # (caches a multiple of the Pallas kernel's 256-key block: see
    # test_decode_ragged_cache_equals_ref)
    dict(B=2, Hq=10, Hkv=2, S=512, D=64, kvlen=301, win=0, cap=0.0),
    dict(B=1, Hq=12, Hkv=2, S=512, D=128, kvlen=512, win=0, cap=30.0),
    dict(B=2, Hq=16, Hkv=1, S=768, D=128, kvlen=555, win=200, cap=50.0),
]
SSD_CASES = [
    dict(B=2, H=4, G=2, S=256, P=32, N=64, chunk=64),
    dict(B=1, H=8, G=1, S=128, P=64, N=32, chunk=32),
    # reduced mamba2: d_inner 256 in 16 heads of 16, d_state 32, chunk 32
    dict(B=2, H=16, G=1, S=96, P=16, N=32, chunk=32),
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ragged_cache_equals_ref(dtype):
    # decode_attention_pallas gives NaN here: a cache of 384 rows in
    # 256-key blocks reads a padded tail, and p = 0 times its NaN rows is
    # NaN (ROADMAP queue 3); the port visits only live keys and equals the
    # reference's plain version.
    (jq, jk, jv), (q, k, v) = _inputs(
        [(2, 10, 64), (2, 2, 384, 64), (2, 2, 384, 64)], dtype)
    out = decode_attention(q, k, v, kv_len=301)
    assert bool(torch.isfinite(out).all())
    assert _rel_err(out, j_dref(jq, jk, jv, kv_len=301)) < TOL[dtype]


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


def test_decode_groups_cover_the_configs():
    """The card's decode kernel takes the GQA group and head_dim of every
    attention config of the repository."""
    from repro.configs import REGISTRY
    DA = importlib.import_module(
        "repro_torch.kernels.decode_attention.decode_attention")
    for name, cfg in REGISTRY.items():
        if cfg.n_heads:
            assert cfg.n_heads // cfg.n_kv_heads in DA.GROUPS, name
            assert cfg.resolved_head_dim in DA.HEAD_DIMS, name


def test_decode_splits_fill_the_card():
    """Key splits from the cache's capacity and the SM count: between 1
    and the capacity, at least MIN_KEYS_PER_SPLIT keys a split of a full
    cache, and about two blocks an SM at gemma2-2b's decode shape."""
    DA = importlib.import_module(
        "repro_torch.kernels.decode_attention.decode_attention")
    for S in range(1, 4641):
        for blocks in (1, 3, 16, 40, 132, 264, 1000):
            n = DA.num_splits(blocks, S, 132)
            assert 1 <= n <= min(S, DA.MAX_SPLITS)
            assert n == 1 or S // n >= DA.MIN_KEYS_PER_SPLIT
            assert blocks * n <= max(blocks, DA.BLOCKS_PER_SM * 132)
    assert DA.num_splits(16, 4640, 132) == 16     # B 4 x Hkv 4: 256 blocks
    assert DA.num_splits(16, 20, 132) == 1
    assert [DA.heads_per_block(g) for g in DA.GROUPS] == \
        [1, 2, 4, 5, 6, 8, 8]


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
    sk = importlib.import_module("repro_torch.kernels.ssd.ssd")
    q = torch.zeros(1, 2, 8, 64)
    before = (fa.launches, da.launches, sk.launches)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q[:, :, 0], q, q, kv_len=4)
    with pytest.raises(ValueError):
        sk.ssd_cuda(q, q[..., 0], q[0, :, 0, 0], q[0, :, 0, 0], q, q,
                    chunk=8)
    assert (fa.launches, da.launches, sk.launches) == before


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


def test_library_path_covers_headers(monkeypatch, tmp_path):
    """A library is named by its source and every `csrc/*.cuh` header, so
    an edited header (hopper.cuh) never loads a library built before."""
    from repro_torch.kernels import runtime
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = runtime.library_path("k")
    assert runtime.library_path("k") == first
    assert first.name.startswith("libk-")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = runtime.library_path("k")
    assert second != first
    (tmp_path / "new.cuh").write_text("")
    assert runtime.library_path("k") not in (first, second)


def _ssd_inputs(case, seed=7):
    """x, dt, A, D, B, C as in tests/test_kernels.py, in float32."""
    B, H, G, S, P, N = (case[k] for k in "BHGSPN")
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, H, S, P)),
            rng.uniform(0.001, 0.1, (B, H, S)),
            -rng.uniform(0.5, 2.0, H),
            rng.standard_normal(H),
            rng.standard_normal((B, G, S, N)) * 0.3,
            rng.standard_normal((B, G, S, N)) * 0.3]
    arrs = [a.astype(np.float32) for a in arrs]
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_vs_pallas_and_ref(case):
    """y and the final state of the port's chunked plain version against
    the Pallas kernel (interpret mode) and the sequential JAX scan."""
    jargs, args = _ssd_inputs(case)
    y, state = ssd(*args, chunk=case["chunk"], return_state=True)
    assert y.shape == args[0].shape and state.dtype == torch.float32
    assert state.shape == (case["B"], case["H"], case["N"], case["P"])
    jy, jstate = j_ssd(*jargs, chunk=case["chunk"], return_state=True,
                       backend="pallas", interpret=True)
    jref = j_ssd_ref(*jargs)
    assert _rel_err(y, jy) < TOL["float32"]
    assert _rel_err(state, jstate) < TOL["float32"]
    assert _rel_err(y, jref) < TOL["float32"]
    chunked = ssd_chunked_ref(*args, chunk=case["chunk"], return_state=True)
    assert _rel_err(chunked[0], y) == 0.0 and _rel_err(chunked[1], state) \
        == 0.0


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_sequential_ref_vs_jax(case):
    """The port's step-by-step recurrence against JAX's, and its final
    state against the Pallas kernel's."""
    jargs, args = _ssd_inputs(case, seed=8)
    y, state = ssd_ref(*args, return_state=True)
    assert _rel_err(y, j_ssd_ref(*jargs)) < TOL["float32"]
    _, jstate = j_ssd(*jargs, chunk=case["chunk"], return_state=True,
                      backend="pallas", interpret=True)
    assert _rel_err(state, jstate) < TOL["float32"]
    assert _rel_err(ssd_ref(*args), y) == 0.0


def test_ssd_bad_shapes_raise():
    """The reference's two refusals: S not a multiple of the chunk, and
    heads not a multiple of the groups."""
    _, (x, dt, A, D, B, C) = _ssd_inputs(SSD_CASES[0])
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, A, D, B, C, chunk=96)
    with pytest.raises(ValueError, match="groups"):
        ssd(x[:, :3], dt[:, :3], A[:3], D[:3], B, C, chunk=64)
    with pytest.raises(ValueError):
        ssd(x.to("meta"), dt, A, D, B, C, chunk=64)


def test_ssd_chunked_ref_gradients_past_exp_overflow():
    """A·dt large enough that exp(cum_t − cum_s) overflows above the
    diagonal (A −40, dt 0.1, chunk 32: seg reaches 124): the port's chunked
    plain version masks before the exponential, so its forward pass equals
    JAX's and its gradients are finite and equal the sequential scan's."""
    rng = np.random.default_rng(9)
    B, H, G, S, P, N, L = 1, 2, 1, 64, 8, 8, 32
    arrs = [rng.standard_normal((B, H, S, P)),
            np.full((B, H, S), 0.1),
            np.array([-40.0, -1.0]),
            rng.standard_normal(H),
            rng.standard_normal((B, G, S, N)) * 0.3,
            rng.standard_normal((B, G, S, N)) * 0.3]
    arrs = [a.astype(np.float32) for a in arrs]
    wy = torch.from_numpy(rng.standard_normal((B, H, S, P)).astype(
        np.float32))
    ws = torch.from_numpy(rng.standard_normal((B, H, N, P)).astype(
        np.float32))
    jy, jstate = j_ssd_chunked_ref(*[jnp.asarray(a) for a in arrs],
                                   chunk=L, return_state=True)

    def grads(fn, **kw):
        args = [torch.from_numpy(a).requires_grad_() for a in arrs]
        y, state = fn(*args, return_state=True, **kw)
        ((y * wy).sum() + (state * ws).sum()).backward()
        return y.detach(), state.detach(), {
            n: args[i].grad for n, i in (("x", 0), ("dt", 1), ("A", 2),
                                         ("B", 4), ("C", 5))}

    y, state, got = grads(ssd_chunked_ref, chunk=L)
    assert _rel_err(y, jy) < TOL["float32"]
    assert _rel_err(state, jstate) < TOL["float32"]
    _, _, want = grads(ssd_ref)
    for name, g in got.items():
        assert bool(torch.isfinite(g).all()), name
        assert _rel_err(g, want[name]) < 1e-4, name


def _route_view(dtype=torch.float32, P=64, N=128, off=0, row_pad=0):
    """x, B, C as (B, H or G, S, .) views of one (B, S, H·P + 2·N) tensor,
    as the SSM layer passes them, starting `off` elements in, with rows
    `row_pad` elements longer."""
    Bb, H, S = 2, 4, 256
    width = H * P + 2 * N + row_pad
    flat = torch.zeros(Bb * S * width + off + 64, dtype=dtype)
    xbc = flat[off:off + Bb * S * width].view(Bb, S, width)
    xs, Bs, Cs = torch.split(xbc[..., :H * P + 2 * N], [H * P, N, N], dim=-1)
    return (xs.reshape(Bb, S, H, P).transpose(1, 2),
            Bs.reshape(Bb, S, 1, N).transpose(1, 2),
            Cs.reshape(Bb, S, 1, N).transpose(1, 2))


@pytest.mark.parametrize("kw,chunk,want", [
    (dict(), 128, "tensor_cores"),                       # mamba2-1.3b
    (dict(dtype=torch.bfloat16), 128, "tensor_cores"),
    (dict(dtype=torch.float16), 128, "cuda_cores"),
    (dict(off=1), 128, "cuda_cores"),                    # base 4 bytes off
    (dict(off=4), 128, "tensor_cores"),                  # 16 bytes off
    (dict(dtype=torch.bfloat16, off=4), 128, "cuda_cores"),
    (dict(dtype=torch.bfloat16, off=8), 128, "tensor_cores"),
    (dict(row_pad=2), 128, "cuda_cores"),                # row stride
    (dict(row_pad=4), 128, "tensor_cores"),
    (dict(dtype=torch.bfloat16, row_pad=4), 128, "cuda_cores"),
    (dict(P=16, N=32), 32, "tensor_cores"),              # reduced mamba2
    (dict(P=32, N=16), 64, "tensor_cores"),
    (dict(P=48, N=80), 96, "cuda_cores"),                # P off the tiles
    (dict(P=128), 128, "cuda_cores"),
    (dict(P=8), 128, "cuda_cores"),
    (dict(N=24), 128, "cuda_cores"),                     # N % 16
    (dict(N=144), 128, "cuda_cores"),                    # N over 128
    (dict(), 96, "tensor_cores"),
    (dict(), 256, "cuda_cores"),                         # chunk over 128
])
def test_ssd_route(kw, chunk, want):
    """The kernel's route, chosen on the host from dtype, base alignment,
    strides, P, N and the chunk (`ssd.route`, called on CPU tensors)."""
    sk = importlib.import_module("repro_torch.kernels.ssd.ssd")
    x, B, C = _route_view(**kw)
    assert sk.route(x, B, C, chunk) == want
    # the same shapes as contiguous tensors: only the view's layout moved
    # the choice
    if "off" in kw or "row_pad" in kw:
        dense = sk.route(*(t.contiguous() for t in (x, B, C)), chunk)
        assert dense == "tensor_cores"


def test_ssd_route_needs_one_dtype_and_contiguous_rows():
    sk = importlib.import_module("repro_torch.kernels.ssd.ssd")
    x, B, C = _route_view()
    assert sk.route(x, B.bfloat16(), C.bfloat16(), 128) == "cuda_cores"
    assert sk.route(x[..., ::2], B, C, 128) == "cuda_cores"
    assert sk.ROUTES == ("tensor_cores", "cuda_cores")
    assert set(sk.launches_by_route) == set(sk.ROUTES)


# --------------------------------------------------------------------------
# The copy and Init engines: plain versions bit for bit against Pallas
# --------------------------------------------------------------------------

DMA_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "uint32": jnp.uint32, "int8": jnp.int8, "int32": jnp.int32,
           "float16": jnp.float16}
DMA_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "uint32": torch.uint32, "int8": torch.int8, "int32": torch.int32,
           "float16": torch.float16}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def same_bits(jax_out, torch_out) -> None:
    assert tuple(np.asarray(jax_out).shape) == tuple(torch_out.shape)
    assert np.array_equal(_bits(jax_out), _bits(torch_out))



INIT_SHAPES = [(8, 128), (100, 300), (256, 512)]


@pytest.mark.parametrize("dtype", ["uint32", "float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", INIT_SHAPES)
def test_init_generators_match_pallas(shape, dtype):
    j, t = DMA_JDT[dtype], DMA_TDT[dtype]
    same_bits(jie.memset(shape, 7, j, backend="pallas", interpret=True),
              tie.memset(shape, 7, t, device="cpu"))
    same_bits(jie.iota_fill(shape, 3, j, backend="pallas", interpret=True),
              tie.iota_fill(shape, 3, t, device="cpu"))
    same_bits(jie.prng_fill(shape, 11, j, backend="pallas", interpret=True),
              tie.prng_fill(shape, 11, t, device="cpu"))


@pytest.mark.parametrize("value,dtype", [(2.5, "int32"), (-2.5, "int32"),
                                         (300, "int8"), (-1, "uint32"),
                                         (1e10, "bfloat16"),
                                         (1e10, "float16"), (0.1, "float32")])
def test_memset_casts_as_jnp_full(value, dtype):
    same_bits(jie.memset((8, 128), value, DMA_JDT[dtype], backend="pallas",
                         interpret=True),
              tie.memset((8, 128), value, DMA_TDT[dtype], device="cpu"))


@pytest.mark.parametrize("start", [(1 << 24) + 1, (1 << 24) + (1 << 16) + 1,
                                   (1 << 30) + 12345, (1 << 31) - 500, -7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "int8",
                                   "float16"])
def test_iota_large_start_and_wrap(start, dtype):
    same_bits(jie.iota_fill((8, 128), start, DMA_JDT[dtype], backend="pallas",
                            interpret=True),
              tie.iota_fill((8, 128), start, DMA_TDT[dtype], device="cpu"))


@pytest.mark.parametrize("seed", [0, 42, (1 << 32) - 3])
def test_prng_matches_init_stream(seed):
    """The plain PRNG == the engine's Init byte stream, in both packages."""
    words = tie.prng_fill((8, 128), seed, torch.uint32, device="cpu")
    for C in (J, T):
        rtl = C.init_stream(C.InitPattern.PSEUDORANDOM, seed, 0, 8 * 128 * 4)
        assert np.array_equal(_bits(words), rtl)
    assert np.array_equal(
        T.splitmix32(np.arange(5000, dtype=np.uint32)),
        J.splitmix32(np.arange(5000, dtype=np.uint32)))


def test_init_ops_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    for op in (tie.memset, tie.iota_fill, tie.prng_fill):
        with pytest.raises(RuntimeError, match="CUDA"):
            op((8, 128))



def _dma_pair(shape, dtype, seed=42):
    a = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    return (jnp.asarray(a, DMA_JDT[dtype]),
            torch.from_numpy(a).to(DMA_TDT[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (100, 300), (512, 1024)])
def test_copy_2d_matches_pallas(shape, dtype):
    jx, tx = _dma_pair(shape, dtype)
    y = tce.copy_2d(tx)
    same_bits(jce.copy_2d(jx, backend="pallas", interpret=True), y)
    assert y.data_ptr() != tx.data_ptr()


@pytest.mark.parametrize("case", ["scale3", "cast_bf16", "cast_f32",
                                  "zero", "identity"])
def test_copy_2d_fused_transforms_match_pallas(case):
    src = "bfloat16" if case == "cast_f32" else "float32"
    jx, tx = _dma_pair((64, 256), src)
    jt, tt, out = {
        "scale3": (functools.partial(J.instream.scale, factor=3.0),
                   functools.partial(T.instream.scale, factor=3.0), None),
        "cast_bf16": (J.instream.cast, T.instream.cast, "bfloat16"),
        "cast_f32": (functools.partial(J.instream.cast, dtype=jnp.float32),
                     functools.partial(T.instream.cast, dtype=torch.float32),
                     "float32"),
        "zero": (J.instream.zero, T.instream.zero, None),
        "identity": (J.instream.identity, T.instream.identity, None),
    }[case]
    want = jce.copy_2d(jx, transform=jt, out_dtype=out and DMA_JDT[out],
                       backend="pallas", interpret=True)
    same_bits(want, tce.copy_2d(tx, tt, out and DMA_TDT[out]))
    # the kernel route accepts the same call
    assert CE.check_copy_2d(tx, tt, out and DMA_TDT[out])[1] == \
        (DMA_TDT[out] if out else tx.dtype)


def test_copy_2d_any_callable_on_cpu():
    jx, tx = _dma_pair((64, 256), "float32")

    def t(v):
        return v * 3.0 + 1.0
    want = np.asarray(jce.copy_2d(jx, transform=t, backend="pallas",
                                  interpret=True))
    got = tce.copy_2d(tx, t).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 2e-5


@pytest.mark.parametrize("shape", [(3, 2, 64, 256), (5,), (2, 3, 4, 8, 16),
                                   ()])
def test_strided_copy_nd_matches_pallas(shape):
    jx, tx = _dma_pair(shape, "float32")
    got = tce.strided_copy_nd(tx)
    same_bits(jce.strided_copy_nd(jx, backend="pallas", interpret=True), got)
    assert got.is_contiguous() and got.ndim == max(2, len(shape))


@pytest.mark.parametrize("view", ["transpose5d", "expand", "offset1",
                                  "slice_rows", "ssm_heads", "bf16_step"])
def test_strided_copy_nd_of_torch_views(view):
    """Views JAX cannot express: the plain version's gather over the
    storage equals torch's own materialisation, and the kernel's host
    geometry (merged dims, widened unit) addresses the same bytes."""
    base = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 6, 5, 8, 12)).astype(np.float32))
    x = {"transpose5d": base.permute(4, 2, 0, 3, 1),
         "expand": base[0, 0, 0, :1].expand(7, 12),
         "offset1": base.reshape(-1)[1:1001].reshape(10, 100),
         "slice_rows": base[:, 1:4, :, :, 4:],
         "ssm_heads": base.reshape(4, 6 * 5, 96)[..., :64]
         .reshape(4, 30, 4, 16).transpose(1, 2),
         "bf16_step": base.to(torch.bfloat16)[..., ::2]}[view]
    got = tce.strided_copy_nd(x)
    assert torch.equal(got, x.contiguous()) and got.is_contiguous()
    # replay the kernel's gather on the host from its geometry
    shape, strides, unit = CE.gather_geometry(x)
    store = np.frombuffer(bytes(x.untyped_storage()), np.uint8)
    start = x.data_ptr() - x.untyped_storage().data_ptr()
    units = store[start % unit:].view(f"V{unit}")
    idx = np.full((), start // unit, np.int64)
    for d, (n, s) in enumerate(zip(shape, strides)):
        view_shape = [1] * len(shape)
        view_shape[d] = n
        idx = idx + np.arange(n).reshape(view_shape) * s
    assert units[idx].tobytes() == _bits(got).tobytes()


# --------------------------------------------------------------------------
# The blocked matmul: the plain version against the Pallas kernel
# --------------------------------------------------------------------------

MM = importlib.import_module("repro_torch.kernels.matmul_dma.matmul_dma")


def _mm_pair(M, K, N, x_dtype, w_dtype=None, seed=42):
    """x (M, K), w (K, N) drawn in float32 with numpy, as each package
    rounds them."""
    rng = np.random.default_rng(seed)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((M, K), (K, N)))
    w_dtype = w_dtype or x_dtype
    return ((jnp.asarray(x, JDT[x_dtype]), jnp.asarray(w, JDT[w_dtype])),
            (torch.from_numpy(x).to(TDT[x_dtype]),
             torch.from_numpy(w).to(TDT[w_dtype])))


@pytest.mark.parametrize("mkn", [(128, 128, 128), (200, 300, 150),
                                 (512, 1024, 256), (64, 2048, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(mkn, dtype):
    from repro.kernels.matmul_dma import matmul as j_mm, matmul_ref as j_ref
    from repro_torch.kernels.matmul_dma import matmul
    M, K, N = mkn
    (jx, jw), (tx, tw) = _mm_pair(M, K, N, dtype)
    got = matmul(tx, tw)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (M, N)
    assert _rel_err(got, j_mm(jx, jw, backend="pallas",
                              interpret=True)) < TOL[dtype]
    assert _rel_err(got, j_ref(jx, jw)) < TOL[dtype]


@pytest.mark.parametrize("epi", ["relu", "silu", "gelu_tanh", "scale"])
def test_matmul_epilogue_matches_pallas(epi):
    """The fusable epilogues, each as JAX writes it and as torch does:
    equal on the CPU, and the kernel route takes the torch one."""
    import jax
    import torch.nn.functional as F
    from repro.kernels.matmul_dma import matmul as j_mm
    from repro_torch.kernels.matmul_dma import matmul
    j_epi, t_epi = {
        "relu": (jax.nn.relu, torch.relu),
        "silu": (jax.nn.silu, F.silu),
        "gelu_tanh": (functools.partial(jax.nn.gelu, approximate=True),
                      functools.partial(F.gelu, approximate="tanh")),
        "scale": (functools.partial(J.instream.scale, factor=0.5),
                  functools.partial(T.instream.scale, factor=0.5)),
    }[epi]
    (jx, jw), (tx, tw) = _mm_pair(128, 256, 128, "float32")
    want = j_mm(jx, jw, epilogue=j_epi, backend="pallas", interpret=True)
    assert _rel_err(matmul(tx, tw, epilogue=t_epi), want) < TOL["float32"]
    assert MM.check_matmul(tx, tw, None, t_epi)[1] == MM.FUSABLE[epi]


def test_matmul_any_callable_on_cpu():
    from repro.kernels.matmul_dma import matmul as j_mm
    from repro_torch.kernels.matmul_dma import matmul

    def t(v):
        return v * 3.0 + 1.0
    (jx, jw), (tx, tw) = _mm_pair(64, 96, 80, "float32")
    want = j_mm(jx, jw, epilogue=t, backend="pallas", interpret=True)
    assert _rel_err(matmul(tx, tw, epilogue=t), want) < TOL["float32"]


@pytest.mark.parametrize("x_dtype,w_dtype", [("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
def test_matmul_mixed_operands_match_pallas(x_dtype, w_dtype):
    """Pallas promotes a mixed product to fp32 and returns x's dtype."""
    from repro.kernels.matmul_dma import matmul as j_mm
    from repro_torch.kernels.matmul_dma import matmul
    (jx, jw), (tx, tw) = _mm_pair(200, 300, 150, x_dtype, w_dtype)
    want = j_mm(jx, jw, backend="pallas", interpret=True)
    got = matmul(tx, tw)
    assert got.dtype == TDT[x_dtype] and str(want.dtype) == x_dtype
    assert _rel_err(got, want) < TOL[x_dtype]
    assert MM.check_matmul(tx, tw)[0] == TDT[x_dtype]


def test_matmul_f32_output_from_bf16_operands():
    from repro.kernels.matmul_dma import matmul as j_mm
    from repro_torch.kernels.matmul_dma import matmul
    (jx, jw), (tx, tw) = _mm_pair(64, 2048, 64, "bfloat16")
    want = j_mm(jx, jw, out_dtype=jnp.float32, backend="pallas",
                interpret=True)
    got = matmul(tx, tw, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _rel_err(got, want) < TOL["float32"]


@pytest.mark.parametrize("mkn", [(300, 700, 300), (64, 576, 64),
                                 (100, 200, 90)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ragged_k_equals_ref(mkn, dtype):
    # matmul_pallas gives all NaN here: it sums the padded tail of a ragged
    # last k block (ROADMAP queue 3); the port computes the true product.
    from repro.kernels.matmul_dma import matmul_ref as j_ref
    from repro_torch.kernels.matmul_dma import matmul
    M, K, N = mkn
    (jx, jw), (tx, tw) = _mm_pair(M, K, N, dtype)
    got = matmul(tx, tw)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, j_ref(jx, jw)) < TOL[dtype]


def test_matmul_contraction_mismatch_raises_in_both():
    from repro.kernels.matmul_dma import matmul as j_mm
    from repro_torch.kernels.matmul_dma import matmul
    (jx, _), (tx, _) = _mm_pair(8, 16, 4, "float32")
    (_, jw), (_, tw) = _mm_pair(8, 12, 4, "float32")
    with pytest.raises(ValueError, match="contraction mismatch"):
        j_mm(jx, jw, backend="pallas", interpret=True)
    with pytest.raises(ValueError, match="contraction mismatch"):
        matmul(tx, tw)
    with pytest.raises(ValueError, match="contraction mismatch"):
        MM.check_matmul(tx, tw)
    with pytest.raises(ValueError, match="2-D"):
        matmul(tx[0], tw)
    with pytest.raises(ValueError):
        matmul(tx.to("meta"), tw.to("meta"))


def test_matmul_card_refusals_on_cpu_tensors():
    """The kernel route's host check, called on CPU tensors: what the
    card would refuse before any launch, which the CPU route takes."""
    import torch.nn.functional as F
    from repro_torch.kernels.matmul_dma import matmul, matmul_ref
    x, w = torch.ones(4, 8), torch.ones(8, 3)
    for epi in (lambda v: v + 1, F.gelu, F.elu,
                functools.partial(F.gelu, approximate="none"),
                functools.partial(T.instream.scale, factor=True),
                functools.partial(F.relu, inplace=True)):
        with pytest.raises(ValueError, match="fuses only"):
            MM.check_matmul(x, w, None, epi)
        assert torch.equal(matmul(x, w, epilogue=epi),
                           matmul_ref(x, w, epilogue=epi))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        MM.check_matmul(x.int(), w.int())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        MM.check_matmul(x, w.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        MM.check_matmul(x, w, torch.float16)
    assert matmul(x.int(), w.int()).dtype == torch.int32
    with pytest.raises(ValueError, match="two devices"):
        MM.check_matmul(x, w.to("meta"))
    assert MM.check_matmul(x, w, torch.bfloat16, T.instream.scale) == \
        (torch.bfloat16, MM.FUSABLE["scale"], 1.0)
    before = MM.launches
    with pytest.raises(ValueError, match="CUDA device"):
        MM.matmul_cuda(x, w)
    assert MM.launches == before


def test_matmul_tile_geometry_of_views():
    """The layout and load width the kernel's tile loads take, for the
    views the served models pass."""
    bf = torch.zeros(64, 2304 + 8, dtype=torch.bfloat16)
    x = bf[:, :2304]                       # rows 2,312 apart: still 16 B
    table = torch.zeros(1000, 2304, dtype=torch.bfloat16)
    w = torch.zeros(2304, 512, dtype=torch.bfloat16)
    assert MM.tile_geometry(x, w) == (True, True, False, True)
    # the decode unembed: w = table.t() is k-major
    assert MM.tile_geometry(x, table.t()) == (True, True, True, True)
    # transposed x: m-major; a base one element off: no 16-byte loads
    assert MM.tile_geometry(w.t(), w)[:2] == (False, True)
    assert MM.tile_geometry(bf[:, 1:2305], w)[:2] == (True, False)
    # odd row pitch, stepped slices and fp32: element loads
    assert MM.tile_geometry(torch.zeros(8, 33, dtype=torch.bfloat16)[:, :32],
                            w)[1] is False
    assert MM.tile_geometry(bf[:, ::2], w)[:2] == (True, False)
    assert MM.tile_geometry(x.float(), w.float()) == (True, False, False,
                                                      False)


def test_matmul_route_of_views():
    """The route the card takes, chosen from dtypes, shapes, strides and
    base alignment alone: wgmma where 2-D tensor maps describe both bf16
    operands (one stride 1, the other a multiple of 16 bytes, a 16-byte
    base), its small-M form for M ≤ SMALL_M with x k-major, mma_sync for
    any other bf16 view, fp32 for any fp32 operand."""
    bf = torch.bfloat16
    x = torch.zeros(18432, 2304 + 8, dtype=bf)[:, :2304]
    w = torch.zeros(2304, 9216, dtype=bf)          # models/ffn.py's (K, N)
    table = torch.zeros(1000, 2304, dtype=bf)      # the tied unembed
    assert MM.SMALL_M == 64
    assert MM.route(x, w) == "wgmma"
    assert MM.route(x[:4], table.t()) == "wgmma_small_m"
    assert MM.routes(x[:4], table.t()) == ("wgmma_small_m", "wgmma",
                                           "mma_sync")
    assert MM.route(x[:64], w) == "wgmma_small_m"   # at the threshold
    assert MM.route(x[:65], w) == "wgmma"           # above it
    assert MM.route(x[:1], w) == "wgmma_small_m"
    # an M-major x stays on the large-M route at any M
    assert MM.route(torch.zeros(2304, 64, dtype=bf).t(), w) == "wgmma"
    # refusals of TMA: an unaligned base, a 66-byte pitch, a stepped
    # inner axis, a pitch shorter than a row, K 0; fp32 anywhere
    assert MM.route(x[:, 1:2305], w) == "mma_sync"
    assert MM.route(x[:100, :2303], w[1:]) == "wgmma"   # base still 16 B
    assert MM.route(torch.zeros(8, 33, dtype=bf), w[:33]) == "mma_sync"
    assert MM.route(x[:100, :264], torch.zeros(264, 33, dtype=bf)) == \
        "mma_sync"
    assert MM.route(x[:100, ::2], w[:1152]) == "mma_sync"
    assert MM.route(x[:100], w[:, ::2]) == "mma_sync"
    assert MM.route(torch.zeros(1000, dtype=bf).as_strided(
        (100, 64), (8, 1)), w[:64]) == "mma_sync"
    assert MM.route(x[:100, :0], w[:0]) == "mma_sync"
    assert MM.route(x.float(), w) == "fp32"
    assert MM.route(x, w.float()) == "fp32"
    assert MM.routes(x.float(), w.float()) == ("fp32",)
