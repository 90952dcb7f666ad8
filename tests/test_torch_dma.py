"""The port's descriptor plane and its copy and Init engines on the CPU,
against the JAX package.

The plane (`repro_torch.core`) is a NumPy copy of `repro.core`: the same
transfers, made from seeded NumPy ints, must give the same bytes, stats,
tile plans and simulated cycles in both.  The Init and copy ops on the CPU are
held against the Pallas kernels in tests/test_torch_kernels.py; here
the kernel route's refusals are held against the Pallas kernels' through
the host-side checks the CUDA wrappers share, and the in-stream
accelerators against JAX's, bit for bit.
"""

import dataclasses
import functools
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.kernels import copy_engine as jce
from repro.kernels import init_engine as jie
from repro_torch.kernels import copy_engine as tce

CE = importlib.import_module("repro_torch.kernels.copy_engine.copy_engine")
IE = importlib.import_module("repro_torch.kernels.init_engine.init_engine")
PRESETS = ["pulp_cluster", "manticore", "cheshire", "edge_ai"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "uint32": jnp.uint32, "int8": jnp.int8, "int32": jnp.int32,
       "float16": jnp.float16, "int16": jnp.int16, "uint8": jnp.uint8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "uint32": torch.uint32, "int8": torch.int8, "int32": torch.int32,
       "float16": torch.float16, "int16": torch.int16, "uint8": torch.uint8}


def jbytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def tbytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def same_bits(jax_out, torch_out) -> None:
    assert tuple(np.asarray(jax_out).shape) == tuple(torch_out.shape)
    assert np.array_equal(jbytes(jax_out), tbytes(torch_out))


def _pair(shape, dtype, seed=42):
    a = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


# --------------------------------------------------------------------------
# The descriptor plane
# --------------------------------------------------------------------------

def _program(seed: int):
    """Seeded transfers as plain ints: 1-D copies, N-D gathers and Init
    fills, sources below 64 KiB, destinations in disjoint windows."""
    rng = np.random.default_rng(seed)
    ints = lambda lo, hi: int(rng.integers(lo, hi))  # noqa: E731
    one_d = [(ints(0, 60000), 262144 + 8192 * i, ints(1, 4096))
             for i in range(6)]
    nd = [(ints(0, 4096), 393216 + 16384 * i, ints(1, 200),
           ((ints(200, 512), ints(200, 400), ints(1, 9)),
            (ints(4096, 8192), ints(3200, 4000), ints(1, 4))))
          for i in range(3)]
    init = [(pattern, ints(0, 1 << 32), 524288 + 8192 * i, ints(1, 5000))
            for i, pattern in enumerate(["constant", "incrementing",
                                         "pseudorandom"])]
    return one_d, nd, init


def _transfers(C, spec, program):
    src_p, dst_p = spec.backend.protocols[0], spec.backend.protocols[-1]
    one_d, nd, init = program
    out = [C.Transfer1D(s, d, n, src_p, dst_p) for s, d, n in one_d]
    out += [C.NdTransfer(s, d, n, tuple(C.TensorDim(*t) for t in dims),
                         src_p, dst_p) for s, d, n, dims in nd]
    out += [C.Transfer1D(0, d, n, C.Protocol.INIT, dst_p,
                         options=C.BackendOptions(
                             init_pattern=C.InitPattern(pattern),
                             init_value=value))
            for pattern, value, d, n in init]
    return out


def _run_plane(C, name, program):
    spec = C.preset(name)
    engine = C.build_engine(spec)
    src = np.random.default_rng(99).integers(0, 256, 65536, dtype=np.uint8)
    engine.mem.spaces[spec.backend.protocols[0]][:65536] = src
    cycles = []
    for t in _transfers(C, spec, program):
        engine.submit(t)
        cycles.append(dataclasses.astuple(engine.simulate(t)))
    asynced = C.build_engine(spec)
    asynced.mem.spaces[spec.backend.protocols[0]][:65536] = src
    for t in _transfers(C, spec, program):
        asynced.submit_async(t)
    drained = asynced.wait_all()
    return dict(
        mem={p.value: engine.mem.spaces[p].copy()
             for p in engine.mem.spaces},
        async_mem={p.value: asynced.mem.spaces[p].copy()
                   for p in asynced.mem.spaces},
        stats=dataclasses.asdict(engine.stats),
        async_stats=dataclasses.asdict(asynced.stats),
        cycles=cycles,
        drain=(dataclasses.astuple(drained.aggregate),
               [dataclasses.astuple(r) for r in drained.per_channel],
               drained.backoff_cycles))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", PRESETS)
def test_plane_matches_reference_on_presets(name, seed):
    program = _program(seed)
    want, got = _run_plane(J, name, program), _run_plane(T, name, program)
    assert want["mem"].keys() == got["mem"].keys()
    for key in ("mem", "async_mem"):
        for p in want[key]:
            assert np.array_equal(want[key][p], got[key][p]), (key, p)
    assert got["stats"]["bursts"] > 0
    for key in ("stats", "async_stats", "cycles", "drain"):
        assert want[key] == got[key], key


def test_quickstart_register_frontend_gather():
    """Quickstart step 1 through both packages: a 3-D strided gather
    programmed on the register front-end, bursts and cycles equal."""
    out = {}
    for C in (J, T):
        spec = C.EngineSpec(
            name="quickstart",
            frontend=C.FrontendSpec(kind="reg", word_bits=32, ndims=3),
            backend=C.BackendSpec(bus_width=8, protocols=(C.Protocol.AXI4,
                                                          C.Protocol.OBI)),
            mem_spaces=((C.Protocol.AXI4, 1 << 16), (C.Protocol.OBI, 1 << 16)))
        engine = C.build_engine(spec)
        engine.mem.spaces[C.Protocol.AXI4][:4096] = np.arange(4096) % 256
        fe = C.build_frontend(spec, engine)
        fe.configure(src=0, dst=0, length=64,
                     dims=(C.TensorDim(src_stride=128, dst_stride=64,
                                       reps=8),),
                     src_protocol=C.Protocol.AXI4,
                     dst_protocol=C.Protocol.OBI)
        fe.launch()
        res = engine.simulate(C.NdTransfer(
            0, 0, 64, (C.TensorDim(128, 64, 8),), C.Protocol.AXI4,
            C.Protocol.OBI))
        out[C] = (engine.mem.spaces[C.Protocol.OBI][:512].copy(),
                  engine.stats.bursts, dataclasses.astuple(res))
    want = np.concatenate([np.arange(i * 128, i * 128 + 64) for i in
                           range(8)]) % 256
    assert np.array_equal(out[T][0], want)
    assert np.array_equal(out[J][0], out[T][0])
    assert out[J][1:] == out[T][1:]


def test_engine_refuses_sanitize():
    """``sanitize=True`` / ``"warn"`` on the cheshire preset (two
    channels, so the overlapping pair lands on both) give the reference's
    reports and warnings on a clean and a racy drain; an
    unknown mode is refused with the reference's `ValueError`; off, the
    engine keeps no reports."""
    def run(C, mode):
        engine = C.build_engine(C.preset("cheshire", num_channels=2),
                                sanitize=mode)
        out = [engine.sanitize]
        for dsts in ((0x8000, 0x9000), (0x8000, 0x8080)):
            for k, dst in enumerate(dsts):
                engine.submit_async(C.Transfer1D(
                    src_addr=0x1000 * k, dst_addr=dst, length=256,
                    src_protocol=C.Protocol.AXI4,
                    dst_protocol=C.Protocol.AXI4))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    engine.wait_all()
                    out.append("drained")
                except RuntimeError as e:
                    out.append((type(e).__name__, str(e)))
            out.append([(w.category.__name__, str(w.message))
                        for w in caught])
            out.append([(r.codes, r.clean, r.checked_rows,
                         dataclasses.astuple(r))
                        for r in engine.sanitize_reports])
        return out

    for mode in (True, "warn", False):
        got, want = run(T, mode), run(J, mode)
        assert got == want, mode
    assert got[0] is False and got[4] == "drained" and got[6] == []
    raised = run(T, True)
    assert raised[0] == "raise" and raised[1] == "drained"
    assert raised[4][0] == "SanitizeError" and "H003" in raised[4][1]
    assert [r[1] for r in raised[6]] == [True, False]
    warned = run(T, "warn")
    assert warned[4] == "drained" and "H003" in warned[5][0][1]
    for C in (T, J):
        with pytest.raises(ValueError, match="sanitize must be"):
            C.IDMAEngine(sanitize="loud")
    assert T.build_engine(T.preset("cheshire")).sanitize_reports == []


# --------------------------------------------------------------------------
# Tiles and batches
# --------------------------------------------------------------------------

PLAN_SHAPES = [(8, 128), (100, 300), (512, 1024), (3, 5), (4096, 4096),
               (1, 100000), (256000, 2304)]


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_nd_copy_matches(shape, itemsize):
    want = J.plan_nd_copy(shape, itemsize)
    got = T.plan_nd_copy(shape, itemsize)
    assert dataclasses.astuple(want) == dataclasses.astuple(got)
    assert want.vmem_bytes == got.vmem_bytes


def test_plan_nd_copy_refuses_itemsize_8():
    for C in (J, T):
        with pytest.raises(ValueError, match="unsupported itemsize 8"):
            C.plan_nd_copy((8, 128), 8)


@pytest.mark.parametrize("bus_width", [4, 8, 64])
def test_legalize_batch_columns_match(bus_width):
    rng = np.random.default_rng(bus_width)
    cols = dict(src_addr=rng.integers(0, 1 << 20, 200),
                dst_addr=rng.integers(0, 1 << 20, 200),
                length=rng.integers(0, 20000, 200))
    out = []
    for C in (J, T):
        batch = C.DescriptorBatch.from_arrays(
            **cols, src_protocol=C.Protocol.AXI4,
            dst_protocol=C.Protocol.OBI)
        legal = C.legalize_batch(batch, bus_width=bus_width)
        C.check_legal_batch(legal, bus_width=bus_width)
        out.append({f.name: getattr(legal, f.name) for f in
                    dataclasses.fields(legal) if f.name != "options"})
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        assert np.array_equal(out[0][k], out[1][k]), k


@pytest.mark.parametrize("shape,itemsize", [((8, 128), 4), ((100, 300), 2),
                                            ((512, 1024), 4),
                                            ((300, 700), 1)])
def test_plan_batches_and_estimates_match(shape, itemsize):
    jplan, tplan = J.plan_nd_copy(shape, itemsize), \
        T.plan_nd_copy(shape, itemsize)
    jb = jce.plan_descriptor_batch(jplan, src_base=64, dst_base=8)
    tb = tce.plan_descriptor_batch(tplan, src_base=64, dst_base=8)
    for col in ("src_addr", "dst_addr", "length", "src_proto", "dst_proto"):
        assert np.array_equal(getattr(jb, col), getattr(tb, col)), col
    assert dataclasses.astuple(jce.estimate_plan_cycles(jplan)) == \
        dataclasses.astuple(tce.estimate_plan_cycles(tplan))
    assert jce.VMEM_SYSTEM == tce.VMEM_SYSTEM or \
        dataclasses.astuple(jce.VMEM_SYSTEM) == \
        dataclasses.astuple(tce.VMEM_SYSTEM)


@pytest.mark.parametrize("shape,dtype", [((8, 128), np.float32),
                                         ((100, 300), np.float32),
                                         ((64, 256), np.uint16),
                                         ((48, 200), np.int8)])
def test_copy_2d_reference_matches(shape, dtype):
    x = np.random.default_rng(3).integers(0, 255, shape).astype(dtype)
    got = tce.copy_2d_reference(x)
    assert np.array_equal(got, x)
    assert np.array_equal(got, jce.copy_2d_reference(x))

    def inv(b):
        return 255 - b
    once = tce.copy_2d_reference(x, instream=inv)
    assert np.array_equal(once.view(np.uint8), 255 - x.view(np.uint8))
    assert np.array_equal(once.view(np.uint8),
                          jce.copy_2d_reference(x, instream=inv)
                          .view(np.uint8))


def test_copy_engine_spec_builds_in_both():
    for C, mod in ((J, jce), (T, tce)):
        engine = C.build_engine(mod.copy_engine_spec(bus_width=16))
        assert engine.bus_width == 16


# --------------------------------------------------------------------------
# The kernel route's refusals, held against the Pallas kernels'
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["prng_f16", "prng_i32", "prng_u8",
                                  "memset_i64", "iota_f64", "memset_3d"])
def test_init_refusals_match_pallas(case):
    gen, shape, dtype = {
        "prng_f16": ("prng", (8, 128), "float16"),
        "prng_i32": ("prng", (8, 128), "int32"),
        "prng_u8": ("prng", (8, 128), "uint8"),
        "memset_i64": ("memset", (8, 128), "int64"),
        "iota_f64": ("iota", (8, 128), "float64"),
        "memset_3d": ("memset", (2, 8, 128), "float32"),
    }[case]
    jdt = {"int64": jnp.int64, "float64": jnp.float64}.get(dtype) or \
        JDT[dtype]
    tdt = {"int64": torch.int64, "float64": torch.float64}.get(dtype) or \
        TDT[dtype]
    jfn = {"prng": jie.prng_fill, "memset": jie.memset,
           "iota": jie.iota_fill}[gen]
    with pytest.raises(Exception) as want:
        jfn(shape, 1, jdt, backend="pallas", interpret=True)
    with pytest.raises(want.type) as got:
        IE.check_fill(shape, tdt, gen)
    if want.type is NotImplementedError:
        assert str(got.value) == f"prng fill for {tdt}"
    else:
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["out_dtype", "cast_into_f32", "one_d",
                                  "zero_into_bf16"])
def test_copy_2d_refusals_match_pallas(case):
    jx, tx = _pair((8, 128), "float32")
    jkw, tkw = {
        "out_dtype": (dict(out_dtype=jnp.bfloat16),
                      dict(out_dtype=torch.bfloat16)),
        "cast_into_f32": (dict(transform=J.instream.cast),
                          dict(transform=T.instream.cast)),
        "one_d": ({}, {}),
        "zero_into_bf16": (dict(transform=J.instream.zero,
                                out_dtype=jnp.bfloat16),
                           dict(transform=T.instream.zero,
                                out_dtype=torch.bfloat16)),
    }[case]
    if case == "one_d":
        jx, tx = jx.reshape(-1), tx.reshape(-1)
    with pytest.raises(ValueError) as want:
        jce.copy_2d(jx, backend="pallas", interpret=True, **jkw)
    with pytest.raises(ValueError) as got:
        CE.check_copy_2d(tx, **tkw)
    assert str(got.value).split(".")[0] == str(want.value).split(".")[0]
    assert str(got.value).strip() == str(want.value).strip()


def test_copy_refusals_of_the_kernel_route():
    """What only the card refuses: 8-byte elements, transforms it cannot
    fuse, cast/scale on integers; the CPU route takes them all."""
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="unsupported itemsize 8"):
        CE.check_copy_2d(x.double())
    with pytest.raises(ValueError, match="unsupported itemsize 8"):
        CE.check_strided_copy_nd(torch.zeros(3, 4, 5, dtype=torch.int64))
    for bad in (lambda v: v + 1, functools.partial(T.instream.scale, 2.0),
                functools.partial(T.instream.scale, factor=torch.ones(1)),
                T.instream.block_transpose):
        with pytest.raises(NotImplementedError, match="fuses only"):
            CE.check_copy_2d(x, bad)
    with pytest.raises(NotImplementedError):
        CE.check_copy_2d(x.to(torch.int32),
                         functools.partial(T.instream.scale, factor=2))
    assert torch.equal(tce.copy_2d(x.double(), lambda v: v + 1),
                       x.double() + 1)
    assert CE.check_strided_copy_nd(torch.zeros(5)).shape == (1, 5)
    assert CE.check_copy_2d(x, functools.partial(
        T.instream.cast, dtype=torch.float32)) == ("copy", torch.float32, 1.0)


def test_dma_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a plain version: a CPU tensor or a
    CPU device is an error there, and no launch is counted."""
    x = torch.zeros(8, 128)
    counts = lambda: (IE.memset_launches, IE.iota_fill_launches,  # noqa
                      IE.prng_fill_launches, CE.copy_2d_launches,
                      CE.strided_copy_nd_launches)
    before = counts()
    with pytest.raises(ValueError):
        CE.copy_2d_cuda(x)
    with pytest.raises(ValueError):
        CE.strided_copy_nd_cuda(x)
    for fn in (IE.memset_cuda, IE.iota_fill_cuda, IE.prng_fill_cuda):
        with pytest.raises(ValueError):
            fn((8, 128), 1, torch.float32, "cpu")
    assert counts() == before


@pytest.mark.parametrize("shape,strides,want", [
    ((3, 1, 4), (4, 4, 1), ([12], [1])),
    ((2, 3, 4), (12, 1, 3), ([2, 3, 4], [12, 1, 3])),
    ((5, 7), (0, 1), ([5, 7], [0, 1])),
    ((5, 7), (0, 0), ([35], [0])),
    ((1, 1), (1, 1), ([1], [1])),
])
def test_collapse_merges_contiguous_dims(shape, strides, want):
    assert CE.collapse(shape, strides) == want


# --------------------------------------------------------------------------
# In-stream accelerators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("identity", {}), ("zero", {}),
                                     ("scale", {"factor": 0.1}),
                                     ("scale", {"factor": 3}),
                                     ("cast", {}),
                                     ("block_transpose", {"block": (8, 8)})])
def test_instream_transforms_match(name, kw):
    jx, tx = _pair((16, 32), "float32")
    assert T.instream.available() == J.instream.available()
    same_bits(J.instream.get(name)(jx, **kw), T.instream.get(name)(tx, **kw))
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    if name != "cast":
        assert np.array_equal(J.instream.get(name)(a, **kw),
                              T.instream.get(name)(a, **kw))


def test_instream_byte_stream_ops_match():
    b = np.arange(32, dtype=np.uint8)
    assert np.array_equal(J.instream.byteswap(b), T.instream.byteswap(b))
    with pytest.raises(TypeError):
        T.instream.byteswap(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(KeyError):
        T.instream.get("nope")
    jp = J.instream.chunk_pipeline(("scale", {"factor": 2.0}), "cast")
    tp = T.instream.chunk_pipeline(("scale", {"factor": 2.0}), "cast")
    jx, tx = _pair((4, 16), "float32")
    same_bits(jp(jx), tp(tx))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_int8_matches(axis):
    jx, tx = _pair((32, 48), "float32", seed=8)
    jq, js = J.instream.quantize_int8(jx, axis=axis)
    tq, ts = T.instream.quantize_int8(tx, axis=axis)
    same_bits(jq, tq)
    same_bits(js, ts)
    same_bits(J.instream.dequantize_int8(jq, js),
              T.instream.dequantize_int8(tq, ts))
    jd = J.instream.get("decompress_int8")(J.instream.get("compress_int8")(jx))
    td = T.instream.get("decompress_int8")(T.instream.get("compress_int8")(tx))
    same_bits(jd, td)


def test_error_feedback_compressor_matches():
    rng = np.random.default_rng(4)
    arrs = {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": [rng.standard_normal(16).astype(np.float32)]}
    jg = {"w": jnp.asarray(arrs["w"]), "b": [jnp.asarray(arrs["b"][0])]}
    tg = {"w": torch.from_numpy(arrs["w"]), "b": [torch.from_numpy(
        arrs["b"][0])]}
    jc, tc = J.instream.ErrorFeedbackCompressor(), \
        T.instream.ErrorFeedbackCompressor()
    jr, tr = jc.init(jg), tc.init(tg)
    for _ in range(2):
        jqs, jr = jc.compress(jg, jr)
        tqs, tr = tc.compress(tg, tr)
        for k in ("w",):
            same_bits(jqs[k][0], tqs[k][0])
            same_bits(jr[k], tr[k])
        same_bits(jr["b"][0], tr["b"][0])
        same_bits(jc.decompress(jqs)["w"], tc.decompress(tqs)["w"])
