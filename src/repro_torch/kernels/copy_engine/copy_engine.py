"""The iDMA transport layer on the card: the descriptor plan of a copy,
its functional oracle, and the wrapper of the hand-written CUDA copy
kernels (`repro_torch/csrc/copy_engine.cu`), the port of the Pallas TPU
kernels `repro/kernels/copy_engine/copy_engine.py`: `copy_2d_pallas` and
`strided_copy_nd_pallas`.

This is the back-end's *transport layer* (paper Fig. 5).  The plan side
is the reference's, in NumPy: `plan_nd_copy` gives the `TilePlan`,
`plan_descriptor_batch` its HBM→VMEM descriptor stream,
`estimate_plan_cycles` costs it on the cycle model and
`copy_2d_reference` runs it through the functional back-end, byte for
byte.  The kernels are free of the TPU tile geometry: a grid-stride walk
of the output, the view's strides for the read and an in-stream transform
(`cast`, `scale`, `zero`) fused into the store.

`check_copy_2d` and `check_strided_copy_nd` hold the Pallas kernels'
host-side refusals and run on any device, so the CPU tests reach them.
`copy_2d_launches` and `strided_copy_nd_launches` count this module's
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import instream
from repro_torch.core import simulator as sim
from repro_torch.core.backend import MemoryMap, execute_batch
from repro_torch.core.descriptor import DescriptorBatch, Protocol
from repro_torch.core.engine import TilePlan, plan_nd_copy
from repro_torch.core.legalizer import legalize_batch
from repro_torch.core.spec import (VMEM_ENDPOINT, BackendSpec, EngineSpec,
                                   FrontendSpec, build_engine)
from repro_torch.kernels import runtime

SOURCE = "copy_engine"
copy_2d_launches = 0
strided_copy_nd_launches = 0


#: VMEM as a transport-layer endpoint for plan estimates: on-chip, deep
#: pipelining, latency of a couple of core cycles (the spec layer's
#: `VMEM_ENDPOINT`, re-exported under the kernel module's historic name).
VMEM_SYSTEM = VMEM_ENDPOINT


def copy_engine_spec(bus_width: int = 8) -> EngineSpec:
    """The TPU copy fabric as an `EngineSpec`: descriptor-doorbell
    control plane over HBM↔VMEM protocol ports — the composition
    `copy_2d_reference` instantiates for its functional legs."""
    return EngineSpec(
        name="tpu_copy",
        frontend=FrontendSpec(kind="desc", word_bits=64),
        backend=BackendSpec(bus_width=bus_width,
                            protocols=(Protocol.HBM, Protocol.VMEM)),
        sim_config=sim.EngineConfig(bus_width=bus_width, n_outstanding=8,
                                    buffer_beats=32),
        src_system=sim.HBM,
        dst_system=VMEM_ENDPOINT,
    )


def plan_descriptor_batch(plan: TilePlan, src_base: int = 0,
                          dst_base: int = 0) -> DescriptorBatch:
    """The HBM→VMEM descriptor stream a `TilePlan` implies, as a
    structure-of-arrays batch.

    One 1-D transfer per contiguous HBM run (one array row inside one
    tile), emitted in pipeline order: tile-row band, then tile column,
    then row within the tile.  VMEM destinations are modeled as densely
    packed — the estimate cares about the HBM side.  This is the batched
    form of the walk the Pallas BlockSpecs in this module perform, so the
    transport-layer simulator can cost a plan without running the kernel.
    """
    rows, cols = plan.shape
    tr, tc = plan.tile
    pitch = cols * plan.itemsize
    grid_c = plan.grid[1]
    r = np.repeat(np.arange(rows, dtype=np.int64), grid_c)
    j = np.tile(np.arange(grid_c, dtype=np.int64), rows)
    order = np.lexsort((r, j, r // tr))      # (band, tile col, row)
    r, j = r[order], j[order]
    length = np.minimum(tc, cols - j * tc) * plan.itemsize
    src = src_base + r * pitch + j * tc * plan.itemsize
    dst = dst_base + np.concatenate(
        ([0], np.cumsum(length)[:-1]))
    return DescriptorBatch.from_arrays(
        src_addr=src, dst_addr=dst, length=length,
        src_protocol=Protocol.HBM, dst_protocol=Protocol.VMEM)


def estimate_plan_cycles(plan: TilePlan, bus_width: int = 64,
                         src_system: Optional[sim.MemSystem] = None,
                         dst_system: Optional[sim.MemSystem] = None
                         ) -> sim.SimResult:
    """Cost a `TilePlan`'s load stream on the cycle model: multi-buffering
    is the outstanding-transaction analogue (NAx = n_buffers), the VMEM
    tile is the dataflow element."""
    cfg = sim.EngineConfig(
        bus_width=bus_width, n_outstanding=max(plan.n_buffers, 1),
        buffer_beats=max(plan.tile[0] * plan.tile[1] * plan.itemsize
                         // bus_width, 1),
        decoupled=True, num_midends=1, tensor_nd_zero_latency=True)
    return sim.simulate_batch(plan_descriptor_batch(plan), cfg,
                              src_system or sim.HBM,
                              dst_system or VMEM_SYSTEM)


def copy_2d_reference(x: np.ndarray, plan: Optional[TilePlan] = None,
                      instream: Optional[Callable] = None,
                      bus_width: int = 8) -> np.ndarray:
    """Functional oracle for `copy_2d`: the descriptor traffic a
    `TilePlan` implies, run through the vectorized functional back-end.

    The plan's HBM→VMEM stream (`plan_descriptor_batch`) gathers the array
    into the VMEM space in pipeline order; the reversed stream scatters it
    back out to a second HBM region — both legs submitted through an
    engine composed from `copy_engine_spec` (the same descriptors the
    Pallas kernel's BlockSpecs walk), so the TPU and functional fabrics
    are costed *and* checked from one composition.  `instream` (a
    byte-stream accelerator, applied per burst on the inbound leg) models
    the kernel's fused transform at the RTL byte level; engines carry no
    in-stream port, so that leg drives `execute_batch` directly.
    """
    x = np.ascontiguousarray(x)
    if plan is None:
        plan = plan_nd_copy(x.shape, x.dtype.itemsize)
    batch = plan_descriptor_batch(plan)
    nbytes = x.nbytes
    mem = MemoryMap.create({Protocol.HBM: 2 * nbytes, Protocol.VMEM: nbytes})
    mem.spaces[Protocol.HBM][:nbytes] = x.view(np.uint8).reshape(-1)
    engine = build_engine(copy_engine_spec(bus_width=bus_width), mem=mem)
    # run_functional: bytes only — the oracle never reads the timing model
    if instream is None:
        engine.run_functional(batch)
    else:
        execute_batch(legalize_batch(batch, bus_width=bus_width), mem,
                      instream=instream, bus_width=bus_width)
    back = DescriptorBatch.from_arrays(
        src_addr=batch.dst_addr, dst_addr=batch.src_addr + nbytes,
        length=batch.length,
        src_protocol=Protocol.VMEM, dst_protocol=Protocol.HBM)
    engine.run_functional(back)
    out = mem.spaces[Protocol.HBM][nbytes:2 * nbytes]
    return out.view(x.dtype).reshape(x.shape).copy()


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------

#: the in-stream transforms the card fuses into the copy, by registry name
FUSABLE = ("identity", "zero", "cast", "scale")
#: element types of `copy_convert` (csrc/copy_engine.cu)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_DIMS = 8


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _fused(transform: Optional[Callable], dtype: torch.dtype
           ) -> Tuple[str, torch.dtype, float]:
    """(op, dtype of the transform's output, factor) of a transform the
    kernel fuses: `instream.identity`, `zero`, `cast` or `scale`, bare or
    as a `functools.partial` with keywords; cast and scale on float32,
    bfloat16 or float16."""
    fn, kw = transform, {}
    if isinstance(transform, functools.partial) and not transform.args:
        fn, kw = transform.func, dict(transform.keywords)
    if transform is None or (fn is instream.identity and not kw):
        return "copy", dtype, 1.0
    if fn is instream.zero and not kw:
        return "zero", dtype, 1.0
    if dtype in FLOAT_CODES:
        if fn is instream.cast and set(kw) <= {"dtype"}:
            to = kw.get("dtype", instream.cast.__defaults__[0])
            if to in FLOAT_CODES:
                return ("copy" if to == dtype else "convert"), to, 1.0
        factor = kw.get("factor", 1.0)
        if fn is instream.scale and set(kw) <= {"factor"} and \
                isinstance(factor, (int, float)) and \
                not isinstance(factor, bool):
            return "convert", dtype, float(factor)
    raise NotImplementedError(
        f"copy_2d on the card fuses only the in-stream transforms "
        f"{', '.join(FUSABLE)} of repro_torch.core.instream (cast and "
        f"scale on float32, bfloat16 or float16), bare or as a "
        f"functools.partial with keywords; got {transform!r} on "
        f"{_dtype_name(dtype)}")


def check_copy_2d(x: torch.Tensor, transform: Optional[Callable] = None,
                  out_dtype=None) -> Tuple[str, torch.dtype, float]:
    """The refusals of `copy_2d_pallas`, in its order, for the kernel
    route → (op, output dtype, factor).  A non-2-D input and an itemsize
    other than 1, 2 or 4 raise `ValueError`; a transform the kernel does
    not fuse raises `NotImplementedError`; a transform whose output dtype
    is not the output's (`out_dtype or x.dtype`) raises the `ValueError`
    of Pallas's store ("Invalid dtype for `swap`"), where the plain
    version would cast."""
    if x.ndim != 2:
        raise ValueError(f"copy_2d expects 2-D input, got {tuple(x.shape)}")
    plan_nd_copy(tuple(x.shape), x.element_size())
    out = out_dtype or x.dtype
    op, value, factor = _fused(transform, x.dtype)
    if value != out:
        raise ValueError(f"Invalid dtype for `swap`. Ref dtype: "
                         f"{_dtype_name(out)}. Value dtype: "
                         f"{_dtype_name(value)}.")
    return op, out, factor


def check_strided_copy_nd(x: torch.Tensor) -> torch.Tensor:
    """The refusals of `strided_copy_nd_pallas` → x as the kernel takes
    it: a 0-D or 1-D input reshaped to 2-D ((5,) → (1, 5)); an itemsize
    other than 1, 2 or 4 raises `ValueError`."""
    if x.ndim < 2:
        x = x.reshape((1,) * (2 - x.ndim) + tuple(x.shape))
    plan_nd_copy(tuple(x.shape[-2:]), x.element_size())
    return x


def collapse(shape, strides) -> Tuple[List[int], List[int]]:
    """Shape and strides, outermost first, without unit dimensions and
    with each dimension merged into the next where the two are one
    contiguous run; a dense tensor becomes one dimension."""
    dims = [[n, s] for n, s in zip(shape, strides) if n != 1] or [[1, 1]]
    out = [dims[0]]
    for n, s in dims[1:]:
        if out[-1][1] == s * n:
            out[-1] = [out[-1][0] * n, s]
        else:
            out.append([n, s])
    return [n for n, _ in out], [s for _, s in out]


def gather_geometry(x: torch.Tensor) -> Tuple[List[int], List[int], int]:
    """(shape, strides, unit bytes) for `copy_gather`: the collapsed view
    moved in the widest unit (16, 8, 4 or 2 bytes) that its innermost
    contiguous run, its other strides and its base address allow."""
    shape, strides = collapse(x.shape, x.stride())
    if len(shape) > MAX_DIMS:
        raise ValueError(f"the copy kernel takes views of at most "
                         f"{MAX_DIMS} dimensions once contiguous ones are "
                         f"merged, got {len(shape)}: {tuple(x.shape)} "
                         f"strides {x.stride()}")
    e = x.element_size()
    if strides[-1] == 1:
        for u in (16, 8, 4, 2):
            if u > e and shape[-1] * e % u == 0 and x.data_ptr() % u == 0 \
                    and all(s * e % u == 0 for s in strides[:-1]):
                k = u // e
                return (shape[:-1] + [shape[-1] // k],
                        [s // k for s in strides[:-1]] + [1], u)
    return shape, strides, e


def _lib() -> ctypes.CDLL:
    lib = runtime.load(SOURCE)
    if lib.copy_gather.argtypes is None:
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)
        lib.copy_gather.argtypes = [P, P, I, P, P, I, P]
        lib.copy_zero.argtypes = [P, L, P]
        lib.copy_convert.argtypes = [P, P, I, P, P, I, I, F, P]
        for fn in (lib.copy_gather, lib.copy_zero, lib.copy_convert):
            fn.restype = I
    return lib


def _int64s(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)


def _gather(lib, x: torch.Tensor, y: torch.Tensor, stream) -> int:
    shape, strides, unit = gather_geometry(x)
    return lib.copy_gather(x.data_ptr(), y.data_ptr(), len(shape),
                           _int64s(shape), _int64s(strides), unit, stream)


def _on_card(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} takes a tensor on a CUDA device, got "
                         f"{x.device}")


def copy_2d_cuda(x: torch.Tensor, transform: Optional[Callable] = None,
                 out_dtype=None) -> torch.Tensor:
    """`transform(x)` into a new row-major (rows, cols) tensor of
    `out_dtype or x.dtype`; x is any 2-D view on the card."""
    global copy_2d_launches
    _on_card(x, "copy_2d_cuda")
    op, out, factor = check_copy_2d(x, transform, out_dtype)
    y = torch.empty(tuple(x.shape), dtype=out, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if op == "copy":
            err = _gather(lib, x, y, stream)
        elif op == "zero":
            err = lib.copy_zero(y.data_ptr(), y.numel() * y.element_size(),
                                stream)
        else:
            shape, strides = collapse(x.shape, x.stride())
            err = lib.copy_convert(x.data_ptr(), y.data_ptr(), len(shape),
                                   _int64s(shape), _int64s(strides),
                                   FLOAT_CODES[x.dtype], FLOAT_CODES[out],
                                   factor, stream)
    runtime.check(lib, err, "copy_2d")
    copy_2d_launches += 1
    return y


def strided_copy_nd_cuda(x: torch.Tensor) -> torch.Tensor:
    """Materialise the view x (up to 8 dimensions once merged, any
    strides, 0 included) as a new contiguous tensor of its shape, 2-D at
    least."""
    global strided_copy_nd_launches
    _on_card(x, "strided_copy_nd_cuda")
    x = check_strided_copy_nd(x)
    y = torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        err = _gather(lib, x, y,
                      torch.cuda.current_stream(x.device).cuda_stream)
    runtime.check(lib, err, "strided_copy_nd")
    strided_copy_nd_launches += 1
    return y
