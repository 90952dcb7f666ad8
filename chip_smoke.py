#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it puts `src` on sys.path itself).  It
drives `repro_torch` only, never JAX, in these phases, each printing
lines tagged with its name:

  1. device  — the card's name and power limit from nvidia-smi; no CUDA
               device is an error;
  2. build   — the six sources under `src/repro_torch/csrc` (flash and
               decode attention, the SSD scan, the Init and copy engines,
               the matmul), one `nvcc` each for sm_90a, started together;
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card (tolerance relative to max|plain|: 2e-2 bf16, 1e-4
               fp32), with its time from CUDA events beside the plain
               version's time and the card's lower bound for the same
               work: flash and decode attention at gemma2-2b's prefill and
               decode shapes, with torch's own `flex_attention`
               (compiled, tanh softcap as its score_mod) timed as a
               yardstick; the SSD scan at mamba2-1.3b's prefill shape in
               fp32 and bf16, on views of (B, S, ...) tensors as the SSM
               layer passes them, with four groups, and a small case also
               held against the sequential recurrence;
  4. dma     — the quickstart's path through the port's descriptor
               plane (host NumPy: a register front-end's 3-D gather, the
               presets' 4 KiB cycles), a `plan_nd_copy` plan whose
               `copy_2d` on the card equals `copy_2d_reference` byte for
               byte, an engine's Init PRNG stream equal to `prng_fill` on
               the card; then the Init and copy kernels at real sizes
               from gemma2-2b and mamba2-1.3b (2.4 GB casts and fills, the
               SSD input's strided view) and small edge cases in every
               dtype, bit for bit against their plain versions; the five
               launch counters, set to 0 first, must equal the calls
               made; then kernel, plain and library times;
  5. matmul  — the blocked matmul through `repro_torch.kernels.matmul_dma.
               matmul`, the entry point a user calls, at the served
               models' real GEMM shapes (gemma2-2b's FFN gate with its
               tanh-gelu and its FFN down, mamba2-1.3b's in_proj, over a
               4 x 4,608-token prefill; gemma2-2b's decode unembed into
               fp32 through `table.t()`; mamba2-1.3b's out_proj in fp32),
               then small edge cases on every route (ragged M, N and K,
               M = 1, transposed and sliced views, mixed types, each fused
               epilogue), each against `matmul_ref` (relative to
               max|plain|: 2e-2 for a bf16 output, 1e-4 for fp32); the
               launch counter, set to 0 first, must equal the calls made;
               then kernel, plain and `torch.matmul` (cuBLAS, TF32 off,
               then the same epilogue) times;
  6. serve   — full-width gemma2-2b (26 layers, d 2304, vocab 256,000)
               and then full-width mamba2-1.3b (48 SSM layers, d 2048,
               vocab 50,280), seeded random weights, bf16, each answer
               4 left-padded requests through `ServeEngine.generate`,
               twice; the launch counters, set to 0 before each run, must
               show every attention and SSD call went through the kernels
               and no other kernel ran (no copy, Init or matmul kernel);
  7. card vs CPU — 2 gemma2 layers (SWA, FULL) and 2 mamba2 layers at
               full width in fp32, a 600-token prompt and 3 decode steps:
               logits of the CUDA path agree with the CPU path within 1e-4.

Any failure raises and exits non-zero.  The second-to-last line is a JSON
object with one entry per kernel; the last is the device line.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def flash_live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(row, col) pairs the mask keeps, for one head."""
    n = 0
    for r in range(Sq):
        hi = min(r, Sk - 1) if causal else Sk - 1
        lo = max(0, r - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    return smi


INIT = "src/repro/kernels/init_engine/init_engine.py"
COPY = "src/repro/kernels/copy_engine/copy_engine.py"
MATMUL = "src/repro/kernels/matmul_dma/matmul_dma.py"
KERNELS = {  # kernel → (wrapper module, its launch counter, source in
    #          csrc/, the TPU kernel it replaces)
    "flash_attention": ("repro_torch.kernels.flash_attention."
                        "flash_attention", "launches", "flash_attention",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:136"),
    "decode_attention": ("repro_torch.kernels.decode_attention."
                         "decode_attention", "launches", "decode_attention",
                         "src/repro/kernels/decode_attention/"
                         "decode_attention.py:119"),
    "ssd": ("repro_torch.kernels.ssd.ssd", "launches", "ssd",
            "src/repro/kernels/ssd/ssd.py:112"),
    "memset": ("repro_torch.kernels.init_engine.init_engine",
               "memset_launches", "init_engine", f"{INIT}:73"),
    "iota_fill": ("repro_torch.kernels.init_engine.init_engine",
                  "iota_fill_launches", "init_engine", f"{INIT}:95"),
    "prng_fill": ("repro_torch.kernels.init_engine.init_engine",
                  "prng_fill_launches", "init_engine", f"{INIT}:108"),
    "copy_2d": ("repro_torch.kernels.copy_engine.copy_engine",
                "copy_2d_launches", "copy_engine", f"{COPY}:176"),
    "strided_copy_nd": ("repro_torch.kernels.copy_engine.copy_engine",
                        "strided_copy_nd_launches", "copy_engine",
                        f"{COPY}:208"),
    "matmul_dma": ("repro_torch.kernels.matmul_dma.matmul_dma", "launches",
                   "matmul_dma", f"{MATMUL}:87"),
}
DMA_KERNELS = ("memset", "iota_fill", "prng_fill", "copy_2d",
               "strided_copy_nd")


def phase_build():
    from repro_torch.kernels import runtime
    sources = sorted({k[2] for k in KERNELS.values()})
    t0 = time.perf_counter()
    runtime.build(sources)
    for name in sources:
        runtime.load(name)
    log(f"[build] {', '.join(n + '.cu' for n in sources)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")


def expected_launches(cfg, steps: int):
    """Kernel launches of one prefill and `steps` decode steps of `cfg`:
    no copy, Init or matmul kernel runs on the serving path."""
    from repro_torch.configs import SSM
    n_ssm = sum(kind == SSM for kind in cfg.layer_kinds)
    n_attn = cfg.n_layers - n_ssm
    return {"flash_attention": n_attn, "decode_attention": n_attn * steps,
            "ssd": n_ssm, "matmul_dma": 0,
            **{name: 0 for name in DMA_KERNELS}}


def reset(mods, names=None):
    for name in names or mods:
        setattr(mods[name], KERNELS[name][1], 0)


def read(mods, names=None):
    return {name: getattr(mods[name], KERNELS[name][1])
            for name in names or mods}


def library_attention():
    """torch's `flex_attention` compiled, with `create_block_mask`; None
    where this torch has none.  Only timed here, as a yardstick: the port
    never calls it."""
    import torch
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
    except ImportError:
        log(f"[kernels] torch {torch.__version__} has no flex_attention: "
            f"library_ms is null")
        return None
    return torch.compile(flex_attention, dynamic=False), create_block_mask


def phase_kernels(fa, da):
    """Kernel vs plain on the card; returns per-kernel JSON entries."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.launch.profile_serve import MAX_LEN
    dev = torch.device("cuda")
    library = library_attention()
    gen = torch.Generator(dev).manual_seed(0)
    DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(DT[dtype])

    def compare(name, got, want, dtype):
        torch.cuda.synchronize()
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / max(float(want.float().abs().max()), 1e-6)
        if not (math.isfinite(rel) and rel < TOL[dtype]):
            raise AssertionError(f"{name}: rel err {rel:.3e} >= "
                                 f"{TOL[dtype]:.0e}")
        return abs_err, rel

    entries = {}
    B, Hq, Hkv, D, scale, cap = 4, 8, 4, 256, 1 / 16, 50.0

    def softcap_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def library_ms(label, q, k, v, mask_mod, want, dtype):
        """Check flex_attention against the plain version, then time it."""
        if library is None:
            return None
        flex, create_block_mask = library
        mask = create_block_mask(mask_mod, None, None, q.shape[2],
                                 k.shape[2], device=dev)

        def call():
            return flex(q, k, v, score_mod=softcap_mod, block_mask=mask,
                        scale=scale, enable_gqa=True)
        _, rel = compare(f"flex_attention {label}", call(), want, dtype)
        ms = time_ms(call)
        log(f"[kernels] library flex_attention {label}: rel err {rel:.2e}, "
            f"{ms:.4f} ms")
        return ms
    flash_cases = [
        # (label, S, causal, window, dtype, main path?)
        ("full", 4608, True, 0, "bfloat16", True),
        ("local", 4608, True, 4096, "bfloat16", False),
        ("full", 4608, True, 0, "float32", False),
        ("local", 4608, True, 4096, "float32", False),
        ("ragged", 4133, True, 4096, "bfloat16", False),
        ("noncausal", 1000, False, 0, "bfloat16", False),
    ]
    worst = 0.0
    for label, S, causal, w, dtype, main in flash_cases:
        q = randn((B, Hq, S, D), dtype)
        k, v = randn((B, Hkv, S, D), dtype), randn((B, Hkv, S, D), dtype)
        kw = dict(causal=causal, window=w, softcap=cap, scale=scale)
        want = attention_ref(q, k, v, **kw)
        abs_err, rel = compare(f"flash {label} {dtype}",
                               fa.flash_attention_cuda(q, k, v, **kw),
                               want, dtype)
        worst = max(worst, abs_err)
        ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
        plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=5,
                           warmup=1)
        pairs = flash_live_pairs(S, S, causal, w) * B * Hq
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(4 * D * pairs, nbytes, dtype)
        log(f"[kernels] flash {label} B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} "
            f"w{w} cap{cap:g} {dtype}: rel err {rel:.2e} (tol "
            f"{TOL[dtype]:.0e}) | kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s")
        if main:
            entries["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=KERNELS["flash_attention"][3],
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms(
                    f"flash {label} S{S} {dtype}", q, k, v,
                    lambda b, h, q_idx, kv_idx: q_idx >= kv_idx, want,
                    dtype))
        del q, k, v, want
    entries["flash_attention"]["max_abs_err"] = worst

    worst = 0.0
    for dtype in ("bfloat16", "float32"):
        q = randn((B, Hq, D), dtype)
        k, v = randn((B, Hkv, MAX_LEN, D), dtype), \
            randn((B, Hkv, MAX_LEN, D), dtype)
        for n in (1, 17, 4097, 4608):
            for w in (4096, 0):
                kw = dict(window=w, softcap=cap, scale=scale)
                # kv_len as a 0-d int32 tensor on the card in the w=0 cases
                kv_len = torch.tensor(n, dtype=torch.int32, device=dev) \
                    if w == 0 else n
                want = decode_attention_ref(q, k, v, kv_len=n, **kw)
                abs_err, rel = compare(
                    f"decode kv{n} w{w} {dtype}",
                    da.decode_attention_cuda(q, k, v, kv_len=kv_len, **kw),
                    want, dtype)
                worst = max(worst, abs_err)
                ms = time_ms(lambda: da.decode_attention_cuda(
                    q, k, v, kv_len=kv_len, **kw), iters=50)
                plain_ms = time_ms(lambda: decode_attention_ref(
                    q, k, v, kv_len=n, **kw))
                live = n - (max(0, n - w) if w else 0)
                nbytes = (2 * B * Hkv * live * D + 2 * q.numel()) \
                    * q.element_size()
                b_ms, b_by = bound(4 * B * Hq * live * D, nbytes, dtype)
                log(f"[kernels] decode B{B} Hq{Hq} Hkv{Hkv} S{MAX_LEN} "
                    f"D{D} kv_len {n} w{w} {dtype}: rel err {rel:.2e} (tol "
                    f"{TOL[dtype]:.0e}) | kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                    f"{nbytes / ms / 1e6:.0f} GB/s")
                if dtype == "bfloat16" and n == 4608 and w == 0:
                    entries["decode_attention"] = dict(
                        name="decode_attention", route="cuda",
                        source="src/repro_torch/csrc/decode_attention.cu",
                        replaces=KERNELS["decode_attention"][3],
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=library_ms(
                            f"decode kv{n} w{w} {dtype}", q[:, :, None],
                            k, v, lambda b, h, q_idx, kv_idx: kv_idx < n,
                            want[:, :, None], dtype))
        del q, k, v
    entries["decode_attention"]["max_abs_err"] = worst
    return entries


def ssd_flops_bytes(B, H, G, S, P, N, elt):
    """The least work that gives y and the final state, by the recurrence
    h_t = exp(A·dt_t)·h_{t-1} + B_t ⊗ (dt_t·x_t), y_t = C_t·h_t + D·x_t:
    per step and head a multiply and a multiply-add for each of the N·P
    state elements, a multiply-add each for C·h, a multiply for dt·x and a
    multiply-add for D·x over P.  The chunked form the kernel runs does
    more (about 7·N·P a step at L 128); the bound counts what the function
    needs.  Each input read once and each output written once."""
    flops = B * H * S * (5 * N * P + 3 * P)
    nbytes = (2 * B * H * S * P + 2 * B * G * S * N) * elt + \
        4 * (B * H * S + 2 * H + B * H * N * P)
    return flops, nbytes


def phase_ssd_kernel(sk):
    """The SSD kernel against its plain versions; returns its JSON entry."""
    import torch
    from repro_torch.kernels.ssd import ssd_chunked_ref, ssd_ref
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    log("[kernels] ssd: no single PyTorch call computes the chunked SSD "
        "scan, so library_ms is null")

    def inputs(B, H, G, S, P, N, dtype):
        """mamba2's ranges: dt = softplus(.) in [0.001, 0.1], A = -exp(A_log)
        with A_log = log(1..H), D = 1.  x, B and C are (B, H or G, S, .)
        views of one (B, S, H·P + 2·G·N) tensor and dt of a (B, S, H) one,
        as the SSM layer passes them."""
        xbc = torch.randn((B, S, H * P + 2 * G * N), generator=gen,
                          device=dev)
        xbc[..., H * P:] *= 0.3
        xs, Bs, Cs = torch.split(xbc.to(DT[dtype]), [H * P, G * N, G * N],
                                 dim=-1)
        dt = 0.001 + 0.099 * torch.rand((B, S, H), generator=gen, device=dev)
        return (xs.reshape(B, S, H, P).transpose(1, 2), dt.transpose(1, 2),
                -torch.arange(1, H + 1, device=dev, dtype=torch.float32),
                torch.ones(H, device=dev),
                *(t.reshape(B, S, G, N).transpose(1, 2) for t in (Bs, Cs)))

    def rel(got, want):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-6)

    cases = [
        # (label, B, H, G, S, P, N, dtype, main path?)
        ("main", 4, 64, 1, 4608, 64, 128, "float32", True),
        ("main", 4, 64, 1, 4608, 64, 128, "bfloat16", False),
        ("groups", 2, 64, 4, 1024, 64, 128, "float32", False),
        ("small", 1, 4, 1, 256, 64, 128, "float32", False),
    ]
    L, worst, entry = 128, 0.0, None
    for label, B, H, G, S, P, N, dtype, main in cases:
        args = inputs(B, H, G, S, P, N, dtype)
        y, state = sk.ssd_cuda(*args, chunk=L)
        wy, wstate = ssd_chunked_ref(*args, chunk=L, return_state=True)
        checks = {"y": rel(y, wy), "state": rel(state, wstate)}
        if label == "small":
            sy, sstate = ssd_ref(*args, return_state=True)
            checks.update({"y vs sequential": rel(y, sy),
                           "state vs sequential": rel(state, sstate)})
        for what, (err, r) in checks.items():
            if not (math.isfinite(r) and r < TOL[dtype]):
                raise AssertionError(f"ssd {label} {dtype} {what}: rel err "
                                     f"{r:.3e} >= {TOL[dtype]:.0e}")
            worst = max(worst, err)
        ms = time_ms(lambda: sk.ssd_cuda(*args, chunk=L), iters=10)
        plain_ms = time_ms(lambda: ssd_chunked_ref(*args, chunk=L,
                                                   return_state=True),
                           iters=5, warmup=1)
        flops, nbytes = ssd_flops_bytes(B, H, G, S, P, N,
                                        args[0].element_size())
        b_ms, b_by = bound(flops, nbytes, dtype)
        log(f"[kernels] ssd {label} B{B} H{H} G{G} S{S} P{P} N{N} L{L} "
            f"{dtype}: rel err " + ", ".join(
                f"{what} {r:.2e}" for what, (_, r) in checks.items()) +
            f" (tol {TOL[dtype]:.0e}) | kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        if main:
            entry = dict(name="ssd", route="cuda",
                         source="src/repro_torch/csrc/ssd.cu",
                         replaces=KERNELS["ssd"][3], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
        del args, y, state, wy, wstate
    entry["max_abs_err"] = worst
    return entry


def dma_plane():
    """Quickstart steps 1 and 7 through the port's descriptor plane, on
    the host in NumPy: a 3-D strided gather programmed on a register
    front-end, then a 4 KiB transfer on each named preset.  Returns the
    quickstart engine."""
    import numpy as np
    from repro_torch.core import (BackendSpec, EngineSpec, FrontendSpec,
                                  NdTransfer, Protocol, TensorDim,
                                  Transfer1D, build_engine, build_frontend,
                                  preset)
    spec = EngineSpec(
        name="quickstart",
        frontend=FrontendSpec(kind="reg", word_bits=32, ndims=3),
        backend=BackendSpec(bus_width=8,
                            protocols=(Protocol.AXI4, Protocol.OBI)),
        mem_spaces=((Protocol.AXI4, 1 << 16), (Protocol.OBI, 1 << 16)))
    engine = build_engine(spec)
    src = np.arange(4096, dtype=np.uint8)
    engine.mem.spaces[Protocol.AXI4][:4096] = src
    fe = build_frontend(spec, engine)
    fe.configure(src=0, dst=0, length=64,
                 dims=(TensorDim(src_stride=128, dst_stride=64, reps=8),),
                 src_protocol=Protocol.AXI4, dst_protocol=Protocol.OBI)
    tid = fe.launch()
    want = np.concatenate([src[i * 128:i * 128 + 64] for i in range(8)])
    if not np.array_equal(engine.mem.spaces[Protocol.OBI][:512], want):
        raise AssertionError("register front-end gather moved wrong bytes")
    res = engine.simulate(NdTransfer(0, 0, 64, (TensorDim(128, 64, 8),),
                                     Protocol.AXI4, Protocol.OBI))
    log(f"[dma] reg front-end (32-bit, 3 dims, AXI4 -> OBI) transfer "
        f"#{tid}: 8 x 64 B at stride 128 gathered, {engine.stats.bursts} "
        f"bursts, {res.cycles} cycles (first read request at "
        f"{res.first_read_req}, utilization {res.utilization:.2f})")
    for name in ("pulp_cluster", "manticore", "cheshire", "edge_ai"):
        ps = preset(name)
        r = build_engine(ps).simulate(Transfer1D(
            0, 1 << 12, 4096, src_protocol=ps.backend.protocols[0],
            dst_protocol=ps.backend.protocols[-1]))
        log(f"[dma] preset {name}: 4 KiB in {r.cycles} cycles "
            f"({ps.src_system.name} -> {ps.dst_system.name}, "
            f"{ps.backend.bus_width * 8}-bit bus)")
    return engine


def dma_cases(dev):
    """Real sizes from the two served models: (label, kernel, input
    maker, kernel call, plain call, library call or None, bytes read +
    written, flops).  Inputs are made on `dev` when asked for."""
    import functools
    import torch
    from repro_torch.core import instream
    from repro_torch.kernels.copy_engine import (copy_2d, copy_2d_ref,
                                                 strided_copy_nd,
                                                 strided_copy_nd_ref)
    from repro_torch.kernels.init_engine import (iota_fill, iota_fill_ref,
                                                 memset, memset_ref,
                                                 prng_fill, prng_fill_ref)
    gen = torch.Generator(dev).manual_seed(3)
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    up = functools.partial(instream.cast, dtype=f32)

    def table():   # gemma2-2b's embedding table (256,000 x 2,304) in bf16
        return torch.randn((256000, 2304), generator=gen, device=dev,
                           dtype=bf16)

    def ssm_x():   # mamba2-1.3b's SSD input x, viewed as ssm.py does
        xbc = torch.randn((4, 4608, 4352), generator=gen, device=dev)
        return xbc[..., :4096].reshape(4, 4608, 64, 64).transpose(1, 2)

    kv, idx, start = (3860480, 256), (16384, 16384), 1 << 20
    n_idx = idx[0] * idx[1]
    return [
        ("copy_2d cast bf16 -> f32 (256000, 2304)", "copy_2d", table,
         lambda x: copy_2d(x, up, f32), lambda x: copy_2d_ref(x, up, f32),
         lambda x: x.to(f32), 256000 * 2304 * (2 + 4), 0),
        ("copy_2d bf16 (256000, 2304)", "copy_2d", table,
         lambda x: copy_2d(x), lambda x: copy_2d_ref(x),
         lambda x: x.clone(), 256000 * 2304 * 4, 0),
        ("strided_copy_nd f32 (4, 64, 4608, 64) of (4, 4608, 4352)",
         "strided_copy_nd", ssm_x, strided_copy_nd, strided_copy_nd_ref,
         lambda x: x.contiguous(), 2 * 4 * 64 * 4608 * 64 * 4, 0),
        ("memset 0 bf16 (3860480, 256)", "memset", lambda: None,
         lambda _: memset(kv, 0, bf16, dev),
         lambda _: memset_ref(kv, 0, bf16, dev),
         lambda _: torch.zeros(kv, dtype=bf16, device=dev),
         kv[0] * kv[1] * 2, 0),
        ("iota_fill int32 (16384, 16384)", "iota_fill", lambda: None,
         lambda _: iota_fill(idx, start, i32, dev),
         lambda _: iota_fill_ref(idx, start, i32, dev),
         lambda _: torch.arange(start, start + n_idx, dtype=i32,
                                device=dev).view(idx), n_idx * 4, 0),
        ("prng_fill f32 (256000, 2304)", "prng_fill", lambda: None,
         lambda _: prng_fill((256000, 2304), 7, f32, dev),
         lambda _: prng_fill_ref((256000, 2304), 7, f32, dev), None,
         256000 * 2304 * 4, 0),
    ]


def dma_edge_cases(dev):
    """Small cases, (label, kernel, kernel call, plain call): every dtype
    the Pallas kernels take at (8, 128), (100, 300) and (256, 512); views
    one element past an aligned base, transposed 5-D views, expanded
    (stride 0) views, a 1-D input; the fused transforms."""
    import functools
    import torch
    from repro_torch.core import instream
    from repro_torch.kernels.copy_engine import (copy_2d, copy_2d_ref,
                                                 strided_copy_nd,
                                                 strided_copy_nd_ref)
    from repro_torch.kernels.init_engine import (iota_fill, iota_fill_ref,
                                                 memset, memset_ref,
                                                 prng_fill, prng_fill_ref)
    gen = torch.Generator(dev).manual_seed(4)
    every = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
             torch.uint8, torch.bool, torch.int16, torch.uint16,
             torch.int32, torch.uint32)
    floats = (torch.float32, torch.bfloat16, torch.float16)

    def rand(shape, dtype):
        x = torch.randn(shape, generator=gen, device=dev) * 100
        return x.to(dtype) if dtype in floats else \
            x.to(torch.int64).to(dtype)

    cases = []
    for shape in ((8, 128), (100, 300), (256, 512)):
        for dt in every:
            for v in (2.5, 300, -1):
                cases.append((f"memset {v} {dt} {shape}", "memset",
                              functools.partial(memset, shape, v, dt, dev),
                              functools.partial(memset_ref, shape, v, dt,
                                                dev)))
            for st in (3, (1 << 24) + (1 << 16) + 1, (1 << 31) - 100):
                cases.append((f"iota {st} {dt} {shape}", "iota_fill",
                              functools.partial(iota_fill, shape, st, dt,
                                                dev),
                              functools.partial(iota_fill_ref, shape, st,
                                                dt, dev)))
            x = rand((shape[0], shape[1] + 1), dt)
            for label, v in (("dense", x[:, :shape[1]].contiguous()),
                             ("offset 1", x.reshape(-1)[1:1 + shape[0] *
                                                        shape[1]]
                              .view(shape)),
                             ("row view", x[:, 1:])):
                cases.append((f"copy_2d {label} {dt} {shape}", "copy_2d",
                              functools.partial(copy_2d, v),
                              functools.partial(copy_2d_ref, v)))
            cases.append((f"strided {dt} {shape} transposed",
                          "strided_copy_nd",
                          functools.partial(strided_copy_nd, x.t()),
                          functools.partial(strided_copy_nd_ref, x.t())))
        for dt in (torch.uint32, torch.float32, torch.bfloat16, torch.int8):
            cases.append((f"prng {dt} {shape}", "prng_fill",
                          functools.partial(prng_fill, shape, 11, dt, dev),
                          functools.partial(prng_fill_ref, shape, 11, dt,
                                            dev)))
        for dt in floats:
            x = rand((shape[0], shape[1] + 1), dt)[:, 1:]
            for t, out in ((functools.partial(instream.scale, factor=3.0),
                            None), (functools.partial(instream.scale,
                                                      factor=0.1), None),
                           (instream.zero, None),
                           (functools.partial(instream.cast, dtype=dt),
                            dt)):
                for v in (x, x.contiguous(), x.t()):
                    cases.append((f"copy_2d {t} {dt} {shape}", "copy_2d",
                                  functools.partial(copy_2d, v, t, out),
                                  functools.partial(copy_2d_ref, v, t, out)))
            for to in floats:
                cast = functools.partial(instream.cast, dtype=to)
                cases.append((f"copy_2d cast {dt} -> {to} {shape}",
                              "copy_2d",
                              functools.partial(copy_2d, x, cast, to),
                              functools.partial(copy_2d_ref, x, cast, to)))
    base = rand((4, 6, 5, 8, 12), torch.float32)
    shifted = rand((11521,), torch.bfloat16)[1:].view(4, 6, 5, 8, 12)
    for label, v in (
            ("5-D transposed", base.permute(4, 2, 0, 3, 1)),
            ("5-D bf16 offset 1", shifted),
            ("5-D bf16 offset 1 transposed", shifted.permute(3, 1, 4, 0, 2)),
            ("expanded (stride 0)", base[0, 0, 0, 0, :1].expand(300, 257)),
            ("expanded rows", base[0, 0, :1].expand(7, 8, 12)),
            ("int8 5-D sliced", base.to(torch.int8)[:, 1:, :, ::2, 3:]),
            ("1-D", base.reshape(-1)[5:901]),
            ("0-D", base[1, 2, 3, 4, 5])):
        cases.append((f"strided {label}", "strided_copy_nd",
                      functools.partial(strided_copy_nd, v),
                      functools.partial(strided_copy_nd_ref, v)))
    return cases


def bits_equal(got, want) -> bool:
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    return bool(torch.equal(got.contiguous().view(torch.uint8),
                            want.contiguous().view(torch.uint8)))


def phase_dma(mods):
    """The quickstart's path through the port on the card: the descriptor
    plane on the host, its plan driving `copy_2d`, the Init stream against
    `prng_fill`, then the real-size and edge cases, each kernel bit for
    bit against its plain version.  The five counters, set to 0 first,
    must equal the calls made; timing follows.  Returns JSON entries."""
    import numpy as np
    import torch
    from repro_torch.core import (BackendOptions, InitPattern, Protocol,
                                  Transfer1D, plan_nd_copy)
    from repro_torch.kernels.copy_engine import (copy_2d, copy_2d_reference,
                                                 estimate_plan_cycles)
    from repro_torch.kernels.init_engine import prng_fill
    reset(mods, DMA_KERNELS)
    calls = dict.fromkeys(DMA_KERNELS, 0)
    engine = dma_plane()

    # the plan → the kernel, against the functional fabric
    plan = plan_nd_copy((512, 1024), 4)
    x = np.random.default_rng(0).standard_normal((512, 1024)) \
        .astype(np.float32)
    want = copy_2d_reference(x, plan)
    got = copy_2d(torch.from_numpy(x).cuda())
    calls["copy_2d"] += 1
    if not np.array_equal(got.cpu().numpy().view(np.uint8),
                          want.view(np.uint8)):
        raise AssertionError("copy_2d on the card != copy_2d_reference")
    log(f"[dma] plan (512, 1024) f32: tile {plan.tile}, grid {plan.grid}, "
        f"{plan.n_buffers} buffers; copy_2d on the card == the plan's "
        f"descriptors through the functional back-end, byte for byte; "
        f"estimate {estimate_plan_cycles(plan).cycles} cycles")

    # Init on both fabrics
    engine.submit(Transfer1D(0, 0, 4096, Protocol.INIT, Protocol.OBI,
                             options=BackendOptions(
                                 init_pattern=InitPattern.PSEUDORANDOM,
                                 init_value=42)))
    words = prng_fill((8, 128), 42, torch.uint32)
    calls["prng_fill"] += 1
    if not np.array_equal(words.view(torch.uint8).reshape(-1).cpu().numpy(),
                          engine.mem.spaces[Protocol.OBI][:4096]):
        raise AssertionError("prng_fill on the card != the engine's Init "
                             "stream")
    log("[dma] Init PSEUDORANDOM 4096 B, value 42: engine bytes == "
        "prng_fill((8, 128), 42, uint32) on the card")

    # real sizes, then edge cases: kernel == plain, bit for bit
    real = []
    dev = torch.device("cuda")
    for label, name, make, kern, plain, lib, nbytes, flops in dma_cases(dev):
        x = make()
        got = kern(x)
        calls[name] += 1
        if not bits_equal(got, plain(x)):
            raise AssertionError(f"{label}: kernel != plain version")
        del got
        real.append((label, name, make, kern, plain, lib, nbytes, flops))
        torch.cuda.empty_cache()
    edge = dma_edge_cases(dev)
    for label, name, kern, plain in edge:
        got = kern()
        calls[name] += 1
        if not bits_equal(got, plain()):
            raise AssertionError(f"{label}: kernel != plain version")
    counts = read(mods, DMA_KERNELS)
    if counts != calls:
        raise AssertionError(f"dma launches {counts}, calls made {calls}")
    log(f"[dma] {len(real)} real-size and {len(edge)} small cases bit for "
        f"bit against the plain versions; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items()) +
        " (= the calls made)")

    # timing, after the count: CUDA events, after warm-up
    entries = {}
    for label, name, make, kern, plain, lib, nbytes, flops in real:
        x = make()
        ms = time_ms(lambda: kern(x))
        plain_ms = time_ms(lambda: plain(x), iters=3, warmup=1)
        lib_ms = None if lib is None else time_ms(lambda: lib(x))
        b_ms, b_by = bound(flops, nbytes, "float32")
        log(f"[dma] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'null' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e9:.3f} GB), "
            f"{nbytes / ms / 1e6:.0f} GB/s")
        if name not in entries:
            entries[name] = dict(
                name=name, route="cuda",
                source=f"src/repro_torch/csrc/{KERNELS[name][2]}.cu",
                replaces=KERNELS[name][3], launches=counts[name],
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
        del x
        torch.cuda.empty_cache()
    return entries


def matmul_cases(dev):
    """Real sizes from the served models' weights ((K, N) in the port:
    `models/ffn.py`, `models/ssm.py`), unreduced: (label, input maker →
    (x, w), out dtype, epilogue).  x ~ N(0, 1), w ~ N(0, 1/K), so outputs
    are O(1)."""
    import functools
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    T = 4 * 4608                 # the §4 traffic's prefill tokens

    def make(M, K, N, dtype):
        def inputs():
            x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            w = (torch.randn((K, N), generator=gen, device=dev)
                 * K ** -0.5).to(dtype)
            return x, w
        return inputs

    def unembed():   # gemma2-2b's tied table, read as table.t()
        x = torch.randn((4, 2304), generator=gen, device=dev).to(bf16)
        table = (torch.randn((256000, 2304), generator=gen, device=dev)
                 * 2304 ** -0.5).to(bf16)
        return x, table.t()

    return [
        ("gemma2-2b FFN gate + tanh-gelu (18432, 2304) @ (2304, 9216) bf16",
         make(T, 2304, 9216, bf16), None,
         functools.partial(F.gelu, approximate="tanh")),
        ("gemma2-2b FFN down (18432, 9216) @ (9216, 2304) bf16",
         make(T, 9216, 2304, bf16), None, None),
        ("mamba2-1.3b in_proj (18432, 2048) @ (2048, 8512) bf16",
         make(T, 2048, 8512, bf16), None, None),
        ("gemma2-2b decode unembed (4, 2304) @ table.t() (2304, 256000) "
         "bf16 -> f32", unembed, f32, None),
        ("mamba2-1.3b out_proj (18432, 4096) @ (4096, 2048) f32",
         make(T, 4096, 2048, f32), None, None),
    ]


def matmul_edge_cases(dev):
    """Small cases on every route, (label, x, w, out dtype, epilogue): the
    four tile layouts of the bf16 kernel and the fp32 kernel's operand
    types; ragged M, N and K (the shapes where the Pallas kernel gives
    NaN among them), M = 1, transposed, sliced and stepped views, each
    fused epilogue, into bf16 and fp32."""
    import functools
    import torch
    import torch.nn.functional as F
    from repro_torch.core import instream
    gen = torch.Generator(dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    cases = []
    pairs = ((bf16, bf16), (f32, f32), (bf16, f32), (f32, bf16))
    for M, K, N in ((300, 700, 300), (64, 576, 64), (100, 200, 90),
                    (1, 2304, 9216), (1, 300, 257), (129, 33, 130)):
        for a, b in pairs:
            x, w = randn((M, K), a), randn((K, N), b, K ** -0.5)
            for out in (None, f32):
                cases.append((f"({M}, {K}) {a} @ ({K}, {N}) {b} -> {out}",
                              x, w, out, None))
    for dt in (bf16, f32):
        big = randn((300, 520), dt)
        x, w = big[:, :256], big[:256, 3:259] * 0.1
        for label, xv, wv in (
                ("x.t()", x.t()[:, :200], w[:200]), ("w.t()", x, w.t()),
                ("x.t() @ w.t()", x.t()[:, :256], w.t()),
                ("x offset 1", big[1:, 1:257], w),
                ("w stepped", x, big[7:263, ::2]),
                ("both stepped", big[::2, :256],
                 big[:256, :300].t()[:256, ::3])):
            for out in (None, f32):
                cases.append((f"{label} {dt} -> {out}", xv, wv, out, None))
        x, w = randn((257, 1000), dt), randn((1000, 383), dt, 0.05)
        for name, epi in (("relu", torch.relu), ("F.relu", F.relu),
                          ("silu", F.silu),
                          ("tanh-gelu", functools.partial(
                              F.gelu, approximate="tanh")),
                          ("scale", instream.scale),
                          ("scale -0.3", functools.partial(instream.scale,
                                                           factor=-0.3))):
            for out in (None, f32):
                cases.append((f"{name} {dt} -> {out}", x, w, out, epi))
    return cases


def library_matmul(x, w, out, epi):
    """One PyTorch call for the same function, then the same epilogue:
    `torch.matmul` (cuBLAS; TF32 off), or `torch.mm(..., out_dtype=)`
    where bf16 operands give an fp32 output.  Only timed here: the port
    never calls it."""
    import torch

    def call():
        y = torch.matmul(x, w) if out in (None, x.dtype) else \
            torch.mm(x, w, out_dtype=out)
        return y if epi is None else epi(y)
    return call


def phase_matmul(mods):
    """The matmul kernel against `matmul_ref` on the card, at real sizes
    and on edge cases; the counter, set to 0 first, must equal the calls
    made; then kernel, plain and library times.  Returns the JSON entry
    (its times those of the first real-size case)."""
    import torch
    from repro_torch.kernels.matmul_dma import matmul, matmul_ref
    dev = torch.device("cuda")
    reset(mods, ["matmul_dma"])
    calls, worst = 0, 0.0

    def compare(label, got, want, tol_dtype):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rel = err / max(float(want.float().abs().max()), 1e-6)
        if got.shape != want.shape or got.dtype != want.dtype or not (
                math.isfinite(rel) and rel < TOL[tol_dtype]):
            raise AssertionError(f"matmul {label}: rel err {rel:.3e} (tol "
                                 f"{TOL[tol_dtype]:.0e}), {got.dtype} "
                                 f"{tuple(got.shape)} vs {want.dtype} "
                                 f"{tuple(want.shape)}")
        return err, rel

    def out_name(x, out):
        return str(out or x.dtype).replace("torch.", "")

    real = matmul_cases(dev)
    for label, make, out, epi in real:
        x, w = make()
        got = matmul(x, w, out, epi)
        calls += 1
        err, rel = compare(label, got, matmul_ref(x, w, out, epi),
                           out_name(x, out))
        worst = max(worst, err)
        log(f"[matmul] {label}: rel err {rel:.2e} (tol "
            f"{TOL[out_name(x, out)]:.0e})")
        del x, w, got
        torch.cuda.empty_cache()
    edge = matmul_edge_cases(dev)
    for label, x, w, out, epi in edge:
        got = matmul(x, w, out, epi)
        calls += 1
        err, _ = compare(label, got, matmul_ref(x, w, out, epi),
                         out_name(x, out))
        worst = max(worst, err)
    del edge
    count = read(mods, ["matmul_dma"])["matmul_dma"]
    if count != calls:
        raise AssertionError(f"matmul launches {count}, calls made {calls}")
    log(f"[matmul] {len(real)} real-size and {calls - len(real)} small cases "
        f"within tolerance of matmul_ref; launches {count} (= the calls "
        f"made); max abs err {worst:.3e}")

    # timing, after the count: CUDA events, after warm-up
    entry = None
    for label, make, out, epi in real:
        x, w = make()
        M, K = x.shape
        N = w.shape[1]
        lib = library_matmul(x, w, out, epi)
        compare(f"library {label}", lib(), matmul_ref(x, w, out, epi),
                out_name(x, out))
        ms = time_ms(lambda: matmul(x, w, out, epi), iters=20)
        plain_ms = time_ms(lambda: matmul_ref(x, w, out, epi), iters=5,
                           warmup=1)
        lib_ms = time_ms(lib, iters=20)
        flops = 2 * M * N * K
        nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                  + M * N * (4 if out_name(x, out) == "float32" else 2))
        kind = "bfloat16" if x.dtype == w.dtype == torch.bfloat16 \
            else "float32"
        b_ms, b_by = bound(flops, nbytes, kind)
        log(f"[matmul] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB) | kernel "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s, "
            f"{100 * b_ms / ms:.1f}% of bound, {ms / lib_ms:.2f}x library")
        if entry is None:
            entry = dict(name="matmul_dma", route="cuda",
                         source="src/repro_torch/csrc/matmul_dma.cu",
                         replaces=KERNELS["matmul_dma"][3], launches=count,
                         max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del x, w
        torch.cuda.empty_cache()
    return entry


def phase_serve(arch, mods):
    """Full-width `arch` answers the traffic twice; returns the launches
    of the first run."""
    import torch
    from repro_torch.configs import RunConfig, get
    from repro_torch.launch.profile_serve import (
        HOT_ROW, HOT_TEMPERATURE, MAX_LEN, NEW_TOKENS, PROMPTS,
        make_requests)
    from repro_torch.models import LM
    from repro_torch.models.common import unembed
    from repro_torch.serve import ServeEngine

    cfg = get(arch)
    t0 = time.perf_counter()
    model = LM(cfg, RunConfig(dtype="bfloat16"), seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {arch} full width: {cfg.n_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params "
        f"(bf16), seeded init {time.perf_counter() - t0:.1f} s")
    engine = ServeEngine(model, max_len=MAX_LEN, seed=0)

    # Time the engine's two phases: wrap its step closures with a
    # synchronize on each side, and check the logits they return.
    phases = {"prefill": [], "decode": []}

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = fn(*args)
            torch.cuda.synchronize()
            phases[key].append(time.perf_counter() - t)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits in {key}")
            return logits, caches
        return run

    engine._prefill = timed(engine._prefill, "prefill")
    engine._decode = timed(engine._decode, "decode")

    runs = []
    for attempt in range(2):
        for key in phases:
            phases[key].clear()
        reset(mods)                            # the main path's run
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = engine.generate(make_requests(cfg.vocab_size))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read(mods)
        steps = len(phases["decode"])
        want = expected_launches(cfg, steps)
        if counts != want:
            raise AssertionError(f"{arch} launches {counts}, want {want}")
        for r in out:
            if len(r.output) != NEW_TOKENS or not all(
                    0 <= t < cfg.vocab_size for t in r.output):
                raise AssertionError(f"bad output {r.output}")
        n_new = sum(len(r.output) for r in out)
        runs.append(dict(outputs=[r.output for r in out], counts=counts,
                         steps=steps))
        log(f"[serve] {arch} run {attempt}: prompts {PROMPTS} left-padded, "
            f"{NEW_TOKENS} new tokens, row {HOT_ROW} at T="
            f"{HOT_TEMPERATURE} | prefill {phases['prefill'][0]:.3f} s, "
            f"decode {1e3 * sum(phases['decode']) / steps:.2f} ms/step "
            f"over {steps} steps, {n_new / wall:.1f} tokens/s "
            f"({wall:.2f} s wall), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items()))
    for i in range(len(PROMPTS)):
        if i != HOT_ROW and runs[0]["outputs"][i] != runs[1]["outputs"][i]:
            raise AssertionError(f"{arch}: greedy row {i} differs on rerun")
    log(f"[serve] {arch}: greedy rows identical on rerun; row 0 starts "
        f"{runs[0]['outputs'][0][:8]}")

    # cost of fp32 logits: upcast operands vs a bf16 product, decode shape
    x = torch.randn(len(PROMPTS), cfg.d_model, device="cuda",
                    dtype=torch.bfloat16)
    up_ms = time_ms(lambda: unembed(model.embed, x))
    bf_ms = time_ms(lambda: x @ model.embed.t())
    log(f"[serve] {arch} unembed (B {len(PROMPTS)}, vocab {cfg.vocab_size}): "
        f"fp32 upcast {up_ms:.3f} ms vs bf16 product {bf_ms:.3f} ms per step")
    return runs[0]["counts"]


def phase_card_vs_cpu(cfg, label, mods):
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.models import LM, lm_decode_step, lm_prefill

    f32 = RunConfig(dtype="float32")
    gpu = LM(cfg, f32, seed=1, device="cuda")
    cpu = LM(cfg, f32, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    B, S, steps = 2, 600, 3
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + steps)))
    max_len = S + steps
    reset(mods)
    worst = 0.0
    lg, cg = lm_prefill(gpu, toks[:, :S].cuda(), max_len=max_len)
    lc, cc = lm_prefill(cpu, toks[:, :S], max_len=max_len)
    pairs = [(lg, lc)]
    for i in range(steps):
        t = toks[:, S + i:S + i + 1]
        lg, cg = lm_decode_step(gpu, cg, t.cuda(), S + i)
        lc, cc = lm_decode_step(cpu, cc, t, S + i)
        pairs.append((lg, lc))
    counts, want = read(mods), expected_launches(cfg, steps)
    for g, c in pairs:
        # the padded vocab rows hold -1e30 on both sides: leave them out
        g, c = g[:, :cfg.vocab_size].cpu(), c[:, :cfg.vocab_size]
        rel = float((g - c).abs().max() / c.abs().max())
        if not rel < 1e-4:
            raise AssertionError(f"card vs CPU logits rel err {rel:.2e}")
        worst = max(worst, rel)
    if counts != want:
        raise AssertionError(f"card path launches {counts}, want {want}")
    log(f"[card-vs-cpu] 2 layers ({label}) d {cfg.d_model} fp32, B {B}, "
        f"prompt {S}, {steps} decode steps: max logits rel err {worst:.2e} "
        f"(tol 1e-4)")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke.py: {SRC / 'repro_torch'} not found; "
                         f"run it from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    # compiled code of the library yardstick stays inside the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "torchinductor"),
                     ("TRITON_CACHE_DIR", "triton/cache"),
                     ("TRITON_HOME", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    import torch
    from repro_torch.configs import ATTN_FULL, ATTN_SWA, get
    smi = phase_device()
    phase_build()
    mods = {name: importlib.import_module(k[0])
            for name, k in KERNELS.items()}
    entries = phase_kernels(mods["flash_attention"], mods["decode_attention"])
    entries["ssd"] = phase_ssd_kernel(mods["ssd"])
    entries.update(phase_dma(mods))
    entries["matmul_dma"] = phase_matmul(mods)
    gemma = phase_serve("gemma2-2b", mods)
    mamba = phase_serve("mamba2-1.3b", mods)
    entries["flash_attention"]["launches"] = gemma["flash_attention"]
    entries["decode_attention"]["launches"] = gemma["decode_attention"]
    entries["ssd"]["launches"] = mamba["ssd"]
    phase_card_vs_cpu(dataclasses.replace(
        get("gemma2-2b"), n_layers=2,
        layer_pattern=(((ATTN_SWA, ATTN_FULL), 1),)), "SWA, FULL", mods)
    phase_card_vs_cpu(dataclasses.replace(get("mamba2-1.3b"), n_layers=2),
                      "SSM, SSM", mods)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: e[k] for k in keys}
                                for e in entries.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
