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
               the flash and matmul libraries' SASS (`cuobjdump -sass`)
               must hold wgmma (`HGMMA`) and TMA loads (`UTMALDG`), the
               copy library's the bulk copy (`UBLKCP`), the SSD library's
               mma.sync (`HMMA`) and cp.async (`LDGSTS`);
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card (tolerance relative to max|plain|: 2e-2 bf16, 1e-4
               fp32; for flash attention, each output row's error against
               that row's max|plain|), with its time from CUDA events
               beside the plain version's time and the card's lower bound
               for the same work: flash and decode attention at gemma2-2b's
               prefill and decode shapes, and flash again at the prefill
               shape with q scaled so that the scores reach the tanh
               softcap, with torch's own `flex_attention` (compiled, tanh
               softcap as its score_mod, the case's causal and
               sliding-window mask as its block mask) timed as a
               yardstick for every case, and each flash case's TFLOP/s,
               share of its bound and factor against it; decode timed by
               its device time (torch.profiler: the split kernel is
               faster than its launch), at the main shape in 5 rounds in
               turns with `flex_attention`, median and spread, and at the
               GQA groups 5, 6 and 16 of the configs still to port; the
               SSD scan at
               mamba2-1.3b's prefill shape in fp32 and bf16, on views of
               (B, S, ...) tensors as the SSM layer passes them, both on
               the tensor-core route (`ssd.route`, counted by route), with
               four groups, and a small case and one whose A·dt overflows
               exp above the diagonal (A −40, dt 0.1) also held against
               the sequential recurrence; its bound both as 3xTF32 on the
               tensor cores and on the CUDA cores, each with its share;
  4. dma     — the quickstart's path through the port's descriptor
               plane (host NumPy: a register front-end's 3-D gather, the
               presets' 4 KiB cycles), a `plan_nd_copy` plan whose
               `copy_2d` on the card equals `copy_2d_reference` byte for
               byte, an engine's Init PRNG stream equal to `prng_fill` on
               the card; then the Init and copy kernels at real sizes
               from gemma2-2b and mamba2-1.3b (2.4 GB casts and fills, the
               SSD input's strided view) and small edge cases in every
               dtype (the bulk copy's chunk edges and memset's block
               edges among them), bit for bit against their plain
               versions, each real copy's route printed and the bf16
               copy on route "bulk"; the five launch counters, set to 0
               first, must equal the calls made, and the copy's counters
               by route sum to its own; then each kernel and its library
               call by device time in turns (5 rounds, median and
               spread), and the plain version;
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
               launch counter, set to 0 first, must equal the calls made,
               and each real size must take its route (the bf16 ones the
               wgmma routes, by the per-route counter); then the chosen
               route, the mma_sync route and `torch.matmul` (cuBLAS, TF32
               off, then the same epilogue) in turns, and the plain
               version; then both wgmma routes at M 1 to 128 (the small-M
               threshold);
  6. serve   — full-width gemma2-2b (26 layers, d 2304, vocab 256,000)
               and then full-width mamba2-1.3b (48 SSM layers, d 2048,
               vocab 50,280), seeded random weights, bf16, each answer
               4 left-padded requests through `ServeEngine.generate`,
               twice; the launch counters, set to 0 before each run, must
               show every attention and SSD call went through the kernels
               (every SSD call on the tensor cores) and no other kernel ran
               (no copy, Init or matmul kernel);
  7. card vs CPU — 2 gemma2 layers (SWA, FULL) and 2 mamba2 layers at
               full width in fp32, a 600-token prompt and 3 decode steps:
               logits of the CUDA path agree with the CPU path within 1e-4;
               then the 2 gemma2 layers in bf16, the serving dtype, on the
               card: logits through the attention kernels agree with those
               through their plain versions within 2e-2.

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

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit); fp32
# products on the tensor cores as three TF32 products each (3xTF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,
              "3xtf32": 494.7e12 / 3}
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


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 5
              ) -> float:
    """Mean milliseconds of device time per call: the time of the kernels
    the call launches, from torch.profiler, without the host's time to
    launch them, which CUDA events around back-to-back calls show once a
    call's kernels take less time than its launch.  The profiler now and
    then drops kernel records: one of a session's 20, or all of them in a
    session where it requests a new activity buffer (runs AI, AJ).  So
    each kernel counts as its mean recorded time times its launches a
    call: the nearest whole number to its records over the calls, or
    that ratio itself where it rounds to 0 (a kernel some calls launch).
    A session with no device record is taken again, `tries` times at
    most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = prof.key_averages()
        total = sum(e.self_device_time_total / e.count *
                    (round(e.count / iters) or e.count / iters)
                    for e in records
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.count)
        if total > 0:
            return total / 1e3
    seen = [(e.key[:60], e.count) for e in records if e.count]
    raise RuntimeError(f"the profiler recorded no device time for {iters} "
                       f"calls in {tries} sessions; the last one's records: "
                       f"{seen}")


def in_turns(fns, rounds: int = 5):
    """Device ms of each callable, timed in turns (the order reversed every
    other round): {name: (median, min, max)}."""
    import statistics
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            try:
                times[name].append(device_ms(fns[name]))
            except RuntimeError as e:
                raise RuntimeError(f"{name}, round {r}: {e}") from None
    return {name: (statistics.median(t), min(t), max(t))
            for name, t in times.items()}


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
    # flash's bf16 route and matmul's wgmma routes must run on wgmma fed
    # by TMA, the copy engine's bulk route on the TMA's bulk copies, the
    # SSD's tensor-core route on mma.sync fed by cp.async
    for name, ops in (("flash_attention", ("HGMMA", "UTMALDG")),
                      ("matmul_dma", ("HGMMA", "UTMALDG")),
                      ("copy_engine", ("UBLKCP",)),
                      ("ssd", ("HMMA", "LDGSTS"))):
        sass = subprocess.run(
            [runtime.cuda_tool("cuobjdump"), "-sass",
             str(runtime.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in ops}
        log(f"[build] {name} SASS: " +
            ", ".join(f"{n} {op}" for op, n in counts.items()))
        if not all(counts.values()):
            raise AssertionError(f"{name} SASS lacks one of {ops}: {counts}")


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

    def compare(name, got, want, dtype, rows=False):
        """Max abs error, and the error relative to max|want|, or with
        `rows` the largest of each row's error against its own max|want|
        (a row with no live key is 0 on both sides)."""
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        abs_err = float(err.max())
        if rows:
            rel = float((err.amax(-1) / want.float().abs().amax(-1)
                         .clamp_min(1e-6)).max())
        else:
            rel = abs_err / max(float(want.float().abs().max()), 1e-6)
        if not (math.isfinite(rel) and rel < TOL[dtype]):
            raise AssertionError(f"{name}: rel err {rel:.3e} >= "
                                 f"{TOL[dtype]:.0e}")
        return abs_err, rel

    def row_rms(got, want):
        """Mean over rows of rms(got − want) / rms(want): finer than the
        checked maximum, which one bf16 step at a row's largest value
        already sets to 2^-8 .. 2^-7.  Logged, not checked."""
        err = (got.float() - want.float()).pow(2).mean(-1).sqrt()
        return float((err / want.float().pow(2).mean(-1).sqrt()
                      .clamp_min(1e-6)).mean())

    entries = {}
    B, Hq, Hkv, D, scale, cap = 4, 8, 4, 256, 1 / 16, 50.0

    def softcap_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def library_call(label, q, k, v, mask_mod, want, dtype, rows=False):
        """flex_attention, checked against the plain version; None where
        this torch has none."""
        if library is None:
            return None
        flex, create_block_mask = library
        mask = create_block_mask(mask_mod, None, None, q.shape[2],
                                 k.shape[2], device=dev)

        def call():
            return flex(q, k, v, score_mod=softcap_mod, block_mask=mask,
                        scale=scale, enable_gqa=True)
        got = call()
        _, rel = compare(f"flex_attention {label}", got, want, dtype, rows)
        rms = f", row rms err {row_rms(got, want):.2e}" if rows else ""
        log(f"[kernels] library flex_attention {label}: rel err {rel:.2e}"
            f"{rms}")
        return call

    def library_ms(label, q, k, v, mask_mod, want, dtype, rows=False):
        """Check flex_attention against the plain version, then time it."""
        call = library_call(label, q, k, v, mask_mod, want, dtype, rows)
        if call is None:
            return None
        ms = time_ms(call)
        log(f"[kernels] library flex_attention {label}: {ms:.4f} ms")
        return ms

    def flash_mask(causal, window):
        def mask_mod(b, h, q_idx, kv_idx):
            live = kv_idx >= 0
            if causal:
                live = live & (q_idx >= kv_idx)
            if window:
                live = live & (q_idx - kv_idx < window)
            return live
        return mask_mod

    flash_cases = [
        # (label, S, causal, window, dtype, main path?, q multiplier)
        ("full", 4608, True, 0, "bfloat16", True, 1.0),
        ("local", 4608, True, 4096, "bfloat16", False, 1.0),
        ("full", 4608, True, 0, "float32", False, 1.0),
        ("local", 4608, True, 4096, "float32", False, 1.0),
        ("ragged", 4133, True, 4096, "bfloat16", False, 1.0),
        ("noncausal", 1000, False, 0, "bfloat16", False, 1.0),
        # scores ~ N(0, 30²), |s| from about 10 to past 100: the softcap
        # moves them by up to half (at randn scale by s³/(3·cap²) < 0.03)
        ("capped", 4608, True, 0, "bfloat16", False, 30.0),
        ("capped", 4608, True, 0, "float32", False, 30.0),
    ]
    worst = 0.0
    for label, S, causal, w, dtype, main, qmul in flash_cases:
        q = (randn((B, Hq, S, D), "float32") * qmul).to(DT[dtype])
        k, v = randn((B, Hkv, S, D), dtype), randn((B, Hkv, S, D), dtype)
        kw = dict(causal=causal, window=w, softcap=cap, scale=scale)
        want = attention_ref(q, k, v, **kw)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        abs_err, rel = compare(f"flash {label} {dtype}", got, want, dtype,
                               rows=True)
        rms = row_rms(got, want)
        del got
        worst = max(worst, abs_err)
        ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
        plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=5,
                           warmup=1)
        pairs = flash_live_pairs(S, S, causal, w) * B * Hq
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(4 * D * pairs, nbytes, dtype)
        lib_ms = library_ms(f"flash {label} S{S} w{w} {dtype}", q, k, v,
                            flash_mask(causal, w), want, dtype, rows=True)
        versus = "no library" if lib_ms is None else \
            f"flex_attention {lib_ms:.4f} ms, {ms / lib_ms:.2f}x library"
        log(f"[kernels] flash {label} B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} "
            f"w{w} cap{cap:g} q x{qmul:g} {dtype}: row rel err {rel:.2e} "
            f"(tol {TOL[dtype]:.0e}), row rms err {rms:.2e} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}) | kernel "
            f"{4 * D * pairs / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * b_ms / ms:.1f}% of bound, {versus}")
        if main:
            entries["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=KERNELS["flash_attention"][3],
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)
        del q, k, v, want
    entries["flash_attention"]["max_abs_err"] = worst

    # Decode: the split kernel takes less device time than the host needs
    # to launch it, so its time is device time from the profiler (CUDA
    # events around back-to-back calls, launch included, are logged too);
    # at the main shape it is timed in turns with flex_attention.
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

                def kern():
                    return da.decode_attention_cuda(q, k, v, kv_len=kv_len,
                                                    **kw)
                ms, call_ms = device_ms(kern, iters=50), time_ms(kern,
                                                                 iters=50)
                plain_ms = time_ms(lambda: decode_attention_ref(
                    q, k, v, kv_len=n, **kw))
                live = n - (max(0, n - w) if w else 0)
                nbytes = (2 * B * Hkv * live * D + 2 * q.numel()) \
                    * q.element_size()
                b_ms, b_by = bound(4 * B * Hq * live * D, nbytes, dtype)
                log(f"[kernels] decode B{B} Hq{Hq} Hkv{Hkv} S{MAX_LEN} "
                    f"D{D} kv_len {n} w{w} {dtype}: rel err {rel:.2e} (tol "
                    f"{TOL[dtype]:.0e}) | kernel {ms:.4f} ms device "
                    f"({call_ms:.4f} ms a call with its launch), plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                    f"{100 * b_ms / ms:.1f}% of bound")
                if dtype == "bfloat16" and n == 4608 and w == 0:
                    flex = library_call(
                        f"decode kv{n} w{w} {dtype}", q[:, :, None], k, v,
                        lambda b, h, q_idx, kv_idx: kv_idx < n,
                        want[:, :, None], dtype)
                    turns = in_turns({"kernel": kern, **(
                        {} if flex is None else {"flex_attention": flex})})
                    k_ms = turns["kernel"][0]
                    factor = "" if flex is None else (
                        f"; kernel / flex_attention "
                        f"{k_ms / turns['flex_attention'][0]:.2f}x")
                    log(f"[kernels] decode main shape in turns, device ms "
                        f"median (min-max) over 5 rounds: " + ", ".join(
                            f"{name} {md:.4f} ({lo:.4f}-{hi:.4f})"
                            for name, (md, lo, hi) in turns.items()) +
                        f"{factor}; {100 * b_ms / k_ms:.1f}% of bound")
                    entries["decode_attention"] = dict(
                        name="decode_attention", route="cuda",
                        source="src/repro_torch/csrc/decode_attention.cu",
                        replaces=KERNELS["decode_attention"][3],
                        ms=turns["kernel"][0], plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=None if flex is None
                        else turns["flex_attention"][0])
        del q, k, v
    # the GQA groups of the configs still to port, each at every head_dim
    # over a 4,640-row cache; at their own head_dim with their own heads:
    # hymba-1.5b (25 / 5, D 64), qwen2.5-32b (40 / 8, D 128),
    # internlm2-20b (48 / 8, D 128), chatglm3-6b (32 / 2, D 128)
    for hq, hkv, d, w in ((25, 5, 64, 1024), (40, 8, 128, 0), (20, 4, 256, 0),
                          (24, 4, 64, 0), (48, 8, 128, 0), (12, 2, 256, 4096),
                          (16, 1, 64, 0), (32, 2, 128, 0),
                          (16, 1, 256, 4096)):
        for dtype in ("bfloat16", "float32"):
            q = randn((B, hq, d), dtype)
            k, v = randn((B, hkv, MAX_LEN, d), dtype), \
                randn((B, hkv, MAX_LEN, d), dtype)
            kw = dict(kv_len=4608, window=w, softcap=cap, scale=d ** -0.5)
            abs_err, rel = compare(
                f"decode G{hq // hkv} D{d} {dtype}",
                da.decode_attention_cuda(q, k, v, **kw),
                decode_attention_ref(q, k, v, **kw), dtype)
            worst = max(worst, abs_err)
            ms = device_ms(lambda: da.decode_attention_cuda(q, k, v, **kw))
            live = min(4608, w) if w else 4608
            nbytes = (2 * B * hkv * live * d + 2 * q.numel()) \
                * q.element_size()
            b_ms, _ = bound(4 * B * hq * live * d, nbytes, dtype)
            log(f"[kernels] decode G{hq // hkv} B{B} Hq{hq} Hkv{hkv} "
                f"S{MAX_LEN} D{d} kv_len 4608 w{w} {dtype}: rel err "
                f"{rel:.2e} (tol {TOL[dtype]:.0e}) | kernel {ms:.4f} ms "
                f"device, bound {b_ms:.5f} ms, {100 * b_ms / ms:.1f}% of "
                f"bound")
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
    """The SSD kernel against its plain versions, each case on the route
    `sk.route` gives it (the main shape, in both dtypes, on the tensor
    cores); returns its JSON entry, whose bound is the least of the two:
    3xTF32 on the tensor cores (165 TFLOP/s) for fp32."""
    import torch
    from repro_torch.kernels.ssd import ssd_chunked_ref, ssd_ref
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    log("[kernels] ssd: no single PyTorch call computes the chunked SSD "
        "scan, so library_ms is null")

    def inputs(B, H, G, S, P, N, dtype, A=None, dt=None):
        """mamba2's ranges: dt = softplus(.) in [0.001, 0.1], A = -exp(A_log)
        with A_log = log(1..H), D = 1.  x, B and C are (B, H or G, S, .)
        views of one (B, S, H·P + 2·G·N) tensor and dt of a (B, S, H) one,
        as the SSM layer passes them.  A number for A or dt fills it."""
        xbc = torch.randn((B, S, H * P + 2 * G * N), generator=gen,
                          device=dev)
        xbc[..., H * P:] *= 0.3
        xs, Bs, Cs = torch.split(xbc.to(DT[dtype]), [H * P, G * N, G * N],
                                 dim=-1)
        dtv = 0.001 + 0.099 * torch.rand((B, S, H), generator=gen,
                                         device=dev)
        if dt is not None:
            dtv.fill_(dt)
        Av = -torch.arange(1, H + 1, device=dev, dtype=torch.float32) \
            if A is None else torch.full((H,), A, device=dev)
        return (xs.reshape(B, S, H, P).transpose(1, 2), dtv.transpose(1, 2),
                Av, torch.ones(H, device=dev),
                *(t.reshape(B, S, G, N).transpose(1, 2) for t in (Bs, Cs)))

    def rel(got, want):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-6)

    cases = [
        # (label, B, H, G, S, P, N, dtype, main path?, A, dt)
        ("main", 4, 64, 1, 4608, 64, 128, "float32", True, None, None),
        ("main", 4, 64, 1, 4608, 64, 128, "bfloat16", False, None, None),
        ("groups", 2, 64, 4, 1024, 64, 128, "float32", False, None, None),
        ("small", 1, 4, 1, 256, 64, 128, "float32", False, None, None),
        # cum_t − cum_s up to 508 above the diagonal: exp overflows there
        ("overflow", 1, 4, 1, 512, 64, 128, "float32", False, -40.0, 0.1),
    ]
    L, worst, entry = 128, 0.0, None
    for label, B, H, G, S, P, N, dtype, main, A, dtc in cases:
        args = inputs(B, H, G, S, P, N, dtype, A, dtc)
        route = sk.route(args[0], args[4], args[5], L)
        if label == "main" and route != "tensor_cores":
            raise AssertionError(f"ssd main {dtype}: route {route}, want "
                                 f"tensor_cores")
        before = dict(sk.launches_by_route)
        y, state = sk.ssd_cuda(*args, chunk=L)
        if sk.launches_by_route[route] != before[route] + 1:
            raise AssertionError(f"ssd {label} {dtype}: no launch counted "
                                 f"on route {route}")
        wy, wstate = ssd_chunked_ref(*args, chunk=L, return_state=True)
        checks = {"y": rel(y, wy), "state": rel(state, wstate)}
        if label in ("small", "overflow"):
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
        if dtype == "float32":   # 3xTF32 on the tensor cores; CUDA cores
            b_ms, b_by = bound(flops, nbytes, "3xtf32")
            cc_ms, cc_by = bound(flops, nbytes, "float32")
            bounds = (f"bound {b_ms:.4f} ms ({b_by}, 3xTF32 at 165 TFLOP/s)"
                      f" {100 * b_ms / ms:.1f}%, CUDA-core bound "
                      f"{cc_ms:.4f} ms ({cc_by}, 67 TFLOP/s) "
                      f"{100 * cc_ms / ms:.1f}%")
        else:
            b_ms, b_by = bound(flops, nbytes, dtype)
            bounds = f"bound {b_ms:.4f} ms ({b_by}) {100 * b_ms / ms:.1f}%"
        log(f"[kernels] ssd {label} B{B} H{H} G{G} S{S} P{P} N{N} L{L} "
            f"{dtype} on route {route}: rel err " + ", ".join(
                f"{what} {r:.2e}" for what, (_, r) in checks.items()) +
            f" (tol {TOL[dtype]:.0e}) | kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, {bounds}, "
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
    written, flops, the route the call must take or None where the kernel
    has one).  Inputs are made on `dev` when asked for."""
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
         lambda x: x.to(f32), 256000 * 2304 * (2 + 4), 0, "convert"),
        ("copy_2d bf16 (256000, 2304)", "copy_2d", table,
         lambda x: copy_2d(x), lambda x: copy_2d_ref(x),
         lambda x: x.clone(), 256000 * 2304 * 4, 0, "bulk"),
        ("strided_copy_nd f32 (4, 64, 4608, 64) of (4, 4608, 4352)",
         "strided_copy_nd", ssm_x, strided_copy_nd, strided_copy_nd_ref,
         lambda x: x.contiguous(), 2 * 4 * 64 * 4608 * 64 * 4, 0, None),
        ("memset 0 bf16 (3860480, 256)", "memset", lambda: None,
         lambda _: memset(kv, 0, bf16, dev),
         lambda _: memset_ref(kv, 0, bf16, dev),
         lambda _: torch.zeros(kv, dtype=bf16, device=dev),
         kv[0] * kv[1] * 2, 0, None),
        ("iota_fill int32 (16384, 16384)", "iota_fill", lambda: None,
         lambda _: iota_fill(idx, start, i32, dev),
         lambda _: iota_fill_ref(idx, start, i32, dev),
         lambda _: torch.arange(start, start + n_idx, dtype=i32,
                                device=dev).view(idx), n_idx * 4, 0, None),
        ("prng_fill f32 (256000, 2304)", "prng_fill", lambda: None,
         lambda _: prng_fill((256000, 2304), 7, f32, dev),
         lambda _: prng_fill_ref((256000, 2304), 7, f32, dev), None,
         256000 * 2304 * 4, 0, None),
    ]


def dma_edge_cases(dev):
    """Small cases, (label, kernel, kernel call, plain call): every dtype
    the Pallas kernels take at (8, 128), (100, 300) and (256, 512); views
    one element past an aligned base, transposed 5-D views, expanded
    (stride 0) views, a 1-D input; the fused transforms; the bulk copy at
    its chunk's edges, memset at a block's."""
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
    # the bulk copy below its size threshold, and memset: a chunk or a
    # block's span (256 threads x 16 bytes) ± 16 bytes, ragged tails
    ce = importlib.import_module("repro_torch.kernels.copy_engine."
                                 "copy_engine")
    for n in (7, 16, ce.BULK_CHUNK_BYTES - 16, ce.BULK_CHUNK_BYTES + 16,
              3 * ce.BULK_CHUNK_BYTES + 48):
        x = rand((1, n), torch.int8)
        cases.append((f"copy_2d bulk {n} B", "copy_2d",
                      functools.partial(ce.copy_2d_cuda, x,
                                        kernel_route="bulk"),
                      functools.partial(copy_2d_ref, x)))
    for n in (3, 8, 2048 - 8, 2048 + 8, 3 * 2048 + 27):
        shape = (1, n)
        cases.append((f"memset -0.0 bf16 {shape}", "memset",
                      functools.partial(memset, shape, -0.0,
                                        torch.bfloat16, dev),
                      functools.partial(memset_ref, shape, -0.0,
                                        torch.bfloat16, dev)))
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


def by_route(mods):
    """The launch counters by route, by kernel: copy_2d's."""
    return {"copy_2d": mods["copy_2d"].copy_2d_launches_by_route}


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
    for routes in by_route(mods).values():
        routes.update(dict.fromkeys(routes, 0))
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

    # real sizes, then edge cases: kernel == plain, bit for bit; each real
    # copy_2d call on its route, by the counters by route
    real = []
    dev = torch.device("cuda")
    for case in dma_cases(dev):
        label, name, make, kern, plain, lib, nbytes, flops, want = case
        x = make()
        routes = by_route(mods).get(name, {})
        before = dict(routes)
        got = kern(x)
        calls[name] += 1
        took = [r for r in routes if routes[r] != before[r]]
        log(f"[dma] {label}: route {', '.join(took) or 'its one kernel'}")
        if want is not None and took != [want]:
            raise AssertionError(f"{label}: took routes {took}, not {want}")
        if not bits_equal(got, plain(x)):
            raise AssertionError(f"{label}: kernel != plain version")
        del got
        real.append(case)
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
    route_counts = {k: dict(v) for k, v in by_route(mods).items()}
    for name, routes in route_counts.items():
        if sum(routes.values()) != counts[name]:
            raise AssertionError(f"{name} launches by route {routes}, "
                                 f"launches {counts[name]}")
    log(f"[dma] {len(real)} real-size and {len(edge)} small cases bit for "
        f"bit against the plain versions; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items()) +
        " (= the calls made); by route " +
        "; ".join(f"{k} {v}" for k, v in route_counts.items()))

    # timing, after the count: device time from the profiler, the kernel
    # and its library call in turns; an entry for each kernel's first
    # case, and one for the bf16 copy's bulk route ("copy_2d bulk", its
    # launches those of that route)
    entries = {}
    for label, name, make, kern, plain, lib, nbytes, flops, want in real:
        x = make()
        fns = {"kernel": lambda: kern(x)}
        if lib is not None:
            fns["library"] = lambda: lib(x)
        turns = in_turns(fns, rounds=5)
        ms = turns["kernel"][0]
        lib_ms = turns["library"][0] if lib is not None else None
        plain_ms = device_ms(lambda: plain(x), iters=3, warmup=1)
        b_ms, b_by = bound(flops, nbytes, "float32")
        spread = ", ".join(f"{n} {m:.4f} ({lo:.4f}-{hi:.4f})"
                           for n, (m, lo, hi) in turns.items())
        log(f"[dma] {label}: device ms in turns, median (min-max) of 5: "
            f"{spread}; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / 1e9:.3f} GB), kernel {b_ms / ms:.1%} of "
            f"it" + (f", {ms / lib_ms:.3f}x the library"
                     if lib_ms is not None else ""))
        key = name if name not in entries else f"{name} {want}"
        if key not in entries:
            entries[key] = dict(
                name=key, route="cuda",
                source=f"src/repro_torch/csrc/{KERNELS[name][2]}.cu",
                replaces=KERNELS[name][3],
                launches=counts[name] if key == name else
                route_counts[name][want],
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
        del x
        torch.cuda.empty_cache()
    return entries


def matmul_cases(dev):
    """Real sizes from the served models' weights ((K, N) in the port:
    `models/ffn.py`, `models/ssm.py`), unreduced: (label, input maker →
    (x, w), out dtype, epilogue, the route the case must take).  x ~ N(0,
    1), w ~ N(0, 1/K), so outputs are O(1)."""
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
         functools.partial(F.gelu, approximate="tanh"), "wgmma"),
        ("gemma2-2b FFN down (18432, 9216) @ (9216, 2304) bf16",
         make(T, 9216, 2304, bf16), None, None, "wgmma"),
        ("mamba2-1.3b in_proj (18432, 2048) @ (2048, 8512) bf16",
         make(T, 2048, 8512, bf16), None, None, "wgmma"),
        ("gemma2-2b decode unembed (4, 2304) @ table.t() (2304, 256000) "
         "bf16 -> f32", unembed, f32, None, "wgmma_small_m"),
        ("mamba2-1.3b out_proj (18432, 4096) @ (4096, 2048) f32",
         make(T, 4096, 2048, f32), None, None, "fp32"),
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
    made, and each real size must take its route (the wgmma routes for
    bf16); then kernel, mma_sync, plain and library times, and the two
    wgmma routes at M 1 to 128.  Returns the JSON entry (its times those
    of the first real-size case)."""
    import collections
    import torch
    from repro_torch.kernels.matmul_dma import matmul, matmul_ref
    mm = mods["matmul_dma"]
    dev = torch.device("cuda")
    reset(mods, ["matmul_dma"])
    for name in mm.launches_by_route:
        mm.launches_by_route[name] = 0
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
    for label, make, out, epi, route in real:
        x, w = make()
        before = dict(mm.launches_by_route)
        got = matmul(x, w, out, epi)
        calls += 1
        took = [r for r, n in mm.launches_by_route.items()
                if n != before[r]]
        if took != [route]:
            raise AssertionError(f"matmul {label}: took route {took}, "
                                 f"not {route}")
        err, rel = compare(label, got, matmul_ref(x, w, out, epi),
                           out_name(x, out))
        worst = max(worst, err)
        log(f"[matmul] {label}: route {route}, rel err {rel:.2e} (tol "
            f"{TOL[out_name(x, out)]:.0e})")
        del x, w, got
        torch.cuda.empty_cache()
    edge = matmul_edge_cases(dev)
    edge_routes = collections.Counter()
    for label, x, w, out, epi in edge:
        edge_routes[mm.route(x, w)] += 1
        got = matmul(x, w, out, epi)
        calls += 1
        err, _ = compare(f"{label} ({mm.route(x, w)})", got,
                         matmul_ref(x, w, out, epi), out_name(x, out))
        worst = max(worst, err)
    del edge
    count = read(mods, ["matmul_dma"])["matmul_dma"]
    if count != calls or sum(mm.launches_by_route.values()) != calls:
        raise AssertionError(f"matmul launches {count}, by route "
                             f"{mm.launches_by_route}, calls made {calls}")
    log(f"[matmul] {len(real)} real-size and {calls - len(real)} small cases "
        f"(routes {dict(edge_routes)}) within tolerance of matmul_ref; "
        f"launches {count} (= the calls made), by route "
        f"{mm.launches_by_route}; max abs err {worst:.3e}")

    # timing, after the count: CUDA events, after warm-up; the routes in
    # turns, the one chosen, the mma_sync kernel that bf16 took before
    # the wgmma routes, and the library call
    import statistics
    entry = None
    for label, make, out, epi, route in real:
        x, w = make()
        M, K = x.shape
        N = w.shape[1]
        lib = library_matmul(x, w, out, epi)
        compare(f"library {label}", lib(), matmul_ref(x, w, out, epi),
                out_name(x, out))
        fns = {r: (lambda r=r: mm.matmul_cuda(x, w, out, epi,
                                              kernel_route=r))
               for r in dict.fromkeys((route, "mma_sync"))
               if r in mm.routes(x, w)}
        fns["library"] = lib
        times = {name: [] for name in fns}
        for r in range(3):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[name].append(time_ms(fns[name], iters=20))
        med = {name: statistics.median(t) for name, t in times.items()}
        ms, lib_ms = med[route], med["library"]
        plain_ms = time_ms(lambda: matmul_ref(x, w, out, epi), iters=5,
                           warmup=1)
        flops = 2 * M * N * K
        nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                  + M * N * (4 if out_name(x, out) == "float32" else 2))
        kind = "bfloat16" if x.dtype == w.dtype == torch.bfloat16 \
            else "float32"
        b_ms, b_by = bound(flops, nbytes, kind)
        earlier = "" if route == "fp32" else (
            f", mma_sync {med['mma_sync']:.4f} ms "
            f"({100 * b_ms / med['mma_sync']:.1f}% of bound)")
        log(f"[matmul] {label}: {route} {ms:.4f} ms{earlier}, plain "
            f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms (medians of "
            f"3 rounds in turns: " + ", ".join(
                f"{n} {min(t):.4f}-{max(t):.4f}" for n, t in times.items())
            + f"), bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e9:.3f} GB) | {route} {flops / ms / 1e9:.1f} "
            f"TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s, {100 * b_ms / ms:.1f}% "
            f"of bound, {ms / lib_ms:.2f}x library")
        if entry is None:
            entry = dict(name="matmul_dma", route="cuda",
                         source="src/repro_torch/csrc/matmul_dma.cu",
                         replaces=KERNELS["matmul_dma"][3], launches=count,
                         max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del x, w, fns, lib
        torch.cuda.empty_cache()

    # the small-M threshold: both wgmma routes at M 1 to 128, device time,
    # K 2,304; N 9,216 (gemma2-2b's FFN weight, N-major) and 256,000 (its
    # table.t(), K-major), into fp32
    gen = torch.Generator(dev).manual_seed(7)
    for N, k_major in ((9216, False), (256000, True)):
        w = torch.randn((N, 2304) if k_major else (2304, N), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = w.t() if k_major else w
        for M in (1, 4, 16, 64, 128):
            x = torch.randn((M, 2304), generator=gen,
                            device=dev).to(torch.bfloat16)
            fns = {r: (lambda r=r: mm.matmul_cuda(
                x, w, torch.float32, kernel_route=r))
                for r in mm.routes(x, w) if r != "mma_sync"}
            fns["torch.mm"] = lambda: torch.mm(x, w, out_dtype=torch.float32)
            line = [f"{n} {device_ms(f):.4f}" for n, f in fns.items()]
            nbytes = 2 * (x.numel() + w.numel()) + 4 * M * N
            log(f"[matmul] small-M sweep N {N} ({'K' if k_major else 'N'}-"
                f"major w) M {M}: device ms " + ", ".join(line) +
                f"; bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
                f"route {mm.route(x, w)}")
        del w
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
        ssd_routes = dict(mods["ssd"].launches_by_route)
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
        ssd_tc = mods["ssd"].launches_by_route["tensor_cores"] - \
            ssd_routes["tensor_cores"]
        if ssd_tc != counts["ssd"]:
            raise AssertionError(f"{arch}: {ssd_tc} of {counts['ssd']} SSD "
                                 f"launches on the tensor cores")
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


def phase_bf16_vs_plain(cfg, label, mods):
    """The serving dtype end to end: the 2 layers in bf16 on the card,
    logits through the attention kernels against the same model with the
    kernels' plain versions in their place."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models import LM, lm_decode_step, lm_prefill

    model = LM(cfg, RunConfig(dtype="bfloat16"), seed=1, device="cuda")
    B, S, steps = 2, 600, 3
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + steps))).cuda()

    def run():
        lg, cache = lm_prefill(model, toks[:, :S], max_len=S + steps)
        out = [lg]
        for i in range(steps):
            lg, cache = lm_decode_step(model, cache,
                                       toks[:, S + i:S + i + 1], S + i)
            out.append(lg)
        return out

    reset(mods)
    got = run()
    counts, want_counts = read(mods), expected_launches(cfg, steps)
    if counts != want_counts:
        raise AssertionError(f"bf16 card path launches {counts}, want "
                             f"{want_counts}")
    fa, da = mods["flash_attention"], mods["decode_attention"]
    kernels = fa.flash_attention_cuda, da.decode_attention_cuda
    fa.flash_attention_cuda, da.decode_attention_cuda = \
        attention_ref, decode_attention_ref
    try:
        want = run()
    finally:
        fa.flash_attention_cuda, da.decode_attention_cuda = kernels
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g[:, :cfg.vocab_size].float(), w[:, :cfg.vocab_size].float()
        rel = float((g - w).abs().max() / w.abs().max())
        if not rel < TOL["bfloat16"]:
            raise AssertionError(f"bf16 kernels vs plain logits rel err "
                                 f"{rel:.2e}")
        worst = max(worst, rel)
    log(f"[card-vs-cpu] 2 layers ({label}) d {cfg.d_model} bf16 on the "
        f"card, B {B}, prompt {S}, {steps} decode steps: kernels vs plain "
        f"versions, max logits rel err {worst:.2e} (tol "
        f"{TOL['bfloat16']:.0e})")


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
    gemma2 = dataclasses.replace(get("gemma2-2b"), n_layers=2,
                                 layer_pattern=(((ATTN_SWA, ATTN_FULL), 1),))
    phase_card_vs_cpu(gemma2, "SWA, FULL", mods)
    phase_bf16_vs_plain(gemma2, "SWA, FULL", mods)
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
