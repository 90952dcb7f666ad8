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
     sanitize — the correctness tools, host NumPy: `python -m
               repro_torch.sanitize --demo --corpus --fuzz-racy 64` (the
               racy demo flagged, the in-repo corpus clean, 64 racy
               programs flagged with their codes) and `python -m
               repro_torch.verify --seeds 32`, then with `--differential`,
               each through its `main`, each returning 0, with its seconds;
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
               GQA groups 5, 6 and 16 of the other configs; the
               SSD scan at
               mamba2-1.3b's prefill shape in fp32 and bf16, on views of
               (B, S, ...) tensors as the SSM layer passes them, both on
               the tensor-core route (`ssd.route`, counted by route), with
               four groups, and a small case and one whose A·dt overflows
               exp above the diagonal (A −40, dt 0.1) also held against
               the sequential recurrence; its bound both as 3xTF32 on the
               tensor cores and on the CUDA cores, each with its share;
               then the three kernels at hymba-1.5b's serving shapes
               (flash and decode attention at 25 q and 5 kv heads of 64,
               windows 1,024 and 0, no softcap; the SSD at 50 heads,
               d_state 16, fp32 and bf16, on the tensor cores), each by
               device time in turns with `flex_attention` where it
               computes the same function; then flash and decode
               attention at head_dim 128 in the dense and VLM configs'
               head layouts (48 q / 8 kv heads: internlm2-20b and
               internvl2-26b; 32 / 2: chatglm3-6b; 40 / 8: qwen2.5-32b),
               causal, no softcap, the same way; then at the MoE configs'
               (16 / 16, GQA group 1: qwen2-moe-a2.7b, causal; 32 / 8:
               mixtral-8x7b, window 4,096);
  4. dma     — the quickstart's path through the port's descriptor
               plane (host NumPy: a register front-end's 3-D gather, the
               presets' 4 KiB cycles), a `plan_nd_copy` plan whose
               `copy_2d` on the card equals `copy_2d_reference` byte for
               byte, an engine's Init PRNG stream equal to `prng_fill` on
               the card, the quickstart engine built with
               `sanitize="raise"` and its drains' reports all clean, and
               the sanitizer demo's racy pair (two overlapping 256-B
               writes on two channels) raising `SanitizeError` before a
               byte moves; then the Init and copy kernels at real sizes
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
  6. serve   — full-width gemma2-2b (26 layers, d 2304, vocab 256,000),
               then full-width mamba2-1.3b (48 SSM layers, d 2048, vocab
               50,280), then full-width hymba-1.5b (32 hybrid layers, d
               1600, attention and SSM heads side by side, vocab 32,001,
               untied head), then the dense configs internlm2-20b (48
               layers, d 6144), chatglm3-6b (28 layers, d 4096, qkv bias,
               RoPE on half the head) and qwen2.5-32b (64 layers, d 5120,
               qkv bias, 61 GiB of weights), seeded random weights, bf16,
               each answer 4 left-padded requests through
               `ServeEngine.generate`, twice, and is freed before the next;
               the launch counters, set to 0 before each run, must show
               every attention and SSD call went through the kernels
               (every SSD call on the tensor cores) and no other kernel ran
               (no copy, Init or matmul kernel); then full-width
               internvl2-26b's prefill of the same batch with 256 seeded
               patch embeddings of width 3,200 a row, through
               `make_prefill_step`, and 3 decode steps: finite logits, 48
               flash and 144 decode launches, and last-position logits
               that differ from those without the patches; then the MoE
               configs the same way, qwen2-moe-a2.7b whole (24 layers, d
               2048, 60 routed experts top 4 and 4 shared, qkv bias,
               14.3 B params) and mixtral-8x7b cut to 20 of its 32 layers
               (d 4096, 8 experts top 2, window 4,096; 29.3 B params), each
               printing the dropped share of (token, expert) pairs in each
               layer of its prefill at capacity factor 1.25 from a third,
               untimed generate, which for qwen2-moe also holds every flash
               and decode call against its plain version; then the MoE
               dispatch: the capacity buffer `moe_dispatch_compute` builds
               on the card for 512 tokens of d 2,048 (bf16, 200 of them
               one repeated row) equals, bit for bit, the one the port's
               `IDMAEngine` fills on the host from `expert_gather_batch`'s
               descriptors at the capacity `moe_expert_gather` uses, the
               sanitizer's `check_batch` of those descriptors is clean
               (each capacity slot written once), and a second call gives
               y, aux and dropped bit for bit;
  7. front   — the same two full-width models behind the continuous-
               batching front door, `ServeFrontDoor(StepLM(model, ...),
               layout).submit(req) ... .run()`: six requests of 33 to
               4,608 prompt tokens, 32 new tokens each, every other one at
               T=0.8, chunked prefill of 256 rows, over a pool of 420 pages
               of one gemma2-2b layer's KV rows; once at max_running 4 and
               once at 1 (all streams, hot ones included, must be equal),
               and for gemma2-2b a third time at max_running 4 through
               `ServeFrontDoor(..., sanitize=True)`, every drain swept and
               every plan-cache hit audited: its streams and launches
               must equal the first run's and its reports be all clean;
               the launch counters, set to 0 before each run, must read
               flash attention once a layer an admission, decode attention
               once a layer a decode call (one request a call), the SSD
               once a layer an admission on the tensor cores, and nothing
               else; each run prints its wall, the host seconds inside
               `StepLM` against the rest (the descriptor plane), tokens/s,
               steps, simulated cycles, preemptions and swaps, decode
               calls, and peak memory; then the traffic's kernel shapes
               (flash at B 1 and each prompt's own length, decode at B 1
               over the 4,640-row cache, the SSD at B 1 on the prompt
               padded to the chunk): every call of an admission and 3
               decode steps of each request, each against its plain
               version at TOL, and a request's logits `torch.equal` alone
               and stepped after the five others;
  8. card vs CPU — 2 gemma2 layers (SWA, FULL) and 2 mamba2 layers at
               full width in fp32, a 600-token prompt and 3 decode steps,
               and 2 hymba layers (HYBRID_FULL, HYBRID) on a 1,100-token
               prompt, past their window and off the SSD's chunk, and 2
               qwen2.5-32b layers (qkv bias, GQA 5, RoPE theta 1e6) and 2
               chatglm3-6b layers (GQA 16, RoPE on half the head), and 2
               qwen2-moe-a2.7b layers (60 experts top 4 at capacity factor
               1.25, GQA 1), their qkv biases seeded non-zero: logits of the
               CUDA path agree with the CPU path within 1e-4; then the 2
               gemma2, the 2 hymba, the 2 qwen2.5, the 2 chatglm3 and the 2
               qwen2-moe layers in bf16, the serving dtype, on the card:
               logits through the attention and SSD kernels agree with
               those through their plain versions within 2e-2; the MoE
               pairs print how many (token, expert) pairs each layer
               routed differently between the two runs;
 ssd-knobs — the SSD's `RunConfig` knobs on the serving path: full-width
               mamba2-1.3b and hymba-1.5b answer the traffic once under
               `ssd_chunk=64` and once under `ssd_compute_dtype=
               "bfloat16"`, every SSD launch counted by route and on the
               tensor cores; 2 layers of each in bf16 with the knob,
               kernels against their plain versions (rel 2e-2); then a
               mamba2 prefill at `ssd_chunk=256` (N 128), which no route
               holds in shared memory, must raise the SSD's named error
               before any launch.

  9. encdec kernels — flash and decode attention at seamless-m4t-large-
               v2's serving shapes (D 64, 16 q on 16 kv heads, bf16, no
               softcap): flash non-causal over the encoder's B 4 x 1,152
               frames, flash with one query row against the 1,152 frames
               (the cross-attention of a decode step; its q the transposed
               view the model hands it, which `runtime.aligned16` must pass
               as it is), decode over a 256-row cache at `kv_len` 64; each
               against its plain version at TOL, then by device time in
               turns with `flex_attention` (the one-row flash also with the
               decode kernel on the same K/V), each its own kernels-line
               entry;
 10. encdec  — full-width seamless-m4t-large-v2 (24 + 24 layers, d 1,024,
               vocab 256,206, 2.035 B bf16 params): B 4 x 1,152 seeded
               frames through `make_prefill_step`, then 64
               `make_decode_step` calls over `init_encdec_cache(4, 256)` (a
               16-token seeded prompt fed one token a step, then 48 greedy
               tokens): launches counted from 0 over the prefill (flash 24)
               and over the steps (flash and decode 24 x 64), nothing else;
               prefill s, ms a step, peak; a second, untimed run holds every
               flash and decode call against its plain version; then 2 + 2
               layers in fp32, `encdec_forward` with the kernels on the card
               against the plain versions on the CPU (rel 1e-4); then one
               full-width fp32 `make_train_step` step (B 2, 256 tokens, 64
               frames): finite loss within 1.0 of ln(256,206), finite grad
               norm > 0, no kernel launched;
 11. train   — full-width gemma2-2b through `Trainer` on the card,
               `RunConfig(kernels="xla", dtype="float32", remat=False)` (the
               reference's launcher's), B 4 x 512 tokens, 5 steps, a step
               fault injected at step 2 and replayed: one replay, finite
               losses (the first within 1.0 of ln(256,000) + 0.5), finite
               grad norms > 0, every weight moved, no kernel launched (the
               plain attention and SSD, as the reference's "xla" path);
               s a step, tokens/s, peak; the replayed run against a fresh
               run without the fault (bit for bit, or logged as not and
               held within loss 1e-5, grad norm 1e-4 of their largest and
               weights 2·Σlr); a step split into forward, backward and
               AdamW, profiled by kernel, and the plain attention and the
               logits timed alone; then 2 layers of mamba2-1.3b at full
               width, 6 steps, a checkpoint every 2 into a temporary
               directory and a node failure at step 3: it restores step
               2's checkpoint, ends at step 6 and is held against an
               uninterrupted run the same way;
 train-bf16 — bf16 compute over fp32 master weights (`RunConfig(kernels=
               "xla", dtype="bfloat16", remat=False)`): full-width
               gemma2-2b through `Trainer`, B 4 x 512, 4 steps with a
               step fault at step 2 replayed, held bit for bit against a
               fresh run; that run's state then takes an fp32 and a bf16
               step in turns, 3 rounds (s, tokens/s, peak each), and the
               bf16 step's device time split into GEMMs, the other
               forward and backward kernels and AdamW (torch.profiler);
               qwen2-moe-a2.7b cut to 2 of its 24 layers at full width, 3
               steps with a fault at step 1 replayed, against a fresh run
               (bit for bit or not, logged); the 2-layer gemma2-2b bf16
               step on the card and on the CPU from the same weights:
               loss and grad norm within rel 2e-2; no kernel launched;
 12. mesh    — the distributed layer over a one-rank NCCL process group
               (a `file://` rendezvous in a temporary directory) and
               `make_host_mesh(1, 1, "cuda")`: (a) one fp32 train step
               of gemma2-2b cut to 8 of its 26 layers at full width (B 4
               x 512) on the mesh
               (`distribute_train_state`, `distribute_batch`, the hint
               function installed) against one without it, run one after
               the other: loss and each weight's checksum (the int64 sum of
               its int32 view) equal, or each weight within 2e-5 of its
               leaf's max|w|, logged as not bit for bit; (b) the mesh
               step's weights checkpointed and restored onto the mesh
               (`restore(shardings=..., mesh=...)`): the placements asked
               for, every weight bit for bit; (c) 2 layers of
               qwen2-moe-a2.7b in bf16, each MoE layer through `moe_forward`
               with `set_moe_mesh(mesh)` in each of `psum` / `scatter` /
               `combine_first` against the local path, bit for bit; (c')
               the backward through one such layer (fp32 leaves in bf16):
               the gradients of x and of every MoE weight on the mesh
               equal the local path's bit for bit, each reduction; (d)
               full-width gemma2-2b fp32, a 200-token prompt prefilled
               through the kernels, then 2R + 5 greedy decode steps (R 64)
               through the kernel decode path and through the ring-append
               decode (`add_decode_rings`, `flush_decode_caches` every R),
               the ring's logits within 1e-4 of max|logit| of the kernel
               path's with the same greedy tokens, its decode-kernel
               launches (the 13 sliding-window layers a step) counted from
               0; (e) `compressed_psum` of 4 Mi fp32 over the one rank: its
               relative error.  One `{"mesh": ...}` line;
 13. specs   — `python -m repro_torch.launch.specs --all` in a child
               process (this one's default process group was the mesh
               phase's NCCL one): `build_cell` for every (arch x shape)
               pair of the ten archs on the (16, 16) data x model
               production mesh over torch's fake process group of 256
               ranks, on the meta device; each cell's count of argument
               leaves and its seconds, 33 cells;
 14. dryrun  — `python -m repro_torch.launch.dryrun --cells ...` in a
               child process: gemma2-2b's train, prefill and decode cells,
               qwen2-moe-a2.7b train, mamba2-1.3b prefill, qwen2.5-32b
               decode and seamless-m4t-large-v2 decode on the fake (16, 16)
               mesh, and gemma2-2b decode on the (2, 16, 16) one (the plain
               path on meta tensors: no kernel runs), into
               `build/dryrun_torch`: exit 0, each JSON with the reference's
               keys, flops, bytes and temp bytes > 0, collective bytes > 0
               in the train cells; each cell's compute, memory and
               collective seconds on the H100's terms, bottleneck, model
               over counted flops and seconds; then `python -m
               repro_torch.launch.debug_collectives --arch gemma2-2b
               --shape train_4k`, which must print its header;
 15. roofline — the cost counter on a real step: gemma2-2b's bf16 step
               over fp32 masters (B 4 x 512, no mesh) counted on the card
               by `launch.hlo_cost.count_call` equals, in flops,
               transcendentals and bytes, the same step traced on the meta
               device; the step alone and counted, 3 rounds in turns; the
               fastest step must take at least the count's compute term;
               compute and memory terms, their shares of the step, and
               model flops over the step's time, beside the card's name
               and power limit.

The dry-run and debug_collectives run on the CPU as well, from the root
of a checkout: `PYTHONPATH=src python -m repro_torch.launch.dryrun --arch
gemma2-2b --shape train_4k` (or `--all`, 33 cells, minutes) and
`PYTHONPATH=src python -m repro_torch.launch.debug_collectives --arch
gemma2-2b --shape train_4k [--bytes]`.

Any failure raises and exits non-zero.  The second-to-last line is a JSON
object with one entry per kernel; the last is the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
    session where it requests a new activity buffer (runs AI, AJ), or
    most of them late in a whole run (run BZ: 2 of 20).  So each kernel
    counts as its mean recorded time times its launches a call, the
    nearest whole number to its records over the calls.  A session with
    no device record, or with a kernel under half a record a call, is
    taken again, `tries` times at most; if none of them is whole, the
    time is taken with CUDA events around the calls instead, and a line
    says so."""
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
        kern = [e for e in records
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count]
        total = sum(e.self_device_time_total / e.count *
                    round(e.count / iters) for e in kern)
        if total > 0 and all(round(e.count / iters) for e in kern):
            return total / 1e3
    seen = [(e.key[:60], e.count) for e in records if e.count]
    log(f"[timing] the profiler recorded no whole session of device time "
        f"for {iters} calls in {tries} sessions (the last one's records: "
        f"{seen}); CUDA events around {iters} calls instead")
    return time_ms(fn, iters=iters, warmup=0)


def in_turns(fns, rounds: int = 5):
    """Device ms of each callable, timed in turns (the order reversed every
    other round): {name: (median, min, max)}."""
    import statistics
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(device_ms(fns[name]))
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


def phase_sanitize():
    """The correctness tools on the host: the static sanitizer's CLI
    (``--demo --corpus --fuzz-racy 64``: the racy demo flagged, every
    corpus program clean, 64 racy programs flagged with their codes) and
    the verifier's (``--seeds 32``, then ``--seeds 32 --differential``),
    each of which must return 0."""
    from repro_torch.sanitize.__main__ import main as sanitize_main
    from repro_torch.verify.__main__ import main as verify_main
    for label, fn, argv in (
            ("sanitize", sanitize_main,
             ["--demo", "--corpus", "--fuzz-racy", "64"]),
            ("verify", verify_main, ["--seeds", "32"]),
            ("verify", verify_main, ["--seeds", "32", "--differential"])):
        t = time.perf_counter()
        rc = fn(argv)
        took = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"python -m repro_torch.{label} "
                                 f"{' '.join(argv)} returned {rc}")
        log(f"[sanitize] python -m repro_torch.{label} {' '.join(argv)}: "
            f"exit 0 in {took:.2f} s on the host")


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


def layer_counts(cfg):
    """(layers with attention, layers with an SSM): a hybrid layer has
    both."""
    from repro_torch.models.blocks import ATTN_KINDS, SSM_KINDS
    kinds = cfg.layer_kinds
    return (sum(k in ATTN_KINDS for k in kinds),
            sum(k in SSM_KINDS for k in kinds))


def expected_launches(cfg, steps: int):
    """Kernel launches of one prefill and `steps` decode steps of `cfg`:
    no copy, Init or matmul kernel runs on the serving path."""
    n_attn, n_ssm = layer_counts(cfg)
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
    never calls it.  Dynamo compiles it anew for each shape and, past its
    recompile limit, runs it uncompiled, which materializes the scores (72
    ms against 0.76 for hymba-1.5b's full-attention case, the whole script
    against its phase alone, runs BM and BL): so each phase that calls
    this starts from an empty cache."""
    import torch
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
    except ImportError:
        log(f"[kernels] torch {torch.__version__} has no flex_attention: "
            f"library_ms is null")
        return None
    torch._dynamo.reset()
    return torch.compile(flex_attention, dynamic=False), create_block_mask


def check_close(name, got, want, dtype, rows=False):
    """Max abs error, and the error relative to max|want|, or with `rows`
    the largest of each row's error against its own max|want| (a row with
    no live key is 0 on both sides); raises at TOL[dtype] or above."""
    import torch
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
    checked maximum, which one bf16 step at a row's largest value already
    sets to 2^-8 .. 2^-7.  Logged, not checked."""
    err = (got.float() - want.float()).pow(2).mean(-1).sqrt()
    return float((err / want.float().pow(2).mean(-1).sqrt()
                  .clamp_min(1e-6)).mean())


def flash_mask(causal, window):
    """`flex_attention`'s mask_mod for a causal and sliding-window mask."""
    def mask_mod(b, h, q_idx, kv_idx):
        live = kv_idx >= 0
        if causal:
            live = live & (q_idx >= kv_idx)
        if window:
            live = live & (q_idx - kv_idx < window)
        return live
    return mask_mod


def flex_call(library, label, q, k, v, mask_mod, want, dtype, scale,
              score_mod=None, rows=False):
    """flex_attention with `mask_mod` as its block mask, checked against
    the plain version's `want`; returns the call, or None where this torch
    has none (`library` None)."""
    if library is None:
        return None
    flex, create_block_mask = library
    mask = create_block_mask(mask_mod, None, None, q.shape[2], k.shape[2],
                             device=q.device)

    def call():
        return flex(q, k, v, score_mod=score_mod, block_mask=mask,
                    scale=scale, enable_gqa=True)
    got = call()
    _, rel = check_close(f"flex_attention {label}", got, want, dtype, rows)
    rms = f", row rms err {row_rms(got, want):.2e}" if rows else ""
    log(f"[kernels] library flex_attention {label}: rel err {rel:.2e}{rms}")
    return call


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

    entries = {}
    B, Hq, Hkv, D, scale, cap = 4, 8, 4, 256, 1 / 16, 50.0

    def softcap_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def library_call(label, q, k, v, mask_mod, want, dtype, rows=False):
        return flex_call(library, label, q, k, v, mask_mod, want, dtype,
                         scale, softcap_mod, rows)

    def library_ms(label, q, k, v, mask_mod, want, dtype, rows=False):
        """Check flex_attention against the plain version, then time it."""
        call = library_call(label, q, k, v, mask_mod, want, dtype, rows)
        if call is None:
            return None
        ms = time_ms(call)
        log(f"[kernels] library flex_attention {label}: {ms:.4f} ms")
        return ms

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
        abs_err, rel = check_close(f"flash {label} {dtype}", got, want,
                                   dtype, rows=True)
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
                abs_err, rel = check_close(
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
    # the GQA groups of the other configs, each at every head_dim over a
    # 4,640-row cache; at their own head_dim with their own heads:
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
            abs_err, rel = check_close(
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


def ssd_view_inputs(gen, B, H, G, S, P, N, dtype, A=None, dt=None):
    """mamba2's ranges: dt = softplus(.) in [0.001, 0.1], A = -exp(A_log)
    with A_log = log(1..H), D = 1.  x, B and C are (B, H or G, S, .) views
    of one (B, S, H·P + 2·G·N) tensor and dt of a (B, S, H) one, as the
    SSM layer passes them.  A number for A or dt fills it."""
    import torch
    dev = gen.device
    DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=gen, device=dev)
    xbc[..., H * P:] *= 0.3
    xs, Bs, Cs = torch.split(xbc.to(DT[dtype]), [H * P, G * N, G * N],
                             dim=-1)
    dtv = 0.001 + 0.099 * torch.rand((B, S, H), generator=gen, device=dev)
    if dt is not None:
        dtv.fill_(dt)
    Av = -torch.arange(1, H + 1, device=dev, dtype=torch.float32) \
        if A is None else torch.full((H,), A, device=dev)
    return (xs.reshape(B, S, H, P).transpose(1, 2), dtv.transpose(1, 2),
            Av, torch.ones(H, device=dev),
            *(t.reshape(B, S, G, N).transpose(1, 2) for t in (Bs, Cs)))


def phase_ssd_kernel(sk):
    """The SSD kernel against its plain versions, each case on the route
    `sk.route` gives it (the main shape, in both dtypes, on the tensor
    cores); returns its JSON entry, whose bound is the least of the two:
    3xTF32 on the tensor cores (165 TFLOP/s) for fp32."""
    import torch
    from repro_torch.kernels.ssd import ssd_chunked_ref, ssd_ref
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    log("[kernels] ssd: no single PyTorch call computes the chunked SSD "
        "scan, so library_ms is null")

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
        args = ssd_view_inputs(gen, B, H, G, S, P, N, dtype, A, dtc)
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


HYMBA = "hymba-1.5b"


def decode_mask(kv_len, window):
    """`flex_attention`'s mask_mod for one query over a cache of `kv_len`
    live rows, the last `window` of them where `window` is not 0."""
    def mask_mod(b, h, q_idx, kv_idx):
        live = kv_idx < kv_len
        if window:
            live = live & (kv_idx >= kv_len - window)
        return live
    return mask_mod


def kernel_entry(name, arch, ms, plain_ms, b_ms, b_by, lib_ms, worst):
    """The kernels line's entry of `name` at `arch`'s shapes."""
    return dict(name=f"{name} {arch}", route="cuda",
                source=f"src/repro_torch/csrc/{KERNELS[name][2]}.cu",
                replaces=KERNELS[name][3], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                max_abs_err=worst)


def timed_in_turns(arch, label, kern, lib):
    """Device ms of the kernel and of the library call (None: no call), 5
    rounds in turns; returns the two medians."""
    t = in_turns({"kernel": kern,
                  **({} if lib is None else {"flex_attention": lib})})
    log(f"[kernels] {arch} {label} in turns, device ms median (min-max) "
        f"over 5 rounds: " + ", ".join(f"{n} {md:.4f} ({lo:.4f}-{hi:.4f})"
                                       for n, (md, lo, hi) in t.items()))
    return t["kernel"][0], None if lib is None else t["flex_attention"][0]


def attention_layout_cases(cfg, mods, library, gen, windows):
    """Flash and decode attention at `cfg`'s heads under the serve phase's
    traffic (B 4, 4,608 prompt tokens, causal, a 4,640-row cache at
    `kv_len` 4,608, bf16, no softcap), once for each of `windows`: each
    against its plain version at TOL (flash row by row), then by device
    time (torch.profiler), 5 rounds in turns with compiled
    `flex_attention`; the plain version by CUDA events.  Prints each
    case's time, bound, share of it and factor against `flex_attention`.
    Returns the entries of flash and decode attention at windows[0], each
    with the worst abs error over `windows`."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.launch.profile_serve import MAX_LEN, PROMPTS

    fa, da = mods["flash_attention"], mods["decode_attention"]
    arch, B, S = cfg.name, len(PROMPTS), max(PROMPTS)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale, bf16 = D ** -0.5, "bfloat16"
    entries, found = {}, {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def versus(ms, lib_ms):
        return "" if lib_ms is None else f", {ms / lib_ms:.2f}x library"

    worst = 0.0
    for w in windows:
        q, k, v = randn(B, Hq, S, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
        kw = dict(causal=True, window=w, softcap=0.0, scale=scale)
        label = f"flash B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} w{w} bf16"
        want = attention_ref(q, k, v, **kw)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        abs_err, rel = check_close(f"{arch} {label}", got, want, bf16,
                                   rows=True)
        rms = row_rms(got, want)
        worst = max(worst, abs_err)
        lib = flex_call(library, f"{arch} {label}", q, k, v,
                        flash_mask(True, w), want, bf16, scale, rows=True)
        del got, want
        torch.cuda.empty_cache()
        ms, lib_ms = timed_in_turns(
            arch, label, lambda: fa.flash_attention_cuda(q, k, v, **kw), lib)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=3,
                           warmup=1)
        flops = 4 * D * flash_live_pairs(S, S, True, w) * B * Hq
        b_ms, b_by = bound(flops, (2 * q.numel() + k.numel() + v.numel())
                           * q.element_size(), bf16)
        log(f"[kernels] {arch} {label}: row rel err {rel:.2e} (tol "
            f"{TOL[bf16]:.0e}), row rms err {rms:.2e} | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of bound, {flops / ms / 1e9:.1f} "
            f"TFLOP/s{versus(ms, lib_ms)}")
        found.setdefault("flash_attention", (ms, plain_ms, b_ms, b_by,
                                             lib_ms))
        del q, k, v, lib
        torch.cuda.empty_cache()
    entries["flash_attention"] = kernel_entry(
        "flash_attention", arch, *found["flash_attention"], worst)

    worst = 0.0
    q = randn(B, Hq, D)
    k, v = randn(B, Hkv, MAX_LEN, D), randn(B, Hkv, MAX_LEN, D)
    for w in windows:
        kw = dict(kv_len=S, window=w, softcap=0.0, scale=scale)
        label = (f"decode B{B} Hq{Hq} Hkv{Hkv} cache {MAX_LEN} D{D} kv_len "
                 f"{S} w{w} bf16")
        want = decode_attention_ref(q, k, v, **kw)
        abs_err, rel = check_close(f"{arch} {label}",
                                   da.decode_attention_cuda(q, k, v, **kw),
                                   want, bf16)
        worst = max(worst, abs_err)
        lib = flex_call(library, f"{arch} {label}", q[:, :, None], k, v,
                        decode_mask(S, w), want[:, :, None], bf16, scale)
        ms, lib_ms = timed_in_turns(
            arch, label, lambda: da.decode_attention_cuda(q, k, v, **kw), lib)
        plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, **kw))
        live = min(S, w) if w else S
        b_ms, b_by = bound(4 * B * Hq * live * D,
                           (2 * B * Hkv * live * D + 2 * q.numel())
                           * q.element_size(), bf16)
        log(f"[kernels] {arch} {label}: rel err {rel:.2e} (tol "
            f"{TOL[bf16]:.0e}) | kernel {ms:.4f} ms device, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of bound{versus(ms, lib_ms)}")
        found.setdefault("decode_attention", (ms, plain_ms, b_ms, b_by,
                                              lib_ms))
    entries["decode_attention"] = kernel_entry(
        "decode_attention", arch, *found["decode_attention"], worst)
    del q, k, v, lib
    torch.cuda.empty_cache()
    return entries


def phase_hymba_kernels(mods):
    """Flash attention, decode attention and the SSD at hymba-1.5b's
    main-path shapes under the serve phase's traffic (B 4, 4,608 prompt
    tokens, a 4,640-row cache; 25 q and 5 kv heads of 64, no softcap,
    window 1,024 on 29 layers and 0 on 3; the SSD on the views
    `models/ssm.py` hands it, 50 heads of 64, d_state 16, chunk 128, on
    the tensor cores), each against its plain version at TOL, then by
    device time in turns, as `attention_layout_cases` says (the SSD has
    no library call).  Returns one JSON entry a kernel, for the case
    with the most launches a generate: the windowed layers' flash and
    decode attention, the fp32 SSD."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.ssd import ssd_chunked_ref
    from repro_torch.launch.profile_serve import PROMPTS
    from repro_torch.models.ssm import ssm_dims

    cfg = get(HYMBA)
    sk = mods["ssd"]
    gen = torch.Generator("cuda").manual_seed(3)
    B, S = len(PROMPTS), max(PROMPTS)
    entries = attention_layout_cases(cfg, mods, library_attention(), gen,
                                     (cfg.window, 0))

    worst = 0.0
    _, H, P, G, N = ssm_dims(cfg)
    L = cfg.ssm.chunk
    for dtype in ("float32", "bfloat16"):
        args = ssd_view_inputs(gen, B, H, G, S, P, N, dtype)
        label = f"ssd B{B} H{H} G{G} S{S} P{P} N{N} L{L} {dtype}"
        route = sk.route(args[0], args[4], args[5], L)
        before = sk.launches_by_route["tensor_cores"]
        y, state = sk.ssd_cuda(*args, chunk=L)
        if route != "tensor_cores" or \
                sk.launches_by_route["tensor_cores"] != before + 1:
            raise AssertionError(f"{HYMBA} {label}: route {route}, want "
                                 f"tensor_cores")
        wy, wstate = ssd_chunked_ref(*args, chunk=L, return_state=True)
        errs = [check_close(f"{HYMBA} {label} {what}", got, want, dtype)
                for what, got, want in (("y", y, wy),
                                        ("state", state, wstate))]
        worst = max([worst] + [e for e, _ in errs])
        del y, state, wy, wstate
        ms, _ = timed_in_turns(HYMBA, label,
                               lambda: sk.ssd_cuda(*args, chunk=L), None)
        plain_ms = time_ms(lambda: ssd_chunked_ref(*args, chunk=L,
                                                   return_state=True),
                           iters=3, warmup=1)
        flops, nbytes = ssd_flops_bytes(B, H, G, S, P, N,
                                        args[0].element_size())
        b_ms, b_by = bound(flops, nbytes,
                           "3xtf32" if dtype == "float32" else dtype)
        log(f"[kernels] {HYMBA} {label} on route {route}: rel err y "
            f"{errs[0][1]:.2e}, state {errs[1][1]:.2e} (tol "
            f"{TOL[dtype]:.0e}) | kernel {ms:.4f} ms device, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}"
            f"{', 3xTF32' if dtype == 'float32' else ''}), "
            f"{100 * b_ms / ms:.1f}% of bound, {flops / ms / 1e9:.1f} "
            f"TFLOP/s")
        if dtype == "float32":
            found = (ms, plain_ms, b_ms, b_by, None)
        del args
        torch.cuda.empty_cache()
    entries["ssd"] = kernel_entry("ssd", HYMBA, *found, worst)
    return {e["name"]: e for e in entries.values()}


DENSE = ("internlm2-20b", "chatglm3-6b", "qwen2.5-32b")
VLM = "internvl2-26b"


MOE = ("qwen2-moe-a2.7b", "mixtral-8x7b")
# mixtral-8x7b's 32 layers hold 46.7 B params, 87 GiB in bf16, more than
# the card: it serves 20 of them, at full width
MIXTRAL_LAYERS = 20


def moe_config(arch):
    """A MoE config as the card serves it: qwen2-moe-a2.7b whole,
    mixtral-8x7b cut to MIXTRAL_LAYERS of its 32 layers."""
    from repro_torch.configs import get
    cfg = get(arch)
    if arch == "mixtral-8x7b":
        cfg = dataclasses.replace(cfg, n_layers=MIXTRAL_LAYERS)
    return cfg


class MoeLog:
    """Within `with`, each `repro_torch.models.moe.route` call (one a MoE
    layer a forward, in the order they run) is kept as (device type,
    expert_idx, dropped fraction), the last two left on their device."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.inner, self.calls = moe, moe.route, []

        def route(*args, **kw):
            r = self.inner(*args, **kw)
            self.calls.append((r.expert_idx.device.type, r.expert_idx,
                               1 - r.keep.float().mean()))
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.inner


def routing_changes(cfg, a, b):
    """Per layer, over the paired calls of two runs `a` and `b` (MoeLog
    records): the (token, expert) pairs routed in `a` and not in `b`, and
    the dropped fractions of both in the first (the prefill) call."""
    import torch
    L, E = cfg.n_layers, cfg.moe.n_experts
    if len(a) != len(b) or len(a) % L:
        raise AssertionError(f"{len(a)} and {len(b)} MoE calls for {L} "
                             f"layers")
    out = []
    for layer in range(L):
        changed = 0
        for (_, ia, _), (_, ib, _) in zip(a[layer::L], b[layer::L]):
            oa = torch.zeros(ia.shape[0], E).scatter_(1, ia.cpu(), 1)
            ob = torch.zeros(ib.shape[0], E).scatter_(1, ib.cpu(), 1)
            changed += int(((oa - ob) > 0).sum())
        out.append((changed, float(a[layer][2]), float(b[layer][2])))
    return out


MOE_DISPATCH_TOKENS, MOE_DISPATCH_PADS = 512, 200


def phase_moe_dispatch():
    """The MoE dispatch on the card against the descriptor plane: one
    qwen2-moe-a2.7b MoE layer (60 experts top 4, capacity factor 1.25,
    seeded weights, bf16) over 512 tokens of d 2,048, the first 200 one
    repeated row as the served batch's left padding makes them, so that
    experts overflow.  The (E, C, d) capacity buffer `moe_dispatch_compute`
    builds on the card must equal, bit for bit, the buffer the port's
    `IDMAEngine` (host NumPy) fills from `moe_expert_gather`'s descriptor
    batch over the same token bytes (`expert_gather_on_engine`, at the
    routing's capacity).  A second call on the same inputs must give the
    same bits: y, the aux loss and the dropped share (no atomics in the
    combine)."""
    import numpy as np
    import torch
    from repro_torch.core.vm import expert_gather_on_engine
    from repro_torch.models import moe

    cfg = moe_config("qwen2-moe-a2.7b")
    mc, T = cfg.moe, MOE_DISPATCH_TOKENS
    gen = torch.Generator("cuda").manual_seed(6)
    p = moe.MoE(cfg, torch.bfloat16, torch.device("cuda"))
    with torch.no_grad():
        for w in p.parameters():
            w.copy_(torch.randn(w.shape, generator=gen, device="cuda")
                    * w.shape[-2] ** -0.5)
    x = torch.randn(T, cfg.d_model, generator=gen, device="cuda").to(
        torch.bfloat16)
    x[:MOE_DISPATCH_PADS] = x[0]
    built, inner = [], moe.dispatch

    def record(x2, r, n):
        built.append((inner(x2, r, n), r))
        return built[-1][0]
    moe.dispatch = record
    try:
        with torch.no_grad():
            y, aux, dropped = moe.moe_dispatch_compute(p, x, mc, cfg.act)
    finally:
        moe.dispatch = inner
    (buf, r), = built
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("MoE dispatch: non-finite output")
    with torch.no_grad():
        again = moe.moe_dispatch_compute(p, x, mc, cfg.act)
    for name, u, v in zip(("y", "aux", "dropped"), (y, aux, dropped), again):
        if not torch.equal(u, v):
            raise AssertionError(f"MoE dispatch: {name} differs between two "
                                 f"calls on the same inputs")
    if mc.capacity_factor != 1.25 or r.capacity != moe._capacity(T, mc):
        raise AssertionError(f"MoE dispatch: capacity {r.capacity} at "
                             f"factor {mc.capacity_factor}")
    rows = x.view(torch.uint8).cpu().numpy()
    t = time.perf_counter()
    plane = expert_gather_on_engine(rows, r.expert_idx.cpu().numpy(),
                                    mc.n_experts, r.capacity)
    plane_s = time.perf_counter() - t
    t = time.perf_counter()
    swept = moe_gather_report(rows.shape, r.expert_idx.cpu().numpy(),
                              mc.n_experts, r.capacity)
    sweep_s = time.perf_counter() - t
    card = buf.view(torch.uint8).cpu().numpy().reshape(plane.shape)
    kept = int(r.keep.sum())
    if not np.array_equal(card, plane):
        bad = int((card != plane).any(-1).sum())
        raise AssertionError(f"MoE dispatch: {bad} of "
                             f"{card.shape[0] * card.shape[1]} buffer rows "
                             f"differ from the IDMAEngine's")
    if not 0 < float(dropped) < 1:
        raise AssertionError(f"MoE dispatch: dropped {float(dropped)}, "
                             f"want some pairs dropped and some kept")
    log(f"[moe] dispatch of {T} tokens (d {cfg.d_model}, bf16, "
        f"{MOE_DISPATCH_PADS} one repeated row) to {mc.n_experts} experts top "
        f"{mc.top_k}, capacity {r.capacity} a expert: {kept} of "
        f"{T * mc.top_k} pairs kept (dropped {float(dropped):.4f}); the "
        f"card's ({mc.n_experts}, {r.capacity}, {cfg.d_model}) buffer equals "
        f"the IDMAEngine's gather of the same token bytes bit for bit "
        f"({kept} descriptors of {rows.shape[1]} B, {plane_s:.2f} s on the "
        f"host); a second call gives y, aux and dropped bit for bit; "
        f"check_batch of the gather's {swept.checked_rows} rows clean (each "
        f"capacity slot written once; {sweep_s:.3f} s on the host)")
    del p, x, buf, built, again
    free_card()


def moe_gather_report(shape, expert_idx, n_experts, capacity):
    """`check_batch` of the descriptor batch `expert_gather_on_engine`
    runs for this routing: token rows at VA 0, the capacity buffer on the
    next page.  Each capacity slot is written once and a token row is
    only read, so the report must be clean (no H002, no H003)."""
    import numpy as np
    from repro_torch.core.vm import MIN_PAGE_SIZE, expert_gather_batch
    from repro_torch.sanitize import check_batch
    T, row = shape
    report = check_batch(expert_gather_batch(
        np.arange(T, dtype=np.int64) * row, expert_idx,
        n_experts=n_experts, capacity=capacity, d_bytes=row,
        expert_buf_va=-(-T * row // MIN_PAGE_SIZE) * MIN_PAGE_SIZE))
    if not report.clean or report.codes:
        raise AssertionError(f"MoE gather batch: {report.format(limit=5)}")
    return report


def phase_moe_kernels(mods):
    """Flash and decode attention at the MoE configs' head layouts, head
    dim 128, no softcap: 16 q on 16 kv heads (qwen2-moe-a2.7b, GQA group
    1), causal; 32 / 8 (mixtral-8x7b, group 4) with its window of 4,096;
    each as `attention_layout_cases` says, with dynamo's cache reset for
    each layout.  Returns the entries, named by the config."""
    import torch
    gen = torch.Generator("cuda").manual_seed(7)
    entries = {}
    for arch in MOE:
        cfg = moe_config(arch)
        for e in attention_layout_cases(cfg, mods, library_attention(), gen,
                                        (cfg.window,)).values():
            entries[e["name"]] = e
    return entries


def phase_dense_kernels(mods):
    """Flash and decode attention at head_dim 128 in the dense and VLM
    configs' three head layouts: 48 q / 8 kv heads (internlm2-20b, and
    internvl2-26b's backbone), 32 / 2 (chatglm3-6b) and 40 / 8
    (qwen2.5-32b); full attention and no softcap, as they serve; each as
    `attention_layout_cases` says, with dynamo's cache reset for each
    layout.  Returns the entries, named by the config of each layout."""
    import torch
    from repro_torch.configs import get
    gen = torch.Generator("cuda").manual_seed(4)
    entries = {}
    for arch in DENSE:
        for e in attention_layout_cases(get(arch), mods, library_attention(),
                                        gen, (0,)).values():
            entries[e["name"]] = e
    return entries


def dma_plane():
    """Quickstart steps 1 and 7 through the port's descriptor plane, on
    the host in NumPy: a 3-D strided gather programmed on a register
    front-end, then a 4 KiB transfer on each named preset.  Returns the
    quickstart engine, built with ``sanitize="raise"``: every drain is
    swept by `repro_torch.sanitize` before a byte moves."""
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
    engine = build_engine(spec, sanitize="raise")
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


def dma_racy_pair():
    """The sanitizer demo's racy pair on a two-channel engine built with
    ``sanitize="raise"``: two 256-B writes overlapping at [0x8080,
    0x8100), dealt round-robin to channels 0 and 1.  `wait_all` must
    raise `SanitizeError` (H003) before a byte moves: the engine's memory
    is unchanged after the raise."""
    import numpy as np
    from repro_torch.core import (BackendSpec, ChannelSpec, EngineSpec,
                                  Protocol, Transfer1D, build_engine)
    from repro_torch.sanitize import SanitizeError
    engine = build_engine(EngineSpec(
        name="demo", backend=BackendSpec(protocols=(Protocol.AXI4,)),
        channels=ChannelSpec(count=2),
        mem_spaces=((Protocol.AXI4, 1 << 16),)), sanitize="raise")
    mem = engine.mem.spaces[Protocol.AXI4]
    mem[:] = np.random.default_rng(3).integers(0, 256, mem.size, np.uint8)
    before = mem.copy()
    engine.submit_async(Transfer1D(src_addr=0x0000, dst_addr=0x8000,
                                   length=256))
    engine.submit_async(Transfer1D(src_addr=0x1000, dst_addr=0x8080,
                                   length=256))
    try:
        engine.wait_all()
    except SanitizeError as err:
        codes = err.report.codes
    else:
        raise AssertionError("racy pair drained without SanitizeError")
    if codes != ("H003",) or not np.array_equal(mem, before):
        raise AssertionError(f"racy pair: codes {codes}, memory changed "
                             f"{not np.array_equal(mem, before)}")
    log("[dma] racy pair (two 256-B writes overlapping at [0x8080, "
        "0x8100) on channels 0 and 1): SanitizeError H003 before a byte "
        "moved, the 64 KiB space unchanged")


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
    reports = engine.sanitize_reports
    if not reports or not all(r.clean for r in reports):
        raise AssertionError(f"sanitized quickstart engine: reports "
                             f"{[r.codes for r in reports]}, want clean")
    log(f"[dma] sanitize='raise': {len(reports)} drains of the quickstart "
        f"and the Init stream certified clean "
        f"({sum(r.checked_rows for r in reports)} rows swept)")
    dma_racy_pair()

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
    # and its library call in turns; the plain version, at 0.25-90 ms a
    # call, by CUDA events (3 profiled calls of one memcpy kept 1 record,
    # or none in 5 sessions); an entry for each kernel's first
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
        plain_ms = time_ms(lambda: plain(x), iters=3, warmup=1)
        b_ms, b_by = bound(flops, nbytes, "float32")
        spread = ", ".join(f"{n} {m:.4f} ({lo:.4f}-{hi:.4f})"
                           for n, (m, lo, hi) in turns.items())
        log(f"[dma] {label}: device ms in turns, median (min-max) of 5: "
            f"{spread}; plain {plain_ms:.4f} ms (events); bound {b_ms:.4f} ms "
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


def phase_serve(arch, mods, cfg=None, held=False, rcfg=None, attempts=2):
    """Full-width `arch` (or `cfg`, a cut of its depth) answers the
    traffic `attempts` times (bf16, or `rcfg`'s knobs); returns the
    launches of the first run.  A MoE model prints the dropped fraction of
    each layer's prefill.  With `held`, a further run goes through
    `HeldKernels`: every flash and decode call of the generate against its
    plain version.  The model, its engine and the allocator's cached
    blocks are freed before it returns, so the next model has the card."""
    import torch
    from repro_torch.configs import RunConfig, get
    from repro_torch.launch.profile_serve import (
        HOT_ROW, HOT_TEMPERATURE, MAX_LEN, NEW_TOKENS, PROMPTS,
        make_requests)
    from repro_torch.models import LM
    from repro_torch.models.common import dense, unembed
    from repro_torch.serve import ServeEngine

    cfg = cfg or get(arch)
    cut = get(arch).n_layers
    cut = "" if cfg.n_layers == cut else f" of its {cut}"
    rcfg = rcfg or RunConfig(dtype="bfloat16")
    knobs = {f: getattr(rcfg, f) for f in ("ssd_chunk", "ssd_compute_dtype")
             if getattr(rcfg, f) != getattr(RunConfig(), f)}
    tag = f" {knobs}" if knobs else ""
    t0 = time.perf_counter()
    model = LM(cfg, rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {arch}{tag} full width: {cfg.n_layers} layers{cut}, d "
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
    for attempt in range(attempts):
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
        log(f"[serve] {arch}{tag} run {attempt}: prompts {PROMPTS} "
            f"left-padded, "
            f"{NEW_TOKENS} new tokens, row {HOT_ROW} at T="
            f"{HOT_TEMPERATURE} | prefill {phases['prefill'][0]:.3f} s, "
            f"decode {1e3 * sum(phases['decode']) / steps:.2f} ms/step "
            f"over {steps} steps, {n_new / wall:.1f} tokens/s "
            f"({wall:.2f} s wall), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items()) +
            f" (ssd on route tensor_cores {ssd_tc})")
    # an untimed generate: each MoE layer's dropped share, and with `held`
    # every kernel call held against its plain version
    if held or cfg.moe is not None:
        with MoeLog() as routed, \
                (HeldKernels(mods) if held else contextlib.nullcontext()) \
                as hk:
            engine.generate(make_requests(cfg.vocab_size))
    if cfg.moe is not None:
        dropped = [float(d) for _, _, d in routed.calls]
        L = cfg.n_layers
        log(f"[serve] {arch} MoE ({cfg.moe.n_experts} experts top "
            f"{cfg.moe.top_k}, capacity factor "
            f"{cfg.moe.capacity_factor}): dropped share of (token, "
            f"expert) pairs in each layer of the prefill: " +
            " ".join(f"{d:.4f}" for d in dropped[:L]) +
            f"; in the decode steps at most {max(dropped[L:]):.4f} (an "
            f"untimed generate)")
    if held:
        calls = hk.report("serve", f"{arch} generate")
        want = {"flash_attention": runs[0]["counts"]["flash_attention"],
                "decode_attention": runs[0]["counts"]["decode_attention"],
                "ssd": runs[0]["counts"]["ssd"]}
        if calls != want:
            raise AssertionError(f"{arch}: held {calls}, want {want}")
    for i in range(len(PROMPTS)):
        if i != HOT_ROW and any(r["outputs"][i] != runs[0]["outputs"][i]
                                for r in runs):
            raise AssertionError(f"{arch}: greedy row {i} differs on rerun")
    log(f"[serve] {arch}{tag}: greedy rows identical on {len(runs)} runs; "
        f"row 0 starts {runs[0]['outputs'][0][:8]}")

    # cost of fp32 logits at the decode shape: the tied head's upcast
    # operands vs a bf16 product; the untied head is a bf16 product
    x = torch.randn(len(PROMPTS), cfg.d_model, device="cuda",
                    dtype=torch.bfloat16)
    if cfg.tie_embeddings:
        up_ms = time_ms(lambda: unembed(model.embed, x))
        bf_ms = time_ms(lambda: x @ model.embed.t())
        log(f"[serve] {arch} unembed (B {len(PROMPTS)}, vocab "
            f"{cfg.vocab_size}): fp32 upcast {up_ms:.3f} ms vs bf16 product "
            f"{bf_ms:.3f} ms per step")
    else:
        head_ms = time_ms(lambda: dense(x, model.lm_head).float())
        log(f"[serve] {arch} untied head (B {len(PROMPTS)}, d {cfg.d_model}, "
            f"vocab {cfg.vocab_size}): bf16 product then upcast "
            f"{head_ms:.3f} ms per step")
    del engine, model, x, out
    free_card()
    return runs[0]["counts"]


def free_card():
    """Drop what no one holds (reference cycles included) and return the
    allocator's cached blocks to the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


VLM_DECODE_STEPS = 3


def phase_vlm_prefill(mods):
    """Full-width internvl2-26b (the 48-layer backbone and its patch
    projector; the vision tower is a stub in both packages) through
    `make_prefill_step(model)(tokens, patch_embeds=...)`: the serve
    traffic's batch with 256 seeded patch embeddings of width 3,200 a row
    in place of its first 256 positions, then VLM_DECODE_STEPS greedy
    decode steps.  The logits must be finite, the launches 48 flash and
    48 x VLM_DECODE_STEPS decode and nothing else, and the last-position
    logits must differ from those of the same tokens without patches.
    Frees the model before it returns."""
    import torch
    from repro_torch.configs import RunConfig, get
    from repro_torch.launch.profile_serve import MAX_LEN, make_requests
    from repro_torch.models import LM
    from repro_torch.serve import (greedy_sample, make_decode_step,
                                   make_prefill_step)
    from repro_torch.serve.engine import left_pad

    cfg = get(VLM)
    model = LM(cfg, RunConfig(dtype="bfloat16"), seed=0, device="cuda")
    prefill = make_prefill_step(model, max_len=MAX_LEN)
    decode = make_decode_step(model)
    tokens = left_pad([r.prompt for r in make_requests(cfg.vocab_size)]
                      ).cuda()
    B, S = tokens.shape
    n, width = cfg.vision.n_patches, cfg.vision.patch_embed_dim
    patches = torch.randn((B, n, width), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(5)
                          ).to(torch.bfloat16)
    reset(mods)                                # the main path's run
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, caches = prefill(tokens, patch_embeds=patches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    first = logits
    for step in range(VLM_DECODE_STEPS):
        logits, caches = decode(caches, greedy_sample(logits)[:, None].long(),
                                S + step)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{VLM}: non-finite logits at decode step "
                                 f"{step}")
    torch.cuda.synchronize()
    counts, want = read(mods), expected_launches(cfg, VLM_DECODE_STEPS)
    if counts != want:
        raise AssertionError(f"{VLM} launches {counts}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del caches
    text, _ = prefill(tokens)
    V = cfg.vocab_size
    if not bool(torch.isfinite(first).all()):
        raise AssertionError(f"{VLM}: non-finite prefill logits")
    diff = float((first[:, :V] - text[:, :V]).abs().max())
    rel = diff / float(text[:, :V].abs().max())
    if not diff > 0:
        raise AssertionError(f"{VLM}: the patch embeddings left the "
                             f"last-position logits unchanged")
    log(f"[serve] {VLM} full width ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"vocab {V} padded to {cfg.padded_vocab}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params "
        f"bf16): prefill of B {B} x {S} tokens with {n} patch embeddings of "
        f"width {width} a row {prefill_s:.3f} s, then {VLM_DECODE_STEPS} "
        f"decode steps; logits finite; last-position logits against the "
        f"same tokens without patches: max abs diff {diff:.3e} (rel "
        f"{rel:.2e}); peak memory {peak:.2f} GiB | launches " +
        ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    del model, prefill, decode, logits, first, text
    free_card()


# the front phase's traffic: six requests of ragged prompts, every other
# one hot, through ServeFrontDoor(StepLM) over one gemma2-2b layer's paged
# KV layout (mamba2-1.3b serves the same layout: the pool holds StepLM's
# hash mirror, not the model's cache)
FRONT_PROMPTS = (33, 300, 700, 1200, 2500, 4608)
FRONT_NEW_TOKENS = 32
FRONT_MAX_LEN = 4640
FRONT_PAGES = 420
FRONT_CHUNK = 256
FRONT_CHECK_STEPS = 3   # decode steps of the kernel check after admission


def front_requests(vocab_size: int):
    """The same requests on every call, drawn from seed 0."""
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(0)
    return [ServeRequest(rid=i, prompt=rng.integers(0, vocab_size, n).tolist(),
                         max_new_tokens=FRONT_NEW_TOKENS,
                         temperature=0.8 if i % 2 else 0.0, seed=i)
            for i, n in enumerate(FRONT_PROMPTS)]


def timed_steplm(model, layout):
    """A `StepLM` whose admissions and decode steps add their host seconds,
    between a synchronize on each side, to its `seconds`."""
    import torch
    from repro_torch.serve import StepLM
    lm = StepLM(model, max_len=FRONT_MAX_LEN, row_bytes=layout.row_bytes)
    lm.seconds = 0.0
    for name in ("on_admit", "next_tokens"):
        def run(*args, fn=getattr(lm, name)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            lm.seconds += time.perf_counter() - t
            return out
        setattr(lm, name, run)
    return lm


def front_run(arch, cfg, model, layout, mods, max_running, sanitize=False):
    """One `ServeFrontDoor.run()` of the traffic; the launch counters, set
    to 0 just before it, must show flash attention once a layer an
    admission, decode attention once a layer a decode call, the SSD once a
    layer an admission on the tensor cores, and no other kernel.  With
    ``sanitize``, the front door's engine sweeps every drain and audits
    every plan-cache hit, and its reports must all be clean.  Returns the
    requests' outputs, the launch counts, the wall and the host seconds
    outside `StepLM`."""
    import torch
    from repro_torch.serve import ServeFrontDoor
    lm = timed_steplm(model, layout)
    fd = ServeFrontDoor(lm, layout, max_seq_len=FRONT_MAX_LEN,
                        max_running=max_running, prefill_chunk=FRONT_CHUNK,
                        sanitize=sanitize)
    reqs = front_requests(cfg.vocab_size)
    for r in reqs:
        fd.submit(r)
    ssd_tc = mods["ssd"].launches_by_route["tensor_cores"]
    gc.collect()      # an earlier run's front door and caches (a cycle)
    reset(mods)                                # the main path's run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    metrics = fd.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read(mods)
    n_attn, n_ssm = layer_counts(cfg)
    admitted = fd.sched.stats.admitted
    want = {name: 0 for name in mods}
    want.update(flash_attention=n_attn * admitted,
                decode_attention=n_attn * lm.decode_calls,
                ssd=n_ssm * admitted)
    if counts != want:
        raise AssertionError(f"{arch} front launches {counts}, want {want}")
    ssd_tc = mods["ssd"].launches_by_route["tensor_cores"] - ssd_tc
    if ssd_tc != counts["ssd"]:
        raise AssertionError(f"{arch}: {ssd_tc} of {counts['ssd']} SSD "
                             f"launches on the tensor cores")
    for r in reqs:
        if len(r.output) != FRONT_NEW_TOKENS or not all(
                0 <= tok < cfg.vocab_size for tok in r.output):
            raise AssertionError(f"bad output {r.output}")
    n_new = sum(len(r.output) for r in reqs)
    st = fd.alloc.stats
    reports = fd.engine.sanitize_reports
    if sanitize and (not reports or not all(r.clean for r in reports)):
        raise AssertionError(f"{arch} sanitized front: reports "
                             f"{sorted({c for r in reports for c in r.codes})}"
                             f" of {len(reports)}, want all clean")
    tag = (f"sanitized, {len(reports)} reports clean "
           f"({sum(r.checked_rows for r in reports)} rows swept, "
           f"{fd.plan_cache.stats.hits} plan-cache hits audited) | "
           if sanitize else "")
    log(f"[front] {arch} max_running {max_running}: {tag}run() {wall:.2f} s "
        f"wall, StepLM {lm.seconds:.2f} s, the rest (descriptor plane, "
        f"scheduler) {wall - lm.seconds:.2f} s, {n_new / wall:.1f} generated "
        f"tokens/s | {metrics.steps} steps, {metrics.cycles} simulated "
        f"cycles, {st.preemptions} preemptions, {st.swapped_out} / "
        f"{st.swapped_in} blocks swapped out / in, {admitted} admissions | "
        f"{lm.decode_calls} decode calls of one request each | peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return {"outputs": [r.output for r in reqs], "counts": counts,
            "wall": wall, "host": wall - lm.seconds}


class HeldKernels:
    """Within `with`, the flash, decode and SSD wrappers are swapped for
    ones that launch the kernel and hold its result against
    `attention_ref`, `decode_attention_ref` or `ssd_chunked_ref` on the
    same inputs at TOL (flash row by row, as the kernels phase does);
    `report` then fails on any call off its plain version and logs the
    worst error and the shapes met.  The errors stay on the card until
    `report`, so the held calls add no synchronization."""

    def __init__(self, mods):
        import torch
        self.fa, self.da, self.sk = (mods[n] for n in (
            "flash_attention", "decode_attention", "ssd"))
        self.kernels = {"flash_attention": self.fa.flash_attention_cuda,
                        "decode_attention": self.da.decode_attention_cuda,
                        "ssd": self.sk.ssd_cuda}
        self.checks = {name: [] for name in self.kernels}  # (shape, rel,
        #                                                      abs, tol)
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def hold(self, name, shape, got, want, dtype, rows=False):
        err = (got.float() - want.float()).abs()
        if rows:
            rel = (err.amax(-1) / want.float().abs().amax(-1)
                   .clamp_min(1e-6)).max()
        else:
            rel = err.max() / want.float().abs().max().clamp_min(1e-6)
        tol = TOL[str(dtype).removeprefix("torch.")]
        self.checks[name].append((shape, rel, err.max(), tol))

    def flash(self, q, k, v, **kw):
        from repro_torch.kernels.flash_attention import attention_ref
        got = self.kernels["flash_attention"](q, k, v, **kw)
        self.hold("flash_attention", f"B{q.shape[0]} Hq{q.shape[1]} "
                  f"Hkv{k.shape[1]} S{q.shape[2]} w{kw['window']}", got,
                  attention_ref(q, k, v, **kw), q.dtype, rows=True)
        return got

    def decode(self, q, k, v, kv_len=None, **kw):
        from repro_torch.kernels.decode_attention import decode_attention_ref
        got = self.kernels["decode_attention"](q, k, v, kv_len=kv_len, **kw)
        G = q.shape[1] // k.shape[1]
        splits = self.da.num_splits(
            q.shape[0] * k.shape[1] * (G // self.da.heads_per_block(G)),
            k.shape[2], self.sms)
        self.hold("decode_attention", f"B{q.shape[0]} G{G} cache "
                  f"{k.shape[2]} kv_len {int(kv_len)} w{kw['window']} "
                  f"splits {splits}", got,
                  decode_attention_ref(q, k, v, kv_len=kv_len, **kw),
                  q.dtype)
        return got

    def ssd(self, x, dt, A, D, B, C, chunk=128, **kw):
        from repro_torch.kernels.ssd import ssd_chunked_ref
        route = self.sk.route(x, B, C, chunk)
        y, state = self.kernels["ssd"](x, dt, A, D, B, C, chunk=chunk, **kw)
        wy, wstate = ssd_chunked_ref(x, dt, A, D, B, C, chunk=chunk,
                                     return_state=True)
        shape = (f"B{x.shape[0]} S{x.shape[2]} "
                 f"{str(x.dtype).removeprefix('torch.')} {route}")
        self.hold("ssd", shape + " y", y, wy, x.dtype)
        self.hold("ssd", shape + " state", state, wstate, x.dtype)
        return y, state

    def __enter__(self):
        self.fa.flash_attention_cuda, self.da.decode_attention_cuda, \
            self.sk.ssd_cuda = self.flash, self.decode, self.ssd
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_cuda, self.da.decode_attention_cuda, \
            self.sk.ssd_cuda = self.kernels.values()

    def report(self, tag, label):
        """Fail on a call off its plain version; log each kernel's calls
        as `[tag] label name: ...`.  Returns {name: calls held}."""
        import torch
        for name, rows in self.checks.items():
            if not rows:
                continue
            got = torch.stack([torch.stack([r, a]) for _, r, a, _ in rows]
                              ).tolist()
            bad = [(shape, rel) for (shape, _, _, tol), (rel, _)
                   in zip(rows, got) if not (math.isfinite(rel) and
                                             rel < tol)]
            if bad:
                raise AssertionError(f"{label} {name}: {len(bad)} of "
                                     f"{len(rows)} calls off their plain "
                                     f"version, first {bad[0]}")
            shapes = dict.fromkeys(shape for shape, _, _, _ in rows)
            worst = max(range(len(rows)), key=lambda i: got[i][0])
            log(f"[{tag}] {label} {name}: {len(rows)} calls held against "
                f"the plain version, max rel err {got[worst][0]:.2e} (at "
                f"{rows[worst][0]}), max abs err "
                f"{max(a for _, a in got):.3e} (tol {rows[0][3]:.0e}) | "
                f"shapes: " + "; ".join(shapes))
        return {name: len(rows) for name, rows in self.checks.items()}


def front_kernels(arch, cfg, model, mods):
    """The front traffic's kernel shapes on the card, each call held
    against its plain version on its own inputs, and a request's logits
    against themselves.  Request 0 alone, then all six requests with
    request 0 last, go through a `StepLM`: admission (a B = 1 prefill:
    flash attention at each prompt's own length, the SSD at it padded to
    the chunk), then FRONT_CHECK_STEPS decode steps (decode attention at
    B = 1 over the FRONT_MAX_LEN-row cache, with its B = 1 key splits),
    through `HeldKernels`; request 0's logits must be `torch.equal` alone
    and among the others."""
    import torch
    from repro_torch.serve import StepLM

    def serve(rids):
        """`rids` admitted in that order and stepped together; the logits
        row behind each sample, by (rid, len(tokens))."""
        lm = StepLM(model, max_len=FRONT_MAX_LEN, row_bytes=2048)
        rows, sample = {}, lm._sample_row

        def record(req, row):
            rows[req.rid, len(req.tokens)] = row.clone()
            return sample(req, row)
        lm._sample_row = record
        by_rid = {r.rid: r for r in front_requests(cfg.vocab_size)}
        reqs = [by_rid[i] for i in rids]
        for r in reqs:
            r.tokens = list(r.prompt)
            lm.on_admit(r)
        for _ in range(FRONT_CHECK_STEPS + 1):
            for r, tok in zip(reqs, lm.next_tokens(reqs, [None] * len(reqs))):
                r.tokens.append(tok)
        return rows

    with HeldKernels(mods) as held:
        alone = serve([0])
        among = serve(list(range(len(FRONT_PROMPTS)))[::-1])
    held.report("front", arch)
    keys = sorted(k for k in alone if k[0] == 0)
    if keys != sorted(k for k in among if k[0] == 0) or not all(
            torch.equal(alone[k], among[k]) for k in keys):
        raise AssertionError(f"{arch}: request 0's logits differ alone and "
                             f"among the other requests")
    log(f"[front] {arch}: request 0's {len(keys)} logits rows (prefill and "
        f"{FRONT_CHECK_STEPS} decode steps) torch.equal alone and stepped "
        f"after the other {len(FRONT_PROMPTS) - 1} requests")


def phase_front(arch, mods, sanitize=False):
    """Full-width `arch` behind the continuous-batching front door; with
    ``sanitize``, a third run at max_running 4 through a sanitized front
    door must give the same streams and the same launches."""
    from repro_torch.configs import RunConfig, get
    from repro_torch.models import LM
    from repro_torch.serve import KVLayout

    cfg = get(arch)
    model = LM(cfg, RunConfig(dtype="bfloat16"), seed=0, device="cuda")
    layout = KVLayout(n_pages=FRONT_PAGES, page_size=16, n_kv_heads=4,
                      head_dim=256, itemsize=2)
    log(f"[front] {arch} full width, bf16, StepLM max_len {FRONT_MAX_LEN}; "
        f"prompts {FRONT_PROMPTS}, {FRONT_NEW_TOKENS} new tokens each, every "
        f"other request at T=0.8; pool of {FRONT_PAGES} pages of 16 rows of "
        f"{layout.row_bytes} B, prefill_chunk {FRONT_CHUNK}")
    run4 = front_run(arch, cfg, model, layout, mods, 4)
    out4 = run4["outputs"]
    out1 = front_run(arch, cfg, model, layout, mods, 1)["outputs"]
    if out4 != out1:
        bad = [i for i, (a, b) in enumerate(zip(out4, out1)) if a != b]
        raise AssertionError(f"{arch}: streams of requests {bad} differ "
                             f"between max_running 4 and 1")
    log(f"[front] {arch}: all {len(out4)} streams, hot ones included, equal "
        f"at max_running 4 and 1; request 0 starts {out4[0][:8]}")
    if sanitize:
        san = front_run(arch, cfg, model, layout, mods, 4, sanitize=True)
        if san["outputs"] != out4 or san["counts"] != run4["counts"]:
            raise AssertionError(f"{arch}: the sanitized run's streams or "
                                 f"launches {san['counts']} differ from the "
                                 f"unsanitized run's {run4['counts']}")
        log(f"[front] {arch}: sanitized run at max_running 4 == unsanitized, "
            f"all {len(out4)} streams and the launches; run() "
            f"{san['wall']:.2f} s vs {run4['wall']:.2f} s wall, host outside "
            f"StepLM {san['host']:.2f} s vs {run4['host']:.2f} s "
            f"(sweep and audit {san['host'] - run4['host']:+.2f} s)")
    front_kernels(arch, cfg, model, mods)
    del model
    free_card()


def seed_qkv_biases(model, seed):
    """Draw a qkv-bias model's biases at σ 0.5 from `seed`: the init's
    zeros would hide a bias that is dropped."""
    import torch
    gen = torch.Generator(model.device).manual_seed(seed)
    with torch.no_grad():
        for layer in model.layers:
            for b in (layer.attn.bq, layer.attn.bk, layer.attn.bv):
                b.copy_(0.5 * torch.randn(b.shape, generator=gen,
                                          device=b.device))


def log_routing(tag, label, cfg, a, b):
    """Log `routing_changes` of two runs' MoeLog records."""
    per_layer = routing_changes(cfg, a, b)
    log(f"[{tag}] {label}: (token, expert) pairs routed differently in "
        f"each layer over the prefill and decode steps, " + ", ".join(
            f"layer {i} {n}" for i, (n, _, _) in enumerate(per_layer)) +
        "; dropped share in each layer's prefill " + ", ".join(
            f"{da:.4f} / {db:.4f}" for _, da, db in per_layer))


def phase_card_vs_cpu(cfg, label, mods, S=600):
    """2 layers at full width in fp32, a prompt of S tokens and 3 decode
    steps: the card's logits against the CPU's over the real vocab rows,
    and the card's launches against `expected_launches`.  qkv biases are
    seeded non-zero."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.models import LM, lm_decode_step, lm_prefill

    f32 = RunConfig(dtype="float32")
    gpu = LM(cfg, f32, seed=1, device="cuda")
    if cfg.qkv_bias:
        seed_qkv_biases(gpu, 1)
    cpu = LM(cfg, f32, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    B, steps = 2, 3
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + steps)))
    max_len = S + steps
    reset(mods)
    worst = 0.0
    with MoeLog() as routed:
        lg, cg = lm_prefill(gpu, toks[:, :S].cuda(), max_len=max_len)
        lc, cc = lm_prefill(cpu, toks[:, :S], max_len=max_len)
        pairs = [(lg, lc)]
        for i in range(steps):
            t = toks[:, S + i:S + i + 1]
            lg, cg = lm_decode_step(gpu, cg, t.cuda(), S + i)
            lc, cc = lm_decode_step(cpu, cc, t, S + i)
            pairs.append((lg, lc))
    counts, want = read(mods), expected_launches(cfg, steps)
    if cfg.moe is not None:
        log_routing("card-vs-cpu", f"2 layers ({label}) fp32, card vs CPU",
                    cfg, [c for c in routed.calls if c[0] == "cuda"],
                    [c for c in routed.calls if c[0] == "cpu"])
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
    del gpu, cpu, cg, cc
    free_card()


def phase_bf16_vs_plain(cfg, label, mods, S=600, rcfg=None):
    """The serving dtype end to end: the 2 layers in bf16 on the card (or
    with `rcfg`'s knobs), logits through the attention and SSD kernels
    against the same model with the kernels' plain versions in their
    place.  qkv biases are seeded non-zero."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.ssd import ssd_chunked_ref
    from repro_torch.models import LM, lm_decode_step, lm_prefill

    def ssd_plain(*args, chunk=128):
        return ssd_chunked_ref(*args, chunk=chunk, return_state=True)

    model = LM(cfg, rcfg or RunConfig(dtype="bfloat16"), seed=1,
               device="cuda")
    if cfg.qkv_bias:
        seed_qkv_biases(model, 2)
    B, steps = 2, 3
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
    with MoeLog() as routed:
        got = run()
    counts, want_counts = read(mods), expected_launches(cfg, steps)
    if counts != want_counts:
        raise AssertionError(f"bf16 card path launches {counts}, want "
                             f"{want_counts}")
    fa, da, sk = (mods[n] for n in ("flash_attention", "decode_attention",
                                    "ssd"))
    kernels = fa.flash_attention_cuda, da.decode_attention_cuda, sk.ssd_cuda
    fa.flash_attention_cuda, da.decode_attention_cuda, sk.ssd_cuda = \
        attention_ref, decode_attention_ref, ssd_plain
    try:
        with MoeLog() as plain_routed:
            want = run()
    finally:
        fa.flash_attention_cuda, da.decode_attention_cuda, sk.ssd_cuda = \
            kernels
    if cfg.moe is not None:
        log_routing("card-vs-cpu", f"2 layers ({label}) bf16, kernels vs "
                    f"plain", cfg, routed.calls, plain_routed.calls)
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
    del model, got, want
    free_card()


SSD_KNOBS = (dict(ssd_chunk=64), dict(ssd_compute_dtype="bfloat16"))


def phase_ssd_knobs(mods):
    """The SSD's two `RunConfig` knobs on the serving path: full-width
    mamba2-1.3b and hymba-1.5b answer the traffic once under
    `ssd_chunk=64` and once under `ssd_compute_dtype="bfloat16"` (x, B and
    C handed to the scan in bf16), every SSD launch counted by route and
    on the tensor cores (`phase_serve`); 2 layers of each in bf16 with the
    knob, kernels against their plain versions (rel 2e-2); then
    `ssd_chunk=256` at mamba2's N 128, which no route holds in shared
    memory: the prefill raises the SSD's named error before any launch."""
    import numpy as np
    import torch
    from repro_torch.configs import HYBRID, HYBRID_FULL, RunConfig, get
    from repro_torch.models import LM, lm_prefill

    t0 = time.perf_counter()
    mamba2 = dataclasses.replace(get("mamba2-1.3b"), n_layers=2)
    hymba2 = dataclasses.replace(get(HYMBA), n_layers=2, layer_pattern=(
        ((HYBRID_FULL,), 1), ((HYBRID,), 1)))
    for knobs in SSD_KNOBS:
        rcfg = RunConfig(dtype="bfloat16", **knobs)
        tag = ", ".join(f"{k}={v!r}" for k, v in knobs.items())
        for arch in ("mamba2-1.3b", HYMBA):
            phase_serve(arch, mods, rcfg=rcfg, attempts=1)
        phase_bf16_vs_plain(mamba2, f"SSM, SSM; {tag}", mods, rcfg=rcfg)
        phase_bf16_vs_plain(hymba2, f"HYBRID_FULL, HYBRID; {tag}", mods,
                            S=1100, rcfg=rcfg)
    sk = mods["ssd"]
    model = LM(dataclasses.replace(get("mamba2-1.3b"), n_layers=1),
               RunConfig(dtype="bfloat16", ssd_chunk=256), seed=0,
               device="cuda")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 50_000, (1, 512))).cuda()
    before = (sk.launches, dict(sk.launches_by_route))
    try:
        lm_prefill(model, toks)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("ssd_chunk=256 at N 128 was not refused")
    if "chunk 256 at N 128" not in msg or \
            (sk.launches, dict(sk.launches_by_route)) != before:
        raise AssertionError(f"the refusal: {msg!r}, launches "
                             f"{sk.launches_by_route} vs {before}")
    log(f"[ssd-knobs] mamba2-1.3b with ssd_chunk=256: refused before any "
        f"launch: {msg}")
    del model
    free_card()
    log(f"[ssd-knobs] phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# The encoder-decoder (seamless-m4t-large-v2) and the training path
# ---------------------------------------------------------------------------

CARD = "cuda"   # the device of the encdec and train phases
SEAMLESS = "seamless-m4t-large-v2"
ENC_B, ENC_FRAMES = 4, 1152        # 4,608 input frames / subsample 4
DEC_MAX_LEN, DEC_PROMPT, DEC_STEPS = 256, 16, 64
TRAIN = "gemma2-2b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_FAULT = 512, 4, 5, 2
MAMBA_LAYERS, MAMBA_STEPS, MAMBA_EVERY, MAMBA_FAULT = 2, 6, 2, 3
PLAIN_RCFG = dict(kernels="xla", dtype="float32", remat=False)


def phase_encdec_kernels(mods):
    """Flash and decode attention at seamless-m4t-large-v2's serving
    shapes, head_dim 64, 16 q on 16 kv heads (GQA group 1), bf16, no
    softcap: flash non-causal over the encoder's B 4 x 1,152 frames;
    flash with one query row against the 1,152 frames (the cross-attention
    of a decode step), its q the transposed (B, 1, 16, 64) view the model
    hands it; decode over a 256-row cache at `kv_len` 64.  Each against
    its plain version at TOL (flash row by row), then by device time in
    turns with `flex_attention` (and the one-row flash also with the
    decode kernel, which computes the same function); the plain version
    by CUDA events.  Returns the three entries, named by their shape."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import runtime
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref

    cfg = get(SEAMLESS)
    fa, da = mods["flash_attention"], mods["decode_attention"]
    library = library_attention()
    gen = torch.Generator(CARD).manual_seed(24)
    H, D, B, S = cfg.n_heads, cfg.resolved_head_dim, ENC_B, ENC_FRAMES
    scale, bf16 = D ** -0.5, "bfloat16"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=CARD).to(
            torch.bfloat16)

    entries = {}
    k, v = randn(B, H, S, D), randn(B, H, S, D)
    x = randn(B, 1, H * D)              # a decode step's q, (B, 1, H·D)
    q1 = x.reshape(B, 1, H, D).transpose(1, 2)
    same = runtime.aligned16(q1).data_ptr() == q1.data_ptr()
    log(f"[encdec-kernels] the cross-attention's q, the (B {B}, 1, {H}, "
        f"{D}) view transposed to {tuple(q1.shape)} with strides "
        f"{q1.stride()}: contiguous {q1.is_contiguous()}, "
        f"runtime.aligned16 {'passes it as it is' if same else 'copies it'}")
    for label, q in (("encoder", randn(B, H, S, D)), ("cross", q1)):
        Sq = q.shape[2]
        kw = dict(causal=False, window=0, softcap=0.0, scale=scale)
        name = (f"flash B{B} Hq{H} Hkv{H} Sq{Sq} Sk{S} D{D} non-causal "
                f"bf16 ({label})")
        want = attention_ref(q, k, v, **kw)
        abs_err, rel = check_close(f"{SEAMLESS} {name}",
                                   fa.flash_attention_cuda(q, k, v, **kw),
                                   want, bf16, rows=True)
        lib = flex_call(library, f"{SEAMLESS} {name}", q, k, v,
                        flash_mask(False, 0), want, bf16, scale, rows=True)
        fns = {"kernel": lambda: fa.flash_attention_cuda(q, k, v, **kw)}
        if lib is not None:
            fns["flex_attention"] = lib
        if label == "cross":
            # the decode kernel computes the same function: one query over
            # 1,152 keys; logged beside flash, the path keeps flash
            q3 = q[:, :, 0]
            dk = dict(kv_len=S, window=0, softcap=0.0, scale=scale)
            check_close(f"{SEAMLESS} decode as cross-attention",
                        da.decode_attention_cuda(q3, k, v, **dk),
                        want[:, :, 0], bf16)
            fns["decode_attention"] = lambda: da.decode_attention_cuda(
                q3, k, v, **dk)
        t = in_turns(fns)
        log(f"[encdec-kernels] {name} in turns, device ms median (min-max) "
            f"over 5 rounds: " + ", ".join(
                f"{n} {md:.4f} ({lo:.4f}-{hi:.4f})"
                for n, (md, lo, hi) in t.items()))
        ms = t["kernel"][0]
        lib_ms = t["flex_attention"][0] if lib is not None else None
        plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), iters=5,
                           warmup=1)
        flops = 4 * D * Sq * S * B * H
        b_ms, b_by = bound(flops, (2 * q.numel() + k.numel() + v.numel())
                           * q.element_size(), bf16)
        log(f"[encdec-kernels] {SEAMLESS} {name}: row rel err {rel:.2e} "
            f"(tol {TOL[bf16]:.0e}) | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of bound" +
            ("" if lib_ms is None else f", {ms / lib_ms:.2f}x library") +
            ("" if label != "cross" else
             f", {ms / t['decode_attention'][0]:.2f}x the decode kernel"))
        entries[f"flash_attention {SEAMLESS} {label}"] = kernel_entry(
            "flash_attention", f"{SEAMLESS} {label}", ms, plain_ms, b_ms,
            b_by, lib_ms, abs_err)
        del want, lib, fns
        torch.cuda.empty_cache()

    # the decoder's self-attention: one query a row over its 256-row cache
    kv_len = DEC_PROMPT + (DEC_STEPS - DEC_PROMPT)
    q = randn(B, H, D)
    ck, cv = randn(B, H, DEC_MAX_LEN, D), randn(B, H, DEC_MAX_LEN, D)
    kw = dict(kv_len=kv_len, window=0, softcap=0.0, scale=scale)
    name = (f"decode B{B} Hq{H} Hkv{H} cache {DEC_MAX_LEN} D{D} kv_len "
            f"{kv_len} bf16")
    want = decode_attention_ref(q, ck, cv, **kw)
    abs_err, rel = check_close(f"{SEAMLESS} {name}",
                               da.decode_attention_cuda(q, ck, cv, **kw),
                               want, bf16)
    lib = flex_call(library, f"{SEAMLESS} {name}", q[:, :, None], ck, cv,
                    decode_mask(kv_len, 0), want[:, :, None], bf16, scale)
    ms, lib_ms = timed_in_turns(
        SEAMLESS, name, lambda: da.decode_attention_cuda(q, ck, cv, **kw),
        lib)
    plain_ms = time_ms(lambda: decode_attention_ref(q, ck, cv, **kw))
    b_ms, b_by = bound(4 * B * H * kv_len * D,
                       (2 * B * H * kv_len * D + 2 * q.numel())
                       * q.element_size(), bf16)
    log(f"[encdec-kernels] {SEAMLESS} {name}: rel err {rel:.2e} (tol "
        f"{TOL[bf16]:.0e}) | kernel {ms:.4f} ms device, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
        f"{100 * b_ms / ms:.1f}% of bound" +
        ("" if lib_ms is None else f", {ms / lib_ms:.2f}x library"))
    entries[f"decode_attention {SEAMLESS}"] = kernel_entry(
        "decode_attention", SEAMLESS, ms, plain_ms, b_ms, b_by, lib_ms,
        abs_err)
    del k, v, ck, cv, lib
    free_card()
    return entries


def encdec_serve(model, frames, prompt, steps, mods, warm=False):
    """Prefill (the encoder and every layer's cross K/V) then `steps`
    decode steps, the prompt's tokens fed one a step and greedy tokens
    after them; returns (cross, the step logits, launches of the prefill,
    of the decode steps, prefill s, decode s).  With `warm`, a first
    prefill, neither timed nor counted, warms the allocator up."""
    import torch
    from repro_torch.models import init_encdec_cache
    from repro_torch.serve import (greedy_sample, make_decode_step,
                                   make_prefill_step)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    B = frames.shape[0]
    if warm:
        prefill(frames)
    reset(mods)                                # the main path's prefill
    torch.cuda.synchronize()
    t = time.perf_counter()
    cross = prefill(frames)
    torch.cuda.synchronize()
    prefill_s, pre = time.perf_counter() - t, read(mods)
    cache = init_encdec_cache(B, DEC_MAX_LEN, model.cfg,
                              device=frames.device)
    outs = []
    reset(mods)                                # the main path's decode
    torch.cuda.synchronize()
    t = time.perf_counter()
    tok = prompt[:, :1]
    for pos in range(steps):
        logits, cache = decode(cache, cross, tok, pos)
        outs.append(logits)
        tok = prompt[:, pos + 1:pos + 2] if pos + 1 < prompt.shape[1] \
            else greedy_sample(logits)[:, None].long()
    torch.cuda.synchronize()
    return cross, outs, pre, read(mods), prefill_s, time.perf_counter() - t


def phase_encdec(mods):
    """Full-width seamless-m4t-large-v2 (24 + 24 layers, d 1,024, 16 heads
    of 64, vocab 256,206), seeded weights, bf16: B 4 x 1,152 seeded frames
    through `make_prefill_step`, then `init_encdec_cache(4, 256)` and 64
    `make_decode_step` calls (a 16-token seeded prompt fed one token a
    step, then 48 greedy tokens).  Launches, counted from 0 over the
    prefill and over the decode steps: flash 24 then 24 x 64, decode 0
    then 24 x 64, nothing else.  A second, untimed run holds every flash
    and decode call against its plain version.  Then 2 layers of each
    stack at full width in fp32, `encdec_forward` with the kernels on the
    card against the plain versions on the CPU (rel 1e-4); then one
    full-width fp32 `make_train_step` step (B 2, 256 tokens, 64 frames):
    finite loss within 1.0 of ln(256,206), finite grad norm > 0, the
    kernels' counters 0.  Returns the launches of the first run, by
    kernel entry."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get
    from repro_torch.configs.base import EncoderConfig
    from repro_torch.models import EncDec, encdec_forward
    from repro_torch.train import init_train_state, make_train_step

    cfg = get(SEAMLESS)
    L = cfg.n_layers
    t0 = time.perf_counter()
    model = EncDec(cfg, RunConfig(dtype="bfloat16"), seed=0, device=CARD)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[encdec] {SEAMLESS} full width: {cfg.encoder.n_layers} encoder + "
        f"{L} decoder layers, d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params (bf16, "
        f"{2 * n_params / 1e9:.2f} GB), seeded init "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(CARD).manual_seed(25)
    frames = torch.randn((ENC_B, ENC_FRAMES, cfg.d_model), generator=gen,
                         device=CARD).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (ENC_B, DEC_PROMPT),
                           generator=gen, device=CARD)
    torch.cuda.reset_peak_memory_stats()
    cross, outs, pre, dec, prefill_s, decode_s = encdec_serve(
        model, frames, prompt, DEC_STEPS, mods, warm=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    zero = {name: 0 for name in mods}
    want_pre = dict(zero, flash_attention=L)
    want_dec = dict(zero, flash_attention=L * DEC_STEPS,
                    decode_attention=L * DEC_STEPS)
    if pre != want_pre or dec != want_dec:
        raise AssertionError(f"{SEAMLESS} launches: prefill {pre}, decode "
                             f"{dec}; want {want_pre}, {want_dec}")
    if not all(bool(torch.isfinite(o[:, :cfg.vocab_size]).all())
               for o in outs):
        raise AssertionError(f"{SEAMLESS}: non-finite decode logits")
    if tuple(cross[0].shape) != (L, ENC_B, cfg.n_kv_heads, ENC_FRAMES,
                                 cfg.resolved_head_dim):
        raise AssertionError(f"cross K shape {tuple(cross[0].shape)}")
    greedy = [int(o[0].argmax()) for o in outs[DEC_PROMPT - 1:]]
    log(f"[encdec] {SEAMLESS} serve: B {ENC_B} x {ENC_FRAMES} frames "
        f"({ENC_FRAMES * cfg.encoder.subsample} input frames / subsample "
        f"{cfg.encoder.subsample}) through make_prefill_step "
        f"{prefill_s:.3f} s (after a warm-up call); {DEC_STEPS} decode steps ({DEC_PROMPT} prompt "
        f"tokens fed one a step, then {DEC_STEPS - DEC_PROMPT} greedy) "
        f"{1e3 * decode_s / DEC_STEPS:.2f} ms a step over a "
        f"{DEC_MAX_LEN}-row cache; peak memory {peak:.2f} GiB | launches: "
        f"prefill flash {pre['flash_attention']}, decode steps flash "
        f"{dec['flash_attention']} decode {dec['decode_attention']}, "
        f"every other kernel 0; logits finite; row 0's greedy tokens "
        f"start {greedy[:8]}")
    del cross, outs
    with HeldKernels(mods) as hk:
        encdec_serve(model, frames, prompt, DEC_STEPS, mods)
    calls = hk.report("encdec", f"{SEAMLESS} prefill and {DEC_STEPS} "
                      f"decode steps")
    want_calls = {"flash_attention": L * (DEC_STEPS + 1),
                  "decode_attention": L * DEC_STEPS, "ssd": 0}
    if calls != want_calls:
        raise AssertionError(f"{SEAMLESS}: held {calls}, want {want_calls}")
    del model, frames, hk
    free_card()

    # 2 layers of each stack, fp32: the card's kernels against the CPU's
    # plain versions through the training forward (no grad)
    cfg2 = dataclasses.replace(cfg, n_layers=2,
                               encoder=EncoderConfig(2, cfg.encoder.subsample))
    f32 = RunConfig(kernels="pallas", dtype="float32")
    gpu = EncDec(cfg2, f32, seed=1, device=CARD)
    cpu = EncDec(cfg2, f32, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(26)
    fr = torch.from_numpy(rng.standard_normal((2, 300, cfg.d_model))
                          .astype(np.float32))
    tk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 70)))
    reset(mods)
    with torch.no_grad():
        lg = encdec_forward(gpu, fr.to(CARD), tk.to(CARD), f32)
        lc = encdec_forward(cpu, fr, tk, f32)
    counts = read(mods)
    if counts != dict(zero, flash_attention=6):
        raise AssertionError(f"2-layer encdec launches {counts}")
    V = cfg.vocab_size
    rel = float((lg[..., :V].cpu() - lc[..., :V]).abs().max() /
                lc[..., :V].abs().max())
    if not rel < 1e-4:
        raise AssertionError(f"encdec card vs CPU logits rel err {rel:.2e}")
    log(f"[card-vs-cpu] 2 + 2 layers of {SEAMLESS} d {cfg.d_model} fp32, "
        f"B 2, 300 frames, 70 tokens, encdec_forward with the flash kernel "
        f"(6 launches: encoder, decoder self- and cross-attention) vs the "
        f"CPU's plain version: max logits rel err {rel:.2e} (tol 1e-4)")
    del gpu, cpu, lg, lc
    free_card()

    # one full-width fp32 train step on the plain path
    rcfg = RunConfig(**PLAIN_RCFG)
    t0 = time.perf_counter()
    state = init_train_state(0, cfg, rcfg, device=CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"frames": torch.randn((2, 64, cfg.d_model), generator=gen,
                                   device=CARD),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 256),
                                     generator=gen, device=CARD)}
    step = make_train_step(cfg, rcfg)
    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    ln_v = math.log(cfg.vocab_size)
    if not (math.isfinite(loss) and abs(loss - ln_v) < 1.0):
        raise AssertionError(f"{SEAMLESS} train loss {loss}, want within "
                             f"1.0 of ln V = {ln_v:.3f}")
    if not (math.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"{SEAMLESS} grad norm {gnorm}")
    if read(mods) != zero:
        raise AssertionError(f"{SEAMLESS} train step launched kernels "
                             f"{read(mods)}")
    log(f"[encdec] {SEAMLESS} full width fp32 train step (kernels='xla', "
        f"B 2, 256 tokens, 64 frames): loss {loss:.4f} (ln V {ln_v:.4f}), "
        f"grad norm {gnorm:.4f}, {step_s:.3f} s (the first step, its "
        f"allocations included; state init {init_s:.1f} s), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no kernel "
        f"launched")
    del state, batch, m
    free_card()
    return {f"flash_attention {SEAMLESS} encoder": pre["flash_attention"],
            f"flash_attention {SEAMLESS} cross": dec["flash_attention"],
            f"decode_attention {SEAMLESS}": dec["decode_attention"]}


def timed_step(step, times):
    """`step` with a synchronize on each side; (the state's step before
    it, its seconds) appended to `times`."""
    import torch

    def run(state, batch):
        before = int(state["step"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append((before, time.perf_counter() - t))
        return out
    return run


def train_run(cfg, tcfg, injector, seq, batch, knobs=PLAIN_RCFG):
    """A `Trainer` run on the card on the plain path (fp32, or `knobs`);
    returns (trainer, state, [(step, seconds)] of each step it ran, the
    first 4,096 elements of each weight before the run, on the CPU)."""
    from repro_torch.configs import RunConfig
    from repro_torch.train import Trainer, make_train_step
    rcfg = RunConfig(**knobs)
    times = []
    trainer = Trainer(cfg, rcfg, tcfg, seq_len=seq, global_batch=batch,
                      injector=injector, device=CARD,
                      step_fn=timed_step(make_train_step(
                          cfg, rcfg, total_steps=tcfg.total_steps), times))
    state = trainer.init_or_restore()
    before = {n: p.detach().reshape(-1)[:4096].to("cpu", copy=True)
              for n, p in state["params"].named_parameters()}
    return trainer, trainer.run(state), times, before


def moved(state, before):
    """The least, over the weights, of a weight's largest move from
    `before` (a slice of each)."""
    return min(float((p.detach().reshape(-1)[:4096].cpu() - before[n])
                     .abs().max())
               for n, p in state["params"].named_parameters())


def state_diff(first, model):
    """Largest abs difference between the weights `first` (CPU copies,
    by name) and `model`'s, leaf by leaf on the card."""
    return max(float((first[n].to(p.device) - p.detach()).abs().max())
               for n, p in model.named_parameters())


def held_equal(label, d_loss, d_gnorm, d_param, losses, gnorms, lr_sum,
               exact_only=False):
    """Two runs that should be the same: bit for bit, or (logged as not)
    within loss 1e-5 and grad norm 1e-4 of their largest, and weights
    within 2·Σlr, the most two Adam runs can part where a tiny gradient's
    sign differs; with `exact_only`, bit for bit.  Returns whether they
    were bit for bit."""
    exact = d_loss == d_gnorm == d_param == 0
    log(f"[train] {label}: max |d loss| {d_loss:.3e}, max |d grad norm| "
        f"{d_gnorm:.3e}, max |d weight| {d_param:.3e}: "
        f"{'bit for bit' if exact else 'NOT bit for bit'}")
    if exact_only and not exact:
        raise AssertionError(f"{label}: not bit for bit")
    if not (d_loss <= 1e-5 * max(map(abs, losses)) and
            d_gnorm <= 1e-4 * max(gnorms) and d_param <= 2 * lr_sum):
        raise AssertionError(f"{label}: the runs part")
    return exact


def history_diff(h1, h2, key):
    return max(abs(a[key] - b[key]) for a, b in zip(h1, h2))


def train_breakdown(cfg, state, batch, label):
    """One more train step, split by synchronizing host clocks into the
    forward with the loss, the backward and AdamW, and a profiled step's
    device time by kernel: the GEMMs' share and the top kernels; then the
    plain attention (`chunked_flash`) forward and backward at one layer's
    shape, and the logits with the loss, forward and backward, each by
    CUDA events.  Logged, not checked."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import RunConfig
    from repro_torch.models import lm_loss
    from repro_torch.models.attention import chunked_flash
    from repro_torch.models.lm import _logits, next_token_nll
    from repro_torch.optim import adamw_update
    from repro_torch.train import make_train_step

    rcfg = RunConfig(**PLAIN_RCFG)
    model = state["params"]
    params = dict(model.named_parameters())

    def sync_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (loss, _), fwd_s = sync_s(lambda: lm_loss(model, batch, rcfg))
    _, bwd_s = sync_s(loss.backward)
    grads = {n: p.grad for n, p in params.items()}
    _, opt_s = sync_s(lambda: adamw_update(grads, state["opt"], params,
                                           1e-5))
    del grads, loss
    for p in params.values():
        p.grad = None
    step = make_train_step(cfg, rcfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    total = sum(e.self_device_time_total for e in kern)
    gemm = sum(e.self_device_time_total for e in kern
               if any(s in e.key.lower() for s in
                      ("gemm", "cutlass", "xmma", "cublas")))
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[train] {label} one step split by synchronizing: forward + loss "
        f"{fwd_s:.3f} s, backward {bwd_s:.3f} s, AdamW {opt_s:.3f} s; "
        f"profiled step: device time {total / 1e6:.3f} s, GEMM kernels "
        f"{gemm / 1e6:.3f} s ({100 * gemm / max(total, 1):.1f}%); top "
        f"kernels: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x"
            f"{e.count}" for e in top))
    # the plain attention at one layer's shape, and the logits and loss
    B, S = batch["tokens"].shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(CARD).manual_seed(27)
    q, k, v = (torch.randn(s, generator=gen, device=CARD)
               .requires_grad_() for s in ((B, Hq, S, D), (B, Hkv, S, D),
                                           (B, Hkv, S, D)))
    scale = cfg.query_scale or D ** -0.5

    def attn():
        o = chunked_flash(q, k, v, True, 0, cfg.attn_softcap, scale,
                          rcfg.attn_chunk_q, rcfg.attn_chunk_k)
        o.backward(torch.ones_like(o))

    attn_ms = time_ms(attn, iters=5, warmup=1)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=CARD,
                    requires_grad=True)
    tok = batch["tokens"]

    def logits_loss():
        nll = next_token_nll(_logits(model, x), tok).mean()
        nll.backward()

    with torch.no_grad():
        for p in params.values():
            p.requires_grad_(False)
    try:
        head_ms = time_ms(logits_loss, iters=5, warmup=1)
    finally:
        for p in params.values():
            p.requires_grad_(True)
    log(f"[train] {label} plain attention (chunked_flash, B {B}, {Hq}/{Hkv} "
        f"heads of {D}, S {S}, causal, softcap {cfg.attn_softcap}) forward "
        f"+ backward {attn_ms:.2f} ms a layer, x {len(cfg.layer_kinds)} "
        f"layers {attn_ms * len(cfg.layer_kinds) / 1e3:.3f} s a step; "
        f"logits (vocab {cfg.padded_vocab}, fp32) + loss forward + backward "
        f"{head_ms:.2f} ms (CUDA events)")


def phase_train(mods):
    """Full-width gemma2-2b trains through `Trainer` on the card, fp32,
    `RunConfig(kernels="xla", dtype="float32", remat=False)` (the
    reference's launcher's), B 4 x 512 tokens, 5 steps, a step fault
    injected at step 2 under `replay`: one replay, 5 steps, finite losses
    (the first within 1.0 of ln(256,000) + 0.5), finite grad norms > 0,
    the weights moved, and no kernel launched (the flash, decode and SSD
    counters 0: training takes the plain path, as the reference's).  Its
    history and weights against a fresh run without the fault.  Then a
    train step split and profiled (`train_breakdown`).  Then 2 layers of
    mamba2-1.3b at full width, 6 steps, a checkpoint every 2 into a
    temporary directory, a node failure injected at step 3: it restores
    step 2's checkpoint and ends at step 6 with the weights of an
    uninterrupted run."""
    import tempfile
    import torch
    from repro_torch.configs import get
    from repro_torch.dist.fault import FaultConfig, FaultInjector
    from repro_torch.train import TrainerConfig

    zero = {name: 0 for name in mods}
    cfg = get(TRAIN)
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, seed=0,
                         fault=FaultConfig(policy="replay"))
    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, state, times, before = train_run(
        cfg, tcfg, FaultInjector([TRAIN_FAULT], kind="step"), TRAIN_SEQ,
        TRAIN_BATCH)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = read(mods)
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    ln_v = math.log(cfg.vocab_size)
    if trainer.stats.replays != 1 or int(state["step"]) != TRAIN_STEPS or \
            [s for s, _ in times] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"{TRAIN}: replays {trainer.stats.replays}, "
                             f"step {int(state['step'])}, ran {times}")
    if counts != zero:
        raise AssertionError(f"{TRAIN} training launched kernels {counts}")
    if not (all(map(math.isfinite, losses)) and
            abs(losses[0] - (ln_v + 0.5)) < 1.0):
        raise AssertionError(f"{TRAIN} losses {losses}")
    if not all(math.isfinite(g) and g > 0 for g in gnorms):
        raise AssertionError(f"{TRAIN} grad norms {gnorms}")
    least = moved(state, before)
    if not least > 0:
        raise AssertionError(f"{TRAIN}: a weight did not move")
    n_params = sum(p.numel() for p in state["params"].parameters())
    secs = [t for _, t in times]
    steady = secs[1:]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"[train] {TRAIN} full width fp32 ({n_params / 1e9:.3f} B params; "
        f"weights, grads, mu and nu {16 * n_params / 1e9:.1f} GB), "
        f"kernels='xla', remat off, B {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"{TRAIN_STEPS} steps, a step fault at step {TRAIN_FAULT} "
        f"replayed: replays {trainer.stats.replays}; losses " +
        " ".join(f"{v:.4f}" for v in losses) + f" (ln V + 0.5 = "
        f"{ln_v + 0.5:.4f}); grad norms " +
        " ".join(f"{g:.3f}" for g in gnorms) + "; lr " +
        " ".join(f"{h['lr']:.3e}" for h in hist) + f"; every weight "
        f"moved (the least largest move {least:.3e}) | step s " +
        " ".join(f"{t:.3f}" for t in secs) + f" (the first with its "
        f"allocations), steady {sum(steady) / len(steady):.3f} s a step, "
        f"{tokens * len(steady) / sum(steady):.0f} tokens/s; run wall "
        f"{wall:.1f} s with init; peak memory {peak:.2f} GiB | launches: "
        f"none (flash, decode, ssd 0)")
    first = {n: p.detach().to("cpu", copy=True)
             for n, p in state["params"].named_parameters()}
    batch = trainer._put(trainer.pipeline.source.batch(TRAIN_STEPS))
    train_breakdown(cfg, state, batch, f"{TRAIN} (B {TRAIN_BATCH} x "
                    f"{TRAIN_SEQ})")
    del trainer, state, batch
    free_card()
    clean, s2, _, _ = train_run(cfg, tcfg, None, TRAIN_SEQ, TRAIN_BATCH)
    held_equal(f"{TRAIN} replayed run vs a fresh run without the fault",
               history_diff(hist, clean.history, "loss"),
               history_diff(hist, clean.history, "grad_norm"),
               state_diff(first, s2["params"]), losses, gnorms,
               sum(h["lr"] for h in hist))
    del clean, s2, first
    free_card()

    mcfg = dataclasses.replace(get("mamba2-1.3b"), n_layers=MAMBA_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        mt = TrainerConfig(total_steps=MAMBA_STEPS,
                           checkpoint_every=MAMBA_EVERY, checkpoint_dir=tmp,
                           keep_checkpoints=2, seed=0)
        reset(mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr, st, mtimes, mbefore = train_run(
            mcfg, mt, FaultInjector([MAMBA_FAULT], kind="node"), TRAIN_SEQ,
            TRAIN_BATCH)
        wall = time.perf_counter() - t0
        counts = read(mods)
    steps_run = [s for s, _ in mtimes]
    if tr.stats.node_failures != 1 or int(st["step"]) != MAMBA_STEPS:
        raise AssertionError(f"mamba2: failures {tr.stats.node_failures}, "
                             f"step {int(st['step'])}")
    want_steps = list(range(MAMBA_FAULT)) + \
        list(range(MAMBA_EVERY * (MAMBA_FAULT // MAMBA_EVERY), MAMBA_STEPS))
    if steps_run != want_steps:
        raise AssertionError(f"mamba2 ran steps {steps_run}, want "
                             f"{want_steps} (a restore of step "
                             f"{MAMBA_EVERY}'s checkpoint)")
    if counts != zero:
        raise AssertionError(f"mamba2 training launched kernels {counts}")
    mfirst = {n: p.detach().to("cpu", copy=True)
              for n, p in st["params"].named_parameters()}
    mhist, mleast = tr.history, moved(st, mbefore)
    del tr, st
    free_card()
    clean, s2, _, _ = train_run(mcfg, dataclasses.replace(
        mt, checkpoint_dir=None), None, TRAIN_SEQ, TRAIN_BATCH)
    log(f"[train] mamba2-1.3b {MAMBA_LAYERS} layers full width fp32 "
        f"(kernels='xla': the SSD through ssd_chunked_ref), B "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {MAMBA_STEPS} steps, a checkpoint "
        f"every {MAMBA_EVERY}, a node failure at step {MAMBA_FAULT}: "
        f"steps run {steps_run} (restored step {MAMBA_EVERY}'s "
        f"checkpoint), ends at step {MAMBA_STEPS}; losses " +
        " ".join(f"{h['loss']:.4f}" for h in mhist) + f"; the least "
        f"largest move of a weight {mleast:.3e} | step s " +
        " ".join(f"{t:.3f}" for _, t in mtimes) + f", run wall {wall:.1f} "
        f"s with 3 checkpoint saves and a restore | launches: none")
    if not mleast > 0:
        raise AssertionError("mamba2: a weight did not move")
    redo = mhist[MAMBA_FAULT:]          # the steps run after the restore
    chist = clean.history[MAMBA_EVERY * (MAMBA_FAULT // MAMBA_EVERY):]
    held_equal("mamba2-1.3b restored run vs an uninterrupted run",
               history_diff(redo, chist, "loss"),
               history_diff(redo, chist, "grad_norm"),
               state_diff(mfirst, s2["params"]),
               [h["loss"] for h in clean.history],
               [h["grad_norm"] for h in clean.history],
               sum(h["lr"] for h in clean.history))
    del clean, s2, mfirst
    free_card()


BF16_RCFG = dict(kernels="xla", dtype="bfloat16", remat=False)
TRAIN16_STEPS, TRAIN16_FAULT, TURN_ROUNDS = 4, 2, 3
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_FAULT = 2, 3, 1
CPU_TRAIN_B, CPU_TRAIN_S = 1, 64


@contextlib.contextmanager
def compute_dtype(model, dtype):
    """Within `with`, `model` computes in `dtype`: every module's compute
    dtype (the `dtype` each model module keeps) is set to it, so one
    train state of fp32 leaves takes an fp32 step and a bf16 step in
    turns."""
    import torch
    held = [(m, m.dtype) for m in model.modules()
            if isinstance(getattr(m, "dtype", None), torch.dtype)]
    for m, _ in held:
        m.dtype = dtype
    try:
        yield
    finally:
        for m, d in held:
            m.dtype = d


def steps_in_turns(cfg, state, batch, rounds):
    """`rounds` of an fp32 step then a bf16 step of one state (fp32
    leaves) on one batch: {dtype: [(seconds, peak GiB)]}, each step with
    a synchronize on each side and the peak reset before it."""
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.models.common import DTYPES
    from repro_torch.train import make_train_step
    steps = {k["dtype"]: make_train_step(cfg, RunConfig(**k))
             for k in (PLAIN_RCFG, BF16_RCFG)}
    out = {name: [] for name in steps}
    for _ in range(rounds):
        for name, step in steps.items():
            with compute_dtype(state["params"], DTYPES[name]):
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, _ = step(state, batch)
                torch.cuda.synchronize()
                out[name].append((time.perf_counter() - t,
                                  torch.cuda.max_memory_allocated() / 2**30))
    return out


def device_split(cfg, state, batch, knobs):
    """One step's device time by kernel, its forward with the loss and
    backward profiled apart from its AdamW: (GEMM kernels s, the other
    kernels of forward + backward s, AdamW's kernels s, the top kernels
    of forward + backward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import RunConfig
    from repro_torch.optim import adamw_update
    from repro_torch.train.train_step import loss_fn_for

    rcfg = RunConfig(**knobs)
    model = state["params"]
    params = dict(model.named_parameters())

    def kernels(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count]

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as p1:
        loss, _ = loss_fn_for(cfg)(model, batch, rcfg)
        loss.backward()
        torch.cuda.synchronize()
    grads = {n: p.grad for n, p in params.items()}
    with profile(activities=acts) as p2:
        adamw_update(grads, state["opt"], params, 1e-5)
        torch.cuda.synchronize()
    del grads, loss
    for p in params.values():
        p.grad = None
    fb = kernels(p1)
    gemm = sum(e.self_device_time_total for e in fb if any(
        k in e.key.lower() for k in ("gemm", "cutlass", "xmma", "cublas",
                                     "sm90_")))
    rest = sum(e.self_device_time_total for e in fb) - gemm
    opt = sum(e.self_device_time_total for e in kernels(p2))
    top = sorted(fb, key=lambda e: -e.self_device_time_total)[:6]
    return gemm / 1e6, rest / 1e6, opt / 1e6, top


def phase_train_bf16(mods):
    """bf16 training over fp32 master weights, `RunConfig(kernels="xla",
    dtype="bfloat16", remat=False)` (the reference's default compute
    dtype; remat off as in the fp32 phase): (a) full-width gemma2-2b, B 4
    x 512, 4 steps through `Trainer` with a step fault at step 2
    replayed, held bit for bit against a fresh run; the fresh run's state
    then takes an fp32 and a bf16 step in turns, 3 rounds (s, tokens/s,
    peak of each), and the bf16 step's device time is split into GEMMs,
    the other kernels and AdamW; (b) qwen2-moe-a2.7b cut to 2 of its 24
    layers at full width (60 experts top 4, 4 shared), 3 steps with a
    fault at step 1 replayed, against a fresh run (bit for bit or not,
    logged: the backward through the dispatch and the combine); (c) the
    same 2-layer full-width gemma2-2b bf16 step on the card and on the
    CPU from the same weights: loss and grad norm within rel 2e-2.  No
    kernel is launched (the plain path)."""
    import numpy as np
    import torch
    from repro_torch.configs import ATTN_FULL, ATTN_SWA, RunConfig, get
    from repro_torch.dist.fault import FaultConfig, FaultInjector
    from repro_torch.train import TrainerConfig, init_train_state
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    zero = {name: 0 for name in mods}
    cfg = get(TRAIN)
    tcfg = TrainerConfig(total_steps=TRAIN16_STEPS, seed=0,
                         fault=FaultConfig(policy="replay"))
    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    trainer, state, times, before = train_run(
        cfg, tcfg, FaultInjector([TRAIN16_FAULT], kind="step"), TRAIN_SEQ,
        TRAIN_BATCH, BF16_RCFG)
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist, counts = trainer.history, read(mods)
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if trainer.stats.replays != 1 or int(state["step"]) != TRAIN16_STEPS:
        raise AssertionError(f"bf16 {TRAIN}: replays "
                             f"{trainer.stats.replays}, step "
                             f"{int(state['step'])}")
    if counts != zero:
        raise AssertionError(f"bf16 training launched kernels {counts}")
    if not (all(map(math.isfinite, losses)) and
            abs(losses[0] - (math.log(cfg.vocab_size) + 0.5)) < 1.0 and
            all(math.isfinite(g) and g > 0 for g in gnorms)):
        raise AssertionError(f"bf16 {TRAIN}: losses {losses}, grad norms "
                             f"{gnorms}")
    dtypes = {p.dtype for p in state["params"].parameters()}
    least = moved(state, before)
    if dtypes != {torch.float32} or not least > 0:
        raise AssertionError(f"bf16 {TRAIN}: leaves {dtypes}, least move "
                             f"{least}")
    secs = [t for _, t in times]
    log(f"[train-bf16] {TRAIN} full width bf16 over fp32 leaves (every "
        f"leaf fp32), kernels='xla', remat off, B {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, {TRAIN16_STEPS} steps, a step fault at step "
        f"{TRAIN16_FAULT} replayed: losses " +
        " ".join(f"{v:.4f}" for v in losses) + "; grad norms " +
        " ".join(f"{g:.3f}" for g in gnorms) + f"; every weight moved "
        f"(least {least:.3e}) | step s " + " ".join(f"{t:.3f}" for t in secs)
        + f"; peak {peak:.2f} GiB | launches: none")
    first = {n: p.detach().to("cpu", copy=True)
             for n, p in state["params"].named_parameters()}
    del trainer, state
    free_card()
    clean, s2, _, _ = train_run(cfg, tcfg, None, TRAIN_SEQ, TRAIN_BATCH,
                                BF16_RCFG)
    held_equal(f"{TRAIN} bf16 replayed run vs a fresh run without the "
               f"fault", history_diff(hist, clean.history, "loss"),
               history_diff(hist, clean.history, "grad_norm"),
               state_diff(first, s2["params"]), losses, gnorms,
               sum(h["lr"] for h in hist), exact_only=True)
    del first
    batch = clean._put(clean.pipeline.source.batch(TRAIN16_STEPS))
    turns = steps_in_turns(cfg, s2, batch, TURN_ROUNDS)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    parts = []
    for name, runs in turns.items():
        ss = [t for t, _ in runs]
        parts.append(f"{name} s " + " ".join(f"{t:.4f}" for t in ss) +
                     f" ({tokens * len(ss) / sum(ss):.0f} tokens/s), peak "
                     + " ".join(f"{g:.2f}" for _, g in runs) + " GiB")
    mean = {n: sum(t for t, _ in r) / len(r) for n, r in turns.items()}
    log(f"[train-bf16] {TRAIN} full width, one state of fp32 leaves, an "
        f"fp32 step then a bf16 step, {TURN_ROUNDS} rounds in turns, B "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: " + "; ".join(parts) +
        f"; bf16 {mean['float32'] / mean['bfloat16']:.2f}x faster")
    with compute_dtype(s2["params"], torch.bfloat16):
        gemm, rest, opt, top = device_split(cfg, s2, batch, BF16_RCFG)
    log(f"[train-bf16] {TRAIN} bf16 step by device time (torch.profiler, "
        f"forward + backward apart from AdamW): GEMMs {gemm:.4f} s, the "
        f"other kernels of forward + backward (elementwise, reductions, "
        f"casts, gathers) {rest:.4f} s, AdamW {opt:.4f} s; top kernels: " +
        "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms "
                  f"x{e.count}" for e in top))
    del clean, s2, batch
    free_card()

    # (b) 2 layers of qwen2-moe-a2.7b at full width, a fault replayed
    mcfg = dataclasses.replace(get("qwen2-moe-a2.7b"),
                               n_layers=MOE_TRAIN_LAYERS)
    mt = TrainerConfig(total_steps=MOE_TRAIN_STEPS, seed=0,
                       fault=FaultConfig(policy="replay"))
    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    tr, st, mtimes, mbefore = train_run(
        mcfg, mt, FaultInjector([MOE_TRAIN_FAULT], kind="step"), TRAIN_SEQ,
        TRAIN_BATCH, BF16_RCFG)
    mpeak = torch.cuda.max_memory_allocated() / 2**30
    if tr.stats.replays != 1 or read(mods) != zero or \
            not all(math.isfinite(h["loss"]) for h in tr.history):
        raise AssertionError(f"qwen2-moe bf16: replays {tr.stats.replays}, "
                             f"launches {read(mods)}, history {tr.history}")
    mhist, mleast = tr.history, moved(st, mbefore)
    if not mleast > 0:
        raise AssertionError("qwen2-moe bf16: a weight did not move")
    mfirst = {n: p.detach().to("cpu", copy=True)
              for n, p in st["params"].named_parameters()}
    n_params = sum(p.numel() for p in st["params"].parameters())
    del tr, st
    free_card()
    clean, s2, _, _ = train_run(mcfg, mt, None, TRAIN_SEQ, TRAIN_BATCH,
                                BF16_RCFG)
    log(f"[train-bf16] qwen2-moe-a2.7b {MOE_TRAIN_LAYERS} of its 24 layers "
        f"full width bf16 over fp32 leaves ({n_params / 1e9:.3f} B params; "
        f"{mcfg.moe.n_experts} experts top {mcfg.moe.top_k} at capacity "
        f"factor {mcfg.moe.capacity_factor}, "
        f"{mcfg.moe.n_shared_experts} shared), B "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {MOE_TRAIN_STEPS} steps, a fault at "
        f"step {MOE_TRAIN_FAULT} replayed: losses " +
        " ".join(f"{h['loss']:.4f}" for h in mhist) + " (aux " +
        " ".join(f"{h['aux_loss']:.4f}" for h in mhist) + "); grad norms " +
        " ".join(f"{h['grad_norm']:.3f}" for h in mhist) + " | step s " +
        " ".join(f"{t:.3f}" for _, t in mtimes) + f"; peak {mpeak:.2f} GiB "
        f"| launches: none")
    held_equal("qwen2-moe-a2.7b 2 layers bf16 replayed run vs a fresh run "
               "(the backward through the dispatch and the combine)",
               history_diff(mhist, clean.history, "loss"),
               history_diff(mhist, clean.history, "grad_norm"),
               state_diff(mfirst, s2["params"]),
               [h["loss"] for h in clean.history],
               [h["grad_norm"] for h in clean.history],
               sum(h["lr"] for h in clean.history))
    del clean, s2, mfirst
    free_card()

    # (c) 2 gemma2 layers, the same bf16 step on the card and on the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2, layer_pattern=(
        ((ATTN_SWA, ATTN_FULL), 1),))
    rcfg = RunConfig(**BF16_RCFG)
    card = init_train_state(1, cfg2, rcfg, device=CARD)
    host = init_train_state(1, cfg2, rcfg, device="cpu", init=False)
    host["params"].load_state_dict(card["params"].state_dict())
    tok = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg2.vocab_size, (CPU_TRAIN_B, CPU_TRAIN_S)))
    step = make_train_step(cfg2, rcfg)
    t = time.perf_counter()
    _, mc = step(card, {"tokens": tok.to(CARD)})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    _, mh = step(host, {"tokens": tok})
    host_s = time.perf_counter() - t
    rel = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
           for k in ("loss", "grad_norm")}
    log(f"[train-bf16] 2 layers (SWA, FULL) of {TRAIN} at full width, bf16 "
        f"over fp32 leaves, one step B {CPU_TRAIN_B} x {CPU_TRAIN_S}, card "
        f"vs CPU from the same weights: loss {float(mc['loss'])!r} vs "
        f"{float(mh['loss'])!r} (rel {rel['loss']:.2e}), grad norm "
        f"{float(mc['grad_norm'])!r} vs {float(mh['grad_norm'])!r} (rel "
        f"{rel['grad_norm']:.2e}; tol 2e-2); {card_s:.2f} s on the card, "
        f"{host_s:.2f} s on the CPU")
    if not max(rel.values()) < TOL["bfloat16"]:
        raise AssertionError(f"bf16 step card vs CPU: {rel}")
    del card, host
    free_card()
    log(f"[train-bf16] phase {time.perf_counter() - t0:.1f} s")


MESH_RING, MESH_PROMPT, MESH_LAYERS = 64, 200, 8
MESH_MOE_B, MESH_MOE_S = 4, 512


def whole(t):
    """A DTensor as one tensor; anything else unchanged."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def leaf_sums(model):
    """Each weight's checksum: the int64 sum of its int32 view."""
    import torch
    return {n: int(whole(p.detach()).view(torch.int32)
                   .sum(dtype=torch.int64))
            for n, p in model.named_parameters()}


def mesh_train_step(cfg, tokens, mesh):
    """One fresh full-width train step on the card (on `mesh` when it is
    not None); returns (state, loss, grad norm, seconds)."""
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.train import (distribute_train_state, init_train_state,
                                   make_train_step)
    rcfg = RunConfig(**PLAIN_RCFG)
    state = init_train_state(0, cfg, rcfg, device=CARD)
    batch = {"tokens": tokens.to(CARD)}
    if mesh is not None:
        distribute_train_state(state, mesh)
        batch = shd.distribute_batch(batch, mesh)
        shd.set_hint_fn(shd.make_hint_fn(mesh, cfg.n_kv_heads, True))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = make_train_step(cfg, rcfg)(state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        shd.set_hint_fn(None)
    return state, float(whole(m["loss"])), float(whole(m["grad_norm"])), \
        secs


def mesh_decode(model, cfg, prompt, mods, ring):
    """A prefill of `prompt` through the kernels, then 2R + 5 decode
    steps: greedy through the kernel decode path (`ring` None), or fed
    those tokens through the ring decode (`ring` = (tokens, logits) of the
    kernel path), each step's logits held against the kernel path's.
    Returns (tokens, logits, decode launches, worst rel err, ms a step)."""
    import torch
    from repro_torch.models import (add_decode_rings, flush_decode_caches,
                                    lm_decode_step, lm_prefill)
    steps, S, V = 2 * MESH_RING + 5, prompt.shape[1], cfg.vocab_size
    with torch.no_grad():
        lg, caches = lm_prefill(model, prompt, max_len=S + steps)
        if ring is not None:
            add_decode_rings(caches, cfg, MESH_RING, S)
        tok = lg.argmax(-1, keepdim=True)
        reset(mods)
        toks, logits, worst = [], [], 0.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(steps):
            pos = S + i
            if ring is not None:
                tok = ring[0][i]
            l, caches = lm_decode_step(model, caches, tok, pos)
            if ring is not None:
                want = ring[1][i]
                rel = float((l[:, :V] - want[:, :V]).abs().max() /
                            want[:, :V].abs().max())
                if not (rel < 1e-4 and torch.equal(
                        l[:, :V].argmax(-1), want[:, :V].argmax(-1))):
                    raise AssertionError(f"ring decode step {i}: rel err "
                                         f"{rel:.2e} or its greedy token "
                                         f"differs")
                worst = max(worst, rel)
                if (pos + 1) % MESH_RING == 0:
                    flush_decode_caches(caches, pos + 1 - MESH_RING)
            toks.append(tok)
            logits.append(l)
            tok = l[:, :V].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / steps
    return toks, logits, read(mods, ["decode_attention"]), worst, ms


def phase_mesh(mods):
    """The distributed layer over a one-rank NCCL mesh at full width:
    parts (a)-(e) of the module docstring's phase 12."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ATTN_FULL, ATTN_SWA, RunConfig, get
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import compressed_psum
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.models.moe import moe_forward

    t0 = time.perf_counter()
    out = {}
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl" if CARD == "cuda" else "gloo",
                            init_method=f"file://{tmp.name}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, CARD)
        # (a) a train step on the mesh against one without it, gemma2-2b
        # cut to MESH_LAYERS of its 26 layers at full width
        cfg = dataclasses.replace(get(TRAIN), n_layers=MESH_LAYERS,
                                  layer_pattern=(((ATTN_SWA, ATTN_FULL),
                                                  MESH_LAYERS // 2),))
        tokens = torch.from_numpy(np.random.default_rng(31).integers(
            0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)))
        torch.cuda.reset_peak_memory_stats()
        state, loss0, gn0, s0 = mesh_train_step(cfg, tokens, None)
        sums0 = leaf_sums(state["params"])
        # the weights stay on the card, for a closer look if a checksum
        # differs
        plain = {n: p.detach() for n, p in state["params"].named_parameters()}
        del state
        free_card()
        state, loss1, gn1, s1 = mesh_train_step(cfg, tokens, mesh)
        sums1 = leaf_sums(state["params"])
        differ = [n for n in sums0 if sums0[n] != sums1[n]]
        worst = 0.0
        for n, p in state["params"].named_parameters():
            if n in differ:
                a, b = whole(p.detach()), plain[n]
                worst = max(worst, float((a - b).abs().max() /
                                         b.abs().max()))
        if worst > 2e-5 or abs(loss1 - loss0) > 1e-5 * abs(loss0):
            raise AssertionError(f"mesh train step: loss {loss1} vs {loss0}, "
                                 f"weights part by {worst:.2e}")
        pls = {str(pl) for p in state["params"].parameters()
               for pl in p.placements}
        out["train_step"] = {
            "loss": loss1, "plain_loss": loss0, "grad_norm": gn1,
            "plain_grad_norm": gn0, "bit_equal": not differ and
            loss0 == loss1 and gn0 == gn1, "leaves_differing": len(differ),
            "worst_rel": worst, "s": round(s1, 4), "plain_s": round(s0, 4),
            "placements": sorted(pls),
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2)}
        log(f"[mesh] (a) {TRAIN} {MESH_LAYERS} of its 26 layers at full "
            f"width, fp32 train step, B "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}: on the mesh loss {loss1!r} grad "
            f"norm {gn1!r} {s1:.3f} s; without it {loss0!r} {gn0!r} "
            f"{s0:.3f} s; {len(differ)} of {len(sums0)} weights' checksums "
            f"differ (worst {worst:.2e} of a leaf's max); placements {pls}")
        del plain
        # (b) the mesh step's weights checkpointed, restored onto the mesh
        t = time.perf_counter()
        ckpt.save(state["params"], tmp.name, step=1)
        save_s = time.perf_counter() - t
        del state["opt"]
        free_card()
        like = LM(cfg, RunConfig(**PLAIN_RCFG), device="meta", init=False)
        sh = shd.param_shardings(like, mesh)
        t = time.perf_counter()
        ckpt.restore(os.path.join(tmp.name, "step_00000001"), like,
                     shardings=sh, mesh=mesh)
        restore_s = time.perf_counter() - t
        got = dict(like.named_parameters())
        for n, p in state["params"].named_parameters():
            g = got[n]
            if tuple(g.placements) != tuple(sh[n]) or \
                    g.device_mesh != mesh or \
                    not torch.equal(g.to_local(), p.to_local()):
                raise AssertionError(f"restore onto the mesh: {n} "
                                     f"{g.placements} differs")
        out["restore"] = {"leaves": len(got), "bit_equal": True,
                          "save_s": round(save_s, 3),
                          "restore_s": round(restore_s, 3)}
        log(f"[mesh] (b) checkpoint of the mesh step's {len(got)} weights "
            f"saved in {save_s:.2f} s, restored onto the mesh in "
            f"{restore_s:.2f} s: placements as asked, bit for bit")
        del state, like, got
        free_card()
        # (c) the MoE mesh dispatch against the local path
        mcfg = dataclasses.replace(get("qwen2-moe-a2.7b"), n_layers=2)
        model = LM(mcfg, RunConfig(dtype="bfloat16"), seed=3, device=CARD)
        gen = torch.Generator(CARD).manual_seed(33)
        x = torch.randn(MESH_MOE_B, MESH_MOE_S, mcfg.d_model, generator=gen,
                        device=CARD).to(torch.bfloat16)
        moe = {}
        reset(mods)
        with torch.no_grad():
            for mode in ("psum", "scatter", "combine_first"):
                rc = RunConfig(dtype="bfloat16", moe_reduce=mode)
                for i, layer in enumerate(model.layers):
                    y0, a0 = moe_forward(layer.moe, x, mcfg, rc)
                    shd.set_moe_mesh(mesh)
                    try:
                        y1, a1 = moe_forward(layer.moe, x, mcfg, rc)
                    finally:
                        shd.set_moe_mesh(None)
                    if not (torch.equal(y0, y1) and torch.equal(a0, a1)):
                        raise AssertionError(
                            f"MoE mesh dispatch {mode} layer {i}: max diff "
                            f"{float((y0 - y1).abs().max()):.3e}")
                moe[mode] = "bit_equal"
        if any(read(mods).values()):
            raise AssertionError(f"the MoE dispatch launched {read(mods)}")
        out["moe"] = moe
        log(f"[mesh] (c) qwen2-moe-a2.7b 2 layers bf16, x ({MESH_MOE_B}, "
            f"{MESH_MOE_S}, {mcfg.d_model}): moe_forward on the mesh == the "
            f"local path bit for bit in psum, scatter, combine_first")
        del model, y0, y1
        free_card()
        # (c') the backward through the dispatch: one layer's fp32 leaves
        # computed in bf16, the gradients of x and of every MoE weight
        one = LM(dataclasses.replace(mcfg, n_layers=1),
                 RunConfig(dtype="bfloat16"), seed=4, device=CARD,
                 param_dtype=torch.float32)
        moe_p = one.layers[0].moe
        xg = x.detach().clone().requires_grad_()
        wt = torch.randn(x.shape, generator=gen, device=CARD)

        def moe_grads(rc, on_mesh):
            xg.grad = None
            for p in moe_p.parameters():
                p.grad = None
            shd.set_moe_mesh(mesh if on_mesh else None)
            try:
                y, aux = moe_forward(moe_p, xg, mcfg, rc)
            finally:
                shd.set_moe_mesh(None)
            ((y.float() * wt).sum() + aux).backward()
            return [xg.grad.clone()] + [p.grad.clone()
                                        for p in moe_p.parameters()]

        reset(mods)
        t = time.perf_counter()
        bwd = {}
        for mode in ("psum", "scatter", "combine_first"):
            rc = RunConfig(dtype="bfloat16", moe_reduce=mode)
            g0, g1 = moe_grads(rc, False), moe_grads(rc, True)
            again = moe_grads(rc, False)
            if not all(torch.equal(a, b) for a, b in zip(g0, again)):
                raise AssertionError(f"MoE backward {mode}: the local path "
                                     f"differs from itself")
            if not all(torch.equal(a, b) for a, b in zip(g0, g1)):
                worst = max(float((a - b).abs().max() / b.abs().max())
                            for a, b in zip(g1, g0))
                raise AssertionError(f"MoE backward {mode} on the mesh: "
                                     f"{worst:.3e} of a gradient's max off "
                                     f"the local path")
            bwd[mode] = "bit_equal"
        torch.cuda.synchronize()
        if any(read(mods).values()):
            raise AssertionError(f"the MoE backward launched {read(mods)}")
        out["moe_backward"] = dict(bwd, s=round(time.perf_counter() - t, 3),
                                   grads=len(g0))
        log(f"[mesh] (c') one qwen2-moe-a2.7b MoE layer, fp32 leaves in "
            f"bf16, x ({MESH_MOE_B}, {MESH_MOE_S}, {mcfg.d_model}): the "
            f"backward through moe_forward on the mesh == the local path's "
            f"gradients (x and {len(g0) - 1} weights) bit for bit in psum, "
            f"scatter, combine_first; the local path twice equal")
        del one, moe_p, xg, wt, g0, g1, again, x
        free_card()
        # (d) ring-append decode against the kernel decode path
        cfg = get(TRAIN)
        model = LM(cfg, RunConfig(dtype="float32"), seed=5, device=CARD)
        prompt = torch.from_numpy(np.random.default_rng(35).integers(
            0, cfg.vocab_size, (1, MESH_PROMPT))).to(CARD)
        toks, logits, plain_n, _, plain_ms = mesh_decode(
            model, cfg, prompt, mods, None)
        _, _, ring_n, worst, ring_ms = mesh_decode(
            model, cfg, prompt, mods, (toks, logits))
        steps = 2 * MESH_RING + 5
        n_swa = sum(k == ATTN_SWA for k in cfg.layer_kinds)
        if ring_n["decode_attention"] != n_swa * steps or \
                plain_n["decode_attention"] != len(cfg.layer_kinds) * steps:
            raise AssertionError(f"decode launches: ring {ring_n}, kernel "
                                 f"path {plain_n}")
        out["ring_decode"] = {
            "prompt": MESH_PROMPT, "ring": MESH_RING, "steps": steps,
            "worst_rel": worst, "same_greedy": True,
            "decode_attention_launches": ring_n["decode_attention"],
            "kernel_path_launches": plain_n["decode_attention"],
            "ms_a_step": round(ring_ms, 3),
            "kernel_path_ms_a_step": round(plain_ms, 3)}
        log(f"[mesh] (d) {TRAIN} full width fp32 ring decode, prompt "
            f"{MESH_PROMPT}, R {MESH_RING}, {steps} steps, flushed every R: "
            f"logits within {worst:.2e} of max|logit| of the kernel path's, "
            f"same greedy tokens; decode_attention launches "
            f"{ring_n['decode_attention']} ({n_swa} sliding-window layers x "
            f"{steps}; the kernel path {plain_n['decode_attention']}); "
            f"{ring_ms:.2f} ms a step vs {plain_ms:.2f}")
        del model, toks, logits
        free_card()
        # (e) compressed_psum over the one rank
        xs = torch.randn(1 << 22, generator=gen, device=CARD)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = compressed_psum(xs, "data", mesh)
        torch.cuda.synchronize()
        cp_ms = (time.perf_counter() - t) * 1e3
        rel = float((got - xs).abs().max() / xs.abs().max())
        if not 0 < rel < 0.1:
            raise AssertionError(f"compressed_psum rel err {rel}")
        out["compressed_psum"] = {"n": xs.numel(), "rel_err": rel,
                                  "ms": round(cp_ms, 3)}
        log(f"[mesh] (e) compressed_psum of {xs.numel()} fp32 over the "
            f"one-rank NCCL group: rel err {rel:.3e} (int8 steps of "
            f"max|x|/127), {cp_ms:.2f} ms with its first call")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    out["s"] = round(time.perf_counter() - t0, 1)
    log(json.dumps({"mesh": out}))
    free_card()


def child(args, timeout):
    """`python3 -m ...args` from the checkout, in a child process (this
    one's default process group was NCCL's); its stdout."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"{args[0]}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return proc.stdout


def phase_specs():
    """Every (arch × shape) cell of `launch.specs.build_cell` on the fake
    (16, 16) production mesh, in a child process: this one's default
    process group was NCCL's (the mesh phase), and a process holds one.
    Each cell's count of argument leaves and its seconds; 33 cells."""
    t0 = time.perf_counter()
    text = child(["repro_torch.launch.specs", "--all"], 300)
    cells = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith('{"cell"')]
    if len(cells) != 33 or not all(c["leaves"] > 0 for c in cells):
        raise AssertionError(f"specs: {len(cells)} cells: {cells}")
    log("[specs] build_cell on the fake (16, 16) data x model mesh (torch's "
        "fake process group, 256 ranks, in a child process): " +
        "; ".join(f"{c['cell']} {c['leaves']} leaves {c['s']:.4f} s"
                  for c in cells))
    total = sum(c["s"] for c in cells)
    log(f"[specs] {len(cells)} cells, build_cell {total:.2f} s in all; "
        f"phase {time.perf_counter() - t0:.1f} s with the child's start")


#: the dry-run phase's cells on the fake (16, 16) mesh, and its one cell
#: on the (2, 16, 16) one
DRYRUN_CELLS = ("gemma2-2b:train_4k", "gemma2-2b:prefill_32k",
                "gemma2-2b:decode_32k", "qwen2-moe-a2.7b:train_4k",
                "mamba2-1.3b:prefill_32k", "qwen2.5-32b:decode_32k",
                "seamless-m4t-large-v2:decode_32k")
DRYRUN_POD2 = "gemma2-2b:decode_32k"
RESULT_KEYS = {"name", "mesh", "n_devices", "cost", "cost_raw", "memory",
               "collectives", "while_trips", "roofline", "lower_s",
               "compile_s", "model_flops_global", "shape", "run_config"}


def phase_dryrun():
    """`python -m repro_torch.launch.dryrun` over `DRYRUN_CELLS` on the
    fake (16, 16) mesh and `DRYRUN_POD2` on the (2, 16, 16) one, in
    child processes, into `build/dryrun_torch`: exit 0, every file with
    the reference's keys, flops, bytes and temp bytes > 0, collective
    bytes > 0 in the train cells; each cell's three terms, bottleneck,
    model over counted flops and seconds.  Then `debug_collectives` on
    gemma2-2b's train cell, which must print the reference's header."""
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun_torch"
    dr = ["repro_torch.launch.dryrun", "--out", str(out_dir)]
    child(dr + ["--cells", ",".join(DRYRUN_CELLS)], 900)
    child(dr + ["--cells", DRYRUN_POD2, "--multi-pod"], 300)
    for cell, tag in [(c, "pod1") for c in DRYRUN_CELLS] + [
            (DRYRUN_POD2, "pod2")]:
        arch, shape = cell.split(":")
        with open(out_dir / f"{arch}_{shape}_{tag}.json") as f:
            art = json.load(f)
        rl, mem = art["roofline"], art["memory"]
        coll = art["collectives"]["total_bytes"]
        if set(art) != RESULT_KEYS or not (
                rl["flops_per_device"] > 0 and rl["bytes_per_device"] > 0
                and mem["temp_bytes"] > 0) or (
                shape.startswith("train") and not coll > 0):
            raise AssertionError(f"dryrun {cell} {tag}: {art}")
        ratio = art["model_flops_global"] / art["n_devices"] / \
            rl["flops_per_device"]
        log(f"[dryrun] {cell} on {rl['mesh']}: compute {rl['compute_s']:.4g}"
            f" s, memory {rl['memory_s']:.4g} s, collective "
            f"{rl['collective_s']:.4g} s -> {rl['bottleneck']}-bound; model "
            f"/ counted flops {ratio:.3f}; temp "
            f"{mem['temp_bytes'] / 2**30:.2f} GiB a rank; build "
            f"{art['lower_s']:.1f} s, count {art['compile_s']:.1f} s")
    text = child(["repro_torch.launch.debug_collectives", "--arch",
                  "gemma2-2b", "--shape", "train_4k", "--top", "5"], 300)
    if "total weighted collective bytes/device" not in text:
        raise AssertionError(f"debug_collectives: {text[-2000:]}")
    log("[dryrun] debug_collectives gemma2-2b train_4k: " +
        " | ".join(ln.strip() for ln in text.splitlines()[:6]))
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s")


def phase_roofline(smi):
    """The cost counter on a real step: gemma2-2b's bf16 step over fp32
    masters (the train-bf16 phase's, B 4 x 512, no mesh) counted on the
    card under `launch.hlo_cost.count_call` and traced on the meta
    device: flops, transcendentals and bytes equal.  Then the step alone
    and the counted step in turns, 3 rounds: the step must take at least
    the count's `compute_s`; `compute_s`, `memory_s`, their shares of
    the measured step, and model flops over the measured time."""
    import torch
    from repro_torch.configs import RunConfig, get
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.analysis import (HBM_BW, PEAK_FLOPS,
                                             model_flops)
    from repro_torch.launch.hlo_cost import count_call
    from repro_torch.train import init_train_state, make_train_step

    cfg, rcfg = get(TRAIN), RunConfig(**BF16_RCFG)
    step = make_train_step(cfg, rcfg)
    meta = torch.device("meta")
    _, want, _ = count_call(
        step, init_train_state(0, cfg, rcfg, device=meta, init=False),
        {"tokens": torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.long,
                               device=meta)})
    state = init_train_state(0, cfg, rcfg, device="cuda")
    gen = torch.Generator("cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ),
                                     generator=gen, device="cuda")}
    step(state, batch)                              # warm-up
    times = {"step": [], "counted": []}
    got = None
    for _ in range(TURN_ROUNDS):
        for name in times:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "counted":
                _, got, _ = count_call(step, state, batch)
            else:
                step(state, batch)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
    for key in ("flops", "transcendentals", "bytes"):
        if getattr(got, key) != getattr(want, key):
            raise AssertionError(f"roofline: {key} on the card "
                                 f"{getattr(got, key)} != on meta "
                                 f"{getattr(want, key)}")
    compute_s, memory_s = got.flops / PEAK_FLOPS, got.bytes / HBM_BW
    measured = min(times["step"])
    if measured < compute_s:
        raise AssertionError(f"roofline: the step {measured:.4f} s is under "
                             f"its compute term {compute_s:.4f} s")
    mf = model_flops(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                    "train"))
    log(f"[roofline] {TRAIN} bf16 over fp32 masters, B {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} ({smi}): counted on the card == traced on meta: "
        f"flops {int(got.flops)}, transcendentals {int(got.transcendentals)}"
        f", bytes {int(got.bytes)} (eager ATen traffic, no fusion), temp "
        f"{got.temp_bytes / 2**30:.2f} GiB | step s " +
        " ".join(f"{t:.4f}" for t in times["step"]) + " | counted step s " +
        " ".join(f"{t:.4f}" for t in times["counted"]) +
        f" | compute_s {compute_s:.4f} ({compute_s / measured:.1%} of the "
        f"fastest step), memory_s {memory_s:.4f} ({memory_s / measured:.1%})"
        f"; model flops {mf:.4g} over the step: "
        f"{mf / measured / 1e12:.1f} TFLOP/s")
    del state, batch
    free_card()


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
    from repro_torch.configs import (ATTN_FULL, ATTN_SWA, HYBRID, HYBRID_FULL,
                                     get)
    smi = phase_device()
    phase_build()
    phase_sanitize()
    mods = {name: importlib.import_module(k[0])
            for name, k in KERNELS.items()}
    entries = phase_kernels(mods["flash_attention"], mods["decode_attention"])
    entries["ssd"] = phase_ssd_kernel(mods["ssd"])
    hymba_entries = phase_hymba_kernels(mods)
    dense_entries = phase_dense_kernels(mods)
    dense_entries.update(phase_moe_kernels(mods))
    encdec_entries = phase_encdec_kernels(mods)
    entries.update(phase_dma(mods))
    entries["matmul_dma"] = phase_matmul(mods)
    gemma = phase_serve("gemma2-2b", mods)
    mamba = phase_serve("mamba2-1.3b", mods)
    hymba = phase_serve(HYMBA, mods)
    served = {arch: phase_serve(arch, mods) for arch in DENSE}
    phase_vlm_prefill(mods)
    for arch in MOE:
        served[arch] = phase_serve(arch, mods, moe_config(arch),
                                   held=arch == "qwen2-moe-a2.7b")
    phase_moe_dispatch()
    entries["flash_attention"]["launches"] = gemma["flash_attention"]
    entries["decode_attention"]["launches"] = gemma["decode_attention"]
    entries["ssd"]["launches"] = mamba["ssd"]
    for name, e in hymba_entries.items():
        e["launches"] = hymba[name.split()[0]]
        entries[name] = e
    for name, e in dense_entries.items():
        kernel, arch = name.split()
        e["launches"] = served[arch][kernel]
        entries[name] = e
    phase_front("gemma2-2b", mods, sanitize=True)
    phase_front("mamba2-1.3b", mods)
    gemma2 = dataclasses.replace(get("gemma2-2b"), n_layers=2,
                                 layer_pattern=(((ATTN_SWA, ATTN_FULL), 1),))
    phase_card_vs_cpu(gemma2, "SWA, FULL", mods)
    phase_bf16_vs_plain(gemma2, "SWA, FULL", mods)
    phase_card_vs_cpu(dataclasses.replace(get("mamba2-1.3b"), n_layers=2),
                      "SSM, SSM", mods)
    # a prompt past hymba's window of 1,024, off the SSD's chunk of 128
    hymba2 = dataclasses.replace(get(HYMBA), n_layers=2, layer_pattern=(
        ((HYBRID_FULL,), 1), ((HYBRID,), 1)))
    phase_card_vs_cpu(hymba2, "HYBRID_FULL, HYBRID", mods, S=1100)
    phase_bf16_vs_plain(hymba2, "HYBRID_FULL, HYBRID", mods, S=1100)
    # qkv biases (seeded non-zero), GQA 5 and θ 1e6; GQA 16 and RoPE on
    # half of each head
    for arch, label in (("qwen2.5-32b", "qwen2.5-32b FULL, FULL"),
                        ("chatglm3-6b", "chatglm3-6b FULL, FULL")):
        cfg2 = dataclasses.replace(get(arch), n_layers=2)
        phase_card_vs_cpu(cfg2, label, mods)
        phase_bf16_vs_plain(cfg2, label, mods)
    # 60 experts top 4 and shared experts at the real capacity factor,
    # GQA group 1, qkv biases seeded non-zero
    qwen_moe2 = dataclasses.replace(get("qwen2-moe-a2.7b"), n_layers=2)
    phase_card_vs_cpu(qwen_moe2, "qwen2-moe-a2.7b FULL, FULL", mods)
    phase_bf16_vs_plain(qwen_moe2, "qwen2-moe-a2.7b FULL, FULL", mods)
    phase_ssd_knobs(mods)
    for name, n in phase_encdec(mods).items():
        encdec_entries[name]["launches"] = n
    entries.update(encdec_entries)
    phase_train(mods)
    phase_train_bf16(mods)
    phase_mesh(mods)
    phase_specs()
    phase_dryrun()
    phase_roofline(smi)
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
