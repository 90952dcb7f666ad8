"""Where the serving time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch ARCH]

A full-width model (`--arch`, default gemma2-2b; also mamba2-1.3b,
hymba-1.5b, internlm2-20b, chatglm3-6b, qwen2.5-32b, internvl2-26b and
qwen2-moe-a2.7b; mixtral-8x7b's 87 GiB of bf16 weights do not fit one
card; random weights from seed 0, bf16) answers the smoke test's
requests (`chip_smoke.py`'s serve phases, defined here as
`make_requests`) through `ServeEngine.generate`: once to warm up, once
timed, once under `torch.profiler`.  For prefill and for the decode step
(the model's step plus sampling and the host's wait for the tokens) it
prints the wall time without the profiler, the device's busy time, its
idle share against that wall time, the kernel launches and the kernels
by device time; and the peak device memory of the timed `generate`.  The
last line is a JSON summary.  Run as a file with another checkout's `src`
on PYTHONPATH, it measures that checkout's port the same way.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import RunConfig, get
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import LM
from repro_torch.serve import Request, ServeEngine

# the smoke test's serving traffic: 4 left-padded prompts, one hot row
PROMPTS = (4608, 2500, 700, 33)
NEW_TOKENS = 32
HOT_ROW, HOT_TEMPERATURE = 2, 0.8
MAX_LEN = max(PROMPTS) + NEW_TOKENS
SEED = 0


def make_requests(vocab_size: int) -> List[Request]:
    """The same prompts on every call, drawn from SEED."""
    rng = np.random.default_rng(SEED)
    return [Request(prompt=rng.integers(0, vocab_size, n).tolist(),
                    max_new_tokens=NEW_TOKENS,
                    temperature=HOT_TEMPERATURE if i == HOT_ROW else 0.0)
            for i, n in enumerate(PROMPTS)]


def run_generate(engine: ServeEngine, profiled: bool):
    """One `generate` of the traffic.  Returns the seconds of prefill and
    of the decode loop (first decode call to the end of `generate`), the
    number of decode steps, and a profiler for each span if `profiled`."""
    prefill, decode = engine._prefill, engine._decode
    seconds: Dict[str, float] = {}
    profs: Dict[str, profile] = {}
    steps = 0

    def start(name):
        torch.cuda.synchronize()
        if profiled:
            profs[name] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            profs[name].start()
        seconds[name] = time.perf_counter()

    def stop(name):
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - seconds[name]
        if profiled:
            profs[name].stop()

    def prefill_step(tokens):
        start("prefill")
        out = prefill(tokens)
        stop("prefill")
        return out

    def decode_step(*args):
        nonlocal steps
        if steps == 0:
            start("decode_step")
        steps += 1
        return decode(*args)

    engine._prefill, engine._decode = prefill_step, decode_step
    try:
        engine.generate(make_requests(engine.model.cfg.vocab_size))
        stop("decode_step")
    finally:
        engine._prefill, engine._decode = prefill, decode
    return seconds, steps, profs


def _kernel_table(prof, n_steps: int, top: int = 12):
    """Device time (ms per step) of the CUDA kernels, largest first."""
    rows = []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, e.count / n_steps, dev_us / 1e3 / n_steps))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    return rows[:top], busy, launches


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    help="a name of repro_torch.configs.REGISTRY, e.g. "
                         "qwen2-moe-a2.7b")
    args = ap.parse_args()
    dev = resolve_device("cuda")
    cfg = get(args.arch)
    model = LM(cfg, RunConfig(dtype="bfloat16"), seed=SEED, device=dev)
    engine = ServeEngine(model, max_len=MAX_LEN, seed=SEED)
    run_generate(engine, profiled=False)                  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    plain, steps, _ = run_generate(engine, profiled=False)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    under, steps, profs = run_generate(engine, profiled=True)

    summary = {"arch": cfg.name,
               "config": f"{cfg.name} full width bf16, prompts {PROMPTS} "
                         f"left-padded, {NEW_TOKENS} new tokens",
               "device": torch.cuda.get_device_name(dev),
               "decode_steps": steps, "peak_gib": peak_gib}
    print(f"[generate] peak device memory {peak_gib:.3f} GiB")
    for name, n in (("prefill", 1), ("decode_step", steps)):
        wall_ms = 1e3 * plain[name] / n
        prof_ms = 1e3 * under[name] / n
        rows, busy, launches = _kernel_table(profs[name], n)
        if busy == 0:
            raise RuntimeError(f"the profiler recorded no device time for "
                               f"{name}")
        print(f"[{name}] wall {wall_ms:.3f} ms ({prof_ms:.3f} ms under the "
              f"profiler), device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall_ms:.3f}, {launches:.0f} kernel launches "
              f"per {name}")
        for key, count, ms in rows:
            print(f"  {ms:9.3f} ms  {count:6.1f}x  {key[:90]}")
        summary[name] = {"wall_ms": wall_ms, "profiled_wall_ms": prof_ms,
                         "device_busy_ms": busy,
                         "idle_share": 1 - busy / wall_ms,
                         "launches": launches,
                         "top": [[k[:60], c, m] for k, c, m in rows[:5]]}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
