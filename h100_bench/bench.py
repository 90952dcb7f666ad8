"""One run of one cell: set-up, the measured window, the traced slice,
the check, and the result's line.

Everything a cell is made of is found by name from `BENCHMARK.json`: its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its check's limits (`limits/<cell>.json`),
the configuration's family module (`families/<family>.py`: its
reference, `ArchConfig`, kernels, flop count, traced ops and followed
choice) and one reader a per-layer metric (`metrics/<metric>.py`, a
function `read(run)` that returns the number or None).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench import (check, families, model, trace, traffic, weights,
                        window)

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    cfg: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def cell(bench: Dict, name: str, here: Path = HERE) -> Cell:
    """The cell `name` of a `BENCHMARK.json`, its files read."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]

    def ours(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name, load_json(here / "configs" / f"{w['config']}.json"),
                load_json(here / "traffic" / f"{w['traffic']}.json"),
                load_json(here / "limits" / f"{name}.json"),
                ours(bench["end_to_end"]), ours(bench["per_layer"]))


def seeds(seed: int) -> Dict[str, int]:
    """Independent streams of the run's seed, each under 2**31 (the
    engine seeds row i's generator with seed · 65,537 + i)."""
    kids = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint64)
    return dict(zip(("weights", "traffic", "engine", "check"),
                    (int(k) % 2**31 for k in kids)))


@dataclass
class Run:
    """What a metric's reader reads."""
    cfg: Dict
    mix: Dict
    window: window.Result
    trace: Optional[trace.Trace]


def read_metric(name: str, run: Run, here: Path = HERE) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{name.replace('.', '_')}",
        here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


class Session:
    """The system under test for one configuration and mix: the weights,
    the model over them and a `ServeEngine`."""

    def __init__(self, cfg: Dict, mix: Dict, device: torch.device,
                 seed: int) -> None:
        self.cfg, self.mix, self.device = cfg, mix, device
        self.family = families.of(cfg)
        self.ref = self.family.reference
        self.layout = self.ref.layout(cfg)
        self.seeds = seeds(seed)
        self.weights = weights.draw(self.layout, model.served_dtype(cfg),
                                    device, self.seeds["weights"])
        self.model = model.build(cfg, self.weights, device)
        self._streams()

    def reseed(self, seed: int) -> None:
        """New weights, traffic and sampling streams in place."""
        self.seeds = seeds(seed)
        weights.draw(self.layout, model.served_dtype(self.cfg), self.device,
                     self.seeds["weights"], into=self.weights)
        self._streams()

    def _streams(self) -> None:
        from repro_torch.serve import ServeEngine
        self.engine = ServeEngine(self.model, max_len=self.mix["max_len"],
                                  seed=self.seeds["engine"])
        self.traffic = traffic.Traffic(self.mix, self.seeds["traffic"],
                                       self.cfg["vocab_size"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        self.engine.generate(self.traffic.warmup())
        self.sync()

    def window(self, seconds: float, cap: check.Capture,
               hooks: Optional[window.Hooks] = None,
               max_batches: Optional[int] = None) -> window.Result:
        def next_batch():
            reqs = self.traffic.batch()
            cap.choose(reqs)              # the first batch's checked rows
            return reqs
        try:
            return window.run(self.engine, next_batch, seconds, hooks,
                              sync=self.sync, max_batches=max_batches,
                              capture=cap)
        finally:
            cap.close()

    def capture(self) -> check.Capture:
        """A fresh capture of the next window's first batch, following the
        family's choice where it has one."""
        rng = np.random.default_rng(self.seeds["check"])
        cap = check.Capture(self.mix["check_requests"],
                            max(self.traffic.outputs),
                            self.model.cfg.padded_vocab, rng, self.device)
        choice = self.family.FOLLOW
        if choice is not None:
            cap.follow(choice, choice.shape(self.cfg), self.mix["max_len"])
        return cap

    def judge(self, result: window.Result, cap: check.Capture,
              control: bool = False, limits: Optional[Dict] = None) -> Dict:
        return check.judge(self.cfg, self.family, self.weights, result, cap,
                           self.device, limits, control=control)


def end_to_end(result: window.Result, peak_bytes: int) -> Dict[str, float]:
    tokens = sum(len(r.output) for b in result.batches for r in b.requests)
    ttft, gaps = [], []
    for b in result.batches:
        for r in b.requests:
            times = b.token_times[:min(r.max_new_tokens, len(b.token_times))]
            ttft.append(times[0] - b.start)
            gaps += list(np.diff(times))
    return {"output_tokens_per_s": tokens / result.seconds,
            "ttft_mean_ms": 1e3 * statistics.fmean(ttft),
            "tpot_p95_ms": 1e3 * float(np.percentile(gaps, 95))
            if gaps else None,
            "peak_mem_gib": peak_bytes / 2**30}


def step_summary(result: window.Result) -> str:
    """The window's step walls: the prefills' median, the decode calls'
    quartiles, in ms."""
    pre = [1e3 * x.seconds for x in result.steps if x.kind == "prefill"]
    dec = [1e3 * x.seconds for x in result.steps if x.kind == "decode"]
    q = statistics.quantiles(dec, n=4) if len(dec) > 1 else [0.0] * 3
    return (f"prefill ms median {statistics.median(pre) if pre else 0:.1f}, "
            f"decode call ms quartiles {q[0]:.2f} {q[1]:.2f} {q[2]:.2f} "
            f"({len(dec)} calls)")


def jax_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among `modules` (`sys.modules`),
    each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run(bench: Dict, name: str, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float, here: Path = HERE) -> Dict:
    """One run; returns the result's line as a dict, whose last key,
    "compared", holds each number the check compared with its limit."""
    c = cell(bench, name, here)
    if device.type == "cuda":
        from repro_torch.kernels import runtime
        runtime.build(families.of(c.cfg).kernels(c.cfg))
    t_build = time.perf_counter()
    s = Session(c.cfg, c.mix, device, seed)
    t_weights = time.perf_counter()
    tracer = None
    if traced:
        tracer = trace.Tracer(device, c.mix["trace_decode_steps"],
                              {**trace.OPS, **s.family.OPS})
        tracer.install()
    s.warm_up()
    cap = s.capture()
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    try:
        result = s.window(seconds, cap, tracer)
    finally:
        if tracer is not None:
            tracer.uninstall()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_window = time.perf_counter()
    if traced:
        metrics_run = Run(c.cfg, c.mix, result, tracer.read())
        metrics = {}
        for m in c.per_layer:
            v = read_metric(m["name"], metrics_run, here)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(result, window_peak)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end if e2e.get(m["name"]) is not None}

    t_read = time.perf_counter()
    judged = s.judge(result, cap, limits=c.limits)
    t_check = time.perf_counter()
    print(f"seconds: imports and kernel build {t_build - t0:.2f}, weights "
          f"{t_weights - t_build:.2f}, warm-up {t0 + setup_s - t_weights:.2f}, "
          f"window {result.seconds:.2f} ({len(result.batches)} batches, "
          f"{sum(b.finished for b in result.batches)} finished), trace read "
          f"{t_read - t_window:.2f}, check {t_check - t_read:.2f} "
          f"({judged['tokens']} tokens); {step_summary(result)}",
          file=sys.stderr)
    compared, correct = compare(judged, c.limits)
    attempted = sum(len(b.requests) for b in result.batches)
    line = {"correct": bool(correct), "attempted": attempted, "failed": 0,
            "metrics": metrics,
            "device": device_info(device, max(setup_peak, window_peak))}
    if traced and metrics_run.trace is not None:
        t = metrics_run.trace
        a, b = t.window()
        line["device"]["busy_s"] = t.busy([(a, b)])
        line["device"]["window_s"] = (b - a) / 1e9
        line["breakdown"] = t.breakdown()
    line["compared"] = compared
    return line


EXACT = ("row_errors", "token_mismatches")


def compare(judged: Dict, limits: Dict):
    """({number: {"value", "limit"}}, correct): the exact counts against 0,
    the cell's limited numbers (`limits/<cell>.json`) against their
    limits, and at least one request checked."""
    compared = {n: {"value": judged.get(n), "limit": 0} for n in EXACT}
    for n, lim in limits.items():
        if n != "readings":
            compared[n] = {"value": judged.get(n), "limit": lim}
    correct = judged["requests"] >= 1 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values())
    compared["requests_checked"] = {"value": judged["requests"],
                                    "limit": 1}
    return compared, correct


def device_info(device: torch.device, peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
