"""The traced run: `torch.profiler` over a fixed slice of the window (the
first batch's prefill and its first `trace_decode_steps` decode steps),
with ranges of the harness's own around the steps and around each call
of the kernel ops (`OPS`, and those of the configuration's family
module), and the reading of that trace.

The ops are wrapped where the model modules bind them
(`repro_torch.models.attention.flash_attention` and `.decode_attention`,
`repro_torch.models.ssm.ssd`), so the same work is read whatever kernel
a later change puts behind an op.  A call's device time is that of the
device records whose launch (the runtime call of the same correlation
id) lies inside the call's range.

The run sets `TEARDOWN_CUPTI=1` (`run.py`): after the profiled slice the
decode calls then run as fast as in an untraced run, where with CUPTI
left up they read about a third slower.  The profiler's first start (its
CUPTI set-up, seconds) falls before the first traced range opens.

Ranges, each a `record_function` named `h100_bench.<what>`:
  prefill   a prefill call, to its synchronize
  step      a decode step: from a decode call to the next one (or to the
            end of `generate`), sampling and the host's wait included
  decode    the decode call itself, to its synchronize
  op.<op>   one call of a kernel op
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from h100_bench import window, yardstick

PREFIX = "h100_bench."


def _flash_args(args, kw) -> Dict:
    q, k = args[0], args[1]
    return dict(q=tuple(q.shape), k=tuple(k.shape),
                causal=kw.get("causal", True), window=kw.get("window", 0),
                elt=q.element_size())


def _decode_args(args, kw) -> Dict:
    q, k = args[0], args[1]
    kv_len = kw.get("kv_len")
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    return dict(q=tuple(q.shape), k=tuple(k.shape), kv_len=kv_len,
                window=kw.get("window", 0), elt=q.element_size())


def _ssd_args(args, kw) -> Dict:
    x, B = args[0], args[4]
    return dict(x=tuple(x.shape), B=tuple(B.shape), elt=x.element_size())


# the kernel ops every family's layers call: {op: (the module that binds
# it, the call's shapes from its (args, kw), the call's (flops, bytes)
# from those)}; a family module's `OPS` adds its own
OPS = {"flash_attention": ("repro_torch.models.attention", _flash_args,
                           yardstick.flash_work),
       "decode_attention": ("repro_torch.models.attention", _decode_args,
                            yardstick.decode_attn_work),
       "ssd": ("repro_torch.models.ssm", _ssd_args, yardstick.ssd_work)}


def _activities(device: torch.device):
    return [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


@dataclass
class Call:
    op: str
    args: Dict
    device_s: float = 0.0       # 0 where no device record came back


@dataclass
class Trace:
    """What the profiled slice held: the harness's ranges (host ns), the
    device records (ns, name, launch ns or None) and the op calls."""
    spans: Dict[str, List[Tuple[int, int]]]
    device: List[Tuple[int, int, str, Optional[int]]]
    calls: Dict[str, List[Call]] = field(default_factory=dict)
    work: Dict[str, Callable] = field(default_factory=dict)  # op → work

    def window(self) -> Tuple[int, int]:
        all_spans = [s for v in self.spans.values() for s in v]
        return min(a for a, _ in all_spans), max(b for _, b in all_spans)

    def busy(self, spans: List[Tuple[int, int]]) -> float:
        """Seconds inside `spans` in which some device record ran."""
        total = 0
        for a, b in spans:
            ivs = sorted((max(s, a), min(e, b)) for s, e, _, _ in self.device
                         if e > a and s < b)
            end = a
            for s, e in ivs:
                if e > end:
                    total += e - max(s, end)
                    end = e
        return total / 1e9

    def idle_share(self, name: str) -> Optional[float]:
        spans = self.spans.get(PREFIX + name, [])
        wall = sum(b - a for a, b in spans) / 1e9
        if not spans or not self.device or wall <= 0:
            return None
        return 100.0 * (1.0 - self.busy(spans) / wall)

    def kernels_launched_in(self, name: str) -> Optional[float]:
        """Kernel records launched inside the `name` ranges, a range."""
        spans = sorted(self.spans.get(PREFIX + name, []))
        if not spans or not self.device:
            return None
        starts = [a for a, _ in spans]
        n = 0
        for s, _, kname, launch in self.device:
            if kname.startswith(("Memcpy", "Memset")):
                continue
            t = s if launch is None else launch
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                n += 1
        return n / len(spans)

    def roofline(self, op: str) -> Optional[float]:
        """Least time of the op calls' work over their device time, in %,
        over the calls whose device records came back."""
        got = [c for c in self.calls.get(op, []) if c.device_s > 0]
        if not got:
            return None
        least = sum(yardstick.bound(*self.work[op](c.args))[0]
                    for c in got)
        return 100.0 * least / sum(c.device_s for c in got)

    def breakdown(self, top: int = 10) -> Dict:
        """The device ops that took most time, and the longest idle gaps
        named by the range the host was in: prefill, decode (the model's
        call) or sampling (between the model's calls)."""
        by_name: Dict[str, float] = {}
        for s, e, name, _ in self.device:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        a, b = self.window()
        ivs = sorted((s, e) for s, e, _, _ in self.device)
        gaps, end = [], a
        for s, e in ivs + [(b, b)]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        named = []
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            what = "sampling"
            for kind in ("prefill", "decode"):
                if any(x <= mid <= y for x, y in self.spans.get(PREFIX + kind,
                                                                [])):
                    what = kind
            named.append([what, (g1 - g0) / 1e9])
        named.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": named[:top]}


class Tracer(window.Hooks):
    """Profiles batch 0's prefill and its first `steps` decode steps of a
    window, and records the shapes of each call of `ops` (`OPS` and the
    family's) while it does."""

    def __init__(self, device: torch.device, steps: int,
                 ops: Dict[str, Tuple[str, Callable, Callable]]) -> None:
        self.device = device
        self.steps = steps
        self.ops = ops
        self.prof: Optional[profile] = None
        self.active = False
        self.done = False
        self.open: Dict[str, record_function] = {}
        self.calls: Dict[str, List[Call]] = {op: [] for op in ops}
        self._orig = {}

    # -- the op wrappers ------------------------------------------------
    def install(self) -> None:
        import importlib
        for op, (mod_name, _, _) in self.ops.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, op)
            self._orig[op] = (mod, fn)
            setattr(mod, op, self._wrap(op, fn))

    def uninstall(self) -> None:
        for op, (mod, fn) in self._orig.items():
            setattr(mod, op, fn)
        self._orig.clear()

    def _wrap(self, op: str, fn):
        call_args = self.ops[op][1]

        def traced(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            self.calls[op].append(Call(op, call_args(args, kw)))
            with record_function(f"{PREFIX}op.{op}"):
                return fn(*args, **kw)
        return traced

    # -- the ranges ------------------------------------------------------
    def _enter(self, name: str) -> None:
        rf = record_function(PREFIX + name)
        rf.__enter__()
        self.open[name] = rf

    def _exit(self, name: str) -> None:
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def _stop(self) -> None:
        self._exit("step")
        self.prof.stop()
        self.active = False
        self.done = True

    def prefill_start(self, batch: int) -> bool:
        if not self.done and self.prof is None:
            self.prof = profile(activities=_activities(self.device))
            self.prof.start()
            self.active = True
        if self.active:
            self._enter("prefill")
        return self.active

    def prefill_end(self, batch: int) -> None:
        self._exit("prefill")

    def decode_start(self, batch: int, k: int) -> bool:
        if not self.active:
            return False
        self._exit("step")
        if k > self.steps:
            self._stop()
            return False
        self._enter("step")
        self._enter("decode")
        return True

    def decode_end(self, batch: int, k: int) -> None:
        self._exit("decode")

    def generate_end(self, batch: int) -> None:
        if self.active:
            self._stop()

    # -- reading ---------------------------------------------------------
    def read(self) -> Optional[Trace]:
        """The trace of the profiled slice (None if none was taken)."""
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        launch: Dict[int, int] = {}
        ranges: Dict[str, List[Tuple[int, int]]] = {}
        device = []
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.is_user_annotation() and name.startswith(PREFIX):
                    ranges.setdefault(name, []).append(
                        (e.start_ns(), e.end_ns()))
                elif name.startswith("cu") and not e.is_user_annotation():
                    launch[e.correlation_id()] = e.start_ns()
            elif not e.is_user_annotation():
                device.append([e.start_ns(), e.end_ns(), name,
                               e.correlation_id()])
        device = [(s, e, n, launch.get(c)) for s, e, n, c in device]
        spans = {n: sorted(v) for n, v in ranges.items()
                 if not n.startswith(PREFIX + "op.")}
        trace = Trace(spans, device,
                      work={op: w for op, (_, _, w) in self.ops.items()})
        launches = sorted((t, s, e) for s, e, _, t in device if t is not None)
        times = [t for t, _, _ in launches]
        for op, calls in self.calls.items():
            rs = sorted(ranges.get(f"{PREFIX}op.{op}", []))
            if len(rs) != len(calls):
                continue                  # cannot pair calls with ranges
            for call, (a, b) in zip(calls, rs):
                i, j = bisect.bisect_left(times, a), bisect.bisect_right(
                    times, b)
                call.device_s = sum(e - s for _, s, e in launches[i:j]) / 1e9
            trace.calls[op] = calls
        return trace
