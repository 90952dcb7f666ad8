"""The program's own spans and counters (`repro_torch.spans`) in the
traced slice, joined to the slice's device records.

The program records while the harness's profiler does, on the
profiler's clock.  Its records that overlap the traced slice
(`Trace.window()`) are read here, so the records of earlier windows in
one process are left out.  A device record belongs to a span when its
launch (the runtime call of the same correlation id) lies inside the
span, as `Trace.roofline` joins op calls.  The program reports shapes,
never flops or bytes: a GEMM's least time is worked out here from its
span's M, K, N and element size by `yardstick.bound`.

Every reading is None where the slice holds no device record, or where
the program made no record of the kind the reading needs (a program
without `repro_torch.spans`).
"""

from __future__ import annotations

import bisect
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

from h100_bench import trace, yardstick

P = "repro_torch."
Range = Tuple[int, int]


def program(run) -> Optional["Program"]:
    """The program's records of the traced slice with its device records,
    or None."""
    t = run.trace
    if t is None or not t.device:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    a, b = t.window()
    recs = [r for r in spans.records() if r.start_ns <= b and r.end_ns >= a]
    return Program(t, recs) if recs else None


def _union(ivs: Iterable[Range]) -> List[Range]:
    out: List[Range] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a: Sequence[Range], b: Sequence[Range]) -> int:
    """ns that two lists of disjoint ranges share."""
    n, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            n += max(0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return n


class Program:
    def __init__(self, t: trace.Trace, recs) -> None:
        self.trace = t
        self.recs = recs
        launched = sorted((launch, e - s) for s, e, _, launch in t.device
                          if launch is not None)
        self._times = [x for x, _ in launched]
        self._sums = [0]
        for _, d in launched:
            self._sums.append(self._sums[-1] + d)

    def named(self, name: str, within: Sequence = ()) -> List:
        """The records of `P + name`, those inside one of `within` where
        given."""
        got = [r for r in self.recs if r.name == P + name]
        if within:
            got = [r for r in got if any(w.start_ns <= r.start_ns and
                                         r.end_ns <= w.end_ns
                                         for w in within)]
        return got

    def device_s(self, r) -> float:
        """Device seconds of the records launched inside `r`."""
        i = bisect.bisect_left(self._times, r.start_ns)
        j = bisect.bisect_right(self._times, r.end_ns)
        return (self._sums[j] - self._sums[i]) / 1e9

    def idle(self, ranges: Iterable[Range]) -> List[Range]:
        """The parts of `ranges` in which no device record ran."""
        busy = _union((s, e) for s, e, _, _ in self.trace.device)
        starts = [s for s, _ in busy]
        gaps: List[Range] = []
        for a, b in sorted(ranges):
            end = a
            for s, e in busy[max(bisect.bisect_right(starts, a) - 1, 0):]:
                if s >= b:
                    break
                if e <= end:
                    continue
                if s > end:
                    gaps.append((end, s))
                end = max(end, e)
            if end < b:
                gaps.append((end, b))
        return gaps

    # -- the readings ------------------------------------------------------
    def pad_share(self) -> Optional[float]:
        """Pad tokens over the tokens the prefills ran, in %."""
        c = self.named("serve.prefill_tokens")
        padded = sum(r.attrs["padded"] for r in c)
        if not padded:
            return None
        return 100.0 * (padded - sum(r.attrs["own"] for r in c)) / padded

    def kv_used_share(self) -> Optional[float]:
        """The requests' own KV rows over the rows reserved, in %, the mean
        over the decode steps."""
        c = self.named("serve.kv_rows")
        if not c:
            return None
        return statistics.fmean(100.0 * r.attrs["own"] / r.attrs["reserved"]
                                for r in c)

    def gemm_roofline(self) -> Optional[float]:
        """The prefills' weight products' least time over their device
        time, in %, over the products whose device records came back."""
        least = dev = 0.0
        for r in self.named("lm.dense", within=self.named("lm.prefill")):
            d = self.device_s(r)
            if d > 0:
                a = r.attrs
                M, K, N = a["M"], a["K"], a["N"]
                least += yardstick.bound(
                    2 * M * K * N, (M * K + K * N + M * N) * a["elt"])[0]
                dev += d
        return 100.0 * least / dev if dev > 0 else None

    def elementwise_share(self) -> Optional[float]:
        """Device time launched in the prefills outside the weight
        products and the attention, over all device time launched in
        them, in %."""
        pre = self.named("lm.prefill")
        total = sum(self.device_s(r) for r in pre)
        if total <= 0:
            return None
        parts = sum(self.device_s(r) for name in ("lm.dense", "lm.attend")
                    for r in self.named(name, pre))
        return 100.0 * (total - parts) / total

    def decode_enqueue_ms(self) -> Optional[float]:
        """The median host time of a decode step's call (`lm_decode_step`:
        its launches), in ms."""
        d = [(r.end_ns - r.start_ns) / 1e6
             for r in self.named("lm.decode_step")]
        return statistics.median(d) if d else None

    def _steps(self) -> List[Range]:
        return self.trace.spans.get(trace.PREFIX + "step", [])

    def decode_sample_ms(self) -> Optional[float]:
        """The median over the traced decode steps of the host time spent
        sampling and emitting the step's tokens, in ms."""
        mine = self.named("serve.sample") + self.named("serve.emit")
        if not mine:
            return None
        per = [sum(r.end_ns - r.start_ns for r in mine
                   if a <= r.start_ns and r.end_ns <= b) / 1e6
               for a, b in self._steps()]
        return statistics.median(per) if per else None

    def idle_in_enqueue(self) -> Optional[float]:
        """Of the device's idle time inside the traced decode steps, the
        share during which the host was inside a decode step's call, in
        %."""
        gaps = self.idle(self._steps())
        idle = sum(b - a for a, b in gaps)
        if idle <= 0:
            return None
        calls = _union((r.start_ns, r.end_ns)
                       for r in self.named("lm.decode_step"))
        return 100.0 * _overlap(gaps, calls) / idle

    def gaps(self) -> List[List]:
        """The ten longest idle gaps of the traced slice, each named by the
        innermost program span that covers its middle, longest first:
        [[name, s], ...].  A gap that no span covers is left out.  No
        metric reads it: the harness's `breakdown.idle_gaps` names gaps
        by its own ranges."""
        spans = [r for r in self.recs if r.end_ns > r.start_ns]
        named = []
        for a, b in sorted(self.idle([self.trace.window()]),
                           key=lambda g: g[0] - g[1]):
            mid = (a + b) // 2
            cover = [r for r in spans if r.start_ns <= mid <= r.end_ns]
            if cover:
                inner = min(cover, key=lambda r: r.end_ns - r.start_ns)
                named.append([inner.name, (b - a) / 1e9])
                if len(named) == 10:
                    break
        return named
