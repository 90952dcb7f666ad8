"""`decode_graph_share`'s reading of the program's `serve.decode_graph`
counter over hand-made records and the hand-made trace of
`test_h100_bench_spans` (its traced slice spans 0-3,000 µs)."""

from __future__ import annotations

import pytest

from h100_bench.tests import tiny  # noqa: F401  (puts src on the path)
from h100_bench import bench
from h100_bench.tests.test_h100_bench_spans import hand_trace, rec, run_of
from repro_torch import spans as program_spans


def counter(t, graphs, eager, captured=0):
    return rec("serve.decode_graph", t, t,
               dict(graphs=graphs, captured=captured, eager=eager))


STEPS = [rec("lm.decode_step", 1000, 1600, dict(B=2, pos=50)),
         rec("lm.decode_step", 2000, 2500, dict(B=2, pos=51))]
CASES = {
    "all_replayed": ([counter(1590, 49, 0), counter(2490, 49, 0)], 100.0),
    "mixed": ([counter(1590, 49, 0, captured=49), counter(2490, 0, 1)],
              50.0),
    # a counter of an earlier window, outside the traced slice, is not read
    "earlier_window": ([counter(-5000, 0, 1), counter(1590, 49, 0)], 100.0),
    "no_counter": ([], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_graph_share(monkeypatch, case):
    counters, want = CASES[case]
    monkeypatch.setattr(program_spans, "records",
                        lambda: STEPS + counters)
    got = bench.read_metric("decode_graph_share", run_of(hand_trace()))
    assert got == (None if want is None else pytest.approx(want))


def test_decode_graph_share_is_none_without_device_records(monkeypatch):
    monkeypatch.setattr(program_spans, "records",
                        lambda: STEPS + CASES["all_replayed"][0])
    assert bench.read_metric("decode_graph_share",
                             run_of(hand_trace(device=False))) is None
    assert bench.read_metric("decode_graph_share", run_of(None)) is None
