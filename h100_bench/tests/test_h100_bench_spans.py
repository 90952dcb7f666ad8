"""The readers of the program's spans and counters (`h100_bench/spans.py`
and the seven metrics on it) on a hand-made trace: the harness's ranges,
device records and program records at known times (µs below), each
reading against its value worked out by hand."""

from __future__ import annotations

import pytest

from h100_bench.tests import tiny  # noqa: F401  (puts src on the path)
from h100_bench import bench, spans, trace
from repro_torch import spans as program_spans
from repro_torch.spans import Record

US = 1000
READERS = {"prefill_pad_share": 40.0,
           # 2·4096³ flops at 989 TFLOP/s: 138.97 µs (the bytes 30.05 µs)
           # over the 200 µs launched in the product
           "prefill_gemm_roofline": 100 * 2 * 4096 ** 3 / 989e12 / 200e-6,
           # 100 of the 400 µs launched in the prefill
           "prefill_elementwise_share": 25.0,
           "kv_used_share": 40.0,             # 50% and 30%
           "decode_enqueue_ms": 0.55,         # 600 and 500 µs
           "decode_sample_ms": 0.15,          # 200 and 100 µs
           # 500 + 400 of the 1,600 µs idle inside the steps
           "decode_idle_in_enqueue": 56.25}


def rec(name, a, b, attrs=None, id_=0):
    return Record("repro_torch." + name, a * US, b * US, id_, None, 1,
                  attrs or {})


RECORDS = [
    # an earlier window's counter, outside the traced slice
    rec("serve.prefill_tokens", -5000, -5000, dict(own=0, padded=100)),
    rec("lm.dense", 100, 300, dict(M=4096, K=4096, N=4096, elt=2)),
    rec("lm.attend", 400, 500, dict(q=(1, 8, 64, 128), k=(1, 8, 64, 128),
                                    kv_len=64)),
    rec("lm.prefill", 0, 1000, dict(B=2, S=50, cache_len=80)),
    rec("serve.prefill_tokens", 950, 950, dict(own=60, padded=100)),
    rec("lm.decode_step", 1000, 1600, dict(B=2, pos=50)),
    rec("serve.sample", 1700, 1750), rec("serve.emit", 1750, 1900),
    rec("serve.kv_rows", 1950, 1950, dict(reserved=1000, own=500)),
    rec("lm.decode_step", 2000, 2500, dict(B=2, pos=51)),
    rec("serve.sample", 2600, 2620), rec("serve.emit", 2620, 2700),
    rec("serve.kv_rows", 2950, 2950, dict(reserved=1000, own=300)),
    rec("serve.generate", -100, 3100, dict(B=2, width=50)),
]


def hand_trace(device=True):
    ranges = {trace.PREFIX + "prefill": [(0, 1000 * US)],
              trace.PREFIX + "step": [(1000 * US, 2000 * US),
                                      (2000 * US, 3000 * US)]}
    # (start, end, name, launch)
    dev = [(200 * US, 400 * US, "nvjet_gemm", 150 * US),
           (450 * US, 550 * US, "flash_fwd", 450 * US),
           (600 * US, 700 * US, "elementwise", 600 * US),
           (1500 * US, 1700 * US, "decode_gemv", 1100 * US),
           (2400 * US, 2600 * US, "decode_gemv", 2100 * US)]
    return trace.Trace(ranges, dev if device else [])


def run_of(t):
    return bench.Run(None, None, None, t)


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: list(RECORDS))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_against_hand_value(records, metric):
    assert bench.read_metric(metric, run_of(hand_trace())) == \
        pytest.approx(READERS[metric], rel=1e-9)


def test_gemm_bound_of_one_shape():
    t, what = spans.yardstick.bound(2 * 4096 ** 3, 3 * 4096 ** 2 * 2)
    assert what == "operations"
    assert t == pytest.approx(138.968e-6, rel=1e-5)


def test_idle_gaps_named_by_the_innermost_span(records):
    p = spans.program(run_of(hand_trace()))
    # idle: [0,200] in the product's span, [400,450] in attend's,
    # [550,600] in the prefill's, [700,1500] and [1700,2400] in a decode
    # step's, [2600,3000] in generate's alone
    assert p.gaps()[:4] == [["repro_torch.lm.decode_step", 800e-6],
                             ["repro_torch.lm.decode_step", 700e-6],
                             ["repro_torch.serve.generate", 400e-6],
                             ["repro_torch.lm.dense", 200e-6]]
    assert len(p.gaps()) == 6
    assert {g[0] for g in p.gaps()} == {
        "repro_torch.lm.decode_step", "repro_torch.serve.generate",
        "repro_torch.lm.dense", "repro_torch.lm.attend",
        "repro_torch.lm.prefill"}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_none_without_device_records(records, metric):
    assert bench.read_metric(metric, run_of(hand_trace(device=False))) \
        is None
    assert bench.read_metric(metric, run_of(None)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_none_without_program_records(monkeypatch, metric):
    """A program that records nothing (one without `repro_torch.spans`
    reads the same way)."""
    monkeypatch.setattr(program_spans, "records", lambda: [])
    assert bench.read_metric(metric, run_of(hand_trace())) is None
