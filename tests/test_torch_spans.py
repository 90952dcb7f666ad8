"""The serving path's spans and counters (`repro_torch.spans`) on the CPU:
off unless something records, their nesting, their clock against the
profiler's, the counters' arithmetic, equal outputs with recording on
and off, and the bounded buffer."""

import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.configs import get
from repro_torch.configs.base import RunConfig, reduced
from repro_torch.models import LM
from repro_torch.models.common import dense
from repro_torch.serve import Request, ServeEngine

MAX_LEN = 48
PROMPTS = (30, 17, 9)
NEW = (5, 3, 1)        # the third request is served by the prefill alone


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def engine():
    cfg = reduced(get("internlm2-20b"), n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab=300)
    model = LM(cfg, RunConfig(dtype="float32"), seed=3, device="cpu")
    return ServeEngine(model, max_len=MAX_LEN, seed=5)


def requests():
    return [Request(prompt=[(7 * i + 3 * j) % 300 + 1 for j in range(n)],
                    max_new_tokens=k)
            for i, (n, k) in enumerate(zip(PROMPTS, NEW))]


def named(recs, name):
    return [r for r in recs if r.name == name]


def test_off_records_nothing(engine):
    assert not spans.active()
    engine.generate(requests())
    assert spans.records() == [] and spans.dropped() == 0


def test_nesting_and_parents(engine):
    with spans.recording():
        engine.generate(requests())
    recs = spans.records()
    by_id = {r.id: r for r in recs}
    [gen] = named(recs, "repro_torch.serve.generate")
    assert gen.parent is None and gen.attrs == dict(B=3, width=30)
    assert {r.call for r in recs} == {gen.call}
    steps = named(recs, "repro_torch.lm.decode_step")
    assert [s.attrs for s in steps] == [dict(B=3, pos=30 + k)
                                        for k in range(4)]
    for step in steps:
        assert step.parent == gen.id
        blocks = [r for r in recs if r.name == "repro_torch.lm.block"
                  and r.parent == step.id]
        assert [b.attrs["layer"] for b in blocks] == [0, 1]
        for b in blocks:
            dense = [r for r in recs if r.parent == b.id
                     and r.name == "repro_torch.lm.dense"]
            # q, k, v, o, gate, up, down: one row a batch row
            assert len(dense) == 7
            assert {(d.attrs["M"], d.attrs["K"]) for d in dense} >= {
                (3, 64), (3, 128)}
            [attend] = [r for r in recs if r.parent == b.id
                        and r.name == "repro_torch.lm.attend"]
            assert attend.attrs["kv_len"] == step.attrs["pos"] + 1
            assert attend.attrs["k"] == (3, 2, MAX_LEN, 16)
    [pre] = named(recs, "repro_torch.lm.prefill")
    assert pre.parent == gen.id
    assert pre.attrs == dict(B=3, S=30, cache_len=MAX_LEN)
    fills = named(recs, "repro_torch.lm.cache_fill")
    assert len(fills) == 2
    assert all(by_id[f.parent].name == "repro_torch.lm.block"
               and by_id[by_id[f.parent].parent] is pre for f in fills)
    # a span lies inside its parent
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    # sampling and emitting: once after the prefill, once a decode step
    assert len(named(recs, "repro_torch.serve.sample")) == 5
    assert len(named(recs, "repro_torch.serve.emit")) == 5


def test_counters(engine):
    with spans.recording():
        engine.generate(requests())
    recs = spans.records()
    [pre] = named(recs, "repro_torch.serve.prefill_tokens")
    assert pre.attrs == dict(own=sum(PROMPTS), padded=3 * 30)
    assert pre.start_ns == pre.end_ns
    kv = named(recs, "repro_torch.serve.kv_rows")
    # step k serves the requests asking for more than k tokens: the first
    # in steps 1-4, the second in steps 1-2
    want = [dict(reserved=3 * MAX_LEN,
                 own=(30 + k) + (17 + k if k <= 2 else 0))
            for k in range(1, 5)]
    assert [r.attrs for r in kv] == want
    # the rows written by step k: B x (width + k), from its decode step
    steps = named(recs, "repro_torch.lm.decode_step")
    assert [s.attrs["B"] * (s.attrs["pos"] + 1) for s in steps] == [
        3 * (30 + k) for k in range(1, 5)]


def test_calls_are_numbered(engine):
    with spans.recording():
        engine.generate(requests())
        engine.generate(requests())
    gens = named(spans.records(), "repro_torch.serve.generate")
    assert gens[1].call == gens[0].call + 1
    for g in gens:
        assert len([r for r in spans.records() if r.call == g.call
                    and r.name == "repro_torch.lm.prefill"]) == 1


def test_outputs_equal_with_recording_on_and_off(engine):
    class Keep(ServeEngine):
        def _sample(self, logits, requests, gens):
            self.seen.append(logits.clone())
            return super()._sample(logits, requests, gens)

    def serve(on):
        e = Keep(engine.model, max_len=MAX_LEN, seed=5)
        e.seen = []
        reqs = requests()
        reqs[1].temperature = 0.7        # a sampled row too
        if on:
            with spans.recording():
                e.generate(reqs)
        else:
            e.generate(reqs)
        return [r.output for r in reqs], e.seen

    off_tokens, off_logits = serve(False)
    on_tokens, on_logits = serve(True)
    assert spans.records()
    assert on_tokens == off_tokens
    assert len(on_logits) == len(off_logits)
    for a, b in zip(on_logits, off_logits):
        assert torch.equal(a, b)


def test_profiler_switches_spans_on_and_shares_its_clock():
    """A span beside a `record_function` of the same extent, under a CPU
    profiler, agrees with the profiler's event within 0.2 ms at both
    ends; before and after the profiler nothing records."""
    with spans.span("repro_torch.test.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.active()
        with record_function("warm"):           # the first range's set-up
            pass
        for _ in range(3):
            with spans.span("repro_torch.test.same"), \
                    record_function("repro_torch.test.same"):
                time.sleep(0.005)
    with spans.span("repro_torch.test.after"):
        pass
    mine = named(spans.records(), "repro_torch.test.same")
    assert [r.name for r in spans.records()] == ["repro_torch.test.same"] * 3
    theirs = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "repro_torch.test.same")
    assert len(theirs) == 3
    for r, (a, b) in zip(mine, theirs):
        assert abs(r.start_ns - a) < 200_000, (r.start_ns, a)
        assert abs(r.end_ns - b) < 200_000, (r.end_ns, b)


def test_buffer_keeps_the_last_records_and_counts_drops(monkeypatch):
    monkeypatch.setattr(spans, "_buf", collections.deque(maxlen=4))
    with spans.recording():
        for i in range(10):
            spans.count("repro_torch.test.n", i=i)
    assert [r.attrs["i"] for r in spans.records()] == [6, 7, 8, 9]
    assert spans.dropped() == 6
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_off_site_is_one_shared_object():
    """Off, `span()` gives the shared OFF and `on` is false, so a hot site
    (`dense`) opens no span; `on` holds inside `recording()` and inside a
    recorded span, and is restored when they close."""
    x, w = torch.zeros(2, 3, 4), torch.zeros(4, 5)
    assert spans.span("repro_torch.test.x", n=3) is spans.OFF
    assert not spans.on
    dense(x, w)
    with spans.recording():
        assert spans.on
        dense(x, w)
        with spans.span("repro_torch.test.x", n=3):
            pass
    assert not spans.on
    assert spans.span("repro_torch.test.x", n=3) is spans.OFF
    g, s = spans.records()
    assert g.name == "repro_torch.lm.dense"
    assert g.attrs == dict(M=6, K=4, N=5, elt=4)
    assert s.attrs == dict(n=3)


def test_hot_sites_record_only_inside_a_recorded_span():
    """Under a profiler, a hot site records inside a span that records,
    and not on its own (it tests `on`, never the profiler)."""
    x, w = torch.zeros(2, 3, 4), torch.zeros(4, 5)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not spans.on
        dense(x, w)
        with spans.span("repro_torch.test.outer"):
            assert spans.on
            dense(x, w)
        assert not spans.on
    inner, outer = spans.records()
    assert inner.name == "repro_torch.lm.dense"
    assert inner.parent == outer.id


def test_table_counts_and_self_time():
    def r(name, a, b, id_, parent):
        return spans.Record(name, a * 10**6, b * 10**6, id_, parent, 1, {})
    recs = [r("repro_torch.lm.dense", 1, 3, 3, 2),
            r("repro_torch.lm.dense", 4, 5, 4, 2),
            r("repro_torch.lm.block", 0, 6, 2, 1),
            r("repro_torch.serve.kv_rows", 7, 7, 5, 1),
            r("repro_torch.lm.decode_step", 0, 8, 1, None)]
    assert spans.table(recs) == [
        ("repro_torch.lm.decode_step", 1, 8.0, 2.0),
        ("repro_torch.lm.block", 1, 6.0, 3.0),
        ("repro_torch.lm.dense", 2, 3.0, 3.0),
        ("repro_torch.serve.kv_rows", 1, 0.0, 0.0)]
