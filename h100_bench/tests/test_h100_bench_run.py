"""The harness end to end on the CPU at a small size, with the kernels'
plain versions: the result line's keys, a mix added as a file alone, and
the check turning `correct` false when the timed path is broken."""

from __future__ import annotations

import json
import time

import pytest
import torch

from h100_bench.tests import tiny
from h100_bench.tests.tiny import one_thread  # noqa: F401
from h100_bench import bench

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def run(tmp_path, traced=False, seconds=1.0, **kw):
    here, spec, name = tiny.bench_dir(tmp_path, **kw)
    line = bench.run(spec, name, 2**31 + 77, seconds, traced, CPU,
                     time.perf_counter(), here=here)
    json.dumps(line)                     # the line is plain JSON
    return line, spec


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(tmp_path, traced):
    # the traced window starts the profiler inside it: room for a batch
    # on a loaded machine
    line, spec = run(tmp_path, traced, seconds=2.0 if traced else 1.0)
    keys = list(line)
    assert keys[-1] == "compared"
    assert [k for k in keys if k != "breakdown"] == KEYS
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] >= tiny.MIX["batch"]
    assert set(line["compared"]) == {"logit_err", "row_errors",
                                     "token_mismatches", "requests_checked"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    metrics = line["metrics"]
    if traced:
        # no device on the CPU: only the host-clock readers find anything,
        # the prefill's where a second, unprofiled batch started
        want = {"decode_mfu"} | ({"prefill_mfu"} if line["attempted"] >
                                 tiny.MIX["batch"] else set())
        assert set(metrics) == want
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(metrics) == {m["name"] for m in spec["end_to_end"]}
        assert metrics["output_tokens_per_s"]["value"] > 0
    for m in metrics.values():
        assert set(m) == {"value", "unit"}


def test_new_mix_file_is_picked_up(tmp_path):
    """A mix is a data file: a new one, named by a new workload entry,
    runs with no other change."""
    mix = dict(tiny.MIX, batch=3, output_tokens=dict(law="uniform", low=2,
                                                      high=3))
    line, _ = run(tmp_path, mix=mix)
    assert line["correct"] is True
    assert line["attempted"] % 3 == 0


def _broken(monkeypatch, fault):
    """Break the timed path underneath the harness."""
    from repro_torch.serve import engine, serve_step

    if fault == "state_unchanged":
        step = serve_step.lm_decode_step

        def stale(model, caches, tokens, pos, rcfg=None):
            copies = [{k: v.clone() for k, v in c.items()} for c in caches]
            logits, _ = step(model, copies, tokens, pos, rcfg)
            return logits, caches
        monkeypatch.setattr(serve_step, "lm_decode_step", stale)
    elif fault == "half_batch":
        prefill = serve_step.lm_prefill

        def half(model, tokens, **kw):
            B = tokens.shape[0]
            logits, caches = prefill(model, tokens[:B // 2], **kw)
            rep = [{k: torch.cat([v, v]) for k, v in c.items()}
                   for c in caches]
            return torch.cat([logits, logits]), rep
        monkeypatch.setattr(serve_step, "lm_prefill", half)
    elif fault == "token_altered":
        greedy = engine.greedy_sample

        def off_by_one(logits):
            return (greedy(logits) + 1) % logits.shape[-1]
        monkeypatch.setattr(engine, "greedy_sample", off_by_one)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    """Every finished request checked, so that a fault in some rows only
    cannot fall outside the sample."""
    _broken(monkeypatch, fault)
    line, _ = run(tmp_path, mix=dict(tiny.MIX, check_requests=1000))
    assert line["correct"] is False, (fault, line["compared"])


def test_cut_first_batch_checks_its_finished_rows():
    """Where the window cut the first batch, its sampled rows that were
    served all their tokens are checked, the others left out."""
    s = bench.Session(tiny.config(), dict(tiny.MIX, check_requests=3),
                      CPU, 2**31 + 3)
    cap = s.capture()
    result = s.window(60.0, cap, max_batches=1)
    cut = result.batches[0].requests[cap.rows[0]]
    cut.output.pop()                    # as if cut before its last token
    result.batches[0].finished = False
    judged = s.judge(result, cap)
    assert judged["requests"] == len(cap.rows) - 1
    assert judged["tokens"] == sum(
        len(result.batches[0].requests[r].output) for r in cap.rows[1:])
