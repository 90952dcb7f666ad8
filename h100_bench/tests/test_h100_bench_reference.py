"""The plain reference against the port's CPU path at a small size, and
the control: the reference in float8 e4m3 put where the program is
reads gaps that the sound runs do not, and the cell's comparison finds
it not correct."""

from __future__ import annotations

import json

import pytest
import torch

from h100_bench.tests import tiny
from h100_bench.tests.tiny import one_thread  # noqa: F401
from h100_bench import bench, check

CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_reference_follows_the_port(dtype, tol):
    """A left-padded batch through the port's prefill and three decode
    steps, against one reference forward a row over its padded prompt and
    the tokens fed: every logit within `tol` of the largest (float32:
    sums in another order; bf16: the served dtype's rounding)."""
    from repro_torch.models import lm_decode_step, lm_prefill

    cfg = tiny.config(dtype)
    s = bench.Session(cfg, tiny.MIX, CPU, 11)
    gen = torch.Generator().manual_seed(3)
    lens, width, steps = (5, 37, 21), 37, 3
    tokens = torch.zeros((3, width), dtype=torch.long)
    prompts = []
    for i, n in enumerate(lens):
        p = torch.randint(0, cfg["vocab_size"], (n,), generator=gen)
        tokens[i, width - n:] = p
        prompts.append(p.tolist())
    fed = torch.randint(0, cfg["vocab_size"], (3, steps), generator=gen)
    logits, caches = lm_prefill(s.model, tokens, max_len=width + steps)
    got = [logits]
    for k in range(steps):
        logits, caches = lm_decode_step(s.model, caches, fed[:, k:k + 1],
                                        width + k)
        got.append(logits)
    got = torch.stack(got, 1)[..., :cfg["vocab_size"]]
    picks = [(p, fed[i].tolist() + [0], width) for i, p in enumerate(prompts)]
    want = s.ref.logits(cfg, s.weights, check._sequences(picks, CPU))
    for i in range(3):
        err = (got[i] - want[i]).abs().max() / want[i].abs().max()
        assert err < tol, (dtype, i, float(err))


def test_control_reads_what_sound_runs_do_not(tmp_path):
    """Four seeds, every request of a batch checked: the control's
    smallest `logit_err` is three times the sound runs' largest or more,
    the tests' limit lies between them, and the comparison with the
    cell's limits file finds every sound run correct and the control, in
    the program's place, not correct."""
    here, spec, name = tiny.bench_dir(tmp_path)
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    s = bench.Session(tiny.config(), dict(tiny.MIX, check_requests=1000),
                      CPU, 0)
    sound, control = [], []
    for seed in range(4):
        s.reseed(seed)
        cap = s.capture()
        judged = s.judge(s.window(60.0, cap, max_batches=1), cap,
                         control=True)
        assert judged["token_mismatches"] == 0
        sound.append(judged["logit_err"])
        control.append(judged["control_err"])
        assert bench.compare(judged, limits)[1] is True
        assert bench.compare(check.as_control(judged), limits)[1] is False
    assert min(control) >= 3 * max(sound), (sound, control)
    assert max(sound) < tiny.TEST_LIMIT < min(control)
