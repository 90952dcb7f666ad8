"""The family modules: the dense family reads as the harness read it
before it had them, and a second family made of files under
`h100_bench/tests/` alone (`moe_family.py`, `moe_reference.py`) runs
through `bench.run` and `calibrate` with no harness file changed."""

from __future__ import annotations

import dataclasses
import json
import re
import time

import pytest
import torch

from h100_bench.tests import tiny
from h100_bench.tests.tiny import one_thread  # noqa: F401
from h100_bench import bench, calibrate, families, trace, weights, yardstick
from h100_bench.tests import moe_family
from h100_bench.tests.test_h100_bench_isolation import _top_level

CPU = torch.device("cpu")
DENSE = json.loads((tiny.HERE / "configs" / "internlm2-20b.json")
                   .read_text())
HARNESS = ("model", "yardstick", "trace", "check", "calibrate", "bench")

# the parent's readings of the dense configuration, before the move
ARCH = {
    'name': 'internlm2-20b', 'family': 'dense', 'n_layers': 48,
    'd_model': 6144, 'n_heads': 48, 'n_kv_heads': 8, 'd_ff': 16384,
    'vocab_size': 92544, 'head_dim': 128, 'window': 0, 'attn_softcap': 0.0,
    'final_softcap': 0.0, 'qkv_bias': False, 'rope_fraction': 1.0,
    'rope_theta': 1000000.0, 'query_scale': None, 'post_block_norm': False,
    'tie_embeddings': False, 'act': 'silu', 'layer_pattern': None,
    'moe': None, 'ssm': None, 'encoder': None, 'vision': None,
    'shapes': ({'name': 'train_4k', 'seq_len': 4096, 'global_batch': 256,
                'kind': 'train'},
               {'name': 'prefill_32k', 'seq_len': 32768, 'global_batch': 32,
                'kind': 'prefill'},
               {'name': 'decode_32k', 'seq_len': 32768, 'global_batch': 128,
                'kind': 'decode'}),
    'source': '[arXiv:2403.17297; hf]'}
PREFILL = {(1,): 38585106432, (1500,): 57499245084672,
           (766, 2873): 141487695986688,
           (750, 1024, 3000): 185035660591104}
DECODE = {(0,): 38585106432, (1020,): 39788347392,
          (521, 1996, 2255): 121384599552}

# the test family's limits, from its readings on the CPU (bf16, 16 seeds,
# every request of a batch checked; the float8 control on 4 seeds):
# logit_err 0.0040-0.0147, control 0.103-0.140; route_margin 0-0.0245,
# control 0.140-0.351.  Without following (a margin limit of 0) the
# sound runs' logit_err read up to 0.235: the flips, not the arithmetic.
MOE_LIMITS = {"logit_err": 0.05, "route_margin": 0.07}


def test_dense_family_reads_as_before():
    fam = families.of(DENSE)
    assert fam.__name__ == "h100_bench.families.dense"
    assert dataclasses.asdict(fam.arch_config(DENSE)) == ARCH
    assert fam.kernels(DENSE) == ("flash_attention", "decode_attention")
    assert fam.OPS == {} and fam.FOLLOW is None
    for lens, want in PREFILL.items():
        assert yardstick.prefill_flops(DENSE, lens) == want
    for ctx, want in DECODE.items():
        assert yardstick.decode_flops(DENSE, ctx) == want


@pytest.mark.parametrize("name", HARNESS)
def test_harness_tests_no_family_name(name):
    text = (tiny.HERE / f"{name}.py").read_text()
    assert '"dense"' not in text
    assert not re.search(r"""\[["']family["']\]\s*[!=]=""", text)


def moe_config():
    cfg = tiny.config()
    cfg.update(name="tiny-moe", family="h100_bench.tests.moe_family",
               registry="mixtral-8x7b", tie_word_embeddings=True,
               num_local_experts=8, num_experts_per_tok=2,
               moe_intermediate_size=32, shared_expert_intermediate_size=64,
               intermediate_size=32)
    return cfg


def moe_dir(tmp_path, **mix):
    """The test family's cell, every request of a batch checked, and a
    reader of its traced op's calls."""
    here, spec, name = tiny.bench_dir(
        tmp_path, cfg=moe_config(), limits=MOE_LIMITS,
        mix=dict(tiny.MIX, check_requests=1000, **mix))
    (here / "metrics" / "moe_calls.py").write_text(
        "def read(run):\n"
        "    calls = None if run.trace is None else \\\n"
        "        run.trace.calls.get('moe_dispatch_compute')\n"
        "    return len(calls) if calls else None\n")
    spec["per_layer"].append(dict(
        name="moe_calls", unit="calls", better="higher",
        source="device_trace", layer="models.moe", moves="ttft_mean_ms",
        workloads=[name]))
    return here, spec, name


def run_moe(tmp_path, traced=False, seconds=1.0):
    here, spec, name = moe_dir(tmp_path)
    return bench.run(spec, name, 2**31 + 91, seconds, traced, CPU,
                     time.perf_counter(), here=here)


def test_moe_family_hooks():
    cfg = moe_config()
    fam = families.of(cfg)
    assert fam is moe_family
    arch = fam.arch_config(cfg)
    assert arch.tie_embeddings and arch.moe.n_experts == 8
    with pytest.raises(ValueError):     # the dense family refuses it
        families.of(DENSE).arch_config(dict(cfg, family="dense"))
    # d 64; attention 4 x 16 q, 2 x 16 kv: 4,096 + 4,096 + 4,096; router
    # 512; two experts of 3 x 64 x 32; the shared expert 3 x 64 x 64 and
    # its gate 64
    layer = 3 * 4096 + 512 + 2 * 6144 + 12288 + 64
    assert fam.matmul_params(cfg) == 3 * layer
    assert yardstick.decode_flops(cfg, [3]) == \
        2 * 3 * layer + 2 * 64 * 300 + 3 * 4 * 16 * 4 * 4


@pytest.mark.parametrize("traced", [False, True])
def test_moe_family_runs(tmp_path, traced):
    # the traced window starts the profiler inside it: room for its first
    # batch to finish on a loaded machine
    line = run_moe(tmp_path, traced, seconds=5.0 if traced else 1.0)
    json.dumps(line)
    assert line["correct"] is True, line["compared"]
    assert set(line["compared"]) == {
        "logit_err", "route_margin", "row_errors", "token_mismatches",
        "requests_checked"}
    assert line["compared"]["route_margin"]["limit"] == 0.07
    if traced:
        assert line["metrics"]["moe_calls"]["value"] > 0
        assert "decode_mfu" in line["metrics"]


def test_moe_family_calibrates(tmp_path):
    """Sound seeds correct, the float8 control not, with the family's
    own number read on both sides of its limit."""
    here, spec, name = moe_dir(tmp_path)
    summary = calibrate.readings(bench.cell(spec, name, here), CPU,
                                 [0, 6, 9], [100, 103])
    assert summary["sound_not_correct"] == []
    assert summary["control_correct"] == []
    for num, lim in MOE_LIMITS.items():
        assert summary[num]["lower"] < lim < summary[num]["upper"], num
    assert all("route_flips" in r for r in summary["rows"])


def test_moe_swapped_expert_is_not_correct(tmp_path, monkeypatch):
    """Experts 0 and 1 swapped under the router: the program takes
    choices far from any tie, which the reference does not follow."""
    from repro_torch.models import moe

    route = moe.route

    def swapped(router, x2, mc, dtype=None):
        perm = torch.arange(router.shape[1], device=router.device)
        perm[:2] = perm[:2].flip(0)
        return route(router[:, perm], x2, mc, dtype)
    monkeypatch.setattr(moe, "route", swapped)
    line = run_moe(tmp_path)
    assert line["correct"] is False
    margin = line["compared"]["route_margin"]
    assert margin["value"] > 3 * margin["limit"], margin
    assert moe.route is swapped            # the check unwrapped it


def test_roofline_reads_the_family_work():
    call = dict(T=64, d=64, E=8, k=2, f=32, elt=2)
    t = trace.Trace({}, [], calls={"moe_dispatch_compute": [
        trace.Call("moe_dispatch_compute", call, device_s=1e-3)]},
        work={"moe_dispatch_compute": moe_family.dispatch_work})
    least = yardstick.bound(*moe_family.dispatch_work(call))[0]
    assert t.roofline("moe_dispatch_compute") == \
        pytest.approx(100 * least / 1e-3)


def test_stacked_weights_draw_by_their_rows():
    w = weights.draw([("w", (4, 256, 64), "matmul")], torch.float32, CPU,
                     2**31 + 7)["w"]
    assert float(w.std()) == pytest.approx(1 / 16, rel=0.02)


def test_test_reference_loads_nothing_of_the_port():
    names = _top_level(
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(tiny.ROOT)!r}]\n"
        "importlib.import_module('h100_bench.tests.moe_reference')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" not in names and "jax" not in names, names
