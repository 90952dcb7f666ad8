"""The granite family (`families/granitemoehybrid.py`,
`reference/granitemoehybrid.py`) on the CPU: its hooks against the
program's parameters and the configuration file, the flop count, the
plain reference against the port's prefill and decode, and a small cell
through `bench.run` and `calibrate`, following the router's top-k."""

from __future__ import annotations

import json
import time

import pytest
import torch

from h100_bench.tests import tiny
from h100_bench.tests.tiny import one_thread  # noqa: F401
from h100_bench import bench, calibrate, check, families, trace, yardstick
from h100_bench.families import granitemoehybrid as family
from h100_bench.tests.test_h100_bench_isolation import _top_level

CPU = torch.device("cpu")
FULL = json.loads((tiny.HERE / "configs" / "granite-4.0-h-small.json")
                  .read_text())
# the tiny cell's limits, from its readings on the CPU (bf16, seeds 0-11
# and 100-103, every request of a batch checked): logit_err 0.00046-
# 0.00094, the float8 control 0.0064-0.0197; route_margin 0.002-0.036,
# the control 0.50-1.55
LIMITS = {"logit_err": 0.003, "route_margin": 0.1}


def config(dtype: str = "bfloat16"):
    """One period of the pattern cut to five layers (four Mamba-2, one
    attention), every width cut, 8 experts top-2, every multiplier the
    file's (the attention's set apart from 1/sqrt(head_dim))."""
    cfg = dict(FULL)
    cfg.update(name="tiny-granite", dtype=dtype, num_hidden_layers=5,
               layer_types=["mamba", "mamba", "attention", "mamba", "mamba"],
               hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, mamba_n_heads=8, mamba_d_head=16,
               mamba_d_state=16, num_local_experts=8, num_experts_per_tok=2,
               intermediate_size=32, shared_intermediate_size=64,
               vocab_size=300, attention_multiplier=0.125)
    return cfg


def test_full_configuration():
    """The file's model: 40 layers, 36 of them Mamba-2, 4 NoPE attention
    layers, the program's `ArchConfig` with every multiplier; its layout
    is the program's parameters, 32.2 B of them; 8.39 B weights a token
    goes through."""
    arch = family.arch_config(FULL)
    assert families.of(FULL) is family
    assert arch.n_layers == 40 and arch.layer_kinds.count("attn_full") == 4
    assert (arch.norm_eps, arch.embedding_multiplier,
            arch.residual_multiplier, arch.logits_divisor,
            arch.query_scale) == (1e-5, 12, 0.22, 16, 0.0078125)
    assert arch.moe.dropless and not arch.moe.shared_gate
    assert arch.ssm.chunk == 128 and arch.ssm.n_heads == 128
    from repro_torch.models import LM
    with torch.device("meta"):
        model = LM(arch, device="meta", init=False)
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: s for n, s, _ in family.reference.layout(FULL)}
    assert have == want
    assert sum(p.numel() for p in model.parameters()) == 32_207_337_984
    # a Mamba-2 layer 102.2 M, an attention layer 41.9 M, each layer's
    # router 0.29 M, ten experts 94.4 M and the shared MLP 18.9 M
    mamba = 4096 * (2 * 8192 + 256 + 128) + 8192 * 4096
    attention = 2 * 4096 * 4096 + 2 * 4096 * 1024
    ffn = 4096 * 72 + 3 * 4096 * 768 * 10 + 3 * 4096 * 1536
    assert family.matmul_params(FULL) == \
        36 * mamba + 4 * attention + 40 * ffn == 8_389_918_720
    assert family.attention_layers(FULL) == (4, 0)
    assert family.kernels(FULL) == ("flash_attention", "decode_attention",
                                    "ssd")


@pytest.mark.parametrize("key,value", [
    ("attention_bias", True), ("position_embedding_type", "rope"),
    ("mamba_proj_bias", True), ("tie_word_embeddings", False),
    ("mamba_expand", 1), ("hidden_act", "gelu")])
def test_refuses_what_the_reference_does_not_compute(key, value):
    with pytest.raises(ValueError):
        family.arch_config(dict(FULL, **{key: value}))


def test_flop_count_of_the_small_cell():
    cfg = config()
    d, di, H, GN = 64, 128, 8, 16
    mamba = d * (2 * di + 2 * GN + H) + di * d
    attention = d * 64 + 2 * d * 32 + 64 * d
    ffn = d * 8 + 3 * d * 32 * 2 + 3 * d * 64
    assert family.matmul_params(cfg) == 4 * mamba + attention + 5 * ffn
    # one decode token at context 3: the products, the head, one
    # attention layer's 4 keys of 4 heads of 16
    assert yardstick.decode_flops(cfg, [3]) == \
        2 * family.matmul_params(cfg) + 2 * d * 300 + 4 * 16 * 4 * 4


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_reference_follows_the_port(dtype, tol):
    """A left-padded batch through the port's prefill and three decode
    steps, against one reference forward a row over its padded prompt and
    the tokens fed: every logit within `tol` of the largest.  float32:
    the same sums in another order (the scan blocked at 128 against the
    reference's 64, grouped products against an expert loop), 1e-6 read;
    bf16: the served dtype's rounding over five layers, 1-2% read (this
    seed's routing flips no choice)."""
    from repro_torch.models import lm_decode_step, lm_prefill

    cfg = config(dtype)
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


def test_reference_scan_is_the_recurrence():
    """The reference's blocked scan against the step-by-step recurrence,
    across block edges, in float64."""
    ref = family.reference
    gen = torch.Generator().manual_seed(0)
    T, H, P, G, N = 150, 4, 3, 2, 5
    x = torch.randn(T, H, P, generator=gen, dtype=torch.float64)
    dt = torch.rand(T, H, generator=gen, dtype=torch.float64) * 0.3
    A = -torch.rand(H, generator=gen, dtype=torch.float64) * 8
    B = torch.randn(T, G, N, generator=gen, dtype=torch.float64)
    C = torch.randn(T, G, N, generator=gen, dtype=torch.float64)
    h = torch.zeros(H, N, P, dtype=torch.float64)
    want = torch.empty_like(x)
    for t in range(T):
        g = torch.arange(H) // (H // G)
        h = h * torch.exp(A * dt[t])[:, None, None] + \
            dt[t][:, None, None] * B[t, g][:, :, None] * x[t][:, None, :]
        want[t] = torch.einsum("hn,hnp->hp", C[t, g], h)
    torch.testing.assert_close(ref.scan(x, dt, A, B, C), want, rtol=1e-10,
                               atol=1e-10)


def cell_dir(tmp_path):
    """The small cell, every request of a batch checked, and readers of
    its traced ops' calls."""
    here, spec, name = tiny.bench_dir(
        tmp_path, cfg=config(), limits=LIMITS,
        mix=dict(tiny.MIX, check_requests=1000))
    for op in ("grouped_experts", "ssd"):
        (here / "metrics" / f"{op}_calls.py").write_text(
            "def read(run):\n"
            "    calls = None if run.trace is None else \\\n"
            f"        run.trace.calls.get({op!r})\n"
            "    return len(calls) if calls else None\n")
        spec["per_layer"].append(dict(
            name=f"{op}_calls", unit="calls", better="higher",
            source="device_trace", layer="models", moves="ttft_mean_ms",
            workloads=[name]))
    return here, spec, name


@pytest.mark.parametrize("traced", [False, True])
def test_small_cell_runs(tmp_path, traced):
    from repro_torch import spans

    here, spec, name = cell_dir(tmp_path)
    spans.clear()
    line = bench.run(spec, name, 2**31 + 93, 5.0 if traced else 1.0, traced,
                     CPU, time.perf_counter(), here=here)
    json.dumps(line)
    assert line["correct"] is True, line["compared"]
    assert set(line["compared"]) == {
        "logit_err", "route_margin", "row_errors", "token_mismatches",
        "requests_checked"}
    if traced:
        assert line["metrics"]["grouped_experts_calls"]["value"] > 0
        # one scan a Mamba-2 layer, in the prefill only
        assert line["metrics"]["ssd_calls"]["value"] == 4
        names = {r.name for r in spans.records()}
        assert {"repro_torch.lm.ssm", "repro_torch.lm.moe",
                "repro_torch.moe.route"} <= names
    spans.clear()


def test_small_cell_calibrates(tmp_path):
    """Sound seeds correct, the float8 control not, each limited number
    read on both sides of its limit."""
    here, spec, name = cell_dir(tmp_path)
    summary = calibrate.readings(bench.cell(spec, name, here), CPU,
                                 [0, 1, 6], [100, 102])
    assert summary["sound_not_correct"] == []
    assert summary["control_correct"] == []
    for num, lim in LIMITS.items():
        assert summary[num]["lower"] < lim < summary[num]["upper"], num


def test_roofline_reads_the_experts_work():
    call = dict(T=64, d=64, E=8, k=2, f=32, elt=2)
    t = trace.Trace({}, [], calls={"grouped_experts": [
        trace.Call("grouped_experts", call, device_s=1e-3)]},
        work={"grouped_experts": family.experts_work})
    flops, nbytes = family.experts_work(call)
    assert flops == 2 * 64 * 2 * 3 * 64 * 32
    assert nbytes == (3 * 2 * 64 * 32 + 2 * 64 * 64) * 2
    assert t.roofline("grouped_experts") == \
        pytest.approx(100 * yardstick.bound(flops, nbytes)[0] / 1e-3)


def test_reference_loads_nothing_of_the_port():
    names = _top_level(
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(tiny.ROOT)!r}]\n"
        "importlib.import_module("
        "'h100_bench.reference.granitemoehybrid')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & {"repro_torch", "repro", "jax", "jaxlib"}, names
