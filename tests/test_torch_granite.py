"""The port's pieces for granite-4.0-h-small on the CPU: the config and
its port-only registry table, the dropless MoE (grouped products over
the experts' own rows) against the capacity path where nothing drops,
the ungated shared expert, the `ssm_ffn` layer kind, the spans and the
counter of the new sites, the graph rule, and the defaults: a model of
a config without the new fields runs the ops it ran before, and one with
them at their defaults gives the same bits.  The model against the
plain reference is `h100_bench/tests/test_h100_bench_granite.py`."""

from __future__ import annotations

import dataclasses
import hashlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import spans
from repro_torch.configs import PORT_ONLY, REGISTRY, get, reduced
from repro_torch.configs.base import (ArchConfig, MoEConfig, PortArchConfig,
                                      PortMoEConfig, RunConfig, SSM_FFN)
from repro_torch.models import LM, lm_decode_step, lm_prefill
from repro_torch.models.moe import MoE, moe_dispatch_compute, moe_forward

GRANITE = "granite-4.0-h-small"
# (aten ops, sha256 of their names in order) of one prefill of (2, 20)
# tokens into caches of 32 rows and one decode step, each reduced config
# in fp32 on the CPU, read at the parent of the change that added the
# new fields: a default config runs what it ran before
OPS_BEFORE = {"gemma2-2b": (658, "8051c422112c77a7"),
              "qwen2-moe-a2.7b": (941, "7a589f6912ceec52"),
              "mamba2-1.3b": (541, "450f522ce429d8cf"),
              "hymba-1.5b": (1118, "5d6c2fb616fb1b7e"),
              "internlm2-20b": (573, "19e7312484867e76")}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


def _tokens(cfg, B=2, S=20):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))


def _serve(model, tokens):
    """Prefill into caches of 32 rows and one decode step: (prefill
    logits, decode logits)."""
    logits, caches = lm_prefill(model, tokens, max_len=32)
    step, _ = lm_decode_step(model, caches, tokens[:, :1], tokens.shape[1])
    return logits, step


def _model(cfg, seed=3):
    return LM(cfg, RunConfig(dtype="float32"), seed=seed, device="cpu")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_granite_config():
    cfg = get(GRANITE)
    assert GRANITE in PORT_ONLY and GRANITE not in REGISTRY
    assert isinstance(cfg, PortArchConfig)
    assert [i for i, k in enumerate(cfg.layer_kinds) if k != SSM_FFN] == \
        [5, 15, 25, 35]
    assert (cfg.norm_eps, cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_divisor) == (1e-5, 12.0, 0.22, 16.0)
    assert cfg.moe.dropless and not cfg.moe.shared_gate
    assert (cfg.rope_fraction, cfg.query_scale) == (0.0, 1 / 128)
    assert cfg.padded_vocab == cfg.vocab_size == 100_352
    with torch.device("meta"):
        model = LM(cfg, device="meta", init=False)
    n = sum(p.numel() for p in model.parameters())
    assert n == 32_207_337_984                  # 64.4 GB in bf16
    assert not any("shared_gate" in name for name, _ in
                   model.named_parameters())
    with pytest.raises(KeyError):
        get("granite-4.0-h-tiny")


def test_new_fields_are_not_the_references():
    """The reference's dataclasses have no such fields: `ArchConfig` and
    `MoEConfig` keep theirs one for one; `ArchConfig` holds the new ones
    as class attributes of today's behaviour, and `models.moe.dropless`
    and `shared_gated` read today's behaviour off a `MoEConfig`."""
    from repro_torch.models.moe import dropless, shared_gated

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    assert not names & {"norm_eps", "embedding_multiplier",
                        "residual_multiplier", "logits_divisor"}
    assert {f.name for f in dataclasses.fields(MoEConfig)}.isdisjoint(
        {"dropless", "shared_gate"})
    base = get("internlm2-20b")
    assert (base.norm_eps, base.embedding_multiplier,
            base.residual_multiplier, base.logits_divisor) == \
        (1e-6, 0.0, 1.0, 1.0)
    qwen = get("qwen2-moe-a2.7b").moe
    assert type(qwen) is MoEConfig and not hasattr(qwen, "dropless")
    assert not dropless(qwen) and shared_gated(qwen)
    granite = get(GRANITE).moe
    assert dropless(granite) and not shared_gated(granite)


@pytest.mark.parametrize("arch", sorted(OPS_BEFORE))
def test_defaults_run_the_ops_they_ran(arch, one_thread):
    cfg = reduced(get(arch))
    model, tokens = _model(cfg), _tokens(cfg)
    with _Ops() as log:
        _serve(model, tokens)
    digest = hashlib.sha256(" ".join(log.ops).encode()).hexdigest()[:16]
    assert (len(log.ops), digest) == OPS_BEFORE[arch]


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b",
                                  "hymba-1.5b"])
def test_defaults_give_the_same_bits(arch, one_thread):
    """A config carrying the new fields at their defaults serves the
    same bits as the config without them."""
    cfg = reduced(get(arch))
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        kw["moe"] = PortMoEConfig(**dataclasses.asdict(cfg.moe))
    port = PortArchConfig(**kw)
    tokens = _tokens(cfg)
    for a, b in zip(_serve(_model(cfg), tokens), _serve(_model(port),
                                                        tokens)):
        assert torch.equal(a, b)


def _moe_layer(dtype):
    cfg = reduced(get(GRANITE))
    torch.manual_seed(0)
    p = MoE(cfg, dtype, torch.device("cpu"))
    with torch.no_grad():
        for w in p.parameters():
            w.normal_(0.0, 0.1)
    return cfg, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [3, 50])
def test_dropless_equals_the_capacity_path(dtype, T, one_thread):
    """At a capacity factor of E / k the capacity path drops nothing and
    runs the experts over a padded (E, C, d) buffer; the dropless path
    runs each expert over its own rows by grouped products.  The same
    products; the combines differ in order and rounding (the capacity
    path adds a token's k outputs by ascending expert id, each product
    and each add rounded; the dropless one sums them in one batched
    product, fp32 accumulation and one rounding): within fp32's rounding
    of such a sum (3e-7 of 1.4 read), or a bf16 ulp of the output
    (0.016 of 3.45 read).  The load-balancing
    loss is the same, with autograd on; off (serving) the dropless path
    skips it.  T 3 has fewer pairs than experts."""
    cfg, p = _moe_layer(dtype)
    mc = cfg.moe
    capacity = MoEConfig(**{f.name: getattr(mc, f.name)
                            for f in dataclasses.fields(MoEConfig)})
    capacity = dataclasses.replace(
        capacity, capacity_factor=mc.n_experts / mc.top_k)
    x = torch.randn(T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(T)).to(dtype)
    y, aux, dropped = moe_dispatch_compute(p, x, mc, "silu", dtype=dtype)
    y_cap, aux_cap, dropped_cap = moe_dispatch_compute(
        p, x, capacity, "silu", dtype=dtype)
    assert float(dropped) == float(dropped_cap) == 0.0
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y, y_cap, rtol=tol, atol=tol)
    assert torch.equal(aux, aux_cap)
    with torch.no_grad():
        y_off, aux_off, _ = moe_dispatch_compute(p, x, mc, "silu",
                                                 dtype=dtype)
    assert torch.equal(y_off, y) and float(aux_off) == 0.0


def test_dropless_keeps_pairs_the_capacity_path_drops(one_thread):
    """Every token to the same k experts: at a capacity factor of 1.25 the
    capacity path drops pairs, the dropless one keeps them all and
    equals the plain sum over each token's k experts."""
    cfg, p = _moe_layer(torch.float32)
    mc = cfg.moe
    with torch.no_grad():
        p.router.zero_()
        p.router[:, :mc.top_k] = 1.0            # every token to experts 0, 1
        x = torch.rand(64, cfg.d_model, generator=torch.Generator()
                       .manual_seed(2)) + 0.5
        y, _, dropped = moe_dispatch_compute(p, x, mc, "silu")
        capacity = dataclasses.replace(
            MoEConfig(**{f.name: getattr(mc, f.name)
                         for f in dataclasses.fields(MoEConfig)}),
            capacity_factor=1.25)
        _, _, dropped_cap = moe_dispatch_compute(p, x, capacity, "silu")
        gates = torch.softmax(x @ p.router[:, :mc.top_k], -1)
        want = sum(gates[:, e, None] * (
            torch.nn.functional.silu(x @ p.w_gate[e]) * (x @ p.w_up[e]))
            @ p.w_down[e] for e in range(mc.top_k))
    assert float(dropped) == 0.0 < float(dropped_cap)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_ungated_shared_expert(one_thread):
    """`shared_gate=False`: no gate weight, and the shared MLP's output
    added as it is."""
    from repro_torch.models.ffn import ffn_forward

    cfg, p = _moe_layer(torch.float32)
    assert not hasattr(p, "shared_gate")
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        y, _ = moe_forward(p, x, cfg)
        routed, _, _ = moe_dispatch_compute(p, x.reshape(10, -1), cfg.moe,
                                            "silu", dtype=torch.float32)
    assert torch.equal(y, routed.reshape(x.shape) + ffn_forward(p.shared, x))


def test_granite_spans_and_counter(one_thread):
    """Under `spans.recording()` each mixer call is a span `lm.ssm` (B,
    S, H, N, P), each MoE call a span `lm.moe` (T, E, k) and a counter
    `moe.route` (pairs, and where each expert's pairs end, from which the
    busiest expert's pairs and the experts given any follow); off,
    nothing is recorded."""
    cfg = reduced(get(GRANITE), n_layers=3)
    model = _model(cfg)
    tokens = _tokens(cfg)
    spans.clear()
    _serve(model, tokens)
    assert spans.records() == []
    with spans.recording():
        _serve(model, tokens)
    recs = spans.records()
    ssm = [r for r in recs if r.name == "repro_torch.lm.ssm"]
    moe = [r for r in recs if r.name == "repro_torch.lm.moe"]
    route = [r for r in recs if r.name == "repro_torch.moe.route"]
    mixers = sum(k == SSM_FFN for k in cfg.layer_kinds)
    assert len(ssm) == 2 * mixers and len(moe) == len(route) == 2 * 3
    assert ssm[0].attrs == dict(B=2, S=20, H=16, N=32, P=16)
    assert ssm[-1].attrs["S"] == 1
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    assert moe[0].attrs == dict(T=40, E=E, k=k)
    for r in route:
        a = r.attrs
        assert a["pairs"] in (40 * k, 2 * k)
        ends = a["ends"]
        assert isinstance(ends, list) and len(ends) == E
        assert all(isinstance(v, int) for v in ends)
        load = [b - a for a, b in zip([0] + ends, ends)]
        assert min(load) >= 0 and ends[-1] == a["pairs"]
        assert -(-a["pairs"] // E) <= max(load) <= a["pairs"] // k
    spans.clear()


def test_route_counter_keeps_the_ends_it_is_given(one_thread):
    """`moe.route` runs no op of its own: it keeps the grouped products'
    `expert_ends` tensor, read by `spans.records()` as each expert's
    cumulative pairs, equal to a count of the routing's pairs."""
    from repro_torch.models.moe import _count_route, expert_ends, route

    cfg = reduced(get(GRANITE), n_layers=1)
    mc = cfg.moe
    gen = torch.Generator().manual_seed(5)
    router = torch.randn(cfg.d_model, mc.n_experts, generator=gen)
    x2 = torch.randn(37, cfg.d_model, generator=gen)
    r = route(router, x2, mc)
    ends = expert_ends(r, mc.n_experts)
    spans.clear()
    with spans.recording(), _Ops() as seen:
        _count_route(r, ends)
    assert seen.ops == []
    (rec,) = spans.records()
    spans.clear()
    want = torch.bincount(r.expert_idx.reshape(-1),
                          minlength=mc.n_experts).cumsum(0)
    assert rec.attrs == dict(pairs=37 * mc.top_k, ends=want.tolist())


def test_granite_decode_stays_eager(monkeypatch):
    """`decode_graphs_fit` keeps a model of `ssm_ffn` layers and MoEs
    eager, on the card as well (its device property patched)."""
    from repro_torch.serve import decode_graphs_fit

    model = _model(reduced(get(GRANITE)))
    monkeypatch.setattr(LM, "device", property(
        lambda self: torch.device("cuda")))
    assert decode_graphs_fit(model) is False
