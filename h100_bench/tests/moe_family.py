"""A second model family for the CPU tests, made of files under
`h100_bench/tests/` alone: the port's MoE FFN in every layer, routed
top-k with every pair kept, and a tied head.  It departs from the dense
family in every hook: a field the dense family refuses (the tied head),
its own flop count, a traced op (`moe_dispatch_compute`) and a followed
choice (the router's top-k, `models.moe.route`).  Its kernels are the
dense family's two attention sources: the port's MoE runs its experts
on cuBLAS.  A configuration names it by its module,
`"family": "h100_bench.tests.moe_family"`."""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, Tuple

from h100_bench.families import Choice, dense
from h100_bench.tests import moe_reference as reference  # noqa: F401

PLAIN = {**{k: v for k, v in dense.PLAIN.items() if k != "moe"},
         "tie_embeddings": True}
RMS_NORM_EPS = dense.RMS_NORM_EPS


def arch_config(cfg: Dict):
    """The registry entry's `ArchConfig` with the file's shapes and
    experts, at the capacity factor E / k, at which no pair is dropped
    (the capacity is at least the tokens routed): the reference drops
    none."""
    from repro_torch.configs import get
    from repro_torch.configs.base import MoEConfig

    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    moe = MoEConfig(n_experts=E, top_k=k,
                    d_ff_expert=cfg["moe_intermediate_size"],
                    n_shared_experts=1,
                    d_ff_shared=cfg["shared_expert_intermediate_size"],
                    capacity_factor=E / k)
    arch = dataclasses.replace(
        get(cfg["registry"]), n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], window=cfg.get("sliding_window", 0),
        tie_embeddings=cfg["tie_word_embeddings"], moe=moe)
    arch.validate()
    for key, want in PLAIN.items():
        if getattr(arch, key) != want:
            raise ValueError(f"{cfg['name']}: the program's {key} is "
                             f"{getattr(arch, key)!r}, which the reference "
                             f"does not compute")
    if cfg["rms_norm_eps"] != RMS_NORM_EPS:
        raise ValueError(f"{cfg['name']}: the program's norms take eps "
                         f"{RMS_NORM_EPS}")
    return arch


def kernels(cfg: Dict) -> Tuple[str, ...]:
    return ("flash_attention", "decode_attention")


def attention_layers(cfg: Dict) -> Tuple[int, int]:
    return cfg["num_hidden_layers"], 0


def matmul_params(cfg: Dict) -> int:
    """Attention, the router, the k routed experts a token goes through,
    the shared expert and its gate, every layer."""
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    layer = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    layer += d * cfg["num_local_experts"]
    layer += 3 * d * cfg["moe_intermediate_size"] * \
        cfg["num_experts_per_tok"]
    layer += 3 * d * cfg["shared_expert_intermediate_size"] + d
    return cfg["num_hidden_layers"] * layer


def _dispatch_args(args, kw) -> Dict:
    p, x2, mc = args[0], args[1], args[2]
    return dict(T=x2.shape[0], d=x2.shape[1], E=mc.n_experts, k=mc.top_k,
                f=p.w_gate.shape[-1], elt=x2.element_size())


def dispatch_work(call: Dict) -> Tuple[float, float]:
    """The router and the routed experts' three products of T tokens,
    2 flops a weight a pair; the router and k experts' weights read (the
    fewest any routing reads), the tokens read and written once."""
    T, d, E, k, f = (call[x] for x in ("T", "d", "E", "k", "f"))
    flops = 2 * T * d * E + 6 * T * k * d * f
    nbytes = (d * E + 3 * k * d * f + 2 * T * d) * call["elt"]
    return flops, nbytes


OPS = {"moe_dispatch_compute": ("repro_torch.models.moe", _dispatch_args,
                                dispatch_work)}
FOLLOW = Choice(module="repro_torch.models.moe", fn="route",
                keep=operator.attrgetter("expert_idx"),
                shape=lambda cfg: (cfg["num_hidden_layers"],
                                   cfg["num_experts_per_tok"]),
                name="route")
