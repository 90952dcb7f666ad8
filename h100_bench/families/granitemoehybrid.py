"""The Granite 4.0-H family (`model_type` granitemoehybrid): Mamba-2
mixers and NoPE attention, each followed by a dropless top-k MoE and an
ungated shared MLP, µP multipliers and a tied head.  Its serving path
launches the flash, decode and SSD kernels; it traces the dropless
experts (`models.moe.grouped_experts`) and follows the router's top-k
(`models.moe.route`)."""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, Tuple

from h100_bench.families import Choice
from h100_bench.reference import granitemoehybrid as reference  # noqa: F401

# the SSD's chunk: at N 128 and P 64 no route of the port's kernel holds
# the published 256; the chunk blocks the scan and leaves its sums as
# they are
SSD_CHUNK = 128
# what the file must say for the reference to compute what the program
# runs: {key: value}
PLAIN = dict(hidden_act="silu", attention_bias=False, mamba_conv_bias=True,
             mamba_proj_bias=False, normalization_function="rmsnorm",
             position_embedding_type="nope", rope_scaling=None,
             tie_word_embeddings=True)
# what the program must run for the reference to compute it
PORT = dict(window=0, attn_softcap=0.0, final_softcap=0.0, qkv_bias=False,
            rope_fraction=0.0, post_block_norm=False, tie_embeddings=True,
            act="silu", encoder=None, vision=None)
KINDS = {"mamba": "ssm_ffn", "attention": "attn_full"}


def arch_config(cfg: Dict):
    """The program's `ArchConfig` of the registry entry the file names,
    with every shape and multiplier the file gives; raises where the
    program would run something the file and the reference do not
    say."""
    from repro_torch.configs import get

    for key, want in PLAIN.items():
        if cfg.get(key) != want:
            raise ValueError(f"{cfg['name']}: {key} {cfg.get(key)!r}; the "
                             f"reference computes {want!r}")
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    if cfg["mamba_expand"] * cfg["hidden_size"] != H * P:
        raise ValueError(f"{cfg['name']}: an inner width of {H} x {P} "
                         f"heads that is not mamba_expand x hidden_size")
    if cfg["hidden_size"] != cfg["num_attention_heads"] * cfg["head_dim"]:
        raise ValueError(f"{cfg['name']}: head_dim x heads is not "
                         f"hidden_size")
    base = get(cfg["registry"])
    moe = dataclasses.replace(
        base.moe, n_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"],
        d_ff_expert=cfg["intermediate_size"], n_shared_experts=1,
        d_ff_shared=cfg["shared_intermediate_size"])
    ssm = dataclasses.replace(
        base.ssm, d_state=cfg["mamba_d_state"], head_dim=P, n_heads=H,
        n_groups=cfg["mamba_n_groups"], expand=cfg["mamba_expand"],
        conv_kernel=cfg["mamba_d_conv"], chunk=SSD_CHUNK)
    arch = dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        query_scale=cfg["attention_multiplier"],
        layer_pattern=tuple(((KINDS[t],), 1) for t in cfg["layer_types"]),
        moe=moe, ssm=ssm, norm_eps=cfg["rms_norm_eps"],
        embedding_multiplier=cfg["embedding_multiplier"],
        residual_multiplier=cfg["residual_multiplier"],
        logits_divisor=cfg["logits_scaling"])
    arch.validate()
    for key, want in PORT.items():
        if getattr(arch, key) != want:
            raise ValueError(f"{cfg['name']}: the program's {key} is "
                             f"{getattr(arch, key)!r}, which the reference "
                             f"does not compute")
    if not (arch.moe.dropless and not arch.moe.shared_gate):
        raise ValueError(f"{cfg['name']}: the program's MoE drops pairs or "
                         f"gates its shared MLP; the reference does neither")
    return arch


def kernels(cfg: Dict) -> Tuple[str, ...]:
    """The CUDA sources the configuration's serving path launches."""
    return ("flash_attention", "decode_attention", "ssd")


def attention_layers(cfg: Dict) -> Tuple[int, int]:
    """(full-attention layers, windowed layers)."""
    return cfg["layer_types"].count("attention"), 0


def matmul_params(cfg: Dict) -> int:
    """Weights of the products one token goes through, every layer, the
    unembedding left out: the mixer (in_proj and out_proj of a Mamba-2
    layer, q, k, v and o of an attention layer), the router, the k
    experts it picks and the shared MLP."""
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    GN = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    mamba = d * (2 * H * P + 2 * GN + H) + H * P * d
    attention = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    ffn = d * cfg["num_local_experts"] + \
        3 * d * cfg["intermediate_size"] * cfg["num_experts_per_tok"] + \
        3 * d * cfg["shared_intermediate_size"]
    return sum((mamba if t == "mamba" else attention) + ffn
               for t in cfg["layer_types"])


def _experts_args(args, kw) -> Dict:
    p, x2, r = args[0], args[1], args[2]
    E, d, f = p.w_gate.shape
    return dict(T=x2.shape[0], d=d, E=E, k=r.expert_idx.shape[1], f=f,
                elt=x2.element_size())


def experts_work(call: Dict) -> Tuple[float, float]:
    """The routed experts' three products of T tokens, each sent to k
    experts: 2 flops a weight a (token, expert) pair; the weights of k
    experts (the fewest any routing reads: each token's k are distinct)
    and the token rows read and written once."""
    T, d, k, f = (call[x] for x in ("T", "d", "k", "f"))
    flops = 6 * T * k * d * f
    nbytes = (3 * k * d * f + 2 * T * d) * call["elt"]
    return flops, nbytes


OPS = {"grouped_experts": ("repro_torch.models.moe", _experts_args,
                           experts_work)}
FOLLOW = Choice(module="repro_torch.models.moe", fn="route",
                keep=operator.attrgetter("expert_idx"),
                shape=lambda cfg: (cfg["num_hidden_layers"],
                                   cfg["num_experts_per_tok"]),
                name="route")
