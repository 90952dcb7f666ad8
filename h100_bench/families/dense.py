"""The dense decoder family (InternLM2 and its kin): causal GQA under
RoPE and a SwiGLU FFN in every layer, an untied head.  Its serving path
launches the flash and decode attention kernels; it traces no op beyond
`trace.OPS` and follows no choice."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from h100_bench.reference import dense as reference  # noqa: F401

# what the reference computes and the program must not depart from
PLAIN = dict(attn_softcap=0.0, final_softcap=0.0, qkv_bias=False,
             rope_fraction=1.0, query_scale=None, post_block_norm=False,
             tie_embeddings=False, act="silu", moe=None, encoder=None,
             vision=None)
RMS_NORM_EPS = 1e-6              # the port's `models.common.rmsnorm`
OPS: Dict = {}
FOLLOW = None


def arch_config(cfg: Dict):
    """The program's `ArchConfig` of the registry entry the file names,
    with every shape the file gives; raises where the program would run
    something the file and the reference do not say."""
    # imported here: the flop count below reads nothing of the program
    from repro_torch.configs import get

    base = get(cfg["registry"])
    kw = dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
              n_heads=cfg["num_attention_heads"],
              n_kv_heads=cfg["num_key_value_heads"],
              head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"],
              vocab_size=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
              window=cfg.get("sliding_window", 0))
    arch = dataclasses.replace(base, **kw)
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
    """The CUDA sources the configuration's serving path launches."""
    return ("flash_attention", "decode_attention")


def attention_layers(cfg: Dict) -> Tuple[int, int]:
    """(full-attention layers, windowed layers)."""
    n = cfg["num_hidden_layers"]
    if cfg.get("sliding_window", 0) <= 0:
        return n, 0
    full = len(cfg.get("full_attention_layers") or [])
    return full, n - full


def matmul_params(cfg: Dict) -> int:
    """Weights of the products one token goes through, every layer, the
    unembedding left out."""
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    layer = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    layer += 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * layer
