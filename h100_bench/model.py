"""The system under test, built from a configuration file: the program's
`LM` at the file's shapes, its parameters the harness's weights, behind
a `ServeEngine`."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs import get
from repro_torch.configs.base import RunConfig
from repro_torch.models import LM

# what the references compute and the program must not depart from
PLAIN = dict(attn_softcap=0.0, final_softcap=0.0, qkv_bias=False,
             rope_fraction=1.0, query_scale=None, post_block_norm=False,
             tie_embeddings=False, act="silu", moe=None, encoder=None,
             vision=None)
RMS_NORM_EPS = 1e-6              # the port's `models.common.rmsnorm`


def reference(cfg: Dict):
    """The plain forward of the configuration's family."""
    return importlib.import_module(f"h100_bench.reference.{cfg['family']}")


def arch_config(cfg: Dict):
    """The program's `ArchConfig` of the registry entry the file names,
    with every shape the file gives; raises where the program would run
    something the file and the reference do not say."""
    base = get(cfg["registry"])
    kw = dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
              n_heads=cfg["num_attention_heads"],
              n_kv_heads=cfg["num_key_value_heads"],
              head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"],
              vocab_size=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
              window=cfg.get("sliding_window", 0))
    if cfg["family"] != "dense":
        raise ValueError(f"{cfg['name']}: no harness path for family "
                         f"{cfg['family']!r}")
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


def build(cfg: Dict, weights: Dict[str, torch.Tensor],
          device: torch.device) -> LM:
    """`LM` at the file's shapes whose parameters are `weights` (the same
    tensors, not copies); raises unless the names and shapes agree."""
    with torch.device("meta"):
        model = LM(arch_config(cfg), RunConfig(dtype=cfg["dtype"]),
                   device="meta", init=False)
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(w.shape) for n, w in weights.items()}
    if have != want:
        raise ValueError(f"{cfg['name']}: the program's parameters differ "
                         f"from the reference's layout: "
                         f"{sorted(set(have.items()) ^ set(want.items()))[:6]}")
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            w = weights[f"{mod_name}.{pname}" if mod_name else pname]
            if w.dtype != p.dtype:
                raise ValueError(f"{mod_name}.{pname}: {w.dtype} where the "
                                 f"program stores {p.dtype}")
            mod._parameters[pname] = nn.Parameter(w, requires_grad=False)
    if model.device != device:
        raise ValueError(f"weights on {model.device}, not {device}")
    return model


def served_dtype(cfg: Dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["dtype"]]


def kernels(cfg: Dict) -> Tuple[str, ...]:
    """The CUDA sources the configuration's serving path launches."""
    return ("flash_attention", "decode_attention")
