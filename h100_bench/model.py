"""The system under test, built from a configuration file: the program's
`LM` at the file's shapes, its `ArchConfig` the family module's, its
parameters the harness's weights."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from h100_bench import families
from repro_torch.configs.base import RunConfig
from repro_torch.models import LM


def build(cfg: Dict, weights: Dict[str, torch.Tensor],
          device: torch.device) -> LM:
    """`LM` at the file's shapes whose parameters are `weights` (the same
    tensors, not copies); raises unless the names and shapes agree."""
    with torch.device("meta"):
        model = LM(families.of(cfg).arch_config(cfg),
                   RunConfig(dtype=cfg["dtype"]), device="meta", init=False)
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
