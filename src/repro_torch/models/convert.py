"""Weights from the reference: the JAX parameter tree, as nested dicts and
lists of numpy arrays, into the port's `LM` or `EncDec`.

The reference stacks the layers of each segment ((kinds...), repeat) along
a leading axis of length `repeat`, one stack per kind; the port keeps one
module per layer in the order they run, segment by segment, repeat by
repeat, kind by kind (gemma2: swa[0], full[0], swa[1], ...).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from .encdec import EncDec
from .lm import LM

# reference path inside one layer's tree → the port's parameter name
_LAYER_LEAVES = {
    ("ln1", "scale"): "ln1",
    ("ln2", "scale"): "ln2",
    ("post_ln1", "scale"): "post_ln1",
    ("post_ln2", "scale"): "post_ln2",
    ("attn_out_norm", "scale"): "attn_out_norm",
    ("ssm_out_norm", "scale"): "ssm_out_norm",
    ("attn", "wq", "kernel"): "attn.wq",
    ("attn", "wk", "kernel"): "attn.wk",
    ("attn", "wv", "kernel"): "attn.wv",
    ("attn", "wo", "kernel"): "attn.wo",
    ("attn", "wq", "bias"): "attn.bq",
    ("attn", "wk", "bias"): "attn.bk",
    ("attn", "wv", "bias"): "attn.bv",
    ("ffn", "w_gate", "kernel"): "ffn.w_gate",
    ("ffn", "w_up", "kernel"): "ffn.w_up",
    ("ffn", "w_down", "kernel"): "ffn.w_down",
    ("moe", "router", "kernel"): "moe.router",
    ("moe", "w_gate"): "moe.w_gate",
    ("moe", "w_up"): "moe.w_up",
    ("moe", "w_down"): "moe.w_down",
    ("moe", "shared", "w_gate", "kernel"): "moe.shared.w_gate",
    ("moe", "shared", "w_up", "kernel"): "moe.shared.w_up",
    ("moe", "shared", "w_down", "kernel"): "moe.shared.w_down",
    ("moe", "shared_gate", "kernel"): "moe.shared_gate",
    ("ssm", "in_proj", "kernel"): "ssm.in_proj",
    ("ssm", "out_proj", "kernel"): "ssm.out_proj",
    ("ssm", "conv_w"): "ssm.conv_w",
    ("ssm", "conv_b"): "ssm.conv_b",
    ("ssm", "A_log"): "ssm.A_log",
    ("ssm", "D"): "ssm.D",
    ("ssm", "dt_bias"): "ssm.dt_bias",
    ("ssm", "gate_norm", "scale"): "ssm.gate_norm",
}


def _encdec_leaf(path: tuple) -> str:
    """A reference encoder-decoder layer's leaf path → the port's name:
    ("cross_attn", "wq", "kernel") → "cross_attn.wq", ("ln1", "scale") →
    "ln1", ("attn", "wk", "bias") → "attn.bk"."""
    if path[-1] == "bias":
        return ".".join(path[:-2] + ("b" + path[-2][1:],))
    if path[-1] in ("kernel", "scale"):
        path = path[:-1]
    return ".".join(path)


def _flatten(tree: Dict[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


@torch.no_grad()
def lm_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                  rcfg: RunConfig = RunConfig(dtype="float32"),
                  device: Union[str, torch.device, None] = None,
                  param_dtype: Optional[torch.dtype] = None) -> LM:
    """Build the port's LM holding the reference tree's weights, stored
    in `param_dtype` (the compute dtype when None): with fp32 storage the
    reference's fp32 leaves are copied without rounding."""
    model = LM(cfg, rcfg, device=device, init=False,
               param_dtype=param_dtype)
    params = dict(model.named_parameters())

    def put(name: str, arr: np.ndarray) -> None:
        if name not in params:
            raise ValueError(f"{name}: the port's {cfg.name} has no such "
                             f"parameter")
        p = params.pop(name)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(arr, dtype=torch.float32))

    top = set(tree) - {"embed", "final_norm", "lm_head", "vision_proj",
                       "segments"}
    if top:
        raise ValueError(f"unported parameters {sorted(top)}")
    put("embed", tree["embed"]["table"])
    put("final_norm", tree["final_norm"]["scale"])
    for name in ("lm_head", "vision_proj"):
        if name in tree:
            put(name, tree[name]["kernel"])
    layer = 0
    for (kinds, rep), seg in zip(cfg.pattern, tree["segments"]):
        for r in range(rep):
            for stack in seg:
                leaves = _flatten(stack)
                unknown = set(leaves) - set(_LAYER_LEAVES)
                if unknown:
                    raise ValueError(f"unported parameters {sorted(unknown)}")
                for path, arr in leaves.items():
                    put(f"layers.{layer}.{_LAYER_LEAVES[path]}", arr[r])
                layer += 1
    if params:
        raise ValueError(f"reference tree lacks {sorted(params)}")
    return model


@torch.no_grad()
def encdec_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                      rcfg: RunConfig = RunConfig(dtype="float32"),
                      device: Union[str, torch.device, None] = None,
                      param_dtype: Optional[torch.dtype] = None
                      ) -> EncDec:
    """Build the port's EncDec holding the reference `init_encdec` tree's
    weights: the stacked `enc_layers` / `dec_layers` leaves, unstacked
    into the module's layers, stored as `lm_from_numpy` stores them."""
    model = EncDec(cfg, rcfg, device=device, init=False,
                   param_dtype=param_dtype)
    params = dict(model.named_parameters())
    top = set(tree) - {"embed", "enc_layers", "dec_layers", "enc_norm",
                       "final_norm", "lm_head"}
    if top:
        raise ValueError(f"unported parameters {sorted(top)}")
    named = {"embed": tree["embed"]["table"],
             "enc_norm": tree["enc_norm"]["scale"],
             "final_norm": tree["final_norm"]["scale"],
             "lm_head": tree["lm_head"]["kernel"]}
    for stack, n in (("enc_layers", cfg.encoder.n_layers),
                     ("dec_layers", cfg.n_layers)):
        for path, arr in _flatten(tree[stack]).items():
            if arr.shape[0] != n:
                raise ValueError(f"{stack}{list(path)}: {arr.shape[0]} "
                                 f"layers stacked, want {n}")
            for i in range(n):
                named[f"{stack}.{i}.{_encdec_leaf(path)}"] = arr[i]
    for name, arr in named.items():
        if name not in params:
            raise ValueError(f"{name}: the port's {cfg.name} has no such "
                             f"parameter")
        p = params.pop(name)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(np.asarray(arr), dtype=torch.float32))
    if params:
        raise ValueError(f"reference tree lacks {sorted(params)}")
    return model
