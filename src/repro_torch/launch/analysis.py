"""A cell's cost per rank and its roofline terms on the H100 (the port's
twin of `repro.launch.analysis`).

`analyze_cell` is the twin of `analyze_compiled`: flops, bytes,
transcendentals and collective bytes come from `launch.hlo_cost`'s count
of one call of the cell's step, every number per rank.

Roofline terms (one NVIDIA H100 SXM a rank):
  compute    = FLOPs / 989e12 bf16 FLOP/s (dense tensor cores)
  memory     = bytes / 3.35e12 B/s HBM3
  collective = coll_bytes / 450e9 B/s NVLink 4, one direction
These are the bound terms of PERF.md §6.  A (16, 16) mesh spans 32
eight-GPU nodes: only the collectives within a node run over NVLink, and
those across nodes run at about 50 GB/s a GPU (one 400 Gb/s NDR link),
so the collective term is a lower bound.  The reference's terms are a
TPU v5e's (197 TFLOP/s, 819 GB/s, 50 GB/s ICI).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable

import torch

PEAK_FLOPS = 989e12          # bf16 per GPU, dense
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s per GPU, one direction


@dataclass
class Roofline:
    name: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float = field(init=False)
    memory_s: float = field(init=False)
    collective_s: float = field(init=False)

    def __post_init__(self) -> None:
        self.compute_s = self.flops_per_device / PEAK_FLOPS
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The largest of the three terms: the roofline's bound."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "name": self.name, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
        }


def tensors_of(tree: Any) -> Iterable[torch.Tensor]:
    """Every tensor of an argument tree: a module's parameters, the
    values of dicts, the items of lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_bytes(tree: Any) -> int:
    """The bytes on this rank of every tensor of `tree`, each storage
    once."""
    from .hlo_cost import local_nbytes

    seen, n = set(), 0
    for t in tensors_of(tree):
        key = id(t)
        if key not in seen:
            seen.add(key)
            n += local_nbytes(t)
    return n


def cell_result(name: str, mesh_desc: str, n_devices: int, totals,
                argument_bytes: float, output_bytes: float) -> Dict:
    """The reference's keys (`cost`, `cost_raw`, `memory`,
    `collectives`, `while_trips`, `roofline`) from a `CostTotals`, all
    numbers per rank.

    `cost_raw` equals `cost`: the reference's second count is XLA's
    `cost_analysis`, which counts a scanned body once; the port has no
    second count.  `memory.argument_bytes` and `output_bytes` are the
    local shards of the arguments and of the result; `temp_bytes` the
    peak of the live intermediate bytes of the call on one rank
    (`CostMode`); `generated_code_bytes` is null: eager PyTorch generates
    no program to measure."""
    rl = Roofline(name=name, mesh=mesh_desc, n_devices=n_devices,
                  flops_per_device=totals.flops,
                  bytes_per_device=totals.bytes,
                  collective_bytes_per_device=totals.total_collective_bytes)
    return {
        "name": name, "mesh": mesh_desc, "n_devices": n_devices,
        "cost": {"flops": totals.flops, "bytes_accessed": totals.bytes,
                 "transcendentals": totals.transcendentals},
        "cost_raw": {"flops": totals.flops, "bytes_accessed": totals.bytes},
        "memory": {"argument_bytes": argument_bytes,
                   "output_bytes": output_bytes,
                   "temp_bytes": totals.temp_bytes,
                   "generated_code_bytes": None},
        "collectives": {"bytes": dict(totals.collective_bytes),
                        "counts": dict(totals.collective_counts),
                        "total_bytes": totals.total_collective_bytes},
        "while_trips": list(totals.while_trips),
        "roofline": rl.as_dict(),
    }


def analyze_cell(name: str, mesh_desc: str, n_devices: int, cell,
                 args=None) -> Dict:
    """The twin of `analyze_compiled`: one call of `cell.fn` on `args`
    (the cell's own when None, e.g. distributed onto its mesh) counted
    by `launch.hlo_cost`, as `cell_result`'s dict."""
    from .hlo_cost import count_call

    args = cell.args if args is None else args
    arg_bytes = tree_bytes(args)
    out, totals, _ = count_call(cell.fn, *args)
    return cell_result(name, mesh_desc, n_devices, totals, arg_bytes,
                       tree_bytes(out))


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training;
    2·N·D for a forward-only cell (prefill), 2·N_active per decoded token."""
    n_active = active_params(cfg)
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg) -> float:
    """Active (per-token) parameter count."""
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    n = 0.0
    # embeddings (active: lookup is sparse; count unembed matmul)
    n += cfg.vocab_size * d
    if cfg.n_heads:
        attn = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh + \
            cfg.n_heads * dh * d
    else:
        attn = 0
    if cfg.moe is not None:
        mc = cfg.moe
        ffn = 3 * d * mc.d_ff_expert * mc.top_k
        if mc.n_shared_experts:
            ffn += 3 * d * mc.d_ff_shared
    else:
        ffn = 3 * d * cfg.d_ff
    ssm = 0
    if cfg.ssm is not None:
        from repro_torch.models.ssm import conv_dim, ssm_dims
        d_inner, H, Pd, G, N = ssm_dims(cfg)
        d_in_proj = 2 * d_inner + 2 * G * N + H
        ssm = d * d_in_proj + d_inner * d + \
            cfg.ssm.conv_kernel * conv_dim(cfg)
    for kinds, rep in cfg.pattern:
        for kind in kinds:
            if kind in ("attn_full", "attn_swa"):
                n += rep * (attn + ffn)
            elif kind == "ssm":
                n += rep * ssm
            else:  # hybrid
                n += rep * (attn + ssm + ffn)
    if cfg.encoder is not None:
        n += cfg.encoder.n_layers * (attn + ffn)
        n += cfg.n_layers * attn          # cross-attention
    return n
