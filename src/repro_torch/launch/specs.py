"""Input specs for every (arch × shape) cell: stand-ins and their
placements, with nothing allocated (the port of `repro.launch.specs`).

`build_cell(cfg, shape_name, mesh, rcfg)` returns a `Cell` holding the
function a cell runs and its (args, in_shardings, out_shardings).  An
argument is a tensor on the "meta" device (shape and dtype, no storage)
or a model built on it with `init=False`; a sharding is a tuple of
DTensor placements (`dist.sharding.placements`), one per mesh dim, in a
tree shaped like its argument.  `fn` is the port's step: the train step
of `make_train_step`, or `serve_step`'s prefill and decode steps around
the meta model, each given the cell's `RunConfig` (`kernels="xla"`, the
plain attention and SSD, by default, as the reference's cells).

The reference stacks each segment's layers on a leading axis; the
port's models and decode caches hold one entry a layer, so a layer's
placements are the reference's less that axis.  A decode cell's `pos`
is the Python int the port's decode step takes (the reference traces a
0-d int32), the cache's last row.

The mesh needs a process group but no devices: `fake_mesh` builds the
production (16, 16) mesh on torch's fake process group in this process
(`python -m repro_torch.launch.specs --all` lists every cell that way).
A process holds one default group, so a caller that runs NCCL builds the
cells in another process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.models import init_decode_cache, init_encdec_cache
from repro_torch.models.ssm import ssm_dims
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import (init_fn_for, init_train_state,
                                          make_train_step)

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in: a tensor of `shape` and `dtype` with no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclass
class Cell:
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any          # None → the step's own
    donate_argnums: Tuple[int, ...] = ()


def _named(mesh, spec: P) -> tuple:
    return shd.placements(mesh, spec)


def _sizes(mesh) -> Dict[str, int]:
    return dict(shd.zip_axis(mesh))


def _dp_size(mesh) -> int:
    n = 1
    for a in shd.data_axes(mesh):
        n *= _sizes(mesh)[a]
    return n


def constrain_fn(mesh, rcfg: RunConfig) -> Callable:
    """The between-blocks residual-stream constraint (SP when enabled):
    a DTensor activation redistributed to `residual_spec`'s placements,
    a plain tensor unchanged."""
    spec = shd.residual_spec(mesh, rcfg.sequence_parallel)

    def constrain(x):
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh, spec)
    return constrain


# --------------------------------------------------------------------------
# Batch specs per family
# --------------------------------------------------------------------------

def batch_structs(cfg: ArchConfig, shape: ShapeSpec, mesh
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    B, S = shape.global_batch, shape.seq_len
    dp = shd.data_axes(mesh)
    batch = {"tokens": sds((B, S), torch.int32)}
    shards = {"tokens": _named(mesh, P(dp, None))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = sds(
            (B, cfg.vision.n_patches, cfg.vision.patch_embed_dim),
            torch.float32)
        shards["patch_embeds"] = _named(mesh, P(dp, None, None))
    if cfg.family == "audio":
        enc_len = max(S // cfg.encoder.subsample, 8)
        batch = {"frames": sds((B, enc_len, cfg.d_model), torch.float32),
                 "tokens": sds((B, S), torch.int32)}
        shards = {"frames": _named(mesh, P(dp, None, None)),
                  "tokens": _named(mesh, P(dp, None))}
    return batch, shards


# --------------------------------------------------------------------------
# State / cache sharding trees
# --------------------------------------------------------------------------

def state_shardings(state, mesh) -> Dict[str, Any]:
    """A train state's placements: the parameters by `param_specs`, mu
    and nu by `moment_specs`, the count and the step replicated."""
    whole = _named(mesh, P())
    params = {n: shd.placements(mesh, s)
              for n, s in shd.param_specs(state["params"], mesh).items()}
    moments = {n: shd.placements(mesh, s)
               for n, s in shd.moment_specs(state["params"], mesh).items()}
    return {"params": params,
            "opt": {"mu": moments, "nu": dict(moments), "count": whole},
            "step": whole}


def cache_shardings(caches, cfg: ArchConfig, mesh, batch: int,
                    how: str = "auto") -> Any:
    """The decode caches' placements, the tree of `caches`: the LM's list
    of per-layer dicts, or the encoder-decoder's {"k", "v"} stacked over
    layers.  k/v split the batch over the data dims and the kv heads over
    'model' (`how`: "heads" forces the heads, uneven or not, "seq" the
    sequence; "auto" takes the heads when they divide); a batch too
    small for the data dims splits the sequence over every dim.  The
    rings "rk"/"rv" split only the batch; the SSM conv history its
    channels, the state its heads where they divide."""
    dp = shd.data_axes(mesh)
    model = _sizes(mesh).get("model", 1)
    dp_size = _dp_size(mesh)
    batch_ok = batch % dp_size == 0 and batch >= dp_size
    heads_ok = bool(cfg.n_kv_heads and cfg.n_kv_heads % model == 0)
    if how == "heads":
        heads_ok = bool(cfg.n_kv_heads)
    elif how == "seq":
        heads_ok = False
    H = ssm_dims(cfg)[1] if cfg.ssm else 0

    def leaf_spec(key: str, t: torch.Tensor) -> P:
        nd = t.ndim
        if key in ("rk", "rv"):
            return P(dp, None, None, None) if batch_ok else P(*[None] * nd)
        if key in ("k", "v"):
            lead = [None] * (nd - 4)        # the stacked layers, if any
            if batch_ok and heads_ok:
                return P(*lead, dp, "model", None, None)
            if batch_ok:
                return P(*lead, dp, None, "model", None)
            return P(*lead, None, None, dp + ("model",), None)
        if key == "conv":
            return P(dp, None, "model") if batch_ok else P(*[None] * nd)
        if key == "state":
            return P(dp if batch_ok else None,
                     "model" if H and H % model == 0 else None, None, None)
        return P(*[None] * nd)

    if isinstance(caches, dict):
        return {k: _named(mesh, leaf_spec(k, t)) for k, t in caches.items()}
    return [{k: _named(mesh, leaf_spec(k, t)) for k, t in c.items()}
            for c in caches]


# --------------------------------------------------------------------------
# Cell builders
# --------------------------------------------------------------------------

def build_cell(cfg: ArchConfig, shape_name: str, mesh,
               rcfg: Optional[RunConfig] = None) -> Cell:
    """The cell of `cfg` at shape `shape_name` on `mesh`.  Installs the
    activation hints and the MoE mesh for this (arch, mesh), as the
    reference does."""
    shape = cfg.shape(shape_name)
    rcfg = rcfg or RunConfig(kernels="xla")
    # Few-head archs run attention context-parallel: q blocks must tile
    # the sequence exactly model_size ways (mp_split boundary = Sq/model).
    model_size = _sizes(mesh).get("model", 1)
    heads_ok = cfg.n_kv_heads and cfg.n_kv_heads % model_size == 0
    if not heads_ok and cfg.n_heads and shape.kind != "decode":
        bq = max(shape.seq_len // model_size, 128)
        rcfg = dataclasses.replace(
            rcfg, attn_chunk_q=min(rcfg.attn_chunk_q, bq))
    con = constrain_fn(mesh, rcfg)
    ssm_heads = 0
    if cfg.ssm is not None and rcfg.ssm_head_tp:
        ssm_heads = ssm_dims(cfg)[1]
    shd.set_hint_fn(shd.make_hint_fn(mesh, cfg.n_kv_heads,
                                     rcfg.sequence_parallel,
                                     ssm_heads=ssm_heads))
    shd.set_moe_mesh(mesh if rcfg.moe_shard_map else None)

    if shape.kind == "train":
        return _train_cell(cfg, shape, mesh, rcfg, con)
    if shape.kind == "prefill":
        return _prefill_cell(cfg, shape, mesh, rcfg)
    return _decode_cell(cfg, shape, mesh, rcfg)


def _train_cell(cfg, shape, mesh, rcfg, con) -> Cell:
    state = init_train_state(0, cfg, rcfg, device=META, init=False)
    st_sh = state_shardings(state, mesh)
    batch, batch_sh = batch_structs(cfg, shape, mesh)
    step = make_train_step(cfg, rcfg, constrain=con)
    return Cell(name=f"{cfg.name}:{shape.name}", fn=step,
                args=(state, batch), in_shardings=(st_sh, batch_sh),
                out_shardings=(st_sh, None), donate_argnums=(0,))


def _serving_params(cfg, rcfg) -> torch.nn.Module:
    """Serving cells hold bf16 parameters (an inference-cast copy: every
    fp32 leaf bf16), on the meta device; the model reads `rcfg`'s SSD
    knobs."""
    rc = dataclasses.replace(rcfg, dtype="bfloat16")
    return init_fn_for(cfg)(cfg, rc, device=META, init=False).to(
        torch.bfloat16)


def _param_shardings(model, mesh) -> Dict[str, tuple]:
    return {n: shd.placements(mesh, s)
            for n, s in shd.param_specs(model, mesh).items()}


def _prefill_cell(cfg, shape, mesh, rcfg) -> Cell:
    model = _serving_params(cfg, rcfg)
    p_sh = _param_shardings(model, mesh)
    batch, batch_sh = batch_structs(cfg, shape, mesh)
    max_len = shape.seq_len

    if cfg.family == "audio":
        def fn(params, frames, tokens):
            return make_prefill_step(params, rcfg=rcfg)(frames, tokens)
        args = (model, batch["frames"], batch["tokens"])
        in_sh = (p_sh, batch_sh["frames"], batch_sh["tokens"])
    elif cfg.family == "vlm":
        def fn(params, tokens, pe):
            return make_prefill_step(params, max_len=max_len, rcfg=rcfg)(
                tokens, patch_embeds=pe)
        args = (model, batch["tokens"], batch["patch_embeds"])
        in_sh = (p_sh, batch_sh["tokens"], batch_sh["patch_embeds"])
    else:
        def fn(params, tokens):
            return make_prefill_step(params, max_len=max_len,
                                     rcfg=rcfg)(tokens)
        args = (model, batch["tokens"])
        in_sh = (p_sh, batch_sh["tokens"])
    return Cell(name=f"{cfg.name}:{shape.name}", fn=fn, args=args,
                in_shardings=in_sh, out_shardings=None)


def _decode_cell(cfg, shape, mesh, rcfg) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    dp = shd.data_axes(mesh)
    dp_size = _dp_size(mesh)
    batch_ok = B % dp_size == 0 and B >= dp_size
    tok_spec = P(dp, None) if batch_ok else P(None, None)

    model = _serving_params(cfg, rcfg)
    p_sh = _param_shardings(model, mesh)
    tokens = sds((B, 1), torch.int32)
    pos = S - 1

    if cfg.family == "audio":
        enc_len = max(S // cfg.encoder.subsample, 8)
        caches = init_encdec_cache(B, S, cfg, device=META)
        kv = (cfg.n_layers, B, cfg.n_kv_heads, enc_len,
              cfg.resolved_head_dim)
        cross = (sds(kv, torch.bfloat16), sds(kv, torch.bfloat16))
        c_sh = cache_shardings(caches, cfg, mesh, B)
        x_spec = P(None, dp, None, None, None) if batch_ok \
            else P(None, None, None, dp + ("model",), None)
        cross_sh = (_named(mesh, x_spec), _named(mesh, x_spec))

        def fn(params, caches, cross, tokens, pos):
            return make_decode_step(params, rcfg)(caches, cross, tokens,
                                                  pos)
        args = (model, caches, cross, tokens, pos)
        in_sh = (p_sh, c_sh, cross_sh, _named(mesh, tok_spec),
                 _named(mesh, P()))
    else:
        caches = init_decode_cache(B, S, cfg, ring=rcfg.decode_ring,
                                   device=META)
        c_sh = cache_shardings(caches, cfg, mesh, B,
                               how=rcfg.decode_kv_shard)

        def fn(params, caches, tokens, pos):
            return make_decode_step(params, rcfg)(caches, tokens, pos)
        args = (model, caches, tokens, pos)
        in_sh = (p_sh, c_sh, _named(mesh, tok_spec), _named(mesh, P()))
    return Cell(name=f"{cfg.name}:{shape.name}", fn=fn, args=args,
                in_shardings=in_sh, out_shardings=(None, c_sh),
                donate_argnums=(1,))


# --------------------------------------------------------------------------
# The production mesh without devices, and a description of a cell
# --------------------------------------------------------------------------

def fake_mesh(shape: Tuple[int, ...] = (16, 16),
              names: Tuple[str, ...] = ("data", "model"),
              world: Optional[int] = None):
    """`shape` over torch's fake process group, in this process (as the
    reference's dry run fakes its host devices): the default group is
    initialized as the fake one, of `world` ranks (prod(shape) when
    None), unless one exists; the mesh takes its first prod(shape)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world or n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _leaves(tree, shards, path=""):
    """(path, stand-in, placements) of each leaf of an argument and its
    sharding tree; a module's leaves are its named parameters."""
    if isinstance(tree, torch.nn.Module):
        for n, p in tree.named_parameters():
            yield f"{path}{n}", p, shards[n]
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], shards[k], f"{path}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, (t, s) in enumerate(zip(tree, shards)):
            yield from _leaves(t, s, f"{path}{i}.")
    else:
        yield path.rstrip("."), tree, shards


def describe(cell: Cell) -> Dict[str, Any]:
    """Each argument leaf of `cell` as [shape, dtype, placements], keyed
    by its path (argument index, then keys, list indices or parameter
    names), with the donated argument indices."""
    args = {}
    for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings)):
        for path, t, pl in _leaves(a, s, f"{i}."):
            if isinstance(t, torch.Tensor):
                args[path] = [list(t.shape), str(t.dtype).split(".")[-1],
                              [str(p) for p in pl]]
            else:
                args[path] = [[], type(t).__name__, [str(p) for p in pl]]
    return {"args": args, "donate": list(cell.donate_argnums)}


def all_cells():
    """(arch, shape name) of every cell of every registered arch."""
    from repro_torch.configs import REGISTRY, get

    return [(arch, s.name) for arch in sorted(REGISTRY)
            for s in get(arch).shapes]


def main(argv=None) -> int:
    from repro_torch.configs import get

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", help="write every cell's description here")
    args = ap.parse_args(argv)
    mesh = fake_mesh()
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    out = {}
    for arch, shape in cells:
        t = time.perf_counter()
        cell = build_cell(get(arch), shape, mesh)
        secs = time.perf_counter() - t
        d = describe(cell)
        out[cell.name] = dict(d, s=secs)
        print(json.dumps({"cell": cell.name, "leaves": len(d["args"]),
                          "s": round(secs, 4)}))
    shd.set_hint_fn(None)
    shd.set_moe_mesh(None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
