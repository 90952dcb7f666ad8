"""Name-based sharding rules: parameter name → partition spec → DTensor
placements (the port of `repro.dist.sharding` on `DeviceMesh`).

One rule table drives everything: `spec_for_path` classifies a parameter
by the last meaningful token of its name (column-parallel projections
shard their output dim over ``'model'``, row-parallel projections shard
their input dim, embeddings shard the vocab dim, norms replicate), and
`param_specs` / `moment_specs` / `param_shardings` map it over whole
trees with divisibility guards (a dim that does not divide the mesh axis
falls back to replicated).

A spec is a `P`: a tuple with one entry per tensor dim, each None, a
mesh-dim name or a tuple of mesh-dim names, as jax's `PartitionSpec`.
`placements` turns it into DTensor placements, one per mesh dim:
``Shard(d)`` where tensor dim d names that mesh dim, else
``Replicate()``.  `distribute_params` puts a module's parameters onto a
mesh as DTensors with those placements.

The port keeps one module per layer (``layers.3.attn.wq``) where the
reference stacks each segment's layers along a leading axis; a parameter
whose name holds a layer index is classified as the reference's stacked
leaf, one dim higher, and that leading dim dropped from its spec.  The
reference's qkv biases are ``wq/bias`` (classified by ``wq``); the
port's are ``bq`` / ``bk`` / ``bv``, so those names join the
column-parallel set.

Activation sharding goes through `hint(name, x)` call sites in the
models: `hint` is the identity until `set_hint_fn(make_hint_fn(mesh,
...))` installs a function that redistributes a DTensor activation to
the named layout.  With no mesh nothing changes.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

__all__ = ["P", "spec_for_path", "zip_axis", "data_axes", "placements",
           "param_specs", "moment_specs", "param_shardings",
           "residual_spec", "distribute_params", "distribute_batch",
           "set_moe_mesh", "moe_mesh", "hint", "set_hint_fn",
           "make_hint_fn"]


class P(tuple):
    """A partition spec: ``P(None, "model")`` shards a matrix's columns
    over the mesh dim ``'model'``; an entry may also be a tuple of mesh
    dims, which shard that tensor dim in their order."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# -- rule table -------------------------------------------------------------

#: output-dim ('model' on the last axis) sharded projections; bq/bk/bv are
#: the port's names of the reference's wq/wk/wv biases
_COL_PARALLEL = {"wq", "wk", "wv", "wqkv", "w_gate", "w_up", "in_proj",
                 "up_proj", "gate_proj", "q_proj", "k_proj", "v_proj",
                 "bq", "bk", "bv"}
#: input-dim ('model' on axis ndim-2) sharded projections
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "down_proj", "o_proj"}
#: vocab-dim sharded embedding tables (2-D: (vocab, d_model))
_EMBED = {"embed", "embedder", "embedding", "wte", "tok_embed"}
#: leaf-name suffixes that are not the classifying token
_LEAF_SUFFIXES = {"kernel", "bias", "scale", "table", "w", "b"}


def _tokens(path: str) -> Tuple[str, ...]:
    """Tokenize a parameter path: ``a/b/c``, jax ``keystr`` output
    (``['a'][0]``) and `named_parameters` names (``layers.0.attn.wq``)
    all give the same token stream.  Unlike the reference's, ``.``
    separates tokens: kept inside one, a port name would be a single
    token that classifies as nothing."""
    return tuple(re.findall(r"[A-Za-z0-9_]+", path))


def _name_token(tokens: Tuple[str, ...]) -> str:
    """The classifying token: the last path component that is neither a
    generic leaf suffix (kernel/bias/scale/...) nor a sequence index."""
    for t in reversed(tokens):
        if t not in _LEAF_SUFFIXES and not t.isdigit():
            return t
    return tokens[-1] if tokens else ""


def spec_for_path(path: str, ndim: int) -> P:
    """Rule-table lookup: parameter path + rank → `P`.

    Column-parallel weights shard the output (last) dim over ``'model'``,
    row-parallel weights shard the input (``ndim - 2``) dim, 2-D
    embedding tables shard the vocab (first) dim, everything else —
    norms, routers, scalars — replicates.
    """
    toks = _tokens(path)
    name = _name_token(toks)
    spec = [None] * ndim
    if ndim >= 2:
        if name in _COL_PARALLEL:
            spec[-1] = "model"
        elif name in _ROW_PARALLEL:
            spec[-2] = "model"
        elif ndim == 2 and (name in _EMBED or
                            (toks and toks[-1] in ("table", "embedding"))):
            spec[0] = "model"
    return P(*spec)


def _port_spec(name: str, ndim: int) -> P:
    """`spec_for_path` of a port parameter: one holding a layer index
    (``layers.3.attn.wq``) is the reference's stacked leaf less its
    leading dim."""
    if any(t.isdigit() for t in _tokens(name)):
        return P(*spec_for_path(name, ndim + 1)[1:])
    return spec_for_path(name, ndim)


# -- mesh helpers -----------------------------------------------------------

def zip_axis(mesh) -> Tuple[Tuple[str, int], ...]:
    """(dim name, size) pairs of a mesh."""
    return tuple(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch-sharding dims: every mesh dim that is not a model /
    pipeline / expert dim."""
    return tuple(a for a in mesh.mesh_dim_names
                 if a not in ("model", "stage", "expert"))


def _axes_size(mesh, axes) -> int:
    sizes = dict(zip_axis(mesh))
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _guarded_spec(mesh, spec, shape) -> P:
    """Drop spec entries whose mesh size does not divide the dim (or is
    1): the rule table is shape-agnostic, the guard makes it safe for any
    (arch, mesh) pair."""
    entries = list(tuple(spec)) + [None] * (len(shape) - len(tuple(spec)))
    out = []
    for dim, ax in zip(shape, entries):
        size = _axes_size(mesh, ax)
        out.append(ax if (size > 1 and dim % size == 0) else None)
    return P(*out)


def placements(mesh, spec) -> tuple:
    """A spec as DTensor placements, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for d, ax in enumerate(tuple(spec)):
            axes = (ax,) if isinstance(ax, str) else (ax or ())
            if name in axes:
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


# -- parameter trees --------------------------------------------------------

def _named_leaves(tree: Any, prefix: str = ""):
    """(name, tensor) pairs: a module's `named_parameters`, a dict's items
    (keys joined with ``.``), nested."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named_leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix.rstrip("."), tree


def param_specs(tree: Any, mesh) -> Dict[str, P]:
    """A module, or a dict of tensors keyed by parameter name → {name:
    guarded `P`} by the rule table."""
    return {name: _guarded_spec(mesh, _port_spec(name, t.ndim),
                                tuple(t.shape))
            for name, t in _named_leaves(tree)}


def moment_specs(tree: Any, mesh) -> Dict[str, P]:
    """Optimizer moments shard exactly like their parameters."""
    return param_specs(tree, mesh)


def param_shardings(tree: Any, mesh) -> Dict[str, tuple]:
    """`param_specs` as DTensor placements."""
    return {name: placements(mesh, spec)
            for name, spec in param_specs(tree, mesh).items()}


def residual_spec(mesh, sequence_parallel: bool) -> tuple:
    """The between-blocks residual stream's (B, S, d) placements: batch
    over the data dims, the sequence over ``'model'`` when sequence
    parallelism is on."""
    dp = data_axes(mesh)
    seq = "model" if (sequence_parallel and
                      _axes_size(mesh, "model") > 1) else None
    return placements(mesh, P(dp or None, seq, None))


@torch.no_grad()
def distribute_params(module: nn.Module, mesh) -> nn.Module:
    """Replace every parameter of `module` by a DTensor parameter on
    `mesh` with its guarded placements (rank 0's values), in place."""
    from torch.distributed.tensor import distribute_tensor

    shardings = param_shardings(module, mesh)
    for name, pl in shardings.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        old = getattr(owner, leaf)
        owner.register_parameter(leaf, nn.Parameter(
            distribute_tensor(old.detach(), mesh, pl),
            requires_grad=old.requires_grad))
    return module


def distribute_batch(batch: Dict[str, torch.Tensor], mesh
                     ) -> Dict[str, torch.Tensor]:
    """Each batch tensor sharded on its first dim over the data dims,
    replicated over the rest."""
    from torch.distributed.tensor import distribute_tensor

    dp = data_axes(mesh) or None
    return {k: distribute_tensor(v, mesh, placements(
        mesh, _guarded_spec(mesh, P(dp), tuple(v.shape))))
        for k, v in batch.items()}


# -- MoE mesh install (the mesh dispatch, opt-in) ---------------------------

_MOE_MESH = None


def set_moe_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh `moe_forward` uses for its
    mesh dispatch."""
    global _MOE_MESH
    _MOE_MESH = mesh


def moe_mesh():
    return _MOE_MESH


# -- activation hints -------------------------------------------------------

_HINT_FN: Optional[Callable[[str, Any], Any]] = None


def hint(name: str, x):
    """Named activation-sharding hint site.  The identity until a mesh
    hint function is installed (`set_hint_fn`)."""
    if _HINT_FN is None:
        return x
    return _HINT_FN(name, x)


def set_hint_fn(fn: Optional[Callable[[str, Any], Any]]) -> None:
    global _HINT_FN
    _HINT_FN = fn


def make_hint_fn(mesh, n_kv_heads: int, sequence_parallel: bool,
                 ssm_heads: int = 0) -> Callable[[str, Any], Any]:
    """The per-(arch, mesh) hint function for the model call sites.

    Attention is head-parallel over ``'model'`` when the KV heads divide
    the model dim, context-parallel over the q-block dim otherwise (there
    a q/k/v projection's output is split on its sequence before its heads
    are split, `attn_proj`: DTensor cannot split a feature dim sharded
    unevenly over the heads, where the reference's XLA pads); FFN
    hidden activations shard the d_ff dim; SSM heads shard over
    ``'model'`` when divisible.  Every entry is divisibility-guarded
    against the activation's shape.  A DTensor activation is
    redistributed to the layout; a plain tensor passes unchanged.
    """
    from torch.distributed.tensor import DTensor

    dp = data_axes(mesh) or None
    model = _axes_size(mesh, "model")
    heads_ok = model > 1 and n_kv_heads and n_kv_heads % model == 0
    ssm_ok = model > 1 and ssm_heads and ssm_heads % model == 0

    def specs_for(name: str, ndim: int):
        if name == "attn_proj" and ndim == 3:     # (B, S, n·dh)
            return None if heads_ok else P(dp, "model", None)
        if name == "attn_q6" and ndim == 6:       # (B, Hkv, G, nq, bq, D)
            return P(dp, "model", None, None, None, None) if heads_ok \
                else P(dp, None, None, "model", None, None)
        if name == "attn_kv4" and ndim == 4:      # (B, Hkv, Sk, D)
            return P(dp, "model", None, None) if heads_ok \
                else P(dp, None, None, None)
        if name == "attn_kv5" and ndim == 5:      # (B, Hkv, nk, bk, D)
            return P(dp, "model", None, None, None) if heads_ok \
                else P(dp, None, None, None, None)
        if name == "attn_out" and ndim == 4:      # (B, Hq, Sq, D)
            return P(dp, "model", None, None) if heads_ok \
                else P(dp, None, "model", None)
        if name == "ssm_conv3" and ndim == 3:     # (B, S, conv channels)
            return P(dp, None, "model")
        if name == "ffn_hidden" and ndim == 3:    # (B, S, d_ff)
            return P(dp, None, "model")
        if name == "ssm_x4" and ndim == 4:        # (B, H, S, P)
            return P(dp, "model", None, None) if ssm_ok else P(dp, None,
                                                               None, None)
        if name == "ssm_dt3" and ndim == 3:       # (B, H, S)
            return P(dp, "model", None) if ssm_ok else P(dp, None, None)
        return None

    def hint_fn(name: str, x):
        if not isinstance(x, DTensor):
            return x
        spec = specs_for(name, x.ndim)
        if spec is None:
            return x
        guarded = _guarded_spec(mesh, spec, tuple(x.shape))
        return x.redistribute(mesh, placements(mesh, guarded))

    return hint_fn
