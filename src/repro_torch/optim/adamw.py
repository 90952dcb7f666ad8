"""AdamW with decoupled weight decay, global-norm clipping and fp32
moments (the port of `repro.optim.adamw`).

A tree is a dict or list, nested, of tensors.  The reference returns new
trees; here `adamw_update` writes the parameters and both moments in
place, leaf by leaf and, within a large leaf, a slice at a time, so a
step holds no second copy of the model: at full-width gemma2-2b in fp32
(2.6 B parameters, 10.5 GB a tree) the temporaries stay under a few
hundred MB.  The arithmetic per element is the reference's, in fp32.

On a mesh the leaves are DTensors (`train.distribute_train_state`): the
global norm sums every leaf over the whole mesh, and each leaf's update
runs on its local shard, its gradient first redistributed to the
parameter's placements, which the moments share.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple, Union

import torch

#: elements of a leaf updated at once: bounds the temporaries to a few
#: buffers of this size
CHUNK = 1 << 24


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _map(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, item) for item in tree)
    return fn(tree)


def adamw_init(params: Any) -> Dict[str, Any]:
    """fp32 zero moments shaped like `params`, on its devices (a DTensor
    leaf's with its placements), and the step count, a 0-d int32 tensor
    on the CPU."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, fp32, on the first leaf's
    device.  A DTensor leaf's sum is over the whole mesh."""
    from torch.distributed.tensor import DTensor

    total = None
    for g in _leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq.to(total.device)
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def _scalar(x: Union[float, torch.Tensor]) -> float:
    """A Python float holding the fp32 value exactly."""
    return float(torch.as_tensor(x, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads: Any, state: Dict[str, Any], params: Any,
                 lr: Union[float, torch.Tensor], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step on every leaf, norm scales included, as the
    reference decays them.  `grads`, `state["mu"]`, `state["nu"]` and
    `params` are trees of one structure.  Updates `params` and `state` in
    place and returns (params, state, {"grad_norm": the norm before
    clipping})."""
    from torch.distributed.tensor import DTensor

    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = None
    if grad_clip > 0:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    cf = count.to(torch.float32)
    b1c = _scalar(1.0 - torch.tensor(b1, dtype=torch.float32) ** cf)
    b2c = _scalar(1.0 - torch.tensor(b2, dtype=torch.float32) ** cf)
    lr = _scalar(lr)

    for g, m, v, p in zip(_leaves(grads), _leaves(state["mu"]),
                          _leaves(state["nu"]), _leaves(params)):
        if isinstance(p, DTensor):
            # the update is elementwise: run it on the local shards, the
            # gradient's laid out as the parameter's
            g = g.redistribute(p.device_mesh, p.placements).to_local()
            m, v, p = (t.to_local() for t in (m, v, p))
        s = None if scale is None else scale.to(g.device)
        # the moments and parameters are written through flat views
        gf, (mf, vf, pf) = g.reshape(-1), (t.view(-1) for t in (m, v, p))
        for i in range(0, pf.numel(), CHUNK):
            sl = slice(i, i + CHUNK)
            gi = gf[sl].float()
            if s is not None:
                gi = gi * s
            mi = mf[sl].mul_(b1).add_((1 - b1) * gi)
            vi = vf[sl].mul_(b2).add_((1 - b2) * gi * gi)
            pi = pf[sl].float()
            update = (mi / b1c) / (torch.sqrt(vi / b2c) + eps)
            update = update + weight_decay * pi
            pf[sl].copy_(pi - lr * update)
    state["count"] = count
    return params, state, {"grad_norm": gnorm}
