"""Checkpoint engine: atomic step directories with per-leaf checksums
and the backend's `ErrorPolicy` verbs applied to leaf writes (the port of
`repro.dist.checkpoint`, in the reference's format).

Layout::

    <dir>/step_00000007/
        arrays.npz    # leaf_000, leaf_001, ...  (bfloat16 as uint16)
        meta.json     # key-path names, dtypes, shapes, crc32 per leaf
        COMPLETE      # marker, written last — absent == partial save

A tree is a dict, list or tuple, nested, whose leaves are tensors, NumPy
arrays or scalars; an `nn.Module` in it stands for the dict of its
`named_parameters`.  A leaf's name is its key path as `jax.tree_util.
keystr` writes it (``['opt']['mu']['embed']``), dict keys in sorted
order, so either package restores the other's checkpoints of dict and
list trees bit for bit.

A leaf write that raises `IOError` goes through the same three verbs the
DMA backend applies to faulted bursts: ``replay`` retries the leaf (up
to ``max_replays``), ``continue`` drops the leaf and leaves the
checkpoint marked partial (ineligible for `latest`), ``abort``
propagates.  `restore` verifies every leaf's crc32 against meta.json and
raises ``IOError("checksum mismatch ...")`` on corruption.

On a mesh: `save` writes a DTensor leaf whole (every rank calls it, as
the gather is a collective, and rank 0 writes the files); `restore` with
``shardings`` (a tree matching ``like`` whose leaves are DTensor
placements, e.g. `sharding.param_shardings`) and ``mesh`` puts each
restored leaf onto its placements — the elastic restore: save on one
topology, restore onto another.  A DTensor leaf of ``like`` receives its
values on its own placements.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.engine import ErrorPolicy

__all__ = ["PAYLOAD", "META", "MARKER", "CheckpointInfo", "save",
           "restore", "latest", "list_checkpoints", "prune"]

PAYLOAD = "arrays.npz"
META = "meta.json"
MARKER = "COMPLETE"

_DIR_FMT = "step_%08d"


@dataclass(frozen=True)
class CheckpointInfo:
    step: int
    path: str
    complete: bool


def _leaf_key(i: int) -> str:
    return f"leaf_{i:03d}"


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key-path part, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, nn.Module):
        return [(f"[{name!r}]", p) for name, p in node.named_parameters()]
    if isinstance(node, dict):
        return [(f"[{key!r}]", node[key]) for key in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", item) for i, item in enumerate(node)]
    return None


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for part, child in kids:
        yield from _flatten(child, prefix + part)


def _is_dtensor(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and hasattr(t, "device_mesh")


def _storable(leaf: Any) -> Tuple[np.ndarray, str]:
    """(npz-safe array, dtype name): bfloat16, which the npy format cannot
    describe portably, as its uint16 bits; a DTensor whole."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes in C order, read in place."""
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


def _tensor(arr: np.ndarray, dtype: str, shape: List[int]) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, dtype=dtype))
    return t.reshape(shape)


def save(tree: Any, directory: str, step: int,
         error_policy: Optional[ErrorPolicy] = None,
         _fault_hook: Optional[Callable[[str], None]] = None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``directory`` and
    return the step directory path.  ``_fault_hook(name)`` (tests) runs
    before each leaf write and may raise `IOError` to exercise the
    error-policy verbs."""
    policy = error_policy or ErrorPolicy()
    path = os.path.join(directory, _DIR_FMT % step)
    # on a mesh every rank gathers the DTensor leaves; rank 0 writes
    writer = not any(_is_dtensor(leaf) for _, leaf in _flatten(tree)) or \
        dist.get_rank() == 0
    if writer:
        os.makedirs(path, exist_ok=True)
    arrays = {}
    meta_leaves: List[dict] = []
    complete = True
    for i, (name, leaf) in enumerate(_flatten(tree)):

        def write_leaf(name=name, leaf=leaf, i=i):
            if _fault_hook is not None:
                _fault_hook(name)
            arr, dtype = _storable(leaf)
            arrays[_leaf_key(i)] = arr
            meta_leaves.append({
                "name": name,
                "key": _leaf_key(i),
                "dtype": dtype,
                "shape": list(arr.shape),
                "crc32": _crc32(arr),
            })

        attempts = 0
        while True:
            try:
                write_leaf()
                break
            except IOError:
                if policy.action == "abort":
                    raise
                if policy.action == "continue":
                    complete = False
                    break
                attempts += 1
                if attempts > max(1, policy.max_replays):
                    raise
    if not writer:
        return path
    np.savez(os.path.join(path, PAYLOAD), **arrays)
    with open(os.path.join(path, META), "w") as f:
        json.dump({"step": step, "complete": complete,
                   "leaves": meta_leaves}, f, indent=1)
    if complete:
        with open(os.path.join(path, MARKER), "w") as f:
            f.write("ok\n")
    return path


@torch.no_grad()
def restore(path: str, like: Any,
            device: Union[str, torch.device, None] = None,
            shardings: Any = None, mesh=None) -> Any:
    """Read a checkpoint back into the structure of ``like``, verifying
    every leaf's checksum, and return the tree.  Each tensor of ``like``
    (a module's parameters included) receives its stored values in place,
    on its own device, so ``like`` may be an uninitialized state that
    holds the only copy; its shape and dtype must be the stored ones.
    With ``device``, tensor leaves are new tensors there instead (a module
    is moved there first).  A leaf of ``like`` that is not a tensor
    becomes a new tensor on ``device``, or on the CPU.

    With ``shardings`` and ``mesh``, every leaf becomes a new DTensor on
    ``mesh`` with the placements of its ``shardings`` leaf (a module's
    parameters are replaced by DTensor parameters)."""
    if (shardings is None) != (mesh is None):
        raise ValueError("restore onto a mesh takes both shardings and mesh")
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    by_name = {m["name"]: m for m in meta["leaves"]}
    arrays = np.load(os.path.join(path, PAYLOAD))

    def read(name: str) -> torch.Tensor:
        m = by_name.get(name)
        if m is None:
            raise IOError(f"checkpoint {path} has no leaf {name!r}")
        arr = arrays[m["key"]]
        crc = _crc32(arr)
        if crc != m["crc32"]:
            raise IOError(f"checksum mismatch for leaf {name!r} in {path}: "
                          f"stored {m['crc32']:#010x}, read {crc:#010x}")
        return _tensor(arr, m["dtype"], m["shape"])

    def into(node: torch.Tensor, name: str) -> torch.Tensor:
        t = read(name)
        if t.shape != node.shape or t.dtype != node.dtype:
            raise IOError(f"leaf {name!r} in {path} is {t.dtype} "
                          f"{tuple(t.shape)}, the tree's {node.dtype} "
                          f"{tuple(node.shape)}")
        if _is_dtensor(node):
            from torch.distributed.tensor import distribute_tensor
            node.to_local().copy_(distribute_tensor(
                t, node.device_mesh, node.placements).to_local())
            return node
        return node.copy_(t)

    def placed(name: str, pl) -> torch.Tensor:
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(read(name), mesh, pl)

    def fill(node: Any, prefix: str, sh: Any) -> Any:
        if isinstance(node, nn.Module):
            if sh is not None:
                for name, p in list(node.named_parameters()):
                    owner_name, _, leaf = name.rpartition(".")
                    owner = node.get_submodule(owner_name)
                    owner.register_parameter(leaf, nn.Parameter(
                        placed(f"{prefix}[{name!r}]", sh[name]),
                        requires_grad=p.requires_grad))
                return node
            if device is not None:
                node.to(device)
            for part, p in _children(node):
                into(p, prefix + part)
            return node
        kids = _children(node)
        if kids is None:
            if sh is not None:
                return placed(prefix, sh)
            if isinstance(node, torch.Tensor) and device is None:
                return into(node, prefix)
            return read(prefix).to(device or "cpu")
        if sh is None:
            subs = [None] * len(kids)
        elif isinstance(node, dict):
            subs = [sh[key] for key in sorted(node)]
        else:
            subs = list(sh)
        out = [fill(child, prefix + part, s)
               for (part, child), s in zip(kids, subs)]
        if isinstance(node, dict):
            return dict(zip(sorted(node), out))
        return type(node)(out)

    return fill(like, "", shardings)


def list_checkpoints(directory: str) -> List[CheckpointInfo]:
    """All checkpoints under ``directory``, sorted by step (complete or
    not)."""
    infos = []
    if not os.path.isdir(directory):
        return infos
    for entry in sorted(os.listdir(directory)):
        if not entry.startswith("step_"):
            continue
        path = os.path.join(directory, entry)
        if not os.path.isdir(path):
            continue
        try:
            step = int(entry[len("step_"):])
        except ValueError:
            continue
        infos.append(CheckpointInfo(
            step=step, path=path,
            complete=os.path.exists(os.path.join(path, MARKER))))
    return sorted(infos, key=lambda i: i.step)


def latest(directory: str) -> Optional[CheckpointInfo]:
    """The newest *complete* checkpoint, or None — partial saves (the
    ``continue`` verb, or a crash mid-save) are never restore targets."""
    complete = [i for i in list_checkpoints(directory) if i.complete]
    return complete[-1] if complete else None


def prune(directory: str, keep: int) -> None:
    """Delete the oldest checkpoints, keeping the newest ``keep``."""
    infos = list_checkpoints(directory)
    for info in infos[:max(0, len(infos) - keep)]:
        shutil.rmtree(info.path)
