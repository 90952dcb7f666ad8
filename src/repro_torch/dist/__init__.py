"""repro_torch.dist — the port's distributed layer: the collectives over
the multi-engine DMA fabric, checkpoints and fault tolerance (the port of
`repro.dist` without its meshes).

`fabric` (`CollectiveFabric`, the NumPy oracles) and `collectives` (the
analytic ring / all-to-all plans over it) are host NumPy over
`repro_torch.core`, as the reference's are; `checkpoint` writes and reads
the reference's checkpoint format from torch trees, and `fault` is the
training loop's error-handler verbs.  The reference's `sharding` and
`pipeline_parallel` (and `collectives.compressed_psum`) are jax meshes and
have no counterpart here yet; asking for one raises `AttributeError`.

Submodules are imported lazily, as in the reference, so importing
`repro_torch.dist` itself costs nothing.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("fabric", "collectives", "checkpoint", "fault")

#: the reference's submodules that this package has no copy of yet
_NOT_PORTED = ("sharding", "pipeline_parallel")

__all__ = list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _NOT_PORTED:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}: the reference's "
            f"repro.dist.{name} is jax and is not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
