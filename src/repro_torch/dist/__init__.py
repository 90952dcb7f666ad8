"""repro_torch.dist — the port's distributed layer (the port of
`repro.dist`): the collectives over the multi-engine DMA fabric, meshes,
checkpoints and fault tolerance.

`fabric` (`CollectiveFabric`, the NumPy oracles) and `collectives` (the
analytic ring / all-to-all plans over it, and `compressed_psum` on
`torch.distributed`) are host NumPy over `repro_torch.core`, as the
reference's are; `sharding` is the rule table and the DTensor placements
on a `DeviceMesh`, `pipeline_parallel` the GPipe schedule over a mesh
dim; `checkpoint` writes and reads the reference's checkpoint format
from torch trees, onto a mesh too, and `fault` is the training loop's
error-handler verbs.

Submodules are imported lazily, as in the reference, so importing
`repro_torch.dist` itself costs nothing.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("fabric", "collectives", "checkpoint", "fault", "sharding",
               "pipeline_parallel")

__all__ = list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
