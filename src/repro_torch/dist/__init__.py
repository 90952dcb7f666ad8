"""repro_torch.dist — the port's distributed layer, so far the collectives
over the multi-engine DMA fabric (the port of `repro.dist`'s NumPy half).

`fabric` (`CollectiveFabric`, the NumPy oracles) and `collectives` (the
analytic ring / all-to-all plans over it) are host NumPy over
`repro_torch.core`, as the reference's are.  The reference's
`sharding`, `checkpoint`, `fault` and `pipeline_parallel` (and
`collectives.compressed_psum`) are jax and have no counterpart here yet;
asking for one raises `AttributeError`.

Submodules are imported lazily, as in the reference, so importing
`repro_torch.dist` itself costs nothing.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("fabric", "collectives")

#: the reference's submodules that this package has no copy of yet
_NOT_PORTED = ("sharding", "checkpoint", "fault", "pipeline_parallel")

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
