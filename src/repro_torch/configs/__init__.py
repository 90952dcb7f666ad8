"""Architecture configs of the port.

`get(name)` returns the full ArchConfig; gemma2-2b, mamba2-1.3b and
hymba-1.5b are ported so far.
`reduced` (from .base) shrinks it for CPU tests.
"""

from __future__ import annotations

from typing import Dict

from .base import (ALL_SHAPES, ArchConfig, EncoderConfig, MoEConfig,
                   RunConfig, SSMConfig, ShapeSpec, VisionStub, reduced,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
                   ATTN_FULL, ATTN_SWA, SSM, HYBRID, HYBRID_FULL)
from .gemma2_2b import CONFIG as gemma2_2b
from .hymba_1_5b import CONFIG as hymba_1_5b
from .mamba2_1_3b import CONFIG as mamba2_1_3b

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in [gemma2_2b,
                                                       mamba2_1_3b,
                                                       hymba_1_5b]}


def get(name: str) -> ArchConfig:
    try:
        cfg = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}") \
            from None
    cfg.validate()
    return cfg
