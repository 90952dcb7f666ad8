"""Architecture configs of the port.

`get(name)` returns the full ArchConfig; gemma2-2b, mamba2-1.3b,
hymba-1.5b, internlm2-20b, chatglm3-6b, qwen2.5-32b, internvl2-26b, the
MoE pair qwen2-moe-a2.7b and mixtral-8x7b, and the encoder-decoder
seamless-m4t-large-v2: every config of the reference.
`reduced` (from .base) shrinks it for CPU tests.
"""

from __future__ import annotations

from typing import Dict

from .base import (ALL_SHAPES, ArchConfig, EncoderConfig, MoEConfig,
                   RunConfig, SSMConfig, ShapeSpec, VisionStub, reduced,
                   TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
                   ATTN_FULL, ATTN_SWA, SSM, HYBRID, HYBRID_FULL)
from .chatglm3_6b import CONFIG as chatglm3_6b
from .gemma2_2b import CONFIG as gemma2_2b
from .hymba_1_5b import CONFIG as hymba_1_5b
from .internlm2_20b import CONFIG as internlm2_20b
from .internvl2_26b import CONFIG as internvl2_26b
from .mamba2_1_3b import CONFIG as mamba2_1_3b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .qwen2_5_32b import CONFIG as qwen2_5_32b
from .qwen2_moe_a2_7b import CONFIG as qwen2_moe_a2_7b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in [
    gemma2_2b, mamba2_1_3b, hymba_1_5b, internlm2_20b, chatglm3_6b,
    qwen2_5_32b, internvl2_26b, qwen2_moe_a2_7b, mixtral_8x7b,
    seamless_m4t_large_v2]}


def get(name: str) -> ArchConfig:
    try:
        cfg = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}") \
            from None
    cfg.validate()
    return cfg
