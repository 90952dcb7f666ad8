"""hymba-1.5b — Hymba hybrid-head architecture [arXiv:2411.13676].

32 layers, d_model 1600, 25 attention heads (GQA kv=5, head_dim 64) in
parallel with Mamba heads inside every layer (hybrid heads), d_ff 5504,
vocab 32001, ssm_state 16, untied unembedding.  Sliding window (1024) on
all but three full-attention layers (first / middle / last, per the
paper).  Meta tokens are omitted, as in the reference.
"""

from .base import (ArchConfig, HYBRID, HYBRID_FULL, SSMConfig, TRAIN_4K,
                   PREFILL_32K, DECODE_32K, LONG_500K)

# layers 0, 15 and 31 use full attention in their hybrid heads
_PATTERN = (
    ((HYBRID_FULL,), 1),
    ((HYBRID,), 14),
    ((HYBRID_FULL,), 1),
    ((HYBRID,), 15),
    ((HYBRID_FULL,), 1),
)

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    window=1024,
    layer_pattern=_PATTERN,
    ssm=SSMConfig(d_state=16, head_dim=64, n_groups=1, expand=2,
                  conv_kernel=4, chunk=128),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K),
    source="[arXiv:2411.13676; hf]",
)
