"""mixtral-8x7b — Mixtral of Experts [arXiv:2401.04088].

32 layers, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab
32000, 8 experts top-2, sliding-window attention (4096).  SWA ⇒ KV state
bounded ⇒ `long_500k` RUNS.
"""

from .base import (ArchConfig, MoEConfig, TRAIN_4K, PREFILL_32K, DECODE_32K,
                   LONG_500K)

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K),
    source="[arXiv:2401.04088; hf]",
)
