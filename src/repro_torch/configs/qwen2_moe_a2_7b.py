"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24 layers, d_model 2048, 16 heads (GQA kv=16), routed experts d_ff 1408,
vocab 151936, MoE: 60 routed experts top-4 + 4 shared experts (shared
intermediate 5632 = 4×1408), qkv bias (Qwen lineage).  Full attention ⇒
`long_500k` SKIPPED.
"""

from .base import (ArchConfig, MoEConfig, TRAIN_4K, PREFILL_32K, DECODE_32K)

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                    # routed expert intermediate
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4, d_ff_shared=5632),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)
