"""qwen2.5-32b — Qwen2.5 [hf:Qwen/Qwen2.5-0.5B (family card); hf].

64 layers, d_model 5120, 40 heads (GQA kv=8), d_ff 27648, vocab 152064,
QKV bias.  Full attention ⇒ `long_500k` SKIPPED.
"""

from .base import ArchConfig, TRAIN_4K, PREFILL_32K, DECODE_32K

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)
