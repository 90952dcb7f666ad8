"""chatglm3-6b — ChatGLM3 / GLM [arXiv:2406.12793].

28 layers, d_model 4096, 32 heads (GQA kv=2 — 'multi-query' with 2 groups),
d_ff 13696, vocab 65024.  '2d RoPE': rotary applied to half the head dim
(rope_fraction 0.5), qkv bias.  Full attention ⇒ `long_500k` SKIPPED.
"""

from .base import ArchConfig, TRAIN_4K, PREFILL_32K, DECODE_32K

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,
    qkv_bias=True,                # GLM uses qkv bias (add_qkv_bias)
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[arXiv:2406.12793; hf]",
)
