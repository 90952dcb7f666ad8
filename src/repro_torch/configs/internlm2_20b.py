"""internlm2-20b — InternLM2 [arXiv:2403.17297].

48 layers, d_model 6144, 48 heads (GQA kv=8), d_ff 16384, vocab 92544.
Full attention ⇒ `long_500k` SKIPPED.
"""

from .base import ArchConfig, TRAIN_4K, PREFILL_32K, DECODE_32K

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K),
    source="[arXiv:2403.17297; hf]",
)
