"""Models of the port in PyTorch: the decoder-only LM for dense attention
(gemma2, internlm2, chatglm3, qwen2.5), mixture-of-experts (qwen2-moe,
mixtral), pure SSM (mamba2), hybrid (hymba) and VLM (internvl2's backbone
and patch projector) configs, and the encoder-decoder (seamless-m4t)."""

from .lm import (LM, add_decode_rings, flush_decode_caches,
                 init_decode_cache, lm_decode_step, lm_forward, lm_loss,
                 lm_prefill)
from .encdec import (EncDec, encdec_decode_step, encdec_forward,
                     encdec_loss, encdec_prepare_cross, init_encdec_cache)
from .convert import encdec_from_numpy, lm_from_numpy
