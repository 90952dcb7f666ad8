"""Models of the port in PyTorch: the decoder-only LM for dense attention
(gemma2, internlm2, chatglm3, qwen2.5), mixture-of-experts (qwen2-moe,
mixtral), pure SSM (mamba2), hybrid (hymba) and VLM (internvl2's backbone
and patch projector) configs."""

from .lm import LM, lm_decode_step, lm_prefill
from .convert import lm_from_numpy
