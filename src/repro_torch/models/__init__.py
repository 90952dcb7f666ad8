"""Models of the port in PyTorch: the dense attention LM (gemma2) and the
pure SSM LM (mamba2)."""

from .lm import LM, lm_decode_step, lm_prefill
from .convert import lm_from_numpy
