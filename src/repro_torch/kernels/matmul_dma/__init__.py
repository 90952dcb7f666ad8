from .matmul_dma import matmul_cuda
from .ops import matmul
from .ref import matmul_ref
