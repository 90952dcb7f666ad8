from .copy_engine import (VMEM_SYSTEM, copy_2d_reference, copy_engine_spec,
                          estimate_plan_cycles, plan_descriptor_batch)
from .ops import copy_2d, strided_copy_nd
from .ref import copy_2d_ref, strided_copy_nd_ref
