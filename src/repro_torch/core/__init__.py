"""repro_torch.core — the paper's contribution: a modular DMA engine
architecture, the port's own copy of `repro.core`.

Front-ends (control plane) → mid-ends (transfer acceleration) → back-ends
(data plane), with standardized descriptor interfaces between them, a
transfer legalizer, decoupled read/write transport, in-stream accelerators,
the Init pseudo-protocol, an error handler, and area/timing/latency models.

The descriptor plane is host code in NumPy in both packages: `descriptor`,
`legalizer`, `midend`, `simulator`, `backend`, `plan`, `frontend`, `engine`
and `spec` are copies of the reference modules (the engine's opt-in
``sanitize=`` runs `repro_torch.sanitize` on every drain), as are `vm` (page
tables, TLB, the translating mid-end, scatter-gather lists and the MoE
expert gather) and `analytics` (the area, timing and latency models);
`instream` works on torch tensors.
"""

from .descriptor import (CODE_PROTO, PROTO_CODE, BackendOptions,
                         DescriptorBatch, InitPattern, MidendBundle,
                         NdTransfer, Protocol, RtConfig, TensorDim,
                         Transfer1D, concat_batches, contiguous_coverage,
                         total_bytes)
from .legalizer import (PAGE_SIZE, TPU_DMA_GRANULE, check_legal,
                        check_legal_batch, legal_latency, legalize,
                        legalize_batch, legalize_tile)
from .midend import (coalesce_nd, iter_tensor_nd, mp_dist, mp_dist_batch,
                     mp_dist_tree, mp_split, mp_split_batch, rt_schedule,
                     split_and_distribute, tensor_2d, tensor_nd,
                     tensor_nd_batch)
from .frontend import (FRONTENDS, CompletionEvent, DescFrontend,
                       InstFrontend, IrqController, IrqStats, RegFrontend,
                       make_frontend, write_chain)
from .backend import (ExecHints, FaultInjector, FaultSite, MemoryMap,
                      PageFault, TransferError, build_exec_hints, execute,
                      execute_batch, init_stream, splitmix32, splitmix64)
from .plan import (PlanCache, PlanCacheStats, TransferPlan, capture_nd_plan,
                   capture_plan, nd_plan_signature, plan_signature,
                   simulate_plan, structure_modulus)
from .engine import (CompletionRecord, ErrorPolicy, IDMAEngine, LoweredPort,
                     TilePlan, plan_nd_copy)
from .simulator import (HBM, PULP_L2, RPC_DRAM, SRAM, ChannelSimResult,
                        EngineConfig, MemSystem, SimResult,
                        cheshire_idma_config, fragmented_copy,
                        fragmented_copy_reference, make_fragmented_batch,
                        manticore_idma_config, pulp_idma_config, simulate,
                        simulate_batch, simulate_channels,
                        simulate_reference, utilization_sweep,
                        xilinx_baseline_config)
from .spec import (PRESETS, VMEM_ENDPOINT, BackendSpec, ChannelSpec,
                   CustomStage, EngineSpec, FrontendSpec, IrqSpec,
                   MidendStage, MpDistStage, MpSplitStage,
                   RtReplicateStage, build_engine, build_engines,
                   build_frontend, cheshire, edge_ai, manticore, preset,
                   pulp_cluster, spec_of)
from .vm import (MIN_PAGE_SIZE, PageTable, Tlb, TlbStats, TranslateStage,
                 expert_gather_batch, read_sg_list, sg_gather_batch,
                 write_sg_list)
from . import analytics, instream

__all__ = [
    "BackendOptions", "CODE_PROTO", "DescriptorBatch", "InitPattern",
    "MidendBundle", "NdTransfer", "PROTO_CODE", "Protocol", "RtConfig",
    "TensorDim", "Transfer1D", "concat_batches", "contiguous_coverage",
    "total_bytes",
    "PAGE_SIZE", "TPU_DMA_GRANULE", "check_legal", "check_legal_batch",
    "legal_latency", "legalize", "legalize_batch", "legalize_tile",
    "coalesce_nd", "iter_tensor_nd", "mp_dist", "mp_dist_batch",
    "mp_dist_tree", "mp_split", "mp_split_batch", "rt_schedule",
    "split_and_distribute", "tensor_2d", "tensor_nd", "tensor_nd_batch",
    "CompletionEvent", "DescFrontend", "FRONTENDS", "InstFrontend",
    "IrqController", "IrqStats", "RegFrontend", "make_frontend",
    "write_chain",
    "ExecHints", "FaultInjector", "FaultSite", "MemoryMap", "PageFault",
    "TransferError", "build_exec_hints", "execute", "execute_batch",
    "init_stream", "splitmix32", "splitmix64",
    "PlanCache", "PlanCacheStats", "TransferPlan", "capture_nd_plan",
    "capture_plan", "nd_plan_signature", "plan_signature", "simulate_plan",
    "structure_modulus",
    "CompletionRecord", "ErrorPolicy", "IDMAEngine", "LoweredPort",
    "TilePlan", "plan_nd_copy",
    "HBM", "PULP_L2", "RPC_DRAM", "SRAM", "ChannelSimResult",
    "EngineConfig", "MemSystem", "SimResult", "cheshire_idma_config",
    "fragmented_copy", "fragmented_copy_reference",
    "make_fragmented_batch", "manticore_idma_config", "pulp_idma_config",
    "simulate", "simulate_batch", "simulate_channels",
    "simulate_reference", "utilization_sweep", "xilinx_baseline_config",
    "BackendSpec", "ChannelSpec", "CustomStage", "EngineSpec",
    "FrontendSpec", "IrqSpec", "MidendStage", "MpDistStage",
    "MpSplitStage", "PRESETS", "RtReplicateStage", "VMEM_ENDPOINT",
    "build_engine", "build_engines",
    "build_frontend", "cheshire", "edge_ai", "manticore", "preset",
    "pulp_cluster", "spec_of",
    "MIN_PAGE_SIZE", "PageTable", "Tlb", "TlbStats", "TranslateStage",
    "expert_gather_batch", "read_sg_list", "sg_gather_batch",
    "write_sg_list",
    "analytics", "instream",
]
