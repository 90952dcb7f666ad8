"""Serving of the port: the padded-batch engine and its step functions,
the paged-KV DMA plane (`kvcache`) and the continuous-batching front door
(`sched`)."""

from .kvcache import (KVLayout, PagedKVDMA, PagePool, append_descriptors,
                      append_token, gather_descriptors, gather_kv,
                      init_paged_kv, make_page_tables,
                      span_append_descriptors, swap_descriptors)
from .sched import (BlockAllocator, HashLM, ReqState, Scheduler,
                    ServeFrontDoor, ServeRequest, StepLM, oracle_generate)
from .serve_step import (GraphDecodeStep, decode_graphs_fit, greedy_sample,
                         make_decode_step, make_prefill_step,
                         temperature_sample)
from .engine import Request, ServeEngine

__all__ = [
    "KVLayout", "PagedKVDMA", "PagePool", "append_descriptors",
    "append_token", "gather_descriptors", "gather_kv", "init_paged_kv",
    "make_page_tables", "span_append_descriptors", "swap_descriptors",
    "BlockAllocator", "HashLM", "ReqState", "Scheduler", "ServeFrontDoor",
    "ServeRequest", "StepLM", "oracle_generate",
    "make_prefill_step", "make_decode_step", "GraphDecodeStep",
    "decode_graphs_fit", "ServeEngine", "Request",
    "greedy_sample", "temperature_sample",
]
