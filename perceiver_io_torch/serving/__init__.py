"""Continuous-batching serving on the port: the engine, its slot scheduler,
the KV page pool, the radix prefix cache and the engine's metrics (port of
``perceiver_io_tpu.serving``; the router, transport, worker and journal come
in later slices)."""

from perceiver_io_torch.serving.engine import (
    RequestStatus,
    ServedRequest,
    ServingEngine,
    SlotState,
    default_prefill_buckets,
)
from perceiver_io_torch.serving.metrics import EngineMetrics
from perceiver_io_torch.serving.paging import (PagePool, PrefixCache, page_keys_for_prompt, pages_for_request,
                                              pages_for_tokens)
from perceiver_io_torch.serving.quant import kv_bytes_per_token
from perceiver_io_torch.serving.scheduler import SlotScheduler

__all__ = [
    "EngineMetrics",
    "PagePool",
    "PrefixCache",
    "RequestStatus",
    "ServedRequest",
    "ServingEngine",
    "SlotScheduler",
    "SlotState",
    "default_prefill_buckets",
    "kv_bytes_per_token",
    "page_keys_for_prompt",
    "pages_for_request",
    "pages_for_tokens",
]
