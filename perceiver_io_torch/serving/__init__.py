"""Continuous-batching serving on the port: the engine with its request
lifecycle (priority classes, preemption and replay, deadlines, quarantine,
drain), its write-ahead request journal and crash recovery, weight serving
(bf16, int8) with in-place ``set_params``, its slot scheduler, the KV page
pool, the radix prefix cache, the engine's and the router's metrics with
their JSONL stream, the router over engine replicas, in process or one
worker process each behind the CRC-framed RPC transport, with the
supervisor that respawns a dead worker through its journal, and the
router's fleet operations: planned migration, the rolling restart,
versioned deploy and rollback, and autoscaling (port of
``perceiver_io_tpu.serving``)."""

from perceiver_io_torch.serving.engine import (
    TERMINAL_STATUSES,
    RequestStatus,
    ServedRequest,
    ServingEngine,
    SlotState,
    default_prefill_buckets,
)
from perceiver_io_torch.serving.journal import (
    JournalCorruptError,
    JournalSession,
    JournalState,
    JournalTornWrite,
    RequestJournal,
    read_journal,
)
from perceiver_io_torch.serving.metrics import KNOWN_SCHEMAS, SCHEMA, EngineMetrics, RouterMetrics, load_metrics_jsonl
from perceiver_io_torch.serving.paging import (PagePool, PrefixCache, page_keys_for_prompt, pages_for_request,
                                              pages_for_tokens)
from perceiver_io_torch.serving.quant import (
    WEIGHT_DTYPES,
    Int8Weight,
    cast_params_bf16,
    dequantize_params,
    kv_bytes_per_token,
    quantize_params_int8,
    serve_params,
    tree_bytes,
    tree_layout_mismatch,
)
from perceiver_io_torch.serving.router import (BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN, RoutedRequest,
                                               ServingRouter)
from perceiver_io_torch.serving.scheduler import SlotScheduler
from perceiver_io_torch.serving.transport import (EngineClient, FrameError, TransportError, WorkerDiedError,
                                                  WorkerOpError)

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "EngineClient",
    "EngineMetrics",
    "FrameError",
    "Int8Weight",
    "JournalCorruptError",
    "JournalSession",
    "JournalState",
    "JournalTornWrite",
    "KNOWN_SCHEMAS",
    "PagePool",
    "PrefixCache",
    "RequestJournal",
    "RequestStatus",
    "RoutedRequest",
    "RouterMetrics",
    "SCHEMA",
    "ServedRequest",
    "ServingEngine",
    "ServingRouter",
    "SlotScheduler",
    "SlotState",
    "TERMINAL_STATUSES",
    "TransportError",
    "WEIGHT_DTYPES",
    "WorkerDiedError",
    "WorkerOpError",
    "cast_params_bf16",
    "default_prefill_buckets",
    "dequantize_params",
    "kv_bytes_per_token",
    "load_metrics_jsonl",
    "page_keys_for_prompt",
    "pages_for_request",
    "pages_for_tokens",
    "quantize_params_int8",
    "read_journal",
    "serve_params",
    "tree_bytes",
    "tree_layout_mismatch",
]
