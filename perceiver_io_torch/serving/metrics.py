"""Serving counters of one ``ServingEngine``.

Port of the part of ``perceiver_io_tpu/serving/metrics.py``'s
``EngineMetrics`` that the port's engine feeds, with the JAX field and
method names: ``record_submit``, ``record_admit``, ``record_decode_step``,
``record_finish``, ``record_reject``, ``set_page_pool``, ``set_kv_quant``,
the prefix cache's ``record_prefix_hit``, ``record_prefix_evict`` and
``set_prefix_cache``, chunked admission's ``set_chunked_prefill`` and
``record_chunk``, the ragged tick's ``set_ragged_tick`` and
``record_tick_dispatch``, ``record_alloc_failure`` and ``snapshot()``. It
adds time to first token (``record_first_token``) and the peaks of pages in
use and of shared pages in use. Latency statistics describe the most recent
``LATENCY_WINDOW`` events; counters are lifetime totals. The JSONL event
stream comes in a later slice.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional

import numpy as np

LATENCY_WINDOW = 4096


def _latency_dict(xs) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "max": 0.0, "p50": 0.0, "p95": 0.0}
    arr = list(xs)
    p50, p95 = np.percentile(arr, [50, 95])
    return {"mean": sum(arr) / len(arr), "max": max(arr), "p50": float(p50), "p95": float(p95)}


def _percentiles(xs) -> Dict[str, float]:
    return {k: v for k, v in _latency_dict(xs).items() if k in ("p50", "p95")}


def _window() -> Deque:
    return deque(maxlen=LATENCY_WINDOW)


@dataclass
class EngineMetrics:
    """Mutable counters owned by one engine; never touches a tensor."""

    num_slots: int
    requests_submitted: int = 0
    requests_admitted: int = 0
    requests_finished: int = 0  # eos / length
    requests_rejected: int = 0  # refused at submit (queue bound, prompt too long)
    tokens_generated: int = 0
    decode_steps: int = 0
    prefills: int = 0
    decode_seconds: float = 0.0
    prefill_seconds: float = 0.0
    queue_depth: int = 0
    slots_busy: int = 0  # active slots in the latest decode step
    # page-pool gauges: pages_total None <=> a dense pool (snapshot page_pool: None)
    pages_total: Optional[int] = None
    pages_in_use: int = 0
    peak_pages_in_use: int = 0
    # quantized-page gauges: None <=> fp pages (snapshot kv_quant: None)
    kv_quant_mode: Optional[str] = None
    kv_bytes_per_token_fp: Optional[float] = None
    kv_bytes_per_token: Optional[float] = None
    alloc_failures: int = 0  # head-of-line blocking episodes on the free list
    # prefix-cache gauges: None <=> no cache (snapshot prefix_cache: None)
    prefix_cache: Optional[Dict] = None
    # chunked admission: chunk_tokens None <=> off (snapshot chunked_prefill: None)
    chunk_tokens: Optional[int] = None
    chunks_dispatched: int = 0
    chunked_admissions: int = 0
    # the tick dispatcher: None <=> a dense engine (snapshot ragged_tick: None)
    ragged_enabled: Optional[bool] = None
    ragged_ticks: int = 0
    _tick_program_counts: Deque[int] = field(default_factory=_window)
    _tick_chunk_counts: Deque[int] = field(default_factory=_window)
    _tick_finish_counts: Deque[int] = field(default_factory=_window)
    _tick_decode_counts: Deque[int] = field(default_factory=_window)
    _tick_build_times: Deque[float] = field(default_factory=_window)
    _start_time: Optional[float] = None
    _occupancy_sum: float = 0.0
    _queue_waits: Deque[float] = field(default_factory=_window)
    _prefill_times: Deque[float] = field(default_factory=_window)
    _decode_times: Deque[float] = field(default_factory=_window)
    _ttfts: Deque[float] = field(default_factory=_window)
    _pages_per_request: Deque[int] = field(default_factory=_window)

    def record_submit(self, request_id: int, prompt_len: int, priority: int = 0) -> None:
        if self._start_time is None:
            self._start_time = time.perf_counter()
        self.requests_submitted += 1
        self.queue_depth += 1

    def record_admit(self, request_id: int, slot: int, wait_s: float, prefill_s: float,
                     bucket: Optional[int] = None, pages: Optional[int] = None, priority: int = 0,
                     chunks: Optional[int] = None, shared_pages: Optional[int] = None) -> None:
        """``chunks``: a chunked admission's chunk count (None otherwise);
        ``shared_pages``: the prefix-cache pages it retained."""
        self.requests_admitted += 1
        self.prefills += 1
        self.prefill_seconds += prefill_s
        self.queue_depth = max(self.queue_depth - 1, 0)
        self._queue_waits.append(wait_s)
        self._prefill_times.append(prefill_s)
        if pages is not None:
            self._pages_per_request.append(pages)
        if chunks is not None:
            self.chunked_admissions += 1

    def record_chunk(self, request_id: int, slot: int, tokens: int, seconds: float) -> None:
        """One prefill chunk of ``tokens`` prompt tokens put on the tick."""
        self.chunks_dispatched += 1

    def record_prefix_hit(self, request_id: int, shared_pages: int, shared_tokens: int) -> None:
        """An admission retained ``shared_pages`` cached pages covering
        ``shared_tokens`` prompt tokens: an event of the JSONL stream (a
        later slice); the counts are the cache's ``stats()``."""

    def record_prefix_evict(self, pages_freed: int, pages_needed: int) -> None:
        """One LRU eviction episode, cached pages nobody referenced yielding
        to a live reservation: an event of the JSONL stream (a later slice);
        the counts are the cache's ``stats()``."""

    def set_prefix_cache(self, stats: Dict, shared_pages_in_use: int) -> None:
        """The cache's ``stats()`` plus the page-table entries backed by
        shared pages (now and at their peak)."""
        peak = max(shared_pages_in_use, self.prefix_cache["peak_shared_pages_in_use"] if self.prefix_cache else 0)
        self.prefix_cache = dict(stats, shared_pages_in_use=shared_pages_in_use, peak_shared_pages_in_use=peak)

    def set_chunked_prefill(self, chunk_tokens: int) -> None:
        self.chunk_tokens = chunk_tokens

    def set_ragged_tick(self, enabled: bool) -> None:
        self.ragged_enabled = bool(enabled)

    def record_tick_dispatch(self, programs: int, chunk_items: int, finish_items: int, decode_items: int,
                             build_s: float) -> None:
        """One dispatching tick: the host dispatches it made (the classic
        path's prefill and install, the tick's phases), its chunk and finish
        lanes, its decoding slots and the descriptor's build seconds."""
        self.ragged_ticks += 1
        self._tick_program_counts.append(int(programs))
        self._tick_chunk_counts.append(int(chunk_items))
        self._tick_finish_counts.append(int(finish_items))
        self._tick_decode_counts.append(int(decode_items))
        self._tick_build_times.append(float(build_s))

    def record_alloc_failure(self, request_id: int, pages_needed: int, pages_free: int) -> None:
        """One head-of-line blocking episode on the free list (counted once
        per episode, not per tick)."""
        self.alloc_failures += 1

    def record_first_token(self, request_id: int, ttft_s: float) -> None:
        """Time from submit to the request's first generated token on the
        host (after the tick's device sync)."""
        self._ttfts.append(ttft_s)

    def record_decode_step(self, active_slots: int, seconds: float, tokens: int) -> None:
        self.decode_steps += 1
        self.decode_seconds += seconds
        self.tokens_generated += tokens
        self.slots_busy = active_slots
        self._occupancy_sum += active_slots / max(self.num_slots, 1)
        self._decode_times.append(seconds)

    def record_finish(self, request_id: int, slot: int, new_tokens: int, reason: str,
                      status: str = "finished") -> None:
        self.requests_finished += 1

    def record_reject(self, request_id: int, reason: str) -> None:
        self.requests_rejected += 1
        self.queue_depth = max(self.queue_depth - 1, 0)

    def set_page_pool(self, total: int, in_use: int) -> None:
        self.pages_total = total
        self.pages_in_use = in_use
        self.peak_pages_in_use = max(self.peak_pages_in_use, in_use)

    def set_kv_quant(self, mode: str, bytes_per_token_fp: float, bytes_per_token: float) -> None:
        self.kv_quant_mode = mode
        self.kv_bytes_per_token_fp = bytes_per_token_fp
        self.kv_bytes_per_token = bytes_per_token

    def snapshot(self) -> Dict:
        wall = (time.perf_counter() - self._start_time) if self._start_time else 0.0
        return {
            "num_slots": self.num_slots,
            "requests_submitted": self.requests_submitted,
            "requests_admitted": self.requests_admitted,
            "requests_finished": self.requests_finished,
            "rejected": self.requests_rejected,
            "queue_depth": self.queue_depth,
            "slots_busy": self.slots_busy,
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "decode_seconds": self.decode_seconds,
            "prefill_seconds": self.prefill_seconds,
            "wall_seconds": wall,
            "decode_tokens_per_s": self.tokens_generated / self.decode_seconds if self.decode_seconds > 0 else 0.0,
            "wall_tokens_per_s": self.tokens_generated / wall if wall > 0 else 0.0,
            "mean_slot_occupancy": self._occupancy_sum / self.decode_steps if self.decode_steps else 0.0,
            "queue_wait_s": _latency_dict(self._queue_waits),
            "prefill_s": _latency_dict(self._prefill_times),
            "decode_step_s": _latency_dict(self._decode_times),
            "ttft_s": _latency_dict(self._ttfts),
            "kv_quant": None if self.kv_quant_mode is None else {
                "mode": self.kv_quant_mode,
                "bytes_per_token_fp": self.kv_bytes_per_token_fp,
                "bytes_per_token": self.kv_bytes_per_token,
            },
            "prefix_cache": None if self.prefix_cache is None else dict(self.prefix_cache),
            "chunked_prefill": None if self.chunk_tokens is None else {
                "chunk_tokens": self.chunk_tokens,
                "chunks_dispatched": self.chunks_dispatched,
                "chunked_admissions": self.chunked_admissions,
            },
            "ragged_tick": None if self.ragged_enabled is None else {
                "enabled": self.ragged_enabled,
                "ticks": self.ragged_ticks,
                **{name: _percentiles(xs) for name, xs in (
                    ("programs_per_tick", self._tick_program_counts), ("chunk_items", self._tick_chunk_counts),
                    ("finish_items", self._tick_finish_counts), ("decode_items", self._tick_decode_counts),
                    ("descriptor_build_s", self._tick_build_times))},
            },
            "page_pool": None if self.pages_total is None else {
                "pages_total": self.pages_total,
                "pages_in_use": self.pages_in_use,
                "peak_pages_in_use": self.peak_pages_in_use,
                "alloc_failures": self.alloc_failures,
                "pages_per_request": _percentiles(self._pages_per_request),
            },
        }
