"""Serving counters of one ``ServingEngine`` and their JSONL event stream.

Port of ``perceiver_io_tpu/serving/metrics.py``'s ``EngineMetrics``, with
the JAX field and method names, and of its JSONL half: ``_JsonlMetrics``
(one line-buffered append handle for the owner's lifetime, an idempotent
``close``), ``EngineMetrics(jsonl_path=...)``, which writes the JAX
package's event with its fields for each ``record_*`` (``submit``,
``admit``, ``chunk``, ``prefix_hit``, ``prefix_evict``, ``preempt``,
``alloc_failure``, ``recovery``, ``quant_agreement``, ``decode_step``,
``finish``, ``reject``)
and ``write_snapshot`` a ``snapshot`` event, ``latency_estimates`` (the
router's shedding input), ``RouterMetrics`` (the in-process router's
events and snapshot), ``SCHEMA`` ("serving-metrics/v12"), ``KNOWN_SCHEMAS``
and the version-tolerant reader ``load_metrics_jsonl``. The two packages
read each other's files.

The snapshot's keys are the JAX snapshot's (``rejected``, ``timed_out``,
``failed``, ``preemptions``, ``preempted_replays``,
``queue_wait_by_priority``, ``journal``, ``weight_serving``, ...); the
fields only a router fills read as a plain JAX engine writes them
(``failovers`` and ``shed_infeasible`` 0, ``fleet_ops`` and ``transport``
None). ``tokens_generated`` counts useful tokens only: a quarantined slot's
sample and a replayed token are not counted. The port adds time to first
token (``record_first_token``, no event), the busy slots of the latest
decode and the peaks of pages in use and of shared pages in use. Latency
statistics describe the most recent ``LATENCY_WINDOW`` events; counters are
lifetime totals.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

SCHEMA = "serving-metrics/v12"
KNOWN_SCHEMAS = (
    "serving-metrics/v1",
    "serving-metrics/v2",
    "serving-metrics/v3",
    "serving-metrics/v4",
    "serving-metrics/v5",
    "serving-metrics/v6",
    "serving-metrics/v7",
    "serving-metrics/v8",
    "serving-metrics/v9",
    "serving-metrics/v10",
    "serving-metrics/v11",
    "serving-metrics/v12",
)
_V3_COUNTERS = ("rejected", "timed_out", "failed")
_V4_FIELDS = ("failovers", "shed_infeasible", "breaker_transitions")
_V6_FIELDS = ("preemptions", "preempted_replays", "queue_wait_by_priority")
_V8_FIELDS = ("prefix_cache", "chunked_prefill")
_V9_FIELDS = ("kv_quant", "weight_serving")
_PRE_V5 = KNOWN_SCHEMAS[:4]
_PRE_V6 = KNOWN_SCHEMAS[:5]
_PRE_V7 = KNOWN_SCHEMAS[:6]
_PRE_V8 = KNOWN_SCHEMAS[:7]
_PRE_V9 = KNOWN_SCHEMAS[:8]
_PRE_V10 = KNOWN_SCHEMAS[:9]
_PRE_V11 = KNOWN_SCHEMAS[:10]
_PRE_V12 = KNOWN_SCHEMAS[:11]

_PERCENTILE_KEYS = ("p50", "p95")
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


def load_metrics_jsonl(path: str) -> Dict:
    """Version-tolerant reader for engine JSONL logs.

    Returns ``{"events": [...], "snapshots": [...]}`` where every snapshot is
    normalized to the v2 shape: v1 snapshots (no percentile sub-dicts) get
    ``prefill_s``/``decode_step_s`` filled with ``None`` values and their
    ``queue_wait_s`` dict extended with ``p50: None, p95: None``. Unknown
    schema strings raise ``ValueError`` (corrupt/foreign files fail loudly,
    missing fields of known versions do not)."""
    events: List[Dict] = []
    snapshots: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            events.append(record)
            if record.get("event") != "snapshot":
                continue
            schema = record.get("schema")
            if schema not in KNOWN_SCHEMAS:
                raise ValueError(f"unknown metrics schema {schema!r} in {path}")
            snap = dict(record)
            if schema == "serving-metrics/v1":
                wait = dict(snap.get("queue_wait_s") or {})
                for k in _PERCENTILE_KEYS:
                    wait.setdefault(k, None)
                wait.setdefault("mean", None)
                wait.setdefault("max", None)
                snap["queue_wait_s"] = wait
                none_lat = {"mean": None, "max": None, "p50": None, "p95": None}
                snap.setdefault("prefill_s", dict(none_lat))
                snap.setdefault("decode_step_s", dict(none_lat))
            if schema in ("serving-metrics/v1", "serving-metrics/v2"):
                # pre-v3 writers had no admission-control outcomes: None, not
                # 0 — "not recorded" must stay distinguishable from "none"
                for k in _V3_COUNTERS:
                    snap.setdefault(k, None)
            if schema in ("serving-metrics/v1", "serving-metrics/v2", "serving-metrics/v3"):
                # pre-v4 writers had no multi-replica counters: same None
                # discipline (a v3 engine never measured failovers — it did
                # not run zero of them)
                for k in _V4_FIELDS:
                    snap.setdefault(k, None)
            if schema in _PRE_V5:
                # pre-v5 writers had no page pool; None also matches a
                # newer DENSE engine's truthful "no pool exists"
                snap.setdefault("page_pool", None)
            if schema in _PRE_V6:
                # pre-v6 writers had no priority/preemption counters: None,
                # not 0 — "not recorded" stays distinguishable from "none"
                for k in _V6_FIELDS:
                    snap.setdefault(k, None)
            if schema in _PRE_V7:
                # pre-v7 writers had no request journal; None also matches a
                # newer engine's truthful "no journal configured"
                snap.setdefault("journal", None)
            if schema in _PRE_V8:
                # pre-v8 writers had neither a prefix cache nor chunked
                # prefill: None, NOT 0 — "not recorded" must stay
                # distinguishable from "feature off / nothing happened"
                for k in _V8_FIELDS:
                    snap.setdefault(k, None)
            if schema in _PRE_V9:
                # pre-v9 writers served full-precision pages and untouched
                # params; None also matches a newer fp engine's truthful
                # "quantization off"
                for k in _V9_FIELDS:
                    snap.setdefault(k, None)
            if schema in _PRE_V10:
                # pre-v10 writers had no fleet-operations layer; None also
                # matches a newer plain engine's truthful "no fleet"
                snap.setdefault("fleet_ops", None)
            if schema in _PRE_V11:
                # pre-v11 writers had no unified ragged tick; None also
                # matches a newer DENSE engine's truthful "no tick dispatcher"
                snap.setdefault("ragged_tick", None)
            if schema in _PRE_V12:
                # pre-v12 writers had no out-of-process transport; None also
                # matches a newer in-process fleet's truthful "no RPC
                # boundary exists"
                snap.setdefault("transport", None)
            snapshots.append(snap)
    return {"events": events, "snapshots": snapshots}


class _JsonlMetrics:
    """Shared JSONL-emitter plumbing for ``EngineMetrics``/``RouterMetrics``:
    one line-buffered append handle for the owner's lifetime, terminal
    idempotent ``close()``, and shutdown-race-guarded teardown. Subclasses are
    dataclasses providing ``jsonl_path``/``_jsonl_file``/``_closed`` fields."""

    def _emit(self, event: str, **fields) -> None:
        if self.jsonl_path is None or self._closed:
            # a closed metrics object silently drops events instead of
            # resurrecting its handle: close() is a real end-of-life, and an
            # _emit racing interpreter teardown must not call open()
            return
        if self._jsonl_file is None:
            # one line-buffered handle for the owner's lifetime: _emit runs
            # once per decoded token, so per-event open/close syscalls would
            # tax the hot decode loop; line buffering keeps readers current
            self._jsonl_file = open(self.jsonl_path, "a", buffering=1)
        record = {"event": event, "ts": round(time.time(), 6), **fields}
        self._jsonl_file.write(json.dumps(record) + "\n")

    def _route_status(self, status: str) -> None:
        """Route one terminal outcome into the shared counter fields. Both
        metrics classes carry the same four counters; ONE router keeps the
        JSONL status strings and the snapshot counters from diverging (an
        eviction recorded as "rejected" must never count as finished)."""
        if status == "timed_out":
            self.requests_timed_out += 1
        elif status == "failed":
            self.requests_failed += 1
        elif status == "rejected":
            self.requests_rejected += 1
        else:
            self.requests_finished += 1

    def close(self) -> None:
        """Release the JSONL handle. Terminal and idempotent: a second close
        is a no-op, and later ``_emit`` calls are dropped instead of
        resurrecting the handle. Guarded against interpreter-shutdown races —
        ``getattr`` with a True default means a close racing module teardown
        (``__del__`` during finalization, partially torn-down instance) bails
        out instead of raising."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        f = self._jsonl_file
        self._jsonl_file = None
        if f is not None:
            try:
                f.close()
            except Exception:
                pass  # a handle torn down by interpreter exit is already closed

    def __del__(self):  # best-effort backstop; close() is the real contract
        try:
            self.close()
        except Exception:
            pass


@dataclass
class EngineMetrics(_JsonlMetrics):
    """Mutable counters owned by one engine; never touches a tensor.
    ``jsonl_path`` appends the event stream to that file (None: no stream)."""

    num_slots: int
    jsonl_path: Optional[str] = None
    requests_submitted: int = 0
    requests_admitted: int = 0
    requests_finished: int = 0  # successful completions (eos / length)
    requests_rejected: int = 0  # refused admission (queue bound, prompt too long, draining)
    requests_timed_out: int = 0  # deadline expiry, queued or running
    requests_failed: int = 0  # evicted by non-finite-logit quarantine, or cancelled
    tokens_generated: int = 0  # useful tokens only
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
    # greedy agreement of a quantized engine with a float reference, fed by
    # a harness (record_quant_agreement)
    agreement_tokens: int = 0
    agreement_matched: int = 0
    alloc_failures: int = 0  # head-of-line blocking episodes on the free list
    # the journal's gauges (RequestJournal.stats()): None <=> no journal
    journal: Optional[Dict] = None
    # weight serving: None <=> the parameters are served as the model holds them
    weight_serving: Optional[Dict] = None
    preemptions: int = 0  # running slots evicted under priority pressure
    preempted_replays: int = 0  # preempted continuations re-admitted (replay)
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
    _queue_waits_by_priority: Dict[int, Deque[float]] = field(default_factory=dict)
    _prefill_times: Deque[float] = field(default_factory=_window)
    _decode_times: Deque[float] = field(default_factory=_window)
    _ttfts: Deque[float] = field(default_factory=_window)
    _pages_per_request: Deque[int] = field(default_factory=_window)
    _jsonl_file: Optional[object] = field(default=None, repr=False)
    _closed: bool = field(default=False, repr=False)

    def record_submit(self, request_id: int, prompt_len: int, priority: int = 0) -> None:
        if self._start_time is None:
            self._start_time = time.perf_counter()
        self.requests_submitted += 1
        self.queue_depth += 1
        self._emit("submit", request_id=request_id, prompt_len=prompt_len, priority=priority)

    def record_admit(self, request_id: int, slot: int, wait_s: float, prefill_s: float,
                     bucket: Optional[int] = None, pages: Optional[int] = None, priority: int = 0,
                     preempted_replay: bool = False, chunks: Optional[int] = None,
                     shared_pages: Optional[int] = None) -> None:
        """``wait_s``: the current queue wait (since submit or the latest
        preemption), also kept per priority class; ``preempted_replay``: a
        preempted continuation re-admitted; ``chunks``: a chunked
        admission's chunk count (None otherwise); ``shared_pages``: the
        prefix-cache pages it retained."""
        self.requests_admitted += 1
        self.prefills += 1
        self.prefill_seconds += prefill_s
        self.queue_depth = max(self.queue_depth - 1, 0)
        self._queue_waits.append(wait_s)
        self._queue_waits_by_priority.setdefault(int(priority), _window()).append(wait_s)
        if preempted_replay:
            self.preempted_replays += 1
        self._prefill_times.append(prefill_s)
        extra = {} if bucket is None else {"bucket": bucket}
        if pages is not None:
            self._pages_per_request.append(pages)
            extra["pages"] = pages
        if preempted_replay:
            extra["preempted_replay"] = True
        if chunks is not None:
            self.chunked_admissions += 1
            extra["chunks"] = chunks
        if shared_pages:
            extra["shared_pages"] = shared_pages
        self._emit("admit", request_id=request_id, slot=slot, wait_s=round(wait_s, 6),
                   prefill_s=round(prefill_s, 6), priority=priority, **extra)

    def record_chunk(self, request_id: int, slot: int, tokens: int, seconds: float) -> None:
        """One prefill chunk of ``tokens`` prompt tokens put on the tick."""
        self.chunks_dispatched += 1
        self._emit("chunk", request_id=request_id, slot=slot, tokens=tokens, seconds=round(seconds, 6))

    def record_prefix_hit(self, request_id: int, shared_pages: int, shared_tokens: int) -> None:
        """An admission retained ``shared_pages`` cached pages covering
        ``shared_tokens`` prompt tokens (an event; the counts are the
        cache's ``stats()``)."""
        self._emit("prefix_hit", request_id=request_id, shared_pages=shared_pages, shared_tokens=shared_tokens)

    def record_prefix_evict(self, pages_freed: int, pages_needed: int) -> None:
        """One LRU eviction episode, cached pages nobody referenced yielding
        to a live reservation (an event; the counts are the cache's
        ``stats()``)."""
        self._emit("prefix_evict", pages_freed=pages_freed, pages_needed=pages_needed)

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
        self._emit("alloc_failure", request_id=request_id, pages_needed=pages_needed, pages_free=pages_free)

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
        self._emit("decode_step", active_slots=active_slots, seconds=round(seconds, 6), tokens=tokens)

    def record_finish(self, request_id: int, slot: int, new_tokens: int, reason: str,
                      status: str = "finished") -> None:
        """Terminal event of a request that held a slot; ``status``
        "finished", "timed_out", "failed" or "rejected" routes the count."""
        self._route_status(status)
        self._emit("finish", request_id=request_id, slot=slot, new_tokens=new_tokens, reason=reason, status=status)

    def record_reject(self, request_id: int, reason: str) -> None:
        """A request refused admission (submitted, never reached a slot)."""
        self.requests_rejected += 1
        self.queue_depth = max(self.queue_depth - 1, 0)
        self._emit("reject", request_id=request_id, reason=reason)

    def record_preempt(self, request_id: int, slot: int, preempted_by: int, pages_freed: int,
                       emitted_tokens: int, priority: int) -> None:
        """One priority preemption: a running slot evicted so a higher-class
        blocked request can admit; the victim re-enters the queue."""
        self.preemptions += 1
        self.queue_depth += 1
        self._emit("preempt", request_id=request_id, slot=slot, preempted_by=preempted_by, pages_freed=pages_freed,
                   emitted_tokens=emitted_tokens, priority=priority)

    def record_timeout_queued(self, request_id: int, reason: str = "deadline", new_tokens: int = 0) -> None:
        """A queued request whose deadline expired while waiting
        (``new_tokens``: what a preempted continuation had emitted)."""
        self.record_evict_queued(request_id, reason, status="timed_out", new_tokens=new_tokens)

    def record_evict_queued(self, request_id: int, reason: str, status: str, new_tokens: int = 0) -> None:
        """A queued request evicted before (re)reaching a slot; ``status``
        routes the count as ``record_finish`` does."""
        self._route_status(status)
        self.queue_depth = max(self.queue_depth - 1, 0)
        self._emit("finish", request_id=request_id, slot=None, new_tokens=new_tokens, reason=reason, status=status)

    def set_page_pool(self, total: int, in_use: int) -> None:
        self.pages_total = total
        self.pages_in_use = in_use
        self.peak_pages_in_use = max(self.peak_pages_in_use, in_use)

    def set_kv_quant(self, mode: str, bytes_per_token_fp: float, bytes_per_token: float) -> None:
        self.kv_quant_mode = mode
        self.kv_bytes_per_token_fp = round(bytes_per_token_fp, 3)
        self.kv_bytes_per_token = round(bytes_per_token, 3)

    def record_quant_agreement(self, matched: int, total: int) -> None:
        """One greedy-agreement sample: a harness decoded ``total`` tokens on
        this quantized engine against a float reference and ``matched`` of
        them agreed. The counts ride the snapshot's ``kv_quant`` section."""
        self.agreement_matched += int(matched)
        self.agreement_tokens += int(total)
        self._emit("quant_agreement", matched=int(matched), total=int(total))

    def set_journal(self, stats: Dict) -> None:
        """The journal's gauges (``RequestJournal.stats()``), refreshed once
        a tick flush; the snapshot copies the latest block."""
        self.journal = dict(stats)

    def record_recovery(self, sessions: int, replayed_tokens: int, truncated: bool, dropped_records: int,
                        generation: int) -> None:
        """One recovery from a journal (``ServingEngine.recover``): the live
        sessions rebuilt, the tokens their replays carry, and whether the
        read hit a torn tail (with the records it dropped)."""
        self._emit("recovery", sessions=sessions, replayed_tokens=replayed_tokens, truncated=truncated,
                   dropped_records=dropped_records, generation=generation)

    def set_weight_serving(self, dtype: str, param_bytes: int, param_bytes_fp: int) -> None:
        """Mark the weight-serving transform active: its dtype and the served
        and float bytes of the parameters."""
        self.weight_serving = {"dtype": dtype, "param_bytes": int(param_bytes), "param_bytes_fp": int(param_bytes_fp)}

    def latency_estimates(self) -> Optional[Dict[str, float]]:
        """Windowed p95s for the router's SLO feasibility estimate: queue
        wait, prefill and decode step, with the lifetime decode-step count as
        the warm-up gate. None until the engine has decoded at all: cold
        estimates never drive admission."""
        if not self._decode_times:
            return None
        return {
            "queue_wait_p95_s": float(np.percentile(list(self._queue_waits), 95)) if self._queue_waits else 0.0,
            "prefill_p95_s": float(np.percentile(list(self._prefill_times), 95)) if self._prefill_times else 0.0,
            "decode_step_p95_s": float(np.percentile(list(self._decode_times), 95)),
            "decode_steps": self.decode_steps,
        }

    def snapshot(self) -> Dict:
        wall = (time.perf_counter() - self._start_time) if self._start_time else 0.0
        return {
            "schema": SCHEMA,
            "num_slots": self.num_slots,
            "requests_submitted": self.requests_submitted,
            "requests_admitted": self.requests_admitted,
            "requests_finished": self.requests_finished,
            "rejected": self.requests_rejected,
            "timed_out": self.requests_timed_out,
            "failed": self.requests_failed,
            # a router's counters: a plain engine fails over and sheds nothing
            "failovers": 0,
            "shed_infeasible": 0,
            "breaker_transitions": {},
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
            "preemptions": self.preemptions,
            "preempted_replays": self.preempted_replays,
            "queue_wait_by_priority": {str(p): _percentiles(xs)
                                       for p, xs in sorted(self._queue_waits_by_priority.items())},
            "kv_quant": None if self.kv_quant_mode is None else {
                "mode": self.kv_quant_mode,
                "bytes_per_token_fp": self.kv_bytes_per_token_fp,
                "bytes_per_token": self.kv_bytes_per_token,
                "agreement_tokens": self.agreement_tokens,
                "agreement_matched": self.agreement_matched,
                "agreement_rate": round(self.agreement_matched / self.agreement_tokens, 4)
                if self.agreement_tokens else None,
            },
            "journal": None if self.journal is None else dict(self.journal),
            "weight_serving": None if self.weight_serving is None else dict(self.weight_serving),
            "fleet_ops": None,  # a router's
            "transport": None,  # a router's
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

    def write_snapshot(self) -> Dict:
        """Append the snapshot as a ``snapshot`` event and return it."""
        snap = self.snapshot()
        self._emit("snapshot", **snap)
        return snap


@dataclass
class RouterMetrics(_JsonlMetrics):
    """Counters owned by one ``ServingRouter``: the router-level outcomes
    (dispatch, failover, shed, breaker transitions) and, in the snapshot,
    each replica engine's snapshot under ``replicas``. The JSONL stream
    holds the router's events (``submit``, ``dispatch``, ``failover``,
    ``shed``, ``breaker``, ``finish``) and its ``snapshot``s; each engine
    writes its own stream (the router's ``replica_metrics_jsonl``
    template). The fleet operations add their events (``migrate``,
    ``recycle``, ``deploy``, ``rollback``, ``autoscale``) and the
    snapshot's ``fleet_ops`` section: their counters, the gauges the router
    sets (``set_fleet_gauges``) and, once a deploy has registered a second
    parameter version, the ``rollout`` table with its ``versions`` rows
    (submitted, finished, tokens by version). ``transport`` is None
    in-process; a process-replica fleet sets it (``set_transport``) with
    the lifetime ``worker_respawns`` and ``rpc_retries`` in it, whose
    events (``respawn``, ``rpc_retry``) join the stream."""

    num_replicas: int
    jsonl_path: Optional[str] = None
    requests_submitted: int = 0
    requests_dispatched: int = 0  # engine submits a replica accepted
    requests_finished: int = 0
    requests_rejected: int = 0  # every router-level refusal, sheds included
    requests_timed_out: int = 0
    requests_failed: int = 0  # containment and max_failovers
    failovers: int = 0  # re-dispatches of a lost replica's live requests
    shed_infeasible: int = 0  # admission-time SLO sheds (a subset of rejected)
    breaker_transitions: Dict[str, int] = field(default_factory=dict)
    # the fleet operations: planned migrations, rolling-restart recycles,
    # the autoscaler's decisions, the gauges the router sets, and by
    # version {"submitted", "finished", "tokens_generated"} (the rollout
    # table, None until a deploy: rollout_state)
    migrations: int = 0
    recycles: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    replicas_active: Optional[int] = None  # None until the router sets it
    restart_in_progress: bool = False
    versions: Dict[str, Dict[str, int]] = field(default_factory=dict)
    rollout_state: Optional[Dict] = None  # {rollout_version, fraction, primary_version}
    # process replicas: supervisor respawns and transport retries over the
    # router's life; the RPC gauges arrive with each snapshot (set_transport)
    worker_respawns: int = 0
    rpc_retries: int = 0
    transport_state: Optional[Dict] = None
    _start_time: Optional[float] = None
    _jsonl_file: Optional[object] = field(default=None, repr=False)
    _closed: bool = field(default=False, repr=False)

    def record_submit(self, request_id: int, prompt_len: int, priority: int = 0,
                      version: Optional[int] = None) -> None:
        """``version``: the session's parameter-version pin, on the event
        when given."""
        if self._start_time is None:
            self._start_time = time.perf_counter()
        self.requests_submitted += 1
        extra = {}
        if version is not None:
            self._version_row(version)["submitted"] += 1
            extra["version"] = version
        self._emit("submit", request_id=request_id, prompt_len=prompt_len, priority=priority, **extra)

    def _version_row(self, version: int) -> Dict[str, int]:
        return self.versions.setdefault(str(version), {"submitted": 0, "finished": 0, "tokens_generated": 0})

    def record_dispatch(self, request_id: int, replica: int, load: int) -> None:
        """One hand-off a replica's engine accepted (a first dispatch or a
        failover's); ``load`` is the replica's load at the decision."""
        self.requests_dispatched += 1
        self._emit("dispatch", request_id=request_id, replica=replica, load=load)

    def record_failover(self, request_id: int, from_replica: int, emitted_tokens: int, failover_n: int) -> None:
        self.failovers += 1
        self._emit("failover", request_id=request_id, from_replica=from_replica, emitted_tokens=emitted_tokens,
                   failover_n=failover_n)

    def record_shed(self, request_id: int, deadline_s: float, estimate_s: float) -> None:
        """An admission-time shed: the latency estimate says the deadline
        cannot be met, so the request is REJECTED before it queues."""
        self.shed_infeasible += 1
        self._emit("shed", request_id=request_id, deadline_s=round(deadline_s, 6), estimate_s=round(estimate_s, 6))

    def record_breaker(self, replica: int, old: str, new: str, tick: int) -> None:
        key = f"{old}->{new}"
        self.breaker_transitions[key] = self.breaker_transitions.get(key, 0) + 1
        self._emit("breaker", replica=replica, transition=key, tick=tick)

    def record_migration(self, request_id: int, src: int, dst: int, emitted_tokens: int) -> None:
        """One planned migration: the session left ``src`` through the
        engine's eviction and landed on ``dst`` as a forced replay of
        ``emitted_tokens`` tokens (no replica lost, no failover spent;
        ``src`` -1 for a parked session)."""
        self.migrations += 1
        self._emit("migrate", request_id=request_id, src=src, dst=dst, emitted_tokens=emitted_tokens)

    def record_recycle(self, replica: int, sessions_moved: int, leftover_sessions: int, tick: int) -> None:
        """One rolling-restart recycle: the replica's sessions moved to
        siblings or parked (``sessions_moved``), its engine was rebuilt
        (through its journal: ``leftover_sessions`` it adopted again) and
        it serves again."""
        self.recycles += 1
        self._emit("recycle", replica=replica, sessions_moved=sessions_moved, leftover_sessions=leftover_sessions,
                   tick=tick)

    def record_deploy(self, version: int, fraction: float, target_replicas: List[int]) -> None:
        """One deploy: ``version`` takes ``fraction`` of new admissions, and
        ``target_replicas`` flip to it once empty."""
        self.rollout_state = {"rollout_version": version, "fraction": round(float(fraction), 4)}
        self._version_row(version)  # the table shows the version from the start
        self._emit("deploy", version=version, fraction=round(float(fraction), 4),
                   target_replicas=list(target_replicas))

    def record_rollback(self, from_version: int, to_version: int) -> None:
        """One rollback: new admissions pin ``to_version`` again; sessions
        pinned to ``from_version`` finish on it."""
        self._emit("rollback", from_version=from_version, to_version=to_version)

    def record_autoscale(self, direction: str, replica: int, active: int, load: int, tick: int) -> None:
        """One autoscaler decision, "up" (a replica revived or added) or
        "down" (one retired by draining it), with the fleet load that
        decided it."""
        if direction == "up":
            self.scale_ups += 1
        else:
            self.scale_downs += 1
        self.replicas_active = active
        self._emit("autoscale", direction=direction, replica=replica, active=active, load=load, tick=tick)

    def set_fleet_gauges(self, replicas_active: int, restart_in_progress: bool,
                         primary_version: Optional[int] = None) -> None:
        """The replicas in service, whether a rolling restart runs, and the
        primary version (shown in the rollout section once a deploy made
        one)."""
        self.replicas_active = replicas_active
        self.restart_in_progress = restart_in_progress
        if primary_version is not None and self.rollout_state is not None:
            self.rollout_state["primary_version"] = primary_version

    def record_respawn(self, replica: int, sessions: int, tick: int) -> None:
        """One supervisor respawn: the replica's dead worker process was
        replaced and attached again through its own journal's recovery
        (``sessions`` live sessions came back), with no breaker strike and
        no failover spent."""
        self.worker_respawns += 1
        self._emit("respawn", replica=replica, sessions=sessions, tick=tick)

    def record_rpc_retry(self, replica: int, op: str, attempt: int, err: str, delay: float) -> None:
        """One transport retry: attempt ``attempt`` of ``op`` on ``replica``
        failed with ``err`` and the backoff sleeps ``delay`` seconds."""
        self.rpc_retries += 1
        self._emit("rpc_retry", replica=replica, op=op, attempt=attempt, err=err, delay_s=round(float(delay), 6))

    def set_transport(self, stats: Optional[Dict]) -> None:
        """The fleet's transport gauges, summed over its clients (None
        in-process)."""
        self.transport_state = stats

    def record_finish(self, request_id: int, status: str, reason: Optional[str], new_tokens: int, failovers: int,
                      version: Optional[int] = None) -> None:
        """A request's terminal router-level outcome; ``status`` routes the
        count as the engine's does."""
        self._route_status(status)
        extra = {}
        if version is not None:
            row = self._version_row(version)
            if status == "finished":
                row["finished"] += 1
            row["tokens_generated"] += int(new_tokens)
            extra["version"] = version
        self._emit("finish", request_id=request_id, status=status, reason=reason, new_tokens=new_tokens,
                   failovers=failovers, **extra)

    def snapshot(self, replicas: Optional[Dict[str, Dict]] = None) -> Dict:
        """The router's counters with the replica snapshots handed in (the
        engines generate the tokens; the router sums them over the wall
        clock, since the replicas' decode windows overlap)."""
        wall = (time.perf_counter() - self._start_time) if self._start_time else 0.0
        replicas = replicas or {}
        tokens = sum(s.get("tokens_generated", 0) for s in replicas.values())
        return {
            "schema": SCHEMA,
            "num_replicas": self.num_replicas,
            "requests_submitted": self.requests_submitted,
            "requests_dispatched": self.requests_dispatched,
            "requests_finished": self.requests_finished,
            "rejected": self.requests_rejected,
            "timed_out": self.requests_timed_out,
            "failed": self.requests_failed,
            "failovers": self.failovers,
            "shed_infeasible": self.shed_infeasible,
            "breaker_transitions": dict(sorted(self.breaker_transitions.items())),
            # preemptions happen inside the engines: the router sums them;
            # queue waits are per engine, in the replica sections
            "preemptions": sum(s.get("preemptions") or 0 for s in replicas.values()),
            "preempted_replays": sum(s.get("preempted_replays") or 0 for s in replicas.values()),
            "queue_wait_by_priority": None,
            # pools, journals, caches and served weights are per engine
            "page_pool": None,
            "journal": None,
            "prefix_cache": None,
            "chunked_prefill": None,
            "kv_quant": None,
            "weight_serving": None,
            "ragged_tick": None,
            # the router's own lifecycle; the rollout table once a deploy
            # registered a second version (versions in numeric order)
            "fleet_ops": {
                "migrations": self.migrations,
                "recycles": self.recycles,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "replicas_active": self.num_replicas if self.replicas_active is None else self.replicas_active,
                "restart_in_progress": self.restart_in_progress,
                "rollout": None if self.rollout_state is None else {
                    **self.rollout_state,
                    "versions": {v: dict(row) for v, row in sorted(self.versions.items(), key=lambda kv: int(kv[0]))},
                },
            },
            # None in-process (no RPC boundary); the lifetime respawn and
            # retry totals ride the block
            "transport": None if self.transport_state is None else {
                **self.transport_state, "worker_respawns": self.worker_respawns, "rpc_retries": self.rpc_retries},
            "tokens_generated": tokens,
            "wall_seconds": round(wall, 6),
            "wall_tokens_per_s": round(tokens / wall, 3) if wall > 0 else 0.0,
            "replicas": replicas,
        }

    def write_snapshot(self, replicas: Optional[Dict[str, Dict]] = None) -> Dict:
        """Append the snapshot as a ``snapshot`` event and return it."""
        snap = self.snapshot(replicas)
        self._emit("snapshot", **snap)
        return snap
