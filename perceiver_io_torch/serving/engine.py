"""Continuous-batching inference engine over a fixed pool of decode slots.

Port of ``perceiver_io_tpu/serving/engine.py``: ``SlotState``,
``RequestStatus``, ``ServedRequest``, ``_PrefillTask``,
``default_prefill_buckets``, ``_engine_compatible`` and ``ServingEngine``
with dense or paged slot pools, fp, int8 or int4 KV pages, chunked prefill,
the cross-request radix prefix cache, the ragged tick and its
dispatch/harvest split, the request lifecycle, the write-ahead request
journal with crash recovery, the metrics' JSONL stream, and weight serving
with in-place ``set_params``.

  * The engine owns ``num_slots`` decode slots stacked into one batched cache
    (batch row = slot): a dense ``PerceiverARCache`` pinned at full window
    capacity, or, with ``kv_page_size``, a ``PagedPerceiverARCache`` whose
    cross-attention KV lives in a shared page pool (``kv_quant`` "int8" or
    "int4" stores it quantized).
  * A tick (``step()``: ``step_dispatch()`` then ``step_harvest()``) advances
    the slots mid-admission one prefill chunk each, admits queued requests
    into free slots, runs the tick's device work, and then syncs with the
    device once, when the host reads the sampled tokens, to harvest them and
    evict finished requests (EOS or ``max_new_tokens``).
  * Admission. Dense pools, and paged pools for prompts shorter than
    ``max_latents``: one batch-1 prefill at the smallest covering bucket of
    ``prefill_buckets``, then ``write_slot`` (dense) or ``install_slot``
    (paged), at once. Paged pools admit every prompt with ``n >= max_latents``
    through the SPLIT path, as the JAX engine's ragged tick does: the slot and
    its reservation are claimed, pages a cached prefix already holds are
    retained (``PrefixCache``), and a ``_PrefillTask`` puts the prompt's
    remaining KV rows on the tick as chunks (all at once, or
    ``prefill_chunk_tokens`` a tick, at most ``max_prefill_slots`` prompts in
    flight); after the last chunk a finish lane computes the latents against
    the written pages and activates the slot, which decodes in the same tick.
  * The ragged tick. The tick's buffered work (quantized pages' scale
    resets, chunk lanes, finish lanes) is packed on the host into a
    fixed-shape descriptor (``_TickDescriptor``: lanes x cap chunk ids, trash
    tables and a latent start of 2**30 on idle lanes), copied to the device
    once, and run in the JAX program's phase order: resets, chunks,
    finishes, then decode. A phase with no work is skipped on the host, as
    the JAX program's ``lax.cond`` skips it.
  * The decode. Sampling runs eagerly (one ``torch.Generator`` per sampled
    request, seeded from ``submit(seed=...)``); the sampled tokens go into a
    static (num_slots, 1) buffer, and the model's decode step runs from it to
    a static logits buffer. On a card that step is one CUDA graph, captured
    once per engine at construction (``cuda_graph=True``, the default): the
    20 layers' GEMMs, norms and copies and the cross-attention kernel (B2 for
    dense pools, B3 for fp/int8 pools, B4 for int4 pools) replay as one
    launch, the port's counterpart of the JAX engine's one compiled tick
    program (watchdog budget 1). The graph replays the addresses it
    captured, so the decode step updates every cache tensor in place, the
    cache's Python-int lengths stay pinned at capacity (checked at every
    replay), and the split-K workspace the capture saw lives as long as the
    graph. A failed capture raises; the engine never falls back to eager on
    its own. ``cuda_graph=False`` runs the same step eagerly (the card tests'
    oracle); on the CPU the tick always runs eagerly.
  * Paged admission reserves the whole request up front (bucket plus
    ``max_new_tokens``, capped at the window) from a deterministic
    ``PagePool``, counting pages shared with the prefix cache once; under
    pressure cached pages nobody references are evicted (refcount-aware LRU)
    before the queue head blocks, so pool exhaustion surfaces as
    ``queue_full`` backpressure at submit, never as a fault mid-decode.
    Eviction releases the pages (shared ones lose one reference) and points
    the slot's table at the trash page.

  * Priority classes and preemption. ``submit(priority=k)`` places a request
    in class k (small int, default 0, higher wins); admission runs by
    (effective class, submit order), a queued request rising one class per
    ``priority_aging_ticks`` ticks waited. When the admission-order head is
    blocked on slots or pages, the engine preempts the cheapest set of
    running slots of a strictly lower base class that frees enough
    (``_select_victims``: lowest class, then the largest reservation, then
    the youngest; minimised; at most ``max_preemptions`` preemptions a
    request, then it is untouchable). A victim is released as an eviction
    is, goes PREEMPTED (not terminal) and re-queues at its class and
    seniority as prompt plus emitted tokens: after its prefill the decode
    step forces those tokens (``replay_ids``) through a mux before the
    graph's token buffer, while the slot still draws from its generator,
    so the resumed stream equals the uncontended one, sampled or greedy.
  * Deadlines. ``deadline_s`` (or ``default_deadline_s``) is a TTL from
    submit, enforced at tick boundaries: expired requests, queued or
    running, end TIMED_OUT with the tokens they had.
  * Quarantine. The decode phase probes each active slot's logits for
    non-finite values on the device, before sampling (rows that fail are
    sampled from neutral logits), and the tick's one sync reads the probe
    with the tokens; a failing slot's token is discarded, its cache rows
    (dense) or the pages it alone holds and their scales (paged, after
    invalidating its prefix-cache subtree) are zeroed in place, and it ends
    FAILED. ``evict_request`` cancels a queued or running request.
  * Drain. ``drain()`` closes admission (later submits are REJECTED
    "draining"), rejects the never-admitted backlog and runs running and
    PREEMPTED work to completion; ``handle_preemption=True`` does the same
    at the next tick after SIGTERM/SIGINT, and ``close()`` restores the
    previous handlers.

Greedy output is token-identical to ``generate()`` on the same canonical
form, and to the JAX engine's with chunking and the prefix cache on or off,
and with preemption. Sampled requests draw from their own generator, so
their tokens depend on their prompt, config and seed only, not on their slot,
their slot-mates or their preemptions; they cannot reproduce the JAX
engine's key chain. A tick's numerics do not depend on what else it holds:
prefill and finish lanes are batch-1, the chunk phase always projects the
descriptor's full (lanes, cap) shape, and the decode step has the fixed
(num_slots, 1) shape.

  * The journal. With ``journal=<dir>`` (or a ``RequestJournal``) every
    accepted request is on disk before ``submit`` returns (its ``accept``
    record, fsynced under the default policy); each tick's admissions,
    free-running tokens and terminal outcomes land as one buffered write at
    the end of the harvest. ``ServingEngine.recover(model, dir, ...)``
    rebuilds the queue and every in-flight session in a fresh process: each
    live session is resubmitted at its class in accept order with its
    journaled tokens as ``replay_ids`` (sessions once admitted come back
    PREEMPTED, holding those tokens), and only then does the journal swap to
    a new generation. Greedy and sampled continuations equal an
    uninterrupted run's tokens, since a request's generator restarts from
    its seed and a replaying slot still draws.
  * Weight serving. ``weight_dtype="bf16"`` or ``"int8"`` transforms the
    model's own parameters in place at construction (``serve_model_params``:
    the engine takes the model over, and its float parameters are dropped,
    so they stay on the card only where the caller holds them). Under int8
    each layer dequantizes its weights when it runs, inside the decode
    graph too, so the graph's pool holds about one layer's float weights,
    not a float copy of the model. ``set_params`` re-applies the transform
    to new parameters and copies them into the served tensors in place: the
    decode graph keeps its one capture, and the prefix cache starts cold.

The router (``serving/router.py``) runs several engines as replicas: it
calls ``step_dispatch``/``step_harvest``, ``evict_request(status=,
queued_only=)``, ``discard_pending_harvest`` and ``_recover_attach``.

  * Telemetry (``obs/``). ``telemetry`` (True, a trace path, a recorder, or
    None for the ``PERCEIVER_IO_TORCH_TELEMETRY`` environment variable)
    records the JAX engine's phase spans under ``obs_ns`` (``{obs_ns}.tick``
    from dispatch to harvest, ``.admit``, ``.prefill_dispatch`` and
    ``.install`` of a classic admission, ``.decode_dispatch``,
    ``.sample_sync`` around the tick's one sync, ``.evict``), its counters
    and gauges, one async span a request (category ``request.e{n}``, one an
    engine) from submit to its terminal status, and a compile watchdog whose
    ``{obs_ns}.decode_step`` reads the decode graph's captures (budget 1).
    Spans time host calls only: nothing reads the device for them, and no
    recorder call runs inside the decode step or its capture.

Not in this slice (ROADMAP A): the JAX package's kill-switch environment
variables.
"""

from __future__ import annotations

import itertools
import os
import time
import weakref
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

import perceiver_io_torch.ops.decode_kernel as dk
import perceiver_io_torch.ops.paged_decode_kernel as pk
import perceiver_io_torch.ops.ragged_paged_kernel as rk
from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.generation.sampling import process_logits_batched, sample_token_batched
from perceiver_io_torch.obs.core import resolve_recorder
from perceiver_io_torch.obs.watchdog import CompileWatchdog
from perceiver_io_torch.ops.paged_decode_kernel import KV_QUANT_MODES
from perceiver_io_torch.reliability import faults
from perceiver_io_torch.reliability.preemption import install_preemption_handler, restore_preemption_handler
from perceiver_io_torch.serving.journal import JournalCorruptError, JournalSession, RequestJournal, read_journal
from perceiver_io_torch.serving.metrics import EngineMetrics
from perceiver_io_torch.serving.paging import PagePool, PrefixCache, page_keys_for_prompt, pages_for_request
from perceiver_io_torch.serving.quant import (WEIGHT_DTYPES, copy_served_params, kv_bytes_per_token,
                                              serve_model_params, serve_params, tree_layout_mismatch)
from perceiver_io_torch.serving.scheduler import SlotScheduler

# the decode-attention kernels a decode step can launch, by the names
# chip_smoke.py and the PERF tables use; a graph replay adds the launches its
# capture recorded to their counters
_KERNELS = {"B2": dk, "B3": pk, "B4": rk}
# latent start of an idle chunk lane: beyond every position, so no row is a latent
_IDLE_LATENT_START = 2**30
# numbers each engine's async-span category: request ids restart at 0 in every
# engine, so engines sharing one recorder must not collide on (cat, id)
_ENGINE_IDS = itertools.count()


class _CaptureProbe:
    """The decode graph's captures behind the compile watchdog's
    ``_cache_size()`` probe, read through a weak reference: the watchdog
    keeps no engine alive."""

    __slots__ = ("_engine",)

    def __init__(self, engine: "ServingEngine"):
        self._engine = weakref.ref(engine)

    def _cache_size(self) -> int:
        engine = self._engine()
        return 0 if engine is None else engine.decode_compilations


@dataclass
class SlotState:
    """Per-slot decode state. ``next_logits`` (B, V) on the device (written
    by admission, by decode afterwards, always in place); ``active`` (B,)
    bool and ``pad_id`` (B,) on the device (inactive rows decode their pad
    token); the sampling parameters in their neutral encodings (temperature
    1.0, top_k 0, top_p 1.0) on the host, with one generator per sampled
    slot."""

    next_logits: torch.Tensor
    active: torch.Tensor
    pad_id: torch.Tensor
    temperature: List[float]
    top_k: List[int]
    top_p: List[float]
    do_sample: List[bool]
    generators: List[Optional[torch.Generator]]

    @staticmethod
    def create(num_slots: int, vocab_size: int, logits_dtype, device) -> "SlotState":
        return SlotState(
            next_logits=torch.zeros(num_slots, vocab_size, dtype=logits_dtype, device=device),
            active=torch.zeros(num_slots, dtype=torch.bool, device=device),
            pad_id=torch.zeros(num_slots, dtype=torch.int64, device=device),
            temperature=[1.0] * num_slots, top_k=[0] * num_slots, top_p=[1.0] * num_slots,
            do_sample=[False] * num_slots, generators=[None] * num_slots,
        )

    def install(self, slot: int, logits: torch.Tensor, config: GenerationConfig,
                generator: Optional[torch.Generator]) -> None:
        """Activate ``slot`` with its first logits (1, V). Greedy requests
        take the neutral encodings whatever their temperature/top-k/top-p
        (argmax survives scaling and filtering)."""
        sampled = bool(config.do_sample)
        self.next_logits[slot] = logits[0].to(self.next_logits.dtype)
        self.active[slot] = True
        self.pad_id[slot] = int(config.pad_token_id)
        self.temperature[slot] = float(config.temperature) if sampled else 1.0
        self.top_k[slot] = int(config.top_k) if (sampled and config.top_k) else 0
        self.top_p[slot] = float(config.top_p) if (sampled and config.top_p is not None) else 1.0
        self.do_sample[slot] = sampled
        self.generators[slot] = generator if sampled else None

    def release(self, slot: int) -> None:
        """Back to the neutral encodings (the pad id stays)."""
        self.active[slot] = False
        self.next_logits[slot] = 0
        self.temperature[slot], self.top_k[slot], self.top_p[slot] = 1.0, 0, 1.0
        self.do_sample[slot] = False
        self.generators[slot] = None


class RequestStatus(str, Enum):
    QUEUED = "queued"
    RUNNING = "running"
    # not terminal: evicted from its slot under priority pressure, queued
    # again at its class awaiting its replay
    PREEMPTED = "preempted"
    FINISHED = "finished"  # eos or length
    REJECTED = "rejected"  # refused admission (queue bound, prompt too long, draining)
    TIMED_OUT = "timed_out"  # deadline expired, queued or running
    FAILED = "failed"  # non-finite logits quarantined, or cancelled


# statuses from which a request never advances again
TERMINAL_STATUSES = frozenset(
    {RequestStatus.FINISHED, RequestStatus.REJECTED, RequestStatus.TIMED_OUT, RequestStatus.FAILED})


@dataclass
class ServedRequest:
    """Handle returned by ``ServingEngine.submit``; updated by the engine."""

    request_id: int
    prompt_ids: np.ndarray
    config: GenerationConfig
    seed: int
    status: RequestStatus = RequestStatus.QUEUED
    slot: Optional[int] = None
    # priority class (higher wins), and the preemptions suffered so far (at
    # the engine's max_preemptions the request is untouchable)
    priority: int = 0
    preemptions: int = 0
    output_ids: List[int] = field(default_factory=list)
    # "eos" | "length", or the rejection, expiry or failure: "queue_full",
    # "prompt_too_long", "draining", "deadline", "nonfinite_logits", "cancelled"
    finish_reason: Optional[str] = None
    submitted_at: float = 0.0
    # when the request last entered the queue (submit, or its latest
    # preemption): the queue-wait statistics measure the current wait
    enqueued_at: float = 0.0
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    deadline_s: Optional[float] = None  # TTL from submit, enforced at ticks
    pages_reserved: Optional[int] = None  # paged engines: the reservation, computed once
    pages_allocated: Optional[int] = None
    # prefix-cache engines: the prompt's cacheable page keys, computed once at
    # submit (None when the request may wrap its ring, see submit)
    page_keys: Optional[tuple] = None
    # a known token stream forced through the decode step after prefill (a
    # preempted request's emitted tokens, or ``submit(replay_ids=...)``):
    # the slot still samples, so its generator advances as in the original
    # run; replayed tokens count toward max_new_tokens
    replay_ids: Optional[np.ndarray] = None
    replay_pos: int = 0
    # accepted work re-entering the engine (``submit(resume=True)``,
    # ``mark_resume``): a draining engine takes it and keeps it queued
    is_resume: bool = False
    # the router's fleet-unique session id and parameter-version pin, kept
    # on the journal's accept record (None from engine callers)
    session_id: Optional[str] = None
    version: Optional[int] = None

    @property
    def done(self) -> bool:
        """Terminal: FINISHED, REJECTED, TIMED_OUT or FAILED."""
        return self.status in TERMINAL_STATUSES

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.FINISHED

    @property
    def deadline_at(self) -> Optional[float]:
        """Absolute ``time.perf_counter()`` expiry, or None."""
        return None if self.deadline_s is None else self.submitted_at + self.deadline_s

    def result(self) -> np.ndarray:
        """Generated tokens (prompt excluded), up to and including EOS; a
        TIMED_OUT or FAILED request keeps the tokens it had."""
        return np.asarray(self.output_ids, np.int32)


# the GenerationConfig fields a servable request can carry; the journal's
# accept record keeps exactly these, and GenerationConfig(**payload) rebuilds
# an equivalent config
_JOURNAL_CONFIG_FIELDS = ("max_new_tokens", "do_sample", "temperature", "top_k", "top_p", "eos_token_id",
                          "pad_token_id")


def _journal_config_payload(config: GenerationConfig) -> dict:
    return {k: getattr(config, k) for k in _JOURNAL_CONFIG_FIELDS}


def _engine_compatible(config: GenerationConfig) -> Optional[str]:
    """None if the config runs on the engine, else the reason it cannot."""
    if config.num_beams > 1:
        return "beam search decodes k dependent continuations per request"
    if config.penalty_alpha is not None and config.penalty_alpha > 0:
        return "contrastive search re-scores k candidates per step"
    if config.decode_chunk > 1:
        return "chunked speculation shares one scalar commit length per batch"
    if config.max_new_tokens < 1:
        return "max_new_tokens must be >= 1"
    if config.do_sample and config.temperature <= 0.0:
        return f"temperature must be > 0 for sampling, got {config.temperature}"
    return None


@dataclass
class _PrefillTask:
    """Host state of one slot's split admission: the slot and its reservation
    are claimed, but the request decodes nothing until its finish lane
    activates it; until then the slot's in-cache page table stays trash (the
    chunks write through ``table_row``)."""

    request: ServedRequest
    table_row: np.ndarray  # (P,) trash-padded reservation (shared + private)
    n: int  # prompt length
    bucket: int  # covering ladder bucket (metrics)
    next_pos: int  # next prompt position whose KV is unwritten
    chunk_budget: int  # tokens per chunk
    shared_pages: int  # prefix-cache pages retained (the page-aligned head)
    t0: float  # admission time (prefill_s spans the chunks)
    resumed: bool = False  # a preempted continuation admitting again
    chunks: int = 0


def default_prefill_buckets(window: int, max_latents: int) -> tuple:
    """Halving ladder of prefill bucket lengths from the window down to the
    smallest that still holds ``max_latents`` latents; ascending."""
    floor = max(max_latents, 1)
    buckets = [window]
    b = window
    while b // 2 >= floor:
        b //= 2
        buckets.append(b)
    return tuple(sorted(buckets))


class _Staged:
    """A small int64 buffer the host fills every tick and the device reads:
    pinned on the host and mirrored on a card (one buffer on the CPU).
    ``begin`` waits until the last tick's copy has read the host side and
    zeroes it; ``send`` copies it over in one non-blocking transfer on the
    current stream, so it is ordered before the work that reads it."""

    def __init__(self, total: int, device: torch.device):
        on_card = device.type == "cuda"
        self.host = torch.zeros(total, dtype=torch.int64, pin_memory=on_card)
        self.dev = self.host.to(device) if on_card else self.host
        self._copied: Optional[torch.cuda.Event] = None

    def begin(self) -> np.ndarray:
        if self._copied is not None:
            self._copied.synchronize()
        self.host.zero_()
        return self.host.numpy()

    def send(self) -> torch.Tensor:
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        return self.dev


class _TickDescriptor:
    """The ragged tick's fixed-shape work descriptor, the host half of the
    JAX ``_dispatch_ragged``: per lane, the scale resets' page ids (P), the
    chunk's token ids (cap), offset, count, latent start and page-table row
    (P), and the finish's page-table row (P), latent token ids (L) and prompt
    length. Idle lanes hold zeros: trash tables, and a latent start of 2**30
    on chunk lanes. One ``_Staged`` buffer, allocated once; ``pack`` fills
    the host side and copies it over in one transfer."""

    def __init__(self, lanes: int, cap: int, pages: int, latents: int, device: torch.device):
        self.lanes = lanes
        shapes = {"reset_ids": (lanes * pages,), "ch_ids": (lanes, cap), "ch_offset": (lanes,),
                  "ch_count": (lanes,), "ch_lstart": (lanes,), "ch_tables": (lanes, pages),
                  "fin_tables": (lanes, pages), "fin_ids": (lanes, latents), "fin_n": (lanes,)}
        self._buf = _Staged(sum(int(np.prod(s)) for s in shapes.values()), device)
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        flat, at = self._buf.host.numpy(), 0
        for name, shape in shapes.items():
            size = int(np.prod(shape))
            self.host[name] = flat[at:at + size].reshape(shape)
            self.dev[name] = self._buf.dev[at:at + size].view(shape)
            at += size

    def pack(self, resets: List[tuple], chunks: List[tuple], finishes: List[tuple]) -> Dict[str, torch.Tensor]:
        """Fill the descriptor from the tick's buffered lanes and copy it to
        the device; returns the device views."""
        for work in (resets, chunks, finishes):
            if len(work) > self.lanes:
                # one chunk, finish and reset lane per slot a tick, admissions
                # capped: more is a scheduling bug, not load
                raise RuntimeError(f"ragged tick overflow: {len(chunks)} chunks / {len(finishes)} finishes / "
                                   f"{len(resets)} resets into {self.lanes} lanes")
        self._buf.begin()
        h = self.host
        h["ch_lstart"][:] = _IDLE_LATENT_START
        for i, (_slot, ids_row) in enumerate(resets):
            h["reset_ids"][i * ids_row.size:(i + 1) * ids_row.size] = ids_row
        for i, (_slot, ids, offset, count, latent_start, table_row) in enumerate(chunks):
            h["ch_ids"][i], h["ch_offset"][i], h["ch_count"][i] = ids, offset, count
            h["ch_lstart"][i], h["ch_tables"][i] = latent_start, table_row
        for i, (_slot, table_row, ids_latent, n, _request) in enumerate(finishes):
            h["fin_tables"][i], h["fin_ids"][i], h["fin_n"][i] = table_row, ids_latent, n
        self._buf.send()
        return self.dev


class _ForcedTokens:
    """The replay mux's inputs: per slot the forced token and whether it is
    forced, in one ``_Staged`` buffer of 2 x num_slots, filled on the host
    only on ticks while some slot replays."""

    def __init__(self, num_slots: int, device: torch.device):
        self._buf = _Staged(2 * num_slots, device)
        self.num_slots = num_slots

    def pack(self, replay_slots: Dict[int, "ServedRequest"]):
        """(forced (B,) int64, use (B,) bool) on the device."""
        h = self._buf.begin().reshape(2, self.num_slots)
        for slot, request in replay_slots.items():
            h[0, slot] = int(request.replay_ids[request.replay_pos])
            h[1, slot] = 1
        dev = self._buf.send().view(2, self.num_slots)
        return dev[0], dev[1] != 0


class ServingEngine:
    """In-process continuous-batching engine over a fixed slot pool, on the
    model's device (the card, unless the model was built with
    ``device="cpu"``).

    ``submit()`` returns a handle at once; ``step()`` runs one tick
    (``step_dispatch()`` then ``step_harvest()``); ``run_until_drained()``
    loops until queue and slots are empty.

    Options beyond the pool's: ``prefill_chunk_tokens`` (paged pools; a
    multiple of ``kv_page_size`` under ``kv_quant``) writes a split
    admission's prompt that many tokens a tick, with at most
    ``max_prefill_slots`` prompts in flight (default ``num_slots``);
    ``prefix_cache`` (paged pools) shares the KV pages of page-aligned prompt
    prefixes across requests; ``cuda_graph`` (default True; a card only)
    replays each tick's decode step as one captured CUDA graph;
    ``default_deadline_s`` is the TTL of requests submitted without one;
    ``priority_aging_ticks`` raises a queued request one class per that
    many ticks waited; ``max_preemptions`` bounds the preemptions of one
    request; ``handle_preemption`` drains the engine at the tick after
    SIGTERM/SIGINT (``close()`` restores the previous handlers);
    ``metrics_jsonl`` appends the metrics' event stream to that file;
    ``journal`` (a directory, or a ``RequestJournal`` for another fsync or
    segment policy) makes every accepted request durable, and ``recover``
    rebuilds an engine from it; ``weight_dtype`` ("bf16" or "int8") serves
    the parameters cast or quantized; ``telemetry`` (see ``obs/core.py``
    for its encoding) records phase spans, counters and request spans
    under the names prefix ``obs_ns``, with a compile watchdog.

    With ``weight_dtype`` set the engine takes the model over: it transforms
    the model's own parameters in place (see ``serving/quant.py``), the
    float ones are dropped, and the model then computes with the served
    weights wherever it is called. ``set_params`` swaps them in place."""

    def __init__(self, model, num_slots: int = 4, kv_page_size: Optional[int] = None,
                 num_kv_pages: Optional[int] = None, kv_quant: Optional[str] = None,
                 prefill_buckets: Optional[Sequence[int]] = None, max_queue_depth: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None, prefix_cache: bool = False,
                 max_prefill_slots: Optional[int] = None, cuda_graph: bool = True,
                 default_deadline_s: Optional[float] = None, priority_aging_ticks: Optional[int] = None,
                 max_preemptions: int = 2, handle_preemption: bool = False, metrics_jsonl: Optional[str] = None,
                 journal=None, weight_dtype: Optional[str] = None, telemetry=None, obs_ns: str = "serving",
                 _served=None):
        if weight_dtype is not None and weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES} or None, got {weight_dtype!r}")
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.cache_dtype = model.cache_dtype
        self.weight_dtype = weight_dtype
        # the served tensors by parameter name (the decode graph reads them
        # at their addresses; set_params copies into them). ``_served``: a
        # sibling engine's (params, served bytes, float bytes) over the same
        # model, whose parameters are already transformed (a router's
        # replicas share one model)
        self.params, self._param_bytes, self._param_bytes_fp = (
            serve_model_params(model, weight_dtype) if _served is None else _served)
        if weight_dtype == "bf16" and model.dtype is None:
            # a model without a compute dtype computes in its parameters'
            # dtype: bf16 weights keep it at the caches' dtype (ROADMAP C13)
            for m in model.modules():
                if getattr(m, "dtype", False) is None:
                    m.dtype = self.cache_dtype
        if max_preemptions < 0:
            raise ValueError(f"max_preemptions must be >= 0, got {max_preemptions}")
        self.max_preemptions = max_preemptions
        self.scheduler: SlotScheduler[ServedRequest] = SlotScheduler(num_slots, aging_ticks=priority_aging_ticks)
        self.metrics = EngineMetrics(num_slots=num_slots, jsonl_path=metrics_jsonl)
        if weight_dtype is not None:
            self.metrics.set_weight_serving(weight_dtype, self._param_bytes, self._param_bytes_fp)
        # telemetry: the JAX engine's span names under obs_ns (a router's
        # replicas share one recorder as "serving.r{i}"), off by default (the
        # shared no-op recorder)
        self._obs_ns = obs_ns
        self._span_tick = f"{obs_ns}.tick"
        self._span_admit = f"{obs_ns}.admit"
        self._span_prefill = f"{obs_ns}.prefill_dispatch"
        self._span_install = f"{obs_ns}.install"
        self._span_decode_dispatch = f"{obs_ns}.decode_dispatch"
        self._span_sample_sync = f"{obs_ns}.sample_sync"
        self._span_evict = f"{obs_ns}.evict"
        self._obs, self._owns_telemetry = resolve_recorder(telemetry)
        self._obs_on = self._obs.enabled
        self._span_cat = f"request.e{next(_ENGINE_IDS)}"
        self.watchdog: Optional[CompileWatchdog] = CompileWatchdog(recorder=self._obs) if self._obs_on else None
        # the write-ahead journal; each tick's changes are buffered here and
        # land as one write at the end of the harvest
        self.journal: Optional[RequestJournal] = None
        if journal is not None:
            self.journal = journal if isinstance(journal, RequestJournal) else RequestJournal(os.fspath(journal))
            self.metrics.set_journal(self.journal.stats())
        self._journal_admits: List[int] = []
        self._journal_tokens: Dict[int, List[int]] = {}
        self._journal_terminals: List[tuple] = []
        self.finished: List[ServedRequest] = []
        self._ids = itertools.count()
        # the non-terminal requests by id (evict_request, mark_resume)
        self._requests: Dict[int, ServedRequest] = {}
        if max_queue_depth is not None and max_queue_depth < 0:
            raise ValueError(f"max_queue_depth must be >= 0, got {max_queue_depth}")
        self.max_queue_depth = max_queue_depth
        self.default_deadline_s = default_deadline_s
        # ticks skip the deadline scan until some request carries a deadline
        self._deadlines_seen = default_deadline_s is not None
        self._draining = False

        cfg = model.config
        self._vocab = cfg.vocab_size
        self._window = model.max_seq_len
        self._latents = model.max_latents
        if prefill_buckets is None:
            self.prefill_buckets = default_prefill_buckets(self._window, self._latents)
        else:
            ladder = tuple(sorted({int(b) for b in prefill_buckets} | {self._window}))
            bad = [b for b in ladder if not self._latents <= b <= self._window]
            if bad:
                raise ValueError(f"prefill_buckets must lie in [max_latents={self._latents}.."
                                 f"window={self._window}], got {bad}")
            self.prefill_buckets = ladder

        if kv_page_size is not None and not 1 <= int(kv_page_size) <= self._window:
            raise ValueError(f"kv_page_size must lie in [1..window={self._window}], got {kv_page_size}")
        if kv_quant is not None and kv_quant not in KV_QUANT_MODES:
            raise ValueError(f"kv_quant must be one of {KV_QUANT_MODES} or None, got {kv_quant!r}")
        if kv_quant is not None and kv_page_size is None:
            raise ValueError("kv_quant requires kv_page_size (quantization is a page layout)")
        self.paged = kv_page_size is not None
        self.kv_quant = kv_quant
        self.kv_page_size: Optional[int] = None
        self._pool: Optional[PagePool] = None
        if self.paged:
            self.kv_page_size = int(kv_page_size)
            self._pages_per_slot = -(-self._window // self.kv_page_size)
            # default pool: one full window per slot (the dense layout's
            # backing) plus the trash page
            pages = int(num_kv_pages) if num_kv_pages is not None else num_slots * self._pages_per_slot + 1
            if pages < self._pages_per_slot + 1:
                raise ValueError(f"num_kv_pages must be >= pages_per_slot + 1 = {self._pages_per_slot + 1} "
                                 f"(worst-case reservation + trash page), got {pages}")
            self._pool = PagePool(pages, reserved=1)
            self._slot_pages: List[Optional[List[int]]] = [None] * num_slots
            # the request head-blocked on the free list: one alloc_failure an episode
            self._alloc_blocked_id: Optional[int] = None
            self._cache = model.init_paged_cache(num_slots, pages, self.kv_page_size, dtype=self.cache_dtype,
                                                 kv_quant=kv_quant)
            self._cache.sa.length = [self._cache.sa.capacity] * len(self._cache.sa.length)
            self.metrics.set_page_pool(self._pool.num_pages - self._pool.reserved, 0)
            if kv_quant is not None:
                self.metrics.set_kv_quant(kv_quant, *kv_bytes_per_token(
                    cfg.num_channels, self.cache_dtype, kv_quant, self.kv_page_size, cfg.num_heads))
        else:
            # the batched cache pinned at full capacity; free slots hold zeros
            # and keep live at the window (their outputs are discarded)
            cache = model.init_cache(batch_size=num_slots)
            cache.ca.length = cache.ca.capacity
            cache.sa.length = [cache.sa.capacity] * len(cache.sa.length)
            cache.live.fill_(cache.ca.capacity)
            self._cache = cache

        # chunked admission and the prefix cache both work on the paged pool
        if prefill_chunk_tokens is not None:
            if kv_page_size is None:
                raise ValueError("prefill_chunk_tokens requires kv_page_size (chunks are written page-wise)")
            if int(prefill_chunk_tokens) < 1:
                raise ValueError(f"prefill_chunk_tokens must be >= 1, got {prefill_chunk_tokens}")
        if prefix_cache and kv_page_size is None:
            raise ValueError("prefix_cache requires kv_page_size (the cache shares pool pages)")
        if max_prefill_slots is not None and max_prefill_slots < 1:
            raise ValueError(f"max_prefill_slots must be >= 1, got {max_prefill_slots}")
        self.chunked = prefill_chunk_tokens is not None
        self.prefill_chunk_tokens = int(prefill_chunk_tokens) if self.chunked else None
        if self.kv_quant is not None and self.chunked and self.prefill_chunk_tokens % self.kv_page_size != 0:
            # quantized chunk writes are whole-page writes: a chunk must start page-aligned
            raise ValueError(f"prefill_chunk_tokens ({self.prefill_chunk_tokens}) must be a multiple of "
                             f"kv_page_size ({self.kv_page_size}) under kv_quant")
        self.max_prefill_slots = int(max_prefill_slots) if max_prefill_slots is not None else num_slots
        self._prefix_cache: Optional[PrefixCache] = None
        self._prefilling: Dict[int, _PrefillTask] = {}
        if self.paged:  # a paged engine always runs the ragged tick
            # lane counts are the descriptor's fixed shapes: at most one chunk
            # and one finish lane a slot a tick, and a chunked engine at most
            # 2 x max_prefill_slots (advancing tasks plus the admissions their
            # finishes unblocked); chunk rows: the chunk, else the window
            self._ragged_lanes = min(num_slots, 2 * self.max_prefill_slots) if self.chunked else num_slots
            self._ragged_chunk_cap = self.prefill_chunk_tokens if self.chunked else self._window
            self._descriptor = _TickDescriptor(self._ragged_lanes, self._ragged_chunk_cap, self._pages_per_slot,
                                               self._latents, self.device)
            self.metrics.set_ragged_tick(True)
            if prefix_cache:
                self._prefix_cache = PrefixCache(self._pool, self.kv_page_size, kv_quant=self.kv_quant)
                self._prefix_cache.ensure_mode(self.kv_quant)
                self.metrics.set_prefix_cache(self._prefix_cache.stats(), 0)
        if self.chunked:
            self.metrics.set_chunked_prefill(self.prefill_chunk_tokens)
        # the tick's buffered lanes (the host side of the descriptor) and its accounting
        self._tick_chunks: List[tuple] = []
        self._tick_finishes: List[tuple] = []
        self._tick_resets: List[tuple] = []
        self._tick_programs = 0
        self._tick_chunk_items = 0
        self._tick_finish_items = 0
        self._tick_build_s = 0.0
        self._tick_poison: Optional[int] = None  # the slot serving.nan poisons this tick
        self._pending_harvest = None
        # slots replaying a known token stream (slot -> request)
        self._replay_slots: Dict[int, ServedRequest] = {}
        self._forced = _ForcedTokens(num_slots, self.device)

        self._state = SlotState.create(num_slots, self._vocab, self.cache_dtype, self.device)
        # the decode step's static input: the tick's tokens, written in place
        self._tok_in = torch.zeros(num_slots, 1, dtype=torch.int64, device=self.device)
        self._decode_method = self.model.decode_step_paged if self.paged else self.model.decode_step
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._captures = 0
        self.graph_replays = 0
        self.graph_pool_bytes = 0
        if cuda_graph and self.device.type == "cuda":
            self._capture_decode_graph()
        if self.watchdog is not None:
            # the JAX engine's tick-program budget: one capture ever. Prefill,
            # install, release and quarantine run eagerly and have no
            # counterpart to watch (ROADMAP C18)
            self.watchdog.watch(f"{obs_ns}.decode_step", _CaptureProbe(self), budget=1)
        # SIGTERM/SIGINT graceful drain: the handler only sets a flag; the
        # next tick closes admission and rejects the backlog, running work
        # finishes, and close() runs once the engine is empty
        self.preempted = False
        self._preempt_requested = False
        self._preempt_flushed = False
        self._preempt_handler, self._preempt_previous = None, {}
        if handle_preemption:
            self._preempt_handler, self._preempt_previous = install_preemption_handler(self._request_preempt)

    def _request_preempt(self) -> None:
        self._preempt_requested = True

    # ------------------------------------------------------------ the graph
    @property
    def decode_compilations(self) -> int:
        """Captures of the decode step's CUDA graph: 1 on a card with
        ``cuda_graph``, ever (the JAX engine's tick-program budget), else 0."""
        return self._captures

    @property
    def prefill_compilations(self) -> int:
        """Captures of prefill programs: prefill runs eagerly, so 0."""
        return 0

    @property
    def total_compilations(self) -> int:
        return self.decode_compilations + self.prefill_compilations

    # ---------------------------------------------------------------- params
    def set_params(self, params) -> None:
        """Swap the served parameters in place: ``params`` by name as
        ``named_parameters()`` gives them (or a model's ``state_dict()``),
        transformed by the engine's ``weight_dtype`` and copied into the
        tensors it serves. The decode graph reads those tensors at their
        addresses, so it replays the new weights with no new capture; a set
        of another layout (names, shapes, dtypes, which tensors are
        quantized) is refused. The prefix cache starts cold (its pages hold
        KV of the old weights). The caller swaps only an engine with no
        request in flight: a running slot's KV was built by the old
        weights."""
        params = {k: v.detach().to(self.device) for k, v in params.items()}
        served, served_bytes, fp_bytes = serve_params(params, self.weight_dtype)
        if tree_layout_mismatch(self.params, served):
            raise ValueError("set_params requires parameters with the names, shapes and dtypes of the served ones "
                             "(the decode graph reads the served tensors in place); build a fresh engine instead")
        copy_served_params(self.params, served)
        self._param_bytes, self._param_bytes_fp = served_bytes, fp_bytes
        if self._prefix_cache is not None:
            self._prefix_cache.clear()
            self.metrics.set_prefix_cache(self._prefix_cache.stats(), self._shared_pages_in_use())
        if self.weight_dtype is not None:
            self.metrics.set_weight_serving(self.weight_dtype, self._param_bytes, self._param_bytes_fp)

    def _cache_tensors(self) -> List[torch.Tensor]:
        """Every tensor the decode step reads or writes outside its own
        temporaries: the cache's and the slot state's."""
        c = self._cache
        if self.paged:
            ca = [c.ca.kp, c.ca.vp, c.ca.page_table, c.ca.start] + [
                t for t in (c.ca.k_scale, c.ca.v_scale) if t is not None]
        else:
            ca = [c.ca.k, c.ca.v, c.pad_slots]
        st = self._state
        return ca + [c.sa.k, c.sa.v, c.shift, c.live, st.next_logits, st.active, st.pad_id, self._tok_in]

    def _check_pinned(self) -> None:
        """The Python-int lengths a decode step reads are baked into the
        graph: they must still sit at capacity."""
        sa = self._cache.sa
        pinned = sa.length == [sa.capacity] * len(sa.length)
        if not self.paged:
            pinned = pinned and self._cache.ca.length == self._cache.ca.capacity
        if not pinned:
            raise RuntimeError("the decode graph was captured with the cache lengths at capacity; they have moved")

    def _capture_decode_graph(self) -> None:
        """Capture the decode step from ``_tok_in`` to a static logits
        buffer, once. A warm-up run on the capture stream first (outside the
        capture) builds and loads the kernels, makes the libraries' handles
        and that stream's split-K workspace; its writes are then undone. The
        workspace is taken out of the per-stream table and kept with the
        graph, so no later call can grow it and free what the graph points
        at. The launches the capture records are what each replay adds to
        the kernels' counters (a capture itself launches nothing)."""
        if self._captures:
            raise RuntimeError("the decode graph is captured once per engine")
        self._check_pinned()
        state = self._cache_tensors()
        saved = [t.clone() for t in state]
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream):
                self._decode_method(self._tok_in, self._cache)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            for t, s in zip(state, saved):
                t.copy_(s)
            del saved
            before = {k: m.launches for k, m in _KERNELS.items()}
            # the capture empties the allocator's cache first; so does this
            # baseline, so that what the capture adds is the graph's pool
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # thread-local: another thread's CUDA call (a fleet built
            # beside this engine, its weights copied to the host) leaves
            # the capture valid; this thread's own unsafe calls still fail it
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out, _ = self._decode_method(self._tok_in, self._cache)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the decode step failed: {e}") from e
        # the memory the capture reserved for the graph's private pool
        self.graph_pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._check_pinned()
        self._graph_launches = {k: m.launches - before[k] for k, m in _KERNELS.items()}
        for k, m in _KERNELS.items():
            m.launches = before[k]
        self._graph, self._graph_out, self._graph_stream = graph, out, stream
        self._graph_workspace = dk.claim_split_workspace(stream)
        self._captures = 1

    def _decode_step(self) -> torch.Tensor:
        """The model's decode step from ``_tok_in``: the graph's replay, or
        an eager call. Returns the (B, 1, V) logits."""
        if self._graph is None:
            out, _ = self._decode_method(self._tok_in, self._cache)
            return out
        self._check_pinned()
        self._graph.replay()
        for k, m in _KERNELS.items():
            m.launches += self._graph_launches[k]
        self.graph_replays += 1
        return self._graph_out

    # -------------------------------------------------------------- capacity
    @property
    def load(self) -> int:
        """Backlog beyond free capacity, the queue bound's metric. Paged
        pools count free pages as much as free slots: the queued requests (in
        admission order) that free slots and pages can absorb, plus
        worst-case-sized headroom beyond the queue. Pages a queued prompt
        shares with the prefix cache are retained, not allocated, and cached
        pages nobody references count as supply (eviction frees them before
        the head blocks), minus those a queued request's own match pins."""
        if not self.paged:
            return self.scheduler.load
        slots, pages, absorbed = self.scheduler.free_slots, self._pool.free_pages, 0
        reclaim = set(self._prefix_cache.reclaimable_page_ids()) if self._prefix_cache is not None else set()
        pages += len(reclaim)
        for request in self.scheduler.queued():
            if slots <= 0:
                break
            need = self._pages_for(request)
            if self._prefix_cache is not None and request.page_keys:
                matched = self._prefix_cache.peek_match_pages(request.page_keys)
                need -= len(matched)
                pinned = reclaim.intersection(matched)
                reclaim -= pinned
                pages -= len(pinned)  # retained by the hit: no longer supply
            if need > pages:
                break  # head-of-line: later requests wait behind this one
            slots -= 1
            pages -= need
            absorbed += 1
        return self.scheduler.queue_depth - absorbed - min(slots, pages // self._pages_per_slot)

    def _pages_for(self, request: ServedRequest) -> int:
        if request.pages_reserved is None:
            request.pages_reserved = pages_for_request(self._bucket_for(request.prompt_ids.size),
                                                       request.config.max_new_tokens, self._window,
                                                       self.kv_page_size)
        return request.pages_reserved

    def _shared_match(self, request: ServedRequest) -> int:
        """Pages the request's prompt shares with the prefix cache now (no
        stamps, no counts)."""
        if self._prefix_cache is None or not request.page_keys:
            return 0
        return self._prefix_cache.peek_match(request.page_keys)

    def _can_admit_paged(self, request: ServedRequest) -> bool:
        """Admission gate: does the free list cover the head's reservation,
        counting its shared pages once? Under pressure, cached pages nobody
        references are evicted first (after stamping the head's own match,
        so eviction cannot grow the need being fitted). A blocked head counts
        one ``alloc_failure`` per blocking episode and stays queued."""
        reservation = self._pages_for(request)
        need = reservation - self._shared_match(request)
        if not self._pool.can_allocate(need) and self._prefix_cache is not None:
            self._prefix_cache.touch(request.page_keys or ())
            freed = self._prefix_cache.evict(need - self._pool.free_pages)
            if freed:
                self.metrics.record_prefix_evict(freed, need)
                self.metrics.set_prefix_cache(self._prefix_cache.stats(), self._shared_pages_in_use())
            need = reservation - self._shared_match(request)  # eviction only shrinks the match
        if self._pool.can_allocate(need):
            if self._alloc_blocked_id == request.request_id:
                self._alloc_blocked_id = None  # the episode is over
            return True
        if self._alloc_blocked_id != request.request_id:
            self._alloc_blocked_id = request.request_id
            self.metrics.record_alloc_failure(request.request_id, need, self._pool.free_pages)
            if self._obs_on:
                self._obs.counter_inc(f"{self._obs_ns}.alloc_failures")
        return False

    def _shared_pages_in_use(self) -> int:
        """Page-table entries of running requests backed by shared pages
        (refcount >= 2, the cache's own reference counted)."""
        if self._pool is None:
            return 0
        return sum(self._pool.shared_count(pages) for pages in self._slot_pages if pages)

    def _bucket_for(self, n: int) -> int:
        """Smallest ladder bucket covering an n-token prompt."""
        return next(b for b in self.prefill_buckets if b >= n)

    # ---------------------------------------------------------------- submit
    def submit(self, prompt_ids: Sequence[int], config: Optional[GenerationConfig] = None, seed: int = 0,
               deadline_s: Optional[float] = None, replay_ids: Optional[Sequence[int]] = None,
               priority: int = 0, resume: bool = False, session_id: Optional[str] = None,
               version: Optional[int] = None, **kwargs) -> ServedRequest:
        """Queue one request and return its handle. ``config`` or keyword
        options, as ``generate()`` takes them; ``seed`` seeds the request's
        own generator (sampled requests only). ``deadline_s`` is a TTL from
        now (default ``default_deadline_s``): an expired request ends
        TIMED_OUT at the next tick. ``priority`` is its class (default 0,
        higher wins; a blocked head may preempt strictly lower classes).
        ``replay_ids`` are forced through the decode step after prefill and
        land in ``output_ids``; generation runs free after them.
        ``resume=True`` marks accepted work re-entering the engine: a
        draining engine takes it. ``session_id`` and ``version`` (a router's
        session id and parameter-version pin) ride the journal's accept
        record. Malformed requests (empty prompt, a config the engine cannot
        serve) raise ValueError; a draining engine, a prompt longer than the
        window or a queue at ``max_queue_depth`` return a handle already
        ``REJECTED``. With a journal the accept record is on disk before the
        handle is returned; if the append fails, the request is REJECTED
        ("journal_error") and the error is raised."""
        if config is None:
            config = GenerationConfig(**kwargs)
        elif kwargs:
            raise ValueError("pass either config or keyword options, not both")
        reason = _engine_compatible(config)
        if reason is not None:
            raise ValueError(f"GenerationConfig not servable by the engine: {reason}")
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must be non-empty (over-long prompts are REJECTED, empty ones are malformed)")
        now = time.perf_counter()
        request = ServedRequest(
            request_id=next(self._ids), prompt_ids=prompt, config=config, seed=int(seed), priority=int(priority),
            submitted_at=now, enqueued_at=now,
            deadline_s=deadline_s if deadline_s is not None else self.default_deadline_s,
            replay_ids=np.asarray(replay_ids, np.int64).reshape(-1) if replay_ids is not None and len(replay_ids)
            else None,
            is_resume=bool(resume), session_id=session_id, version=None if version is None else int(version))
        if request.deadline_s is not None:
            self._deadlines_seen = True
        # a request whose prompt plus generation budget passes the window
        # wraps its ring into its own oldest pages mid-decode: those pages
        # must never be shared or donated, so it neither probes nor inserts
        if self._prefix_cache is not None and prompt.size + config.max_new_tokens <= self._window:
            request.page_keys = page_keys_for_prompt(prompt.tolist(), self.kv_page_size, self._latents)
        self.metrics.record_submit(request.request_id, int(prompt.size), priority=request.priority)
        if self._obs_on:
            # the request's lifecycle span, keyed by the id its metric events carry
            self._obs.async_begin(self._span_cat, request.request_id, prompt_len=int(prompt.size))
            self._obs.async_instant(self._span_cat, request.request_id, "queued")
        if self._draining and not request.is_resume:
            return self._reject(request, "draining")
        if prompt.size > self._window:
            return self._reject(request, "prompt_too_long")
        if self.max_queue_depth is not None and self.load >= self.max_queue_depth:
            return self._reject(request, "queue_full")
        if self.journal is not None:
            # the durability point: every rejection above returned first, so
            # a rejected request is never journaled
            try:
                self.journal.append_accept(
                    request.request_id, prompt.tolist(), _journal_config_payload(config), [request.seed],
                    priority=request.priority, deadline_s=request.deadline_s,
                    replay=request.replay_ids.tolist() if request.replay_ids is not None else None,
                    session_id=request.session_id, version=request.version)
            except BaseException:
                # close the submit's accounting, then raise (a failed append
                # is not tracked, so no terminal record is buffered)
                self._reject(request, "journal_error")
                raise
        self._requests[request.request_id] = request
        # seq = the request id: FIFO within a class is submit order, and a
        # preempted request queued again keeps its seniority
        self.scheduler.enqueue(request, priority=request.priority, seq=request.request_id)
        return request

    def _reject(self, request: ServedRequest, reason: str) -> ServedRequest:
        self._requests.pop(request.request_id, None)
        request.status = RequestStatus.REJECTED
        request.finish_reason = reason
        request.finished_at = time.perf_counter()
        self.finished.append(request)
        # a drain's rejection of an accepted queued request is journaled
        self._journal_note_terminal(request, RequestStatus.REJECTED, reason)
        self.metrics.record_reject(request.request_id, reason)
        if self._obs_on:
            self._obs.counter_inc(f"{self._obs_ns}.rejected")
            self._obs.async_end(self._span_cat, request.request_id, status="rejected", reason=reason)
        return request

    # ----------------------------------------------------------------- admit
    def _bucket_prompt(self, request: ServedRequest, bucket: int):
        """The prompt left-padded to its bucket, with its pad mask."""
        n = request.prompt_ids.size
        ids = torch.full((1, bucket), request.config.pad_token_id, dtype=torch.int64)
        ids[0, bucket - n:] = torch.from_numpy(request.prompt_ids)
        pad = torch.arange(bucket)[None, :] < bucket - n
        return ids.to(self.device), pad.to(self.device)

    def _generator(self, request: ServedRequest) -> Optional[torch.Generator]:
        if not request.config.do_sample:
            return None
        return torch.Generator(self.device).manual_seed(request.seed)

    def _admit(self, slot: int, request: ServedRequest) -> None:
        t0 = time.perf_counter()
        n = int(request.prompt_ids.size)
        bucket = self._bucket_for(n)
        pages = table_row = None
        if self.paged:
            shared_run: List[int] = []
            if self._prefix_cache is not None and request.page_keys:
                shared_run = self._prefix_cache.probe(request.page_keys)
            # every admission the tick's finish can take (n >= max_latents)
            # rides the descriptor; shorter prompts take the classic path
            if shared_run or n >= self._latents:
                self._admit_split(slot, request, bucket, shared_run, t0)
                return
            pages = self._pages_for(request)
            page_ids = self._pool.allocate(pages)
            self._slot_pages[slot] = page_ids
            table_row = torch.zeros(self._pages_per_slot, dtype=torch.int32)
            table_row[:pages] = torch.tensor(page_ids, dtype=torch.int32)
        self._tick_programs += 2  # the classic path: prefill, install
        with self._obs.span(self._span_prefill):
            ids, pad_mask = self._bucket_prompt(request, bucket)
            cache = self.model.init_cache(batch_size=1, max_seq_len=bucket)
            logits, cache = self.model.prefill(ids, bucket - self._latents, cache, pad_mask=pad_mask)
        with self._obs.span(self._span_install):
            if self.paged:
                self._cache.install_slot(slot, table_row.to(self.device), cache)
            else:
                self._cache.write_slot(slot, cache)
            self._state.install(slot, logits[:, -1], request.config, self._generator(request))
        if self._prefix_cache is not None and request.page_keys:
            # the page-aligned install makes this prompt's pages cache-grade
            self._prefix_cache.insert(request.page_keys, [int(p) for p in table_row[:len(request.page_keys)]])
            self.metrics.set_prefix_cache(self._prefix_cache.stats(), self._shared_pages_in_use())
        now = time.perf_counter()
        resumed = request.status is RequestStatus.PREEMPTED
        request.status = RequestStatus.RUNNING
        request.slot = slot
        request.pages_allocated = pages
        request.admitted_at = now
        if self.journal is not None:
            # in-flight from now on: a recovery's drain finishes it
            self._journal_admits.append(request.request_id)
        self._register_replay(slot, request)
        self.metrics.record_admit(request.request_id, slot, wait_s=t0 - request.enqueued_at, prefill_s=now - t0,
                                  bucket=bucket, pages=pages, priority=request.priority, preempted_replay=resumed)
        if self.paged:
            self.metrics.set_page_pool(self._pool.num_pages - self._pool.reserved, self._pool.pages_in_use)
        if self._obs_on:
            self._obs.async_instant(self._span_cat, request.request_id, "prefill", slot=slot, bucket=bucket)

    def _admit_split(self, slot: int, request: ServedRequest, bucket: int, shared_run: List[int],
                     t0: float) -> None:
        """Claim the slot and the reservation of a split admission: shared
        prefix pages are retained, only the rest is allocated, and a
        ``_PrefillTask`` puts the chunks on the ticks (one a tick when
        chunked, all of them now otherwise). Quantized pools queue a scale
        reset of the private pages on the tick, before any chunk writes them
        (a fresh page's first ratcheted append then zeroes stale bytes);
        shared pages keep theirs, which are part of the cached bytes."""
        n = int(request.prompt_ids.size)
        shared = len(shared_run)
        if shared:
            self._pool.retain(shared_run)
        private = self._pool.allocate(self._pages_for(request) - shared)
        page_ids = list(shared_run) + private
        self._slot_pages[slot] = page_ids
        table_row = np.zeros(self._pages_per_slot, np.int64)
        table_row[:len(page_ids)] = page_ids  # trash-padded reservation
        if self.kv_quant is not None:
            ids_row = np.zeros(self._pages_per_slot, np.int64)
            ids_row[:len(private)] = private
            self._tick_resets.append((slot, ids_row))
        shared_tokens = shared * self.kv_page_size
        budget = self.prefill_chunk_tokens if self.chunked else max(n - shared_tokens, 1)
        task = _PrefillTask(request=request, table_row=table_row, n=n, bucket=bucket, next_pos=shared_tokens,
                            chunk_budget=budget, shared_pages=shared, t0=t0,
                            resumed=request.status is RequestStatus.PREEMPTED)
        self._prefilling[slot] = task
        request.status = RequestStatus.RUNNING
        request.slot = slot
        if self.journal is not None:
            # admitted when the slot is claimed: a crash mid-chunk recovers
            # it as a preempted continuation
            self._journal_admits.append(request.request_id)
        if shared:
            self.metrics.record_prefix_hit(request.request_id, shared, shared_tokens)
            if self._obs_on:
                self._obs.counter_inc(f"{self._obs_ns}.prefix_hits")
        self.metrics.set_page_pool(self._pool.num_pages - self._pool.reserved, self._pool.pages_in_use)
        # the first chunk goes on this tick; unchunked, the whole tail and the finish
        self._advance_prefill(slot, task)
        while not self.chunked and slot in self._prefilling:
            self._advance_prefill(slot, task)

    def _advance_prefill(self, slot: int, task: _PrefillTask) -> None:
        """Put one prefill chunk of a mid-admission slot on the tick (a tick
        waits on at most one chunk a prefilling slot). Every cacheable page
        the chunks have now covered joins the prefix cache at once (below
        the latent boundary a page is final for the session's lifetime), so a
        sibling admitted next tick forks it. After the last chunk the finish
        goes on the same tick."""
        request = task.request
        remaining = task.n - task.next_pos
        if remaining > 0:
            c = min(task.chunk_budget, remaining)
            self._tick_chunk_items += 1
            t0 = time.perf_counter()
            ids = np.full(self._ragged_chunk_cap, request.config.pad_token_id, np.int64)
            ids[:c] = request.prompt_ids[task.next_pos:task.next_pos + c]
            self._tick_chunks.append((slot, ids, task.next_pos, c, task.n - self._latents, task.table_row))
            task.next_pos += c
            task.chunks += 1
            if self.chunked:
                self.metrics.record_chunk(request.request_id, slot, c, time.perf_counter() - t0)
        if self._prefix_cache is not None and request.page_keys:
            upto = min(task.next_pos // self.kv_page_size, len(request.page_keys))
            if upto:
                self._prefix_cache.insert(request.page_keys[:upto], [int(p) for p in task.table_row[:upto]])
        if task.next_pos >= task.n:
            self._finish_prefill(slot, task)

    def _finish_prefill(self, slot: int, task: _PrefillTask) -> None:
        """Put the split admission's finish on the tick: its lane computes
        the latents against the slot's pages, installs the table, ring offset
        and self-attention cache and activates the slot, after every chunk
        lane and before the decode. The request counts as admitted now (its
        prefill time spans its chunks)."""
        request = task.request
        ids_latent = request.prompt_ids[task.n - self._latents:]
        self._tick_finish_items += 1
        self._tick_finishes.append((slot, task.table_row, ids_latent, task.n, request))
        del self._prefilling[slot]
        now = time.perf_counter()
        request.pages_allocated = len(self._slot_pages[slot] or [])
        request.admitted_at = now
        self._register_replay(slot, request)
        self.metrics.record_admit(request.request_id, slot, wait_s=task.t0 - request.enqueued_at,
                                  prefill_s=now - task.t0, bucket=task.bucket, pages=request.pages_allocated,
                                  priority=request.priority, preempted_replay=task.resumed,
                                  chunks=task.chunks if self.chunked else None,
                                  shared_pages=task.shared_pages or None)
        if self._prefix_cache is not None:
            self.metrics.set_prefix_cache(self._prefix_cache.stats(), self._shared_pages_in_use())
        if self._obs_on:
            self._obs.async_instant(self._span_cat, request.request_id, "prefill", slot=slot, bucket=task.bucket,
                                    chunks=task.chunks, shared_pages=task.shared_pages)

    def _register_replay(self, slot: int, request: ServedRequest) -> None:
        """A request with unreplayed ``replay_ids`` decodes them forced."""
        if request.replay_ids is not None and request.replay_pos < request.replay_ids.size:
            self._replay_slots[slot] = request

    def _drop_tick_work(self, slot: int, request: ServedRequest) -> None:
        """Drop a slot's buffered lanes: a request evicted or preempted
        between buffering and dispatch must leave no lane that writes pages
        it gave back. Pages its dropped chunks were to write may already be
        in the prefix cache (a chunk's pages join it as it is buffered): that
        subtree is invalidated, so nobody forks pages that stay unwritten."""
        dropped = any(w[0] == slot for w in self._tick_chunks)
        self._tick_chunks = [w for w in self._tick_chunks if w[0] != slot]
        self._tick_finishes = [w for w in self._tick_finishes if w[0] != slot]
        self._tick_resets = [w for w in self._tick_resets if w[0] != slot]
        if self._tick_poison == slot:
            self._tick_poison = None
        if dropped and self._prefix_cache is not None and request.page_keys:
            if self._prefix_cache.invalidate(request.page_keys):
                self.metrics.set_prefix_cache(self._prefix_cache.stats(), self._shared_pages_in_use())

    def _release(self, slot: int) -> int:
        """The device and host half of taking a request off its slot: free
        the slot, drop its replay, its split admission and its buffered
        lanes, reset its sampling state and (paged) point its table at the
        trash page and give its pages back (a shared page loses this slot's
        reference only). Returns the pages given back."""
        request = self.scheduler.release(slot)
        self._replay_slots.pop(slot, None)
        self._drop_tick_work(slot, request)
        self._prefilling.pop(slot, None)  # a mid-chunk admission dies whole
        self._state.release(slot)
        self._tick_programs += 1
        if not self.paged:
            return 0
        # a freed slot keeps decoding: its table must point at the trash
        # page before its pages can go to another request
        self._tick_programs += 1
        self._cache.release_slot(slot)
        pages = self._slot_pages[slot] or []
        if pages:
            self._pool.release(pages)
        self._slot_pages[slot] = None
        self.metrics.set_page_pool(self._pool.num_pages - self._pool.reserved, self._pool.pages_in_use)
        return len(pages)

    def _evict(self, slot: int, request: ServedRequest, reason: str,
               status: RequestStatus = RequestStatus.FINISHED, journal_terminal: bool = True) -> None:
        self._release(slot)
        self._terminate(request, status, reason, journal_terminal)
        self.metrics.record_finish(request.request_id, slot, len(request.output_ids), reason, status=status.value)

    def _terminate(self, request: ServedRequest, status: RequestStatus, reason: str,
                   journal_terminal: bool = True) -> None:
        request.status = status
        request.finish_reason = reason
        request.finished_at = time.perf_counter()
        request.slot = None
        self._requests.pop(request.request_id, None)
        self.finished.append(request)
        if journal_terminal:
            self._journal_note_terminal(request, status, reason)
        if self._obs_on:
            self._obs.async_end(self._span_cat, request.request_id, status=status.value, reason=reason,
                                new_tokens=len(request.output_ids))

    def evict_request(self, request_id: int, reason: str = "cancelled", status: RequestStatus = RequestStatus.FAILED,
                      queued_only: bool = False, journal_terminal: bool = True) -> Optional[ServedRequest]:
        """Cancel one non-terminal request wherever it sits, ending
        ``status``: queued (it leaves the queue and never costs a prefill)
        or running (its slot is released, its partial output kept). Returns
        the now-terminal handle, or None for an unknown or already terminal
        id. ``queued_only`` cancels only a queued request (host bookkeeping:
        a running eviction writes the slot's device state). The router
        reclaims a lost replica's stale requests through this.
        ``journal_terminal=False`` journals no terminal record: the
        journal's live entry stays the session's durable copy (a router
        moving the session elsewhere closes it)."""
        request = self._requests.get(request_id)
        if request is None:
            return None
        if request.slot is not None:
            if queued_only:
                return None
            self._evict(request.slot, request, reason, status=status, journal_terminal=journal_terminal)
            return request
        if not self.scheduler.prune_queue(lambda r: r is request):
            return None
        self._terminate(request, status, reason, journal_terminal)
        self.metrics.record_evict_queued(request_id, reason, status=status.value, new_tokens=len(request.output_ids))
        return request

    def mark_resume(self, request_id: int) -> None:
        """Flag a live request as accepted work re-entering the engine, so a
        drain keeps it queued."""
        request = self._requests.get(request_id)
        if request is not None:
            request.is_resume = True

    # ------------------------------------------------------------ preemption
    def _select_victims(self, request: ServedRequest) -> List[tuple]:
        """The cheapest set of running slots of a strictly lower class whose
        release lets ``request`` (the blocked admission-order head) admit, as
        (slot, request) pairs; a function of class, admission order and
        page counts only. Candidates: running requests whose base class is
        below the head's base class (aging raises queue rank, never
        preemption rights) and that have preemption budget left. Order:
        lowest class, then the largest reservation, then the youngest. Taken
        greedily until the head's missing slot and pages are covered, then
        every victim the rest cover without is dropped again; if all
        candidates cannot cover the need, nobody."""
        need_slot = self.scheduler.free_slots == 0
        need_pages = 0
        if self.paged:
            # pages the head shares with the prefix cache are retained, not allocated
            need_pages = self._pages_for(request) - self._shared_match(request) - self._pool.free_pages
        if not need_slot and need_pages <= 0:
            return []
        candidates = [(slot, r) for slot, r in self.scheduler.occupied()
                      if r.priority < request.priority and r.preemptions < self.max_preemptions]
        candidates.sort(key=lambda sr: (sr[1].priority, -len(self._slot_pages[sr[0]] or []) if self.paged else 0,
                                        -sr[1].request_id))
        # what a victim set frees: a page counts if, once every victim lets
        # go, nobody holds it or only the prefix cache does (the admission
        # gate's eviction reclaims it); a page a live sibling shares does not
        cached = self._prefix_cache.cached_page_ids() if self._prefix_cache is not None else frozenset()

        def sim_freed(victims) -> int:
            if not self.paged:
                return 0
            drops: Dict[int, int] = {}
            for slot, _r in victims:
                for p in self._slot_pages[slot] or []:
                    drops[p] = drops.get(p, 0) + 1
            return sum(1 for p, d in drops.items()
                       if (rc := self._pool.refcount(p) - d) == 0 or (rc == 1 and p in cached))

        def covers(victims) -> bool:
            return sim_freed(victims) >= need_pages and (len(victims) >= 1 or not need_slot)

        chosen: List[tuple] = []
        for victim in candidates:
            if covers(chosen):
                break
            chosen.append(victim)
        if not covers(chosen):
            return []
        # a cheap low-class victim that a later, larger one made redundant
        # would burn its budget and a replay for nothing
        for victim in list(chosen):
            trial = [v for v in chosen if v[0] != victim[0]]
            if covers(trial):
                chosen = trial
        return chosen

    def _requeue(self, slot: int, request: ServedRequest) -> int:
        """Release a running request as an eviction does and queue it again
        at its class and seniority, PREEMPTED, to replay its known tokens:
        its emitted ones, or the longer stream it was still replaying.
        Returns the pages given back."""
        pages_freed = self._release(slot)
        if request.replay_ids is not None and request.replay_ids.size > len(request.output_ids):
            stream = request.replay_ids
        elif request.output_ids:
            stream = np.asarray(request.output_ids, np.int64)
        else:
            stream = None
        request.replay_ids = stream
        request.replay_pos = 0
        request.status = RequestStatus.PREEMPTED
        request.slot = None
        request.pages_allocated = None
        request.enqueued_at = time.perf_counter()
        self.scheduler.enqueue(request, priority=request.priority, seq=request.request_id)
        return pages_freed

    def _preempt(self, slot: int, request: ServedRequest, preemptor: ServedRequest) -> None:
        """Requeue one victim of a blocked higher-class head, spending one
        of its preemptions."""
        pages_freed = self._requeue(slot, request)
        request.preemptions += 1
        self.metrics.record_preempt(request.request_id, slot, preempted_by=preemptor.request_id,
                                    pages_freed=pages_freed, emitted_tokens=len(request.output_ids),
                                    priority=request.priority)
        if self._obs_on:
            self._obs.counter_inc(f"{self._obs_ns}.preemptions")
            self._obs.async_instant(self._span_cat, request.request_id, "preempted", by=preemptor.request_id,
                                    emitted=len(request.output_ids))

    def _preempt_for_blocked_head(self, can_admit) -> None:
        """Admission's second pass: while the admission-order head is blocked
        on slots or pages and lower-class victims can free enough, preempt
        them and admit again, so the head admits this tick. At most
        ``num_slots`` rounds."""
        for _ in range(self.num_slots):
            head = self.scheduler.peek()
            if head is None:
                return
            # the chunked engine's prefill-slot bound holds here too; checked
            # before choosing victims, so none is preempted for nothing
            limit = max(self.max_prefill_slots - len(self._prefilling), 0) if self.chunked else None
            if limit == 0:
                return
            victims = self._select_victims(head)
            if not victims:
                return
            for slot, victim in victims:
                self._preempt(slot, victim, preemptor=head)
            admitted = False
            for slot, request in self.scheduler.pop_admissible(can_admit, limit=limit):
                self._admit(slot, request)
                admitted = True
            if not admitted:
                return

    # --------------------------------------------------------------- journal
    def _journal_note_terminal(self, request: ServedRequest, status: RequestStatus, reason: str) -> None:
        """Buffer one terminal outcome for the tick's journal write, for a
        request the journal tracks (a rejection before acceptance has no
        accept record)."""
        if self.journal is not None and self.journal.tracks(request.request_id):
            self._journal_terminals.append((request.request_id, status.value, reason))

    def _journal_flush(self) -> None:
        """Land the tick's buffered admissions, tokens and terminals as one
        journal write and refresh the journal's gauges. A fail-stopped
        journal (an append died mid-line) takes nothing more: the buffers
        are dropped, so a caller stepping the degraded engine does not grow
        them, and recovery reads the durable prefix."""
        if self.journal is None or self.journal.failed:
            self._journal_admits, self._journal_tokens, self._journal_terminals = [], {}, []
            return
        if self._journal_admits or self._journal_tokens or self._journal_terminals:
            self.journal.append_tick(self._journal_admits, self._journal_tokens, self._journal_terminals)
            self._journal_admits, self._journal_tokens, self._journal_terminals = [], {}, []
        self.metrics.set_journal(self.journal.stats())

    def _recover_attach(self, journal_path, fsync: str = "accept", segment_max_records: int = 4096,
                        skip_session_ids=frozenset(), _state=None) -> dict:
        """Replay a journal directory into this fresh engine (no journal, no
        work), then swap the journal to a new generation that holds the
        recovered sessions and attach it. The order is the crash-safety
        argument: the old generation stays untouched until every live
        session is resubmitted and the new generation's rename lands, so a
        crash anywhere in here recovers again, identically. Sessions are
        resubmitted in accept order at their class (the monotone request ids
        keep their seniority), with their journaled tokens as the replay
        stream and on the handle; a session once admitted comes back
        PREEMPTED (in-flight work a drain finishes), a never-admitted one
        QUEUED (backlog a drain rejects). ``skip_session_ids`` leaves out
        router sessions another journal holds."""
        if self.journal is not None or self._requests or self.scheduler.has_work:
            raise JournalCorruptError("recovery needs a fresh journal-less engine (construct with journal=None and "
                                      "no submitted work)")
        journal_path = os.path.abspath(os.fspath(journal_path))
        state = read_journal(journal_path) if _state is None else _state
        handles: List[ServedRequest] = []
        mirror = []
        deduped = 0
        now = time.time()
        saved_bound = self.max_queue_depth
        # accepted work is not refused by the queue bound, which gates new admissions
        self.max_queue_depth = None
        try:
            for session in state.sessions:
                if session.session is not None and session.session in skip_session_ids:
                    deduped += 1
                    continue
                if len(session.rng) != 1:
                    raise ValueError(f"journal session rid={session.rid} carries a {len(session.rng)}-word rng "
                                     f"{session.rng} (a JAX key); this engine's requests are seeded by one integer, "
                                     f"[seed]")
                emitted = session.emitted
                handle = self.submit(session.prompt, config=GenerationConfig(**session.config),
                                     seed=int(session.rng[0]), deadline_s=session.remaining_deadline(now),
                                     replay_ids=emitted if emitted else None, priority=session.priority,
                                     session_id=session.session, version=session.version)
                if handle.status is RequestStatus.REJECTED:
                    raise JournalCorruptError(f"recovered session rid={session.rid} rejected "
                                              f"({handle.finish_reason}): the engine's geometry does not match the "
                                              f"journal's")
                if session.admitted:
                    handle.status = RequestStatus.PREEMPTED
                # the handle holds the journaled tokens from the start, so a
                # TTL expiry before it admits again still returns them
                handle.output_ids = [int(t) for t in emitted]
                handles.append(handle)
                mirror.append((handle.request_id, JournalSession(
                    rid=handle.request_id, prompt=session.prompt, config=session.config, rng=session.rng,
                    priority=session.priority, deadline_s=handle.deadline_s, accepted_ts=now,
                    admitted=session.admitted, replay=emitted, tokens=[], session=session.session,
                    version=session.version)))
        finally:
            self.max_queue_depth = saved_bound
        kept = [s for s in state.sessions if not (s.session and s.session in skip_session_ids)]
        replayed = sum(len(s.emitted) for s in kept)
        self.journal = RequestJournal(journal_path, fsync=fsync, segment_max_records=segment_max_records,
                                      _recovered_from=state, _sessions=mirror)
        self.metrics.set_journal(self.journal.stats())
        self.metrics.record_recovery(sessions=len(handles), replayed_tokens=replayed, truncated=state.truncated,
                                     dropped_records=state.dropped_records, generation=state.generation)
        if self._obs_on:
            self._obs.counter_inc(f"{self._obs_ns}.sessions_recovered", len(handles))
        return {"sessions": len(handles), "replayed_tokens": replayed,
                "in_flight": sum(1 for s in kept if s.admitted), "deduped": deduped, "truncated": state.truncated,
                "dropped_records": state.dropped_records, "records": state.records,
                "generation": state.generation, "handles": handles}

    @classmethod
    def recover(cls, model, journal, fsync: str = "accept", segment_max_records: int = 4096, **engine_kwargs):
        """Rebuild an engine from a write-ahead journal after the process
        died: every accepted, non-terminal request re-enters the queue at
        its class and seniority as a prompt plus emitted-token replay.
        Returns ``(engine, info)``, ``info["handles"]`` the recovered
        handles in accept order; stepped or drained, each completes with an
        uninterrupted run's tokens. The model carries its parameters;
        ``engine_kwargs`` must give the pool geometry the dead process ran
        (slots, buckets, paging): the journal records requests, not the
        engine."""
        engine = cls(model, journal=None, **engine_kwargs)
        info = engine._recover_attach(journal, fsync=fsync, segment_max_records=segment_max_records)
        return engine, info

    # ------------------------------------------------- deadlines, quarantine
    def _expire_deadlines(self, now: float) -> None:
        """Expired queued requests leave the queue without costing a
        prefill; expired running ones free their slot before the tick's
        decode. Both end TIMED_OUT with the tokens they had."""
        for request in self.scheduler.prune_queue(lambda r: r.deadline_at is not None and now >= r.deadline_at):
            self._terminate(request, RequestStatus.TIMED_OUT, "deadline")
            self.metrics.record_timeout_queued(request.request_id, new_tokens=len(request.output_ids))
        for slot, request in list(self.scheduler.occupied()):
            if request.deadline_at is not None and now >= request.deadline_at:
                self._evict(slot, request, "deadline", status=RequestStatus.TIMED_OUT)

    def _maybe_inject_nan(self) -> None:
        """The ``serving.nan`` fault point: the tick writes NaN into one
        slot's logits between its finish lanes and its decode."""
        spec = faults.fire_serving_nan()
        if spec is None:
            return
        slot = spec.slot
        if slot is None:
            occupied = next(iter(self.scheduler.occupied()), None)
            if occupied is None:
                return
            slot = occupied[0]
        self._tick_poison = slot

    def _quarantine(self, slot: int, request: ServedRequest) -> None:
        """Zero what a slot with non-finite logits may have poisoned, in
        place, before its release: dense pools its cache rows (and its
        pad/shift/live to the free form); paged pools its self-attention
        rows and the pages it alone holds with their scales. The prefix-cache
        subtree reached through its prompt is invalidated first, so a page
        only the cache shared with it is zeroed too, while pages a live
        sibling still holds are left to the sibling."""
        c = self._cache
        c.sa.k[:, slot].zero_()
        c.sa.v[:, slot].zero_()
        self._tick_programs += 1
        if not self.paged:
            c.ca.k[slot].zero_()
            c.ca.v[slot].zero_()
            c.pad_slots[slot] = False
            c.shift[slot] = 0
            c.live[slot] = c.ca.capacity
            return
        pages = self._slot_pages[slot] or []
        if self._prefix_cache is not None:
            if request.page_keys and self._prefix_cache.invalidate(request.page_keys):
                self.metrics.set_prefix_cache(self._prefix_cache.stats(), self._shared_pages_in_use())
            pages = [p for p in pages if self._pool.refcount(p) < 2]
        if pages:
            ids = torch.tensor(pages, dtype=torch.int64, device=self.device)
            c.ca.kp[ids] = 0
            c.ca.vp[ids] = 0
            c.ca.reset_page_scales(ids)

    # ------------------------------------------------------------------ tick
    def _run_chunks(self, d: Dict[str, torch.Tensor], chunks: List[tuple]) -> None:
        """The chunk phase: every lane of the descriptor in one call of the
        fixed (lanes, cap) shape, as the JAX program's (positions clipped to
        the window, latent-region rows through ``q_norm``; idle lanes are
        computed and never written), then each real lane written page-wise
        through its table. The call's shape never depends on how many lanes
        the tick holds, so neither do a lane's rows: a resumed request's
        prefill gives the bits it gave the first time."""
        rows = d["ch_offset"][:, None] + torch.arange(self._ragged_chunk_cap, device=self.device)
        k, v = self.model.prefill_chunk_kv(d["ch_ids"], rows.clamp(0, self._window - 1),
                                           rows >= d["ch_lstart"][:, None])
        for i, (_slot, _ids, offset, count, _lstart, _table) in enumerate(chunks):
            self._cache.ca.write_rows(d["ch_tables"][i], offset, count, k[i], v[i])

    def _run_finishes(self, d: Dict[str, torch.Tensor], finishes: List[tuple]) -> None:
        """The finish phase, lane by lane: latents against the written
        pages, then install and activate."""
        for i, (slot, _table, _ids, n, request) in enumerate(finishes):
            table = d["fin_tables"][i]
            logits, sa_src = self.model.prefill_finish_paged(d["fin_ids"][i:i + 1], n, self._cache.ca, table)
            self._cache.install_finish(slot, table, sa_src, n)
            self._state.install(slot, logits, request.config, self._generator(request))

    def _decode(self) -> torch.Tensor:
        """The decode phase: probe each slot's logits for non-finite values
        (sampling then sees neutral logits on such a row), process and
        sample (eagerly: a generator per sampled request), feed inactive
        rows their pad token and replaying rows their forced token, and
        advance every slot one token. Returns (2, B) on the device: the
        tokens, and per slot 1 where its logits were finite or it is
        inactive."""
        st = self._state
        logits = st.next_logits
        row_finite = torch.isfinite(logits).all(-1)
        finite = row_finite | ~st.active
        logits = torch.where(row_finite[:, None], logits, torch.zeros_like(logits))
        if any(st.do_sample):
            dev = logits.device
            top_k = torch.tensor(st.top_k, device=dev)
            top_p = torch.tensor(st.top_p, dtype=torch.float32, device=dev)
            logits = process_logits_batched(logits, torch.tensor(st.temperature, device=dev), top_k, top_p,
                                            any_filter=any(k > 0 for k in st.top_k) or any(p < 1.0 for p in st.top_p))
        # a replaying slot draws too, so its generator advances as in the
        # original run; its draw is then replaced by the known token
        tok = sample_token_batched(st.generators, logits, st.do_sample)
        tok = torch.where(st.active, tok, st.pad_id)
        if self._replay_slots:
            forced, use = self._forced.pack(self._replay_slots)
            tok = torch.where(use, forced, tok)
        self._tok_in.copy_(tok[:, None])
        out = self._decode_step()
        st.next_logits.copy_(torch.where(st.active[:, None], out[:, -1].to(st.next_logits.dtype), st.next_logits))
        return torch.stack([tok, finite.to(tok.dtype)])

    def _dispatch_tick(self, any_decode: bool) -> Optional[torch.Tensor]:
        """Run the tick's phases in the JAX program's order (scale resets,
        chunk lanes, finish lanes, the fault point's poison, decode),
        skipping a phase with no work. Returns the decode's (2, B) tokens
        and probe, or None without a decode."""
        resets, chunks, finishes = self._tick_resets, self._tick_chunks, self._tick_finishes
        if resets or chunks or finishes:
            t0 = time.perf_counter()
            d = self._descriptor.pack(resets, chunks, finishes)
            self._tick_build_s = time.perf_counter() - t0
            if resets:
                self._tick_programs += 1
                self._cache.ca.reset_page_scales(d["reset_ids"])
            if chunks:
                self._tick_programs += 1
                self._run_chunks(d, chunks)
            if finishes:
                self._tick_programs += 1
                self._run_finishes(d, finishes)
            self._tick_resets, self._tick_chunks, self._tick_finishes = [], [], []
        if self._tick_poison is not None:
            self._state.next_logits[self._tick_poison] = float("nan")
            self._tick_poison = None
        if not any_decode:
            return None
        self._tick_programs += 1
        return self._decode()

    @torch.no_grad()
    def step_dispatch(self) -> bool:
        """First half of a tick: expire deadlines, advance the slots
        mid-admission one chunk each, admit queued requests (preempting
        lower classes for a blocked head), and put the tick's work on the
        device, with no sync. Returns True when a decode is in flight
        (``step_harvest`` must run before the next dispatch)."""
        if self._pending_harvest is not None:
            raise RuntimeError("step_harvest() must run before the next step_dispatch()")
        faults.fire_serving_tick_delay()  # the serving.deadline fault point's stall
        if self._preempt_requested and not self._draining:
            # the signal's drain starts here, at a tick boundary
            self.preempted = True
            self._begin_drain()
        # the tick span brackets both halves (a router interleaves its
        # replicas' halves); every way out of a half balances it
        self._obs.span_begin(self._span_tick)
        try:
            dispatched = self._dispatch_half()
        except BaseException:
            self._obs.span_end(self._span_tick)
            raise
        if not dispatched:
            self._obs.span_end(self._span_tick)
        return dispatched

    def _dispatch_half(self) -> bool:
        """``step_dispatch``'s work inside the tick span."""
        self._tick_programs = self._tick_chunk_items = self._tick_finish_items = 0
        self._tick_build_s = 0.0
        self._tick_resets, self._tick_chunks, self._tick_finishes = [], [], []
        self._tick_poison = None
        self.scheduler.advance_tick()
        if self._deadlines_seen:
            self._expire_deadlines(time.perf_counter())
        # oldest work first: a finish here frees prefill-slot budget for the
        # admissions below; a task this tick's admissions started is not
        # advanced twice
        for slot, task in list(self._prefilling.items()):
            if self._prefilling.get(slot) is task:
                self._advance_prefill(slot, task)
        # while draining, the queue holds only preempted and resumed work,
        # which is admitted as capacity frees and finishes
        if not self._draining or self.scheduler.queue_depth:
            can_admit = self._can_admit_paged if self.paged else None
            # a chunked engine keeps at most max_prefill_slots prompts in flight
            limit = max(self.max_prefill_slots - len(self._prefilling), 0) if self.chunked else None
            with self._obs.span(self._span_admit):
                for slot, request in self.scheduler.pop_admissible(can_admit, limit=limit):
                    self._admit(slot, request)
                if not self._draining:
                    self._preempt_for_blocked_head(can_admit)
        self._maybe_inject_nan()
        occupied = list(self.scheduler.occupied())
        if self._obs_on:
            self._obs.gauge_set(f"{self._obs_ns}.active_slots", len(occupied))
            self._obs.gauge_set(f"{self._obs_ns}.queue_depth", self.scheduler.queue_depth)
            if self.paged:
                self._obs.gauge_set(f"{self._obs_ns}.pages_in_use", self._pool.pages_in_use)
        # slots mid-admission hold no decode state yet: they are not harvested
        occupied = [(s, r) for s, r in occupied if s not in self._prefilling]
        if not occupied and not (self._tick_chunks or self._tick_finishes or self._tick_resets):
            if self._tick_programs:
                self.metrics.record_tick_dispatch(self._tick_programs, 0, 0, 0, 0.0)
            return False
        t0 = time.perf_counter()
        with self._obs.span(self._span_decode_dispatch):
            out = self._dispatch_tick(bool(occupied))
        self.metrics.record_tick_dispatch(self._tick_programs, self._tick_chunk_items, self._tick_finish_items,
                                          len(occupied), self._tick_build_s)
        if not occupied:
            return False  # a tick of prefill work alone: nothing to harvest
        self._pending_harvest = (occupied, out, t0)
        return True

    @torch.no_grad()
    def step_harvest(self) -> bool:
        """Second half of a tick: the tick's one device sync on the sampled
        tokens and the finiteness probe, then harvest, quarantine and evict.
        Returns True while work remains; a no-op returning that when nothing
        was dispatched."""
        pending, self._pending_harvest = self._pending_harvest, None
        if pending is None:
            # a tick with no decode still journals its admissions and
            # terminals (a drain's rejected backlog, expiries)
            self._journal_flush()
            self._maybe_flush_preempted()
            return self.scheduler.has_work
        try:
            self._harvest(pending)
        except BaseException:
            self._obs.span_end(self._span_tick)
            raise
        self._obs.span_end(self._span_tick)
        self._journal_flush()  # the tick's one journal write
        self._maybe_flush_preempted()
        return self.scheduler.has_work

    def _harvest(self, pending) -> None:
        occupied, out, t0 = pending
        with self._obs.span(self._span_sample_sync):
            tok, finite = out.tolist()  # the tick's one device sync
        now = time.perf_counter()
        # useful tokens only: a quarantined slot's sample is discarded, and a
        # replayed token was delivered once already
        useful = sum(1 for slot, _ in occupied if finite[slot] and slot not in self._replay_slots)
        self.metrics.record_decode_step(len(occupied), now - t0, tokens=useful)
        with self._obs.span(self._span_evict):
            self._evict_harvested(occupied, tok, finite, now)
        if self.watchdog is not None:
            # one int read a watch: a capture past its budget is flagged, never raised
            self.watchdog.check()

    def _evict_harvested(self, occupied, tok, finite, now: float) -> None:
        for slot, request in occupied:
            if self.scheduler.occupant(slot) is not request:
                continue  # left its slot between dispatch and harvest
            if not finite[slot]:
                self._quarantine(slot, request)
                self._evict(slot, request, "nonfinite_logits", status=RequestStatus.FAILED)
                continue
            token = int(tok[slot])
            if slot in self._replay_slots:
                # a preempted handle holds its replayed tokens already: only
                # a token past them is appended
                emit = len(request.output_ids) <= request.replay_pos
                request.replay_pos += 1
                if request.replay_pos >= request.replay_ids.size:
                    del self._replay_slots[slot]
            else:
                emit = True
                if self.journal is not None:
                    # only free-running tokens: a replayed one is on the
                    # accept's replay prefix or an earlier tick record
                    self._journal_tokens.setdefault(request.request_id, []).append(token)
            if emit:
                request.output_ids.append(token)
                if len(request.output_ids) == 1:
                    self.metrics.record_first_token(request.request_id, now - request.submitted_at)
            cfg = request.config
            if cfg.eos_token_id is not None and token == cfg.eos_token_id:
                self._evict(slot, request, "eos")
            elif len(request.output_ids) >= cfg.max_new_tokens:
                self._evict(slot, request, "length")

    def discard_pending_harvest(self) -> None:
        """Drop a dispatched, unharvested decode without syncing it: its
        tokens never land. Its slots advanced on the device by one token
        the host never read, so each request it decoded that still holds
        its slot is released and queued again PREEMPTED, to replay its
        known tokens (no preemption budget spent): no slot keeps a cache
        position, a forced token or a replay-mux entry the host view has
        lost, and a request stepped on gives an uninterrupted run's
        tokens. The router discards a lost replica's half-tick before its
        probe tick."""
        pending, self._pending_harvest = self._pending_harvest, None
        if pending is None:
            return
        self._obs.span_end(self._span_tick)  # the dispatch's tick span, balanced
        for slot, request in pending[0]:
            if self.scheduler.occupant(slot) is request:
                self._requeue(slot, request)
                self.metrics.queue_depth += 1

    def step(self) -> bool:
        """One tick: ``step_dispatch()`` then ``step_harvest()``. Returns
        True while work remains."""
        self.step_dispatch()
        return self.step_harvest()

    def run_until_drained(self, max_steps: Optional[int] = None) -> List[ServedRequest]:
        """Step until every submitted request is terminal; returns (and
        clears) the requests finished since the last call, in completion
        order. ``max_steps`` guards runaway loops."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"engine not drained after {max_steps} steps")
        drained, self.finished = self.finished, []
        return drained

    # ----------------------------------------------------------------- drain
    def _begin_drain(self) -> None:
        """Close admission and reject the never-admitted backlog. Preempted
        continuations and resumed work are accepted, mid-generation work:
        they stay queued and finish."""
        self._draining = True
        for request in self.scheduler.prune_queue(
                lambda r: r.status is not RequestStatus.PREEMPTED and not r.is_resume):
            self._reject(request, "draining")

    def drain(self, max_steps: Optional[int] = None) -> List[ServedRequest]:
        """Graceful shutdown: later submits are REJECTED, the queued backlog
        is rejected, running and preempted work runs to completion. Returns
        the terminal handles (the rejected backlog first)."""
        self._begin_drain()
        return self.run_until_drained(max_steps=max_steps)

    def _maybe_flush_preempted(self) -> None:
        """Once a signal's drain has emptied the engine, write the final
        metrics snapshot and close the engine."""
        if self.preempted and not self._preempt_flushed and not self.scheduler.has_work:
            self._preempt_flushed = True
            self.metrics.write_snapshot()
            self.close()

    # ------------------------------------------------------------- telemetry
    @property
    def telemetry(self):
        """The engine's recorder (the shared no-op recorder when off), bound
        at construction with the watchdog."""
        return self._obs

    def telemetry_summary(self) -> Optional[dict]:
        """The recorder's phases, counters and gauges with the watchdog's
        ``compile`` block when telemetry is on, else None."""
        if not self._obs_on:
            return None
        out = self._obs.summary()
        if self.watchdog is not None:
            out["compile"] = self.watchdog.summary()
        return out

    def close(self) -> None:
        """Restore the signal handlers ``handle_preemption`` replaced, land
        the buffered journal records and close the journal (fsynced), the
        metrics stream, the watchdog and a recorder the engine made from its
        knob (which writes its trace when it has a path; a recorder passed
        in stays open). Idempotent."""
        restore_preemption_handler(self._preempt_handler, self._preempt_previous)
        self._preempt_handler = None
        if self.journal is not None:
            self._journal_flush()
            self.journal.close()
        self.metrics.close()
        if self.watchdog is not None:
            self.watchdog.close()
        if self._owns_telemetry:
            self._obs.close()
