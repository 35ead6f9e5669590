"""Continuous-batching inference engine over a fixed pool of decode slots.

Port of ``perceiver_io_tpu/serving/engine.py``: ``SlotState``,
``RequestStatus``, ``ServedRequest``, ``_PrefillTask``,
``default_prefill_buckets``, ``_engine_compatible`` and ``ServingEngine``
with dense or paged slot pools, fp, int8 or int4 KV pages, chunked prefill,
the cross-request radix prefix cache, the ragged tick and its
dispatch/harvest split.

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

Greedy output is token-identical to ``generate()`` on the same canonical
form, and to the JAX engine's with chunking and the prefix cache on or off.
Sampled requests draw from their own generator, so their tokens depend on
their prompt, config and seed only, not on their slot or slot-mates; they
cannot reproduce the JAX engine's key chain.

Not in this slice (ROADMAP A): priorities and preemption, deadlines,
non-finite-logit quarantine, journal and recovery, telemetry, weight
serving, drain and signals, and the router, transport and worker.
"""

from __future__ import annotations

import itertools
import time
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
from perceiver_io_torch.ops.paged_decode_kernel import KV_QUANT_MODES
from perceiver_io_torch.serving.metrics import EngineMetrics
from perceiver_io_torch.serving.paging import PagePool, PrefixCache, page_keys_for_prompt, pages_for_request
from perceiver_io_torch.serving.quant import kv_bytes_per_token
from perceiver_io_torch.serving.scheduler import SlotScheduler

# the decode-attention kernels a decode step can launch, by the names
# chip_smoke.py and the PERF tables use; a graph replay adds the launches its
# capture recorded to their counters
_KERNELS = {"B2": dk, "B3": pk, "B4": rk}
# latent start of an idle chunk lane: beyond every position, so no row is a latent
_IDLE_LATENT_START = 2**30


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
    FINISHED = "finished"  # eos or length
    REJECTED = "rejected"  # refused at submit (queue bound, prompt too long)


TERMINAL_STATUSES = frozenset({RequestStatus.FINISHED, RequestStatus.REJECTED})


@dataclass
class ServedRequest:
    """Handle returned by ``ServingEngine.submit``; updated by the engine."""

    request_id: int
    prompt_ids: np.ndarray
    config: GenerationConfig
    seed: int
    status: RequestStatus = RequestStatus.QUEUED
    slot: Optional[int] = None
    output_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None  # "eos" | "length" | "queue_full" | "prompt_too_long"
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    pages_reserved: Optional[int] = None  # paged engines: the reservation, computed once
    pages_allocated: Optional[int] = None
    # prefix-cache engines: the prompt's cacheable page keys, computed once at
    # submit (None when the request may wrap its ring, see submit)
    page_keys: Optional[tuple] = None

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.FINISHED

    def result(self) -> np.ndarray:
        """Generated tokens (prompt excluded), up to and including EOS."""
        return np.asarray(self.output_ids, np.int32)


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


class _TickDescriptor:
    """The ragged tick's fixed-shape work descriptor, the host half of the
    JAX ``_dispatch_ragged``: per lane, the scale resets' page ids (P), the
    chunk's token ids (cap), offset, count, latent start and page-table row
    (P), and the finish's page-table row (P), latent token ids (L) and prompt
    length. Idle lanes hold zeros: trash tables, and a latent start of 2**30
    on chunk lanes. One int64 buffer on the host (pinned on a card) and one
    on the device, allocated once; ``pack`` fills the host side and copies
    it over in one transfer (on the CPU the two are one buffer)."""

    def __init__(self, lanes: int, cap: int, pages: int, latents: int, device: torch.device):
        self.lanes = lanes
        shapes = {"reset_ids": (lanes * pages,), "ch_ids": (lanes, cap), "ch_offset": (lanes,),
                  "ch_count": (lanes,), "ch_lstart": (lanes,), "ch_tables": (lanes, pages),
                  "fin_tables": (lanes, pages), "fin_ids": (lanes, latents), "fin_n": (lanes,)}
        total = sum(int(np.prod(s)) for s in shapes.values())
        on_card = device.type == "cuda"
        self._host = torch.zeros(total, dtype=torch.int64, pin_memory=on_card)
        self._dev = self._host.to(device) if on_card else self._host
        self._copied: Optional[torch.cuda.Event] = None
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        flat, at = self._host.numpy(), 0
        for name, shape in shapes.items():
            size = int(np.prod(shape))
            self.host[name] = flat[at:at + size].reshape(shape)
            self.dev[name] = self._dev[at:at + size].view(shape)
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
        if self._copied is not None:
            self._copied.synchronize()  # the last tick's copy has read the host buffer
        h = self.host
        self._host.zero_()
        h["ch_lstart"][:] = _IDLE_LATENT_START
        for i, (_slot, ids_row) in enumerate(resets):
            h["reset_ids"][i * ids_row.size:(i + 1) * ids_row.size] = ids_row
        for i, (_slot, ids, offset, count, latent_start, table_row) in enumerate(chunks):
            h["ch_ids"][i], h["ch_offset"][i], h["ch_count"][i] = ids, offset, count
            h["ch_lstart"][i], h["ch_tables"][i] = latent_start, table_row
        for i, (_slot, table_row, ids_latent, n, _request) in enumerate(finishes):
            h["fin_tables"][i], h["fin_ids"][i], h["fin_n"][i] = table_row, ids_latent, n
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        return self.dev


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
    replays each tick's decode step as one captured CUDA graph."""

    def __init__(self, model, num_slots: int = 4, kv_page_size: Optional[int] = None,
                 num_kv_pages: Optional[int] = None, kv_quant: Optional[str] = None,
                 prefill_buckets: Optional[Sequence[int]] = None, max_queue_depth: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None, prefix_cache: bool = False,
                 max_prefill_slots: Optional[int] = None, cuda_graph: bool = True):
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.cache_dtype = model.cache_dtype
        self.scheduler: SlotScheduler[ServedRequest] = SlotScheduler(num_slots)
        self.metrics = EngineMetrics(num_slots=num_slots)
        self.finished: List[ServedRequest] = []
        self._ids = itertools.count()
        if max_queue_depth is not None and max_queue_depth < 0:
            raise ValueError(f"max_queue_depth must be >= 0, got {max_queue_depth}")
        self.max_queue_depth = max_queue_depth

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
        self._pending_harvest = None

        self._state = SlotState.create(num_slots, self._vocab, self.cache_dtype, self.device)
        # the decode step's static input: the tick's tokens, written in place
        self._tok_in = torch.zeros(num_slots, 1, dtype=torch.int64, device=self.device)
        self._decode_method = self.model.decode_step_paged if self.paged else self.model.decode_step
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._captures = 0
        self.graph_replays = 0
        if cuda_graph and self.device.type == "cuda":
            self._capture_decode_graph()

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
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                out, _ = self._decode_method(self._tok_in, self._cache)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the decode step failed: {e}") from e
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
               **kwargs) -> ServedRequest:
        """Queue one request and return its handle. ``config`` or keyword
        options, as ``generate()`` takes them; ``seed`` seeds the request's
        own generator (sampled requests only). Malformed requests (empty
        prompt, a config the engine cannot serve) raise ValueError; a prompt
        longer than the window, or a queue at ``max_queue_depth``, returns a
        handle already ``REJECTED``."""
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
        request = ServedRequest(request_id=next(self._ids), prompt_ids=prompt, config=config, seed=int(seed),
                                submitted_at=now)
        # a request whose prompt plus generation budget passes the window
        # wraps its ring into its own oldest pages mid-decode: those pages
        # must never be shared or donated, so it neither probes nor inserts
        if self._prefix_cache is not None and prompt.size + config.max_new_tokens <= self._window:
            request.page_keys = page_keys_for_prompt(prompt.tolist(), self.kv_page_size, self._latents)
        self.metrics.record_submit(request.request_id, int(prompt.size))
        if prompt.size > self._window:
            return self._reject(request, "prompt_too_long")
        if self.max_queue_depth is not None and self.load >= self.max_queue_depth:
            return self._reject(request, "queue_full")
        self.scheduler.enqueue(request, seq=request.request_id)
        return request

    def _reject(self, request: ServedRequest, reason: str) -> ServedRequest:
        request.status = RequestStatus.REJECTED
        request.finish_reason = reason
        request.finished_at = time.perf_counter()
        self.finished.append(request)
        self.metrics.record_reject(request.request_id, reason)
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
        ids, pad_mask = self._bucket_prompt(request, bucket)
        cache = self.model.init_cache(batch_size=1, max_seq_len=bucket)
        logits, cache = self.model.prefill(ids, bucket - self._latents, cache, pad_mask=pad_mask)
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
        request.status = RequestStatus.RUNNING
        request.slot = slot
        request.pages_allocated = pages
        request.admitted_at = now
        self.metrics.record_admit(request.request_id, slot, wait_s=t0 - request.submitted_at, prefill_s=now - t0,
                                  bucket=bucket, pages=pages)
        if self.paged:
            self.metrics.set_page_pool(self._pool.num_pages - self._pool.reserved, self._pool.pages_in_use)

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
                            chunk_budget=budget, shared_pages=shared, t0=t0)
        self._prefilling[slot] = task
        request.status = RequestStatus.RUNNING
        request.slot = slot
        if shared:
            self.metrics.record_prefix_hit(request.request_id, shared, shared_tokens)
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
        self.metrics.record_admit(request.request_id, slot, wait_s=task.t0 - request.submitted_at,
                                  prefill_s=now - task.t0, bucket=task.bucket, pages=request.pages_allocated,
                                  chunks=task.chunks if self.chunked else None,
                                  shared_pages=task.shared_pages or None)
        if self._prefix_cache is not None:
            self.metrics.set_prefix_cache(self._prefix_cache.stats(), self._shared_pages_in_use())

    def _drop_tick_work(self, slot: int) -> None:
        """Drop a slot's buffered lanes: a request evicted between buffering
        and dispatch must leave no lane that writes pages it gave back."""
        self._tick_chunks = [w for w in self._tick_chunks if w[0] != slot]
        self._tick_finishes = [w for w in self._tick_finishes if w[0] != slot]
        self._tick_resets = [w for w in self._tick_resets if w[0] != slot]

    def _evict(self, slot: int, request: ServedRequest, reason: str) -> None:
        self.scheduler.release(slot)
        self._prefilling.pop(slot, None)  # a mid-chunk admission dies whole
        self._drop_tick_work(slot)
        self._state.release(slot)
        self._tick_programs += 1
        if self.paged:
            # a freed slot keeps decoding: its table must point at the trash
            # page before its pages can go to another request; a shared
            # page's release drops this slot's reference only
            self._tick_programs += 1
            self._cache.release_slot(slot)
            if self._slot_pages[slot]:
                self._pool.release(self._slot_pages[slot])
            self._slot_pages[slot] = None
            self.metrics.set_page_pool(self._pool.num_pages - self._pool.reserved, self._pool.pages_in_use)
        request.status = RequestStatus.FINISHED
        request.finish_reason = reason
        request.finished_at = time.perf_counter()
        request.slot = None
        self.finished.append(request)
        self.metrics.record_finish(request.request_id, slot, len(request.output_ids), reason)

    # ------------------------------------------------------------------ tick
    def _run_chunks(self, d: Dict[str, torch.Tensor], chunks: List[tuple]) -> None:
        """The chunk phase: the lanes' KV rows in one batched call (positions
        clipped to the window, latent-region rows through ``q_norm``), each
        written page-wise through its lane's table."""
        m, cap = len(chunks), self._ragged_chunk_cap
        rows = d["ch_offset"][:m, None] + torch.arange(cap, device=self.device)
        k, v = self.model.prefill_chunk_kv(d["ch_ids"][:m], rows.clamp(0, self._window - 1),
                                           rows >= d["ch_lstart"][:m, None])
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
        """The decode phase: process each slot's logits and sample (eagerly:
        a generator per sampled request), feed inactive rows their pad token,
        advance every slot one token. Returns the (B,) tokens on the
        device."""
        st = self._state
        logits = st.next_logits
        if any(st.do_sample):
            dev = logits.device
            top_k = torch.tensor(st.top_k, device=dev)
            top_p = torch.tensor(st.top_p, dtype=torch.float32, device=dev)
            logits = process_logits_batched(logits, torch.tensor(st.temperature, device=dev), top_k, top_p,
                                            any_filter=any(k > 0 for k in st.top_k) or any(p < 1.0 for p in st.top_p))
        tok = sample_token_batched(st.generators, logits, st.do_sample)
        tok = torch.where(st.active, tok, st.pad_id)
        self._tok_in.copy_(tok[:, None])
        out = self._decode_step()
        st.next_logits.copy_(torch.where(st.active[:, None], out[:, -1].to(st.next_logits.dtype), st.next_logits))
        return tok

    def _dispatch_tick(self, any_decode: bool) -> Optional[torch.Tensor]:
        """Run the tick's phases in the JAX program's order (scale resets,
        chunk lanes, finish lanes, decode), skipping a phase with no work.
        Returns the sampled tokens, or None without a decode."""
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
        if not any_decode:
            return None
        self._tick_programs += 1
        return self._decode()

    @torch.no_grad()
    def step_dispatch(self) -> bool:
        """First half of a tick: advance the slots mid-admission one chunk
        each, admit queued requests, and put the tick's work on the device,
        with no sync. Returns True when a decode is in flight
        (``step_harvest`` must run before the next dispatch)."""
        if self._pending_harvest is not None:
            raise RuntimeError("step_harvest() must run before the next step_dispatch()")
        self._tick_programs = self._tick_chunk_items = self._tick_finish_items = 0
        self._tick_build_s = 0.0
        self._tick_resets, self._tick_chunks, self._tick_finishes = [], [], []
        self.scheduler.advance_tick()
        # oldest work first: a finish here frees prefill-slot budget for the
        # admissions below; a task this tick's admissions started is not
        # advanced twice
        for slot, task in list(self._prefilling.items()):
            if self._prefilling.get(slot) is task:
                self._advance_prefill(slot, task)
        can_admit = self._can_admit_paged if self.paged else None
        # a chunked engine keeps at most max_prefill_slots prompts in flight
        limit = max(self.max_prefill_slots - len(self._prefilling), 0) if self.chunked else None
        for slot, request in self.scheduler.pop_admissible(can_admit, limit=limit):
            self._admit(slot, request)
        # slots mid-admission hold no decode state yet: they are not harvested
        occupied = [(s, r) for s, r in self.scheduler.occupied() if s not in self._prefilling]
        if not occupied and not (self._tick_chunks or self._tick_finishes or self._tick_resets):
            if self._tick_programs:
                self.metrics.record_tick_dispatch(self._tick_programs, 0, 0, 0, 0.0)
            return False
        t0 = time.perf_counter()
        tok = self._dispatch_tick(bool(occupied))
        self.metrics.record_tick_dispatch(self._tick_programs, self._tick_chunk_items, self._tick_finish_items,
                                          len(occupied), self._tick_build_s)
        if not occupied:
            return False  # a tick of prefill work alone: nothing to harvest
        self._pending_harvest = (occupied, tok, t0)
        return True

    @torch.no_grad()
    def step_harvest(self) -> bool:
        """Second half of a tick: the tick's one device sync on the sampled
        tokens, then harvest and evict finished requests. Returns True while
        work remains; a no-op returning that when nothing was dispatched."""
        pending, self._pending_harvest = self._pending_harvest, None
        if pending is None:
            return self.scheduler.has_work
        return self._harvest(pending)

    def _harvest(self, pending) -> bool:
        occupied, tok, t0 = pending
        tok = tok.tolist()  # the tick's one device sync
        now = time.perf_counter()
        self.metrics.record_decode_step(len(occupied), now - t0, tokens=len(occupied))
        for slot, request in occupied:
            if self.scheduler.occupant(slot) is not request:
                continue  # left its slot between dispatch and harvest
            request.output_ids.append(int(tok[slot]))
            if len(request.output_ids) == 1:
                self.metrics.record_first_token(request.request_id, now - request.submitted_at)
            cfg = request.config
            if cfg.eos_token_id is not None and request.output_ids[-1] == cfg.eos_token_id:
                self._evict(slot, request, "eos")
            elif len(request.output_ids) >= cfg.max_new_tokens:
                self._evict(slot, request, "length")
        return self.scheduler.has_work

    def discard_pending_harvest(self) -> None:
        """Drop a dispatched, unharvested decode without syncing it: its
        tokens never land."""
        self._pending_harvest = None

    def step(self) -> bool:
        """One tick: ``step_dispatch()`` then ``step_harvest()``. Returns
        True while work remains."""
        self.step_dispatch()
        return self.step_harvest()

    def run_until_drained(self, max_steps: Optional[int] = None) -> List[ServedRequest]:
        """Step until every submitted request finished; returns (and clears)
        the requests finished since the last call, in completion order.
        ``max_steps`` guards runaway loops."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"engine not drained after {max_steps} steps")
        drained, self.finished = self.finished, []
        return drained
