"""Fault-tolerant serving over several engine replicas: a health-checked router.

Port of ``perceiver_io_tpu/serving/router.py``: ``RoutedRequest``, the
breaker states and ``ServingRouter`` with load-based dispatch, per-replica
health and a circuit breaker, failover by forced-token replay, NaN
containment and the slow-tick detector, SLO shedding at admission, drain
and SIGTERM, per-replica journals with the router's own journal for parked
submits, ``ServingRouter.recover``, ``RouterMetrics`` on the JSONL stream,
replicas in worker processes with the supervisor that respawns a dead
worker through its journal, and the fleet operations: planned migration,
the rolling restart, versioned deploy and rollback, and autoscaling.

  * Same surface as the engine. ``submit()`` returns a handle at once,
    ``step()`` runs one router tick, ``run_until_drained()`` and ``drain()``
    close the loop: a caller written against ``ServingEngine`` moves to N
    replicas by swapping the constructor.
  * In-process replicas. Each replica is a ``ServingEngine`` of the fleet's
    geometry over the one model the caller hands in, on the model's device:
    the replicas share its parameters (the card holds one copy, and under
    ``weight_dtype`` they are transformed once; the replicas of a deployed
    version share that version's model), while each owns its caches,
    its page pool, its decode graph (one capture each) and its journal. An
    in-process replica fails alone only for host-side faults: an exception
    out of its tick, a stall, non-finite logits. A sticky CUDA error (an
    illegal address, a device-side assert) poisons the whole process's
    context and every replica with it.
  * Process replicas. ``replica_mode="process"`` runs each replica's engine
    in a worker process of its own behind ``serving/transport.py``'s framed
    RPC (``EngineClient``), with its own CUDA context, stream and copy of
    the weights; ``transport`` holds the clients' options (``rpc_timeout_s``,
    ``init_timeout_s``, ``retry``, ``num_threads``). The fleet keeps one
    spare worker process started ahead (from its build on): a respawn, a
    recycle, a flip or a scale-up takes it, its interpreter and imports
    done (the largest part of a worker's start), and starts the next spare
    in its place. Dispatch, breakers,
    failover and journals work as in-process. A worker whose process dies
    (``kill -9``, an out-of-memory kill, or its exit after a CUDA error)
    surfaces ``WorkerDiedError``, and on a journaled fleet the supervisor
    (``_respawn_worker``) starts a fresh worker through that replica's
    journal recovery: its sessions come back and continue with the same
    tokens, with no failover spent and no breaker strike, while the
    siblings tick on. A wedged worker (``TransportError``) and an op that
    raised in the worker (``WorkerOpError``) are breaker strikes; a worker
    found dead when its breaker goes half-open is replaced before the
    probe, through its journal or, on a fleet without one, by a fresh,
    empty worker.
  * Dispatch by load. A new request goes to the replica with the least
    ``engine.load`` whose breaker is CLOSED, ties on the lowest index, so
    placement is a function of the submit and tick interleaving.
  * Health and the breaker. A replica's health is read from its ticks:
    consecutive exceptions, slow-tick strikes (its own dispatch and harvest
    time beyond ``slow_tick_threshold_s``) and the NaN containments its
    harvest reports. A breaker runs CLOSED -> OPEN -> HALF_OPEN: an OPEN
    replica is not ticked and gets no work for a cooldown counted in router
    ticks (``RetryPolicy``'s bounded exponential schedule with jitter 0, so
    no clock and no randomness decide it); HALF_OPEN runs one probe tick,
    which closes the breaker (stale slots reclaimed) or opens it again with
    the next cooldown.
  * Failover. When a replica is lost, each of its queued and running
    requests goes to a healthy replica as its prompt plus the tokens it
    emitted, forced through the new engine's decode step (the engine's
    replay mux) after the same prefill, with the same seed and class. The
    continuation's tokens equal the uninterrupted run's, sampled ones too:
    a request's generator restarts from its seed and a replaying slot still
    draws (ROADMAP C11, C14). A request survives at most ``max_failovers``
    re-dispatches, then ends FAILED with its tokens kept. A continuation no
    replica can take parks at the front of the router's queue.
  * Shedding. A request with a deadline is REJECTED at admission
    (``shed_infeasible``) when p95 queue wait + p95 prefill +
    ``max_new_tokens`` x p95 decode step (``EngineMetrics.latency_estimates``)
    exceeds it on every healthy replica. Replicas with fewer than
    ``shed_min_samples`` decode steps never shed.
  * No request is silently lost: every handle reaches FINISHED, REJECTED,
    TIMED_OUT or FAILED while any replica serves; ``drain()`` and
    ``handle_preemption`` (SIGTERM/SIGINT) resolve the backlog. A request
    with no deadline parked through a whole-fleet outage waits until a
    replica recovers or a drain rejects it.
  * Durability. ``journal`` is a directory template with ``"{i}"``, one
    journal a replica; a fresh submit parked while no replica can take it
    is journaled in the router's own journal (``"{i}"`` = ``router``). A
    failed-over session's origin entry stays live until its continuation's
    accept is durable elsewhere or it ends while parked, so a process death
    anywhere recovers it exactly once (``ServingRouter.recover``).

Fleet operations (one tick of progress each ``step()``, decided by tick
counts, never by a clock):

  * Planned migration. ``migrate(request_id, dst)`` lifts a session off its
    healthy replica through the engine's eviction and lands it on ``dst``
    as its prompt plus emitted tokens, the failover's forced replay: the
    same tokens, no failover spent, no new capture. The origin's journal
    entry stays live until the destination's accept is durable, then closes
    as ("moved", "migrated"); a death between the two leaves the session in
    two journals, which ``recover`` dedupes by session id.
  * Rolling restart. ``begin_rolling_restart()`` (``rolling_restart()``
    steps it to the end) recycles every replica in index order, one at a
    time, over two ticks: the first drains its sessions to siblings (or
    parks them, durable in its journal), the second rebuilds its engine
    through its journal at the version it served and serves again. A
    replica that is recycling reads as OPEN everywhere: no dispatch, no
    tick, no strike. In process mode the rebuild is a fresh worker.
  * Versions. ``deploy(state_dict, fraction)`` registers a parameter
    version (its layout checked at once); a deterministic ``fraction`` of
    new admissions pins it, and the last ``ceil(fraction x replicas)``
    replicas flip to it once empty; every session keeps the version it was
    admitted at, through dispatch, failover and migration. ``rollback()``
    pins new admissions to the old version at once; a full rollout becomes
    the primary version once every replica has flipped. A worker flips in
    place (``set_params``, no new capture). In-process replicas share one
    model a version (each version's parameters live once on the device), so
    an in-process flip builds a fresh engine on the version's model (one
    capture) and leaves its siblings' weights alone (ROADMAP C14).
  * Autoscaling. ``autoscale=dict(min_replicas, max_replicas,
    scale_up_load, scale_down_load, every_ticks, patience)`` scales the
    replicas in service on the fleet's load (parked requests plus each
    serving replica's queue beyond its slots), evaluated every
    ``every_ticks`` ticks and acted on after ``patience`` readings in a
    row: up revives the lowest retired replica or adds one, down retires
    the highest one through the recycle's drain.

Telemetry (``obs/``): ``telemetry`` (the engine's encoding) resolves one
recorder that the router and every in-process replica share, each replica's
engine under the namespace ``serving.r{i}`` (the first build, a recycle, a
flip and a scale-up alike); the router records ``router.tick``, one
``router.request`` async span a request with its ``dispatch``,
``failover`` and ``migrate`` milestones, and the ``router.*`` counters and
instants of the JAX router. Worker processes run telemetry-off, as the JAX
package's do. ``telemetry_summary()`` merges the replicas' compile reports.

The JAX package's kill switches are TPU rollback levers and are not ported
(C11, C15): the fleet operations are always on, and
``replica_mode="process"`` always means worker processes.
"""

from __future__ import annotations

import itertools
import math
import os
import random
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.obs.core import resolve_recorder
from perceiver_io_torch.reliability import faults
from perceiver_io_torch.reliability.preemption import install_preemption_handler, restore_preemption_handler
from perceiver_io_torch.reliability.retry import RetryPolicy
from perceiver_io_torch.serving.engine import (RequestStatus, ServedRequest, ServingEngine, _engine_compatible,
                                               _journal_config_payload)
from perceiver_io_torch.serving.journal import JournalSession, RequestJournal, read_journal
from perceiver_io_torch.serving.metrics import RouterMetrics
from perceiver_io_torch.serving.quant import tree_layout_mismatch
from perceiver_io_torch.serving.transport import (EngineClient, TransportError, WorkerDiedError, model_recipe,
                                                   spawn_worker)

# breaker states (the values land in the metrics' transition keys)
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


@dataclass
class RoutedRequest:
    """The router's handle, returned by ``ServingRouter.submit``. It has the
    ``ServedRequest`` surface (``status``, ``ok``, ``done``,
    ``finish_reason``, ``result()``) and outlives the engine that runs it:
    tokens emitted before a replica was lost are kept in ``_salvaged``, so
    ``result()`` is always the whole stream and ``output_ids`` never moves
    backwards while a new replica replays the prefix."""

    request_id: int
    prompt_ids: np.ndarray
    config: GenerationConfig
    seed: int
    priority: int = 0  # forwarded to whichever engine serves it, failover included
    finish_reason: Optional[str] = None
    submitted_at: float = 0.0
    finished_at: Optional[float] = None
    deadline_s: Optional[float] = None
    failovers: int = 0  # re-dispatches survived so far
    replica: Optional[int] = None  # the replica it is on (None: parked)
    # the parameter-version pin, chosen at submit: every dispatch, failover
    # and migration lands the session on a replica serving it
    version: int = 0
    # the fleet-unique session id every accept of this session carries:
    # recovery's key when a session is live in two journals
    session_id: Optional[str] = None
    # True once any engine accepted it: accepted work is never rejected by a
    # drain while parked, and re-enters engines as a resume
    _accepted: bool = field(default=False, repr=False)
    # how the origin's journal entry closes when the session lands elsewhere:
    # ("moved", reason) after a detach, the failover's default otherwise
    _move_note: Optional[tuple] = field(default=None, repr=False)
    # the longest token prefix salvaged from a lost replica; the live handle
    # overtakes it as its replay catches up
    _salvaged: List[int] = field(default_factory=list, repr=False)
    _engine_handle: Optional[ServedRequest] = field(default=None, repr=False)
    _terminal_status: Optional[RequestStatus] = field(default=None, repr=False)
    # (replica, engine request id) whose journal still holds this session
    # live after a failover: its durable copy while it is between replicas,
    # closed when the continuation's accept is durable elsewhere or it ends
    _journal_origin: Optional[tuple] = field(default=None, repr=False)
    # True while the router's own journal holds this (parked) submit live
    _router_journaled: bool = field(default=False, repr=False)

    @property
    def status(self) -> RequestStatus:
        """QUEUED (parked at the router or queued at an engine), RUNNING
        (holding a slot), PREEMPTED, or the terminal status the router
        resolved. An engine-terminal handle not yet harvested reads RUNNING:
        ``done`` flips only through the router."""
        if self._terminal_status is not None:
            return self._terminal_status
        handle = self._engine_handle
        if handle is not None:
            if handle.status in (RequestStatus.QUEUED, RequestStatus.RUNNING, RequestStatus.PREEMPTED):
                return handle.status
            return RequestStatus.RUNNING
        return RequestStatus.QUEUED

    @property
    def done(self) -> bool:
        return self._terminal_status is not None

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.FINISHED

    @property
    def output_ids(self) -> List[int]:
        """Every token emitted so far, monotonic across failover: while a
        new engine replays the salvaged prefix, the salvage answers."""
        engine_out = self._engine_handle.output_ids if self._engine_handle else []
        if len(engine_out) >= len(self._salvaged):
            return list(engine_out)
        return list(self._salvaged)

    @property
    def admitted_at(self) -> Optional[float]:
        """``time.perf_counter()`` when it last reached a slot (None while
        queued or parked)."""
        return None if self._engine_handle is None else self._engine_handle.admitted_at

    @property
    def deadline_at(self) -> Optional[float]:
        return None if self.deadline_s is None else self.submitted_at + self.deadline_s

    def result(self) -> np.ndarray:
        """Generated tokens (prompt excluded) across every replica that
        served it; partial for TIMED_OUT and FAILED."""
        return np.asarray(self.output_ids, np.int32)


@dataclass
class _Version:
    """A parameter version the router holds: its parameters by name on the
    CPU (None: the caller's model's, version 0) and, in process, the model
    that serves it and the served parameters its first engine made, handed
    to its other replicas so that it is transformed once."""

    state_dict: Optional[Dict[str, torch.Tensor]]
    model: Optional[object] = None
    served: Optional[tuple] = None


@dataclass
class _Replica:
    """One replica's health record."""

    rid: int
    engine: ServingEngine  # or an EngineClient in process mode
    breaker: str = BREAKER_CLOSED
    opened_at_tick: int = 0
    open_count: int = 0  # consecutive opens: the rung of the cooldown ladder
    cooldown_ticks: int = 0
    consecutive_failures: int = 0  # tick exceptions since the last healthy tick
    consecutive_slow: int = 0  # slow-tick strikes since the last fast tick
    nan_failures: int = 0  # non-finite containments harvested
    last_tick: int = -1  # heartbeat: the router tick of its last healthy tick
    last_error: Optional[str] = None
    # engine request id -> routed request, every live hand-off
    assigned: Dict[int, RoutedRequest] = field(default_factory=dict)
    # engine request id -> routed request, hand-offs failed over but not yet
    # reclaimed from the engine (reclaimed when the replica recovers)
    orphaned: Dict[int, RoutedRequest] = field(default_factory=dict)
    # this replica's own dispatch + harvest time this tick: the slow-tick
    # detector's input, never its siblings'
    _own_tick_s: float = 0.0
    # the engine's capture count as last seen: a tick that captured is
    # slow, not wedged (the port's engine captures at construction, so this
    # starts at its count)
    _programs_seen: int = 0
    # the parameter version its engine serves, and the one it is to serve
    # (they differ while a flip waits for the replica to empty: it then
    # takes continuations of its version only)
    version: int = 0
    target_version: int = 0
    # out of service by plan (a recycle or a retirement under way): read as
    # OPEN everywhere, without touching the breaker's ladder
    recycling: bool = False
    # retired by the autoscaler: its engine closed, left out of everything
    # until a scale-up revives it
    retired: bool = False


# the autoscaler's knobs and their defaults (the JAX router's)
_AUTOSCALE_DEFAULTS = dict(min_replicas=1, scale_up_load=1, scale_down_load=0, every_ticks=8, patience=2)


class ServingRouter:
    """Router over ``num_replicas`` ``ServingEngine`` replicas of ``model``,
    in this process or (``replica_mode="process"``) one worker process each
    (see the module docstring); the engine's submit/step/drain surface.

    Engine options (``num_slots``, ``kv_page_size``, ``num_kv_pages``,
    ``kv_quant``, ``prefill_buckets``, ``max_queue_depth``,
    ``prefill_chunk_tokens``, ``prefix_cache``, ``max_prefill_slots``,
    ``weight_dtype``, ``priority_aging_ticks``, ``max_preemptions``) go to
    every replica. ``journal``: a directory template with ``"{i}"`` (one
    journal a replica; a plain path with one replica); ``metrics_jsonl``:
    the router's event stream; ``replica_metrics_jsonl``: a ``"{i}"``
    template for each engine's. Failover and breaker policy:
    ``max_failovers``, ``failure_threshold``, ``slow_tick_threshold_s``,
    ``slow_ticks_to_open``, ``nan_failures_to_open``,
    ``breaker_cooldown_ticks``, ``breaker_max_cooldown_ticks``; shedding:
    ``shed_infeasible``, ``shed_min_samples``; autoscaling: ``autoscale``
    (a dict of the knobs in the module docstring, or None for a fixed
    fleet); ``telemetry``: one recorder for the router and its in-process
    replicas (see the module docstring).

    In-process replicas share the model's parameters (a deployed version's
    replicas share a model built for it), so the router never calls
    ``set_params`` on an in-process engine: an engine changes version by
    being built again. Process replicas each build their own copy from the
    model's recipe, and the caller's model is never handed to an engine."""

    def __init__(self, model, num_replicas: int = 2, num_slots: int = 4, metrics_jsonl: Optional[str] = None,
                 replica_metrics_jsonl: Optional[str] = None, prefill_buckets: Optional[Sequence[int]] = None,
                 max_queue_depth: Optional[int] = None, default_deadline_s: Optional[float] = None,
                 kv_page_size: Optional[int] = None, num_kv_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None, prefix_cache: bool = False,
                 max_prefill_slots: Optional[int] = None, kv_quant: Optional[str] = None,
                 weight_dtype: Optional[str] = None, priority_aging_ticks: Optional[int] = None,
                 max_preemptions: int = 2, journal: Optional[str] = None, telemetry=None,
                 handle_preemption: bool = False, max_failovers: int = 2, failure_threshold: int = 1,
                 slow_tick_threshold_s: Optional[float] = None, slow_ticks_to_open: int = 3,
                 nan_failures_to_open: Optional[int] = 3, breaker_cooldown_ticks: int = 4,
                 breaker_max_cooldown_ticks: int = 64,
                 shed_infeasible: bool = True, shed_min_samples: int = 3, autoscale: Optional[Dict] = None,
                 replica_mode: str = "inproc", transport: Optional[Dict] = None, _from_recovery: bool = False):
        if replica_mode not in ("inproc", "process"):
            raise ValueError(f"replica_mode must be 'inproc' or 'process', got {replica_mode!r}")
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if max_failovers < 0:
            raise ValueError(f"max_failovers must be >= 0, got {max_failovers}")
        self.model = model
        self.num_replicas = num_replicas
        self._window = model.max_seq_len
        self.max_failovers = max_failovers
        self.failure_threshold = max(failure_threshold, 1)
        self.slow_tick_threshold_s = slow_tick_threshold_s
        self.slow_ticks_to_open = max(slow_ticks_to_open, 1)
        self.nan_failures_to_open = nan_failures_to_open
        self.shed_infeasible = shed_infeasible
        self.shed_min_samples = max(shed_min_samples, 1)
        self.default_deadline_s = default_deadline_s
        self.max_queue_depth = max_queue_depth
        # one journal a replica (engine request ids are engine-local), and
        # the router's own beside them under the same template
        if journal is not None and num_replicas > 1 and "{i}" not in journal:
            raise ValueError(f"journal must be a per-replica template containing '{{i}}' with num_replicas > 1, "
                             f"got {journal!r}")
        self._journal_template = journal
        self._autoscale: Optional[Dict] = None
        if autoscale is not None:
            knobs = dict(autoscale)
            a = {k: int(knobs.pop(k, d)) for k, d in dict(_AUTOSCALE_DEFAULTS, max_replicas=num_replicas).items()}
            if knobs:
                raise ValueError(f"unknown autoscale knobs {sorted(knobs)}")
            a["every_ticks"], a["patience"] = max(a["every_ticks"], 1), max(a["patience"], 1)
            if not 1 <= a["min_replicas"] <= num_replicas <= a["max_replicas"]:
                raise ValueError(f"autoscale requires 1 <= min_replicas <= num_replicas <= max_replicas, got "
                                 f"min={a['min_replicas']} start={num_replicas} max={a['max_replicas']}")
            if journal is not None and a["max_replicas"] > 1 and "{i}" not in journal:
                raise ValueError("journal must be a per-replica '{i}' template when the autoscaler can grow the fleet "
                                 "past one replica")
            self._autoscale = a
        self._scale_up_streak = 0
        self._scale_down_streak = 0
        # the journal policy of rebuilt replicas' recoveries (recover()
        # sets the dead fleet's)
        self._journal_fsync = "accept"
        self._journal_segment_max = 4096
        self._replica_mode = replica_mode
        self._transport_cfg = dict(transport or {})
        # process mode: the spare worker (process, socket), started ahead
        self._spare: Optional[Tuple[object, object]] = None
        # the last transport_stats() of each worker client the supervisor
        # replaced: the fleet's transport counters stay lifetime totals
        self.retired_transport: List[Dict] = []
        self._router_journal: Optional[RequestJournal] = None
        self._router_journal_dir: Optional[str] = None
        if journal is not None:
            self._router_journal_dir = journal.format(i="router") if "{i}" in journal else journal + "-router"
        # the cooldown ladder: RetryPolicy's bounded exponential schedule in
        # ticks with jitter 0, so its generator's draws move nothing
        self._breaker_policy = RetryPolicy(attempts=1, base_delay_s=float(max(breaker_cooldown_ticks, 1)),
                                           max_delay_s=float(max(breaker_max_cooldown_ticks,
                                                                 breaker_cooldown_ticks, 1)), jitter=0.0)
        self._breaker_rng = random.Random(0)
        # one shared recorder for the router and every in-process replica
        # (each engine under its own span namespace and request category)
        self._obs, self._owns_telemetry = resolve_recorder(telemetry)
        self._obs_on = self._obs.enabled
        self._engine_cfg = dict(num_slots=num_slots, prefill_buckets=prefill_buckets, max_queue_depth=max_queue_depth,
                                kv_page_size=kv_page_size, num_kv_pages=num_kv_pages,
                                prefill_chunk_tokens=prefill_chunk_tokens, prefix_cache=prefix_cache,
                                max_prefill_slots=max_prefill_slots, kv_quant=kv_quant, weight_dtype=weight_dtype,
                                priority_aging_ticks=priority_aging_ticks, max_preemptions=max_preemptions)
        self._replica_metrics_jsonl = replica_metrics_jsonl
        # parameter versions; every session pins one at submit. A rollout:
        # {"version", "fraction", "count", "base"}
        self._versions: Dict[int, _Version] = {0: _Version(None, model=model)}
        self._next_version = 1
        self._primary_version = 0
        self._rollout: Optional[Dict] = None
        # the layout (names, shapes, dtypes) a deployed version must have,
        # read before any engine transforms the model
        self._layout = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in model.state_dict().items()}
        # the rolling restart and the autoscaler's retirements: the
        # replicas still to recycle, the one under way and its mode
        # ("restart" or "retire"), and the sessions its drain moved
        self._restart_queue: List[int] = []
        self._recycle_rid: Optional[int] = None
        self._recycle_mode: Optional[str] = None
        self._recycle_moved = 0
        # a fleet-unique session-id prefix: two fleets sharing journal
        # directories across restarts never collide on the dedup key
        self._fleet_id = uuid.uuid4().hex[:12]
        if self._router_journal_dir is not None and not _from_recovery:
            self._router_journal = RequestJournal(self._router_journal_dir)
        # recovery builds the fleet journal-less, replays each replica's
        # journal, and only then attaches it
        engines = self._make_engines([journal.format(i=i) if journal and not _from_recovery else None
                                      for i in range(num_replicas)])
        self.replicas: List[_Replica] = [_Replica(rid=i, engine=e, _programs_seen=e.total_compilations)
                                         for i, e in enumerate(engines)]
        self.metrics = RouterMetrics(num_replicas=num_replicas, jsonl_path=metrics_jsonl)
        self.finished: List[RoutedRequest] = []
        self._ids = itertools.count()
        self._tick = 0  # the breaker's clock
        self._pending: Deque[RoutedRequest] = deque()  # held while no replica can take them
        self._deadlines_seen = default_deadline_s is not None
        self._draining = False
        # SIGTERM/SIGINT drain, as the engine's
        self.preempted = False
        self._preempt_requested = False
        self._preempt_flushed = False
        self._preempt_handler, self._preempt_previous = None, {}
        if handle_preemption:
            self._preempt_handler, self._preempt_previous = install_preemption_handler(self._request_preempt)

    def _request_preempt(self) -> None:
        self._preempt_requested = True

    def _make_engines(self, journal_paths: List[Optional[str]]) -> list:
        """The fleet's replicas, in order. Process replicas are built
        together: the model's recipe pickled once, every worker started in
        turn (the first start builds the serving kernels, so that no two
        workers run one nvcc), then each initialised on a thread of its own,
        so that one worker loads and captures while the next takes its
        recipe; the fleet's spare worker starts beside them. On a failure
        the clients built are closed (a failed client kills its worker), the
        spare ended and the error raised."""
        if self._replica_mode != "process":
            return [self._make_engine(i, path) for i, path in enumerate(journal_paths)]
        recipe = self._recipe(self._primary_version)
        # the spare starts with the replicas' workers, beside their inits
        workers = [spawn_worker(self.model.device) for _ in range(len(journal_paths) + 1)]
        self._spare = workers.pop()
        built: List[object] = [None] * len(journal_paths)

        def make(i):
            try:
                built[i] = self._make_engine(i, journal_paths[i], _worker=workers[i], _recipe=recipe)
            except BaseException as exc:  # noqa: BLE001 — raised below, in the caller's thread
                built[i] = exc

        threads = [threading.Thread(target=make, args=(i,), name=f"replica-{i}-init") for i in range(len(built))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        errors = [e for e in built if isinstance(e, BaseException)]
        if errors:
            for e in built:
                if isinstance(e, EngineClient):
                    e.close()
            self._end_spare()
            raise errors[0]
        return built

    def _make_engine(self, rid: int, journal_path: Optional[str] = None, version: Optional[int] = None,
                     _worker=None, _recipe=None):
        """One replica engine at the fleet's geometry serving ``version``
        (the primary by default): the one construction point of the first
        build, a respawn, a recycle, a flip and a scale-up. In process, over
        the version's shared model; in process mode, an ``EngineClient``
        whose worker builds its own copy (``_worker``: one ``spawn_worker``
        started; ``_recipe``: the version's recipe, pickled)."""
        version = self._primary_version if version is None else version
        metrics_jsonl = self._replica_metrics_jsonl.format(i=rid) if self._replica_metrics_jsonl else None
        if self._replica_mode == "process":
            if _worker is None:
                _worker = self._take_spare()
            return EngineClient(self.model, replica_id=rid, metrics_jsonl=metrics_jsonl, journal=journal_path,
                                on_retry=self._note_rpc_retry, _worker=_worker,
                                _recipe=self._recipe(version) if _recipe is None else _recipe,
                                **self._transport_cfg, **self._engine_cfg)
        record = self._versions[version]
        engine = ServingEngine(self._version_model(version), metrics_jsonl=metrics_jsonl, journal=journal_path,
                               telemetry=self._obs if self._obs_on else False, obs_ns=f"serving.r{rid}",
                               _served=record.served, **self._engine_cfg)
        if record.served is None:
            record.served = (engine.params, engine._param_bytes, engine._param_bytes_fp)
        return engine

    def _recipe(self, version: int) -> bytes:
        """The pickled recipe a worker builds ``version``'s model from."""
        return model_recipe(self.model, state_dict=self._versions[version].state_dict)

    def _version_model(self, version: int):
        """In process: the model that serves ``version``, built on first use
        at the caller's model's config, dtypes and device with the version's
        parameters. The replicas serving one version share it."""
        record = self._versions[version]
        if record.model is None:
            base = self.model
            record.model = type(base)(base.config, device=base.device, dtype=base.dtype,
                                      param_dtype=base.param_dtype)
            record.model.load_state_dict(record.state_dict)
            record.model.train(base.training)
        return record.model

    def _version_params(self, version: int) -> Dict[str, torch.Tensor]:
        """``version``'s parameters by name, for a worker's ``set_params``
        (version 0's are the caller's model's, which process mode never
        transforms)."""
        params = self._versions[version].state_dict
        return self.model.state_dict() if params is None else params

    def _note_rpc_retry(self, replica: int, op: str, attempt: int, err: str, delay: float) -> None:
        """``EngineClient``'s retry hook: each transport retry is an
        ``rpc_retry`` event. The init RPC can retry before ``self.metrics``
        exists."""
        metrics = getattr(self, "metrics", None)
        if metrics is not None:
            metrics.record_rpc_retry(replica, op, attempt, err, delay)

    # -------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, model, journal: str, num_replicas: int = 2, fsync: str = "accept",
                segment_max_records: int = 4096, versions: Optional[Dict] = None, **router_kwargs):
        """Rebuild a fleet from its journals after the process died.
        ``journal`` is the template the dead fleet ran with; each replica's
        journal is replayed into its own replica, in replica order (each
        swap is atomic per journal, so a crash during recovery recovers
        again). A session live in two journals (between a continuation's
        accept and its origin's close) is kept once, the copy with the
        longest emitted prefix. The router's journal's parked submits come
        back parked, unless a replica journal holds them already. Returns
        ``(router, info)``: ``info["handles"]`` the recovered handles
        (replica order, accept order within a replica) and
        ``info["parked_handles"]``; run the router as usual and each
        completes with the uninterrupted run's tokens. The model carries its
        parameters, version 0's; ``versions`` gives the other versions the
        dead fleet had deployed, ``{version: state_dict}`` under the numbers
        its accept records pin, and each replica serves its sessions' pin
        (a pin with no parameters given raises). ``router_kwargs`` must give
        the dead fleet's geometry."""
        if num_replicas > 1 and "{i}" not in journal:
            raise ValueError(f"journal must be a per-replica template containing '{{i}}' with num_replicas > 1, "
                             f"got {journal!r}")
        if "{i}" in journal:
            # a journal past num_replicas with live sessions would be dropped
            # silently: refuse (a fully drained one holds nothing to lose)
            stray = [i for i in range(num_replicas, num_replicas + 64)
                     if os.path.isdir(journal.format(i=i)) and read_journal(journal.format(i=i)).sessions]
            if stray:
                raise ValueError(f"journal template {journal!r} holds live sessions for replica indices {stray} "
                                 f"beyond num_replicas={num_replicas}: recovering fewer replicas than the dead fleet "
                                 f"ran would drop their accepted sessions (pass the fleet's num_replicas)")
        router = cls(model, num_replicas=num_replicas, journal=journal, _from_recovery=True, **router_kwargs)
        router._journal_fsync = fsync
        router._journal_segment_max = segment_max_records
        for v, params in sorted((versions or {}).items()):
            router._register_version(int(v), params)
        # per session id, the copy with the longest emitted prefix wins, ties
        # to the lowest replica
        best: Dict[str, tuple] = {}
        per_journal_ids: Dict[int, set] = {}
        states = {}
        for r in router.replicas:
            state = read_journal(journal.format(i=r.rid))
            states[r.rid] = state
            ids = set()
            for s in state.sessions:
                if s.session is None:
                    continue
                ids.add(s.session)
                cur = best.get(s.session)
                if cur is None or len(s.emitted) > cur[1]:
                    best[s.session] = (r.rid, len(s.emitted))
            per_journal_ids[r.rid] = ids
        now = time.perf_counter()
        handles: List[RoutedRequest] = []
        per_replica: Dict[str, Dict] = {}
        for r in router.replicas:
            skip = frozenset(sid for sid in per_journal_ids[r.rid] if best[sid][0] != r.rid)
            # every live session a replica keeps was accepted while it
            # served the session's pin, so the pins agree
            pins = {s.version for s in states[r.rid].sessions if s.version is not None and s.session not in skip}
            if len(pins) > 1:
                raise ValueError(f"replica {r.rid} journal holds sessions pinned to several parameter versions "
                                 f"{sorted(pins)} (one replica serves one version)")
            pin = pins.pop() if pins else router._primary_version
            if pin not in router._versions:
                raise ValueError(f"replica {r.rid} journal pins its sessions to parameter version {pin}, which "
                                 f"this router does not hold: pass its parameters as versions={{{pin}: state_dict}}")
            if pin != r.version:
                router._serve_version(r, pin, through_journal=False)
            info = r.engine._recover_attach(journal.format(i=r.rid), fsync=fsync,
                                            segment_max_records=segment_max_records, skip_session_ids=skip,
                                            _state=states[r.rid])
            for handle in info.pop("handles"):
                routed = RoutedRequest(request_id=next(router._ids), prompt_ids=handle.prompt_ids,
                                       config=handle.config, seed=handle.seed, priority=handle.priority,
                                       submitted_at=now, deadline_s=handle.deadline_s, session_id=handle.session_id,
                                       version=handle.version if handle.version is not None else r.version)
                routed._engine_handle = handle
                routed._accepted = True
                routed.replica = r.rid
                r.assigned[handle.request_id] = routed
                if routed.deadline_s is not None:
                    router._deadlines_seen = True
                # a fresh submit and dispatch in the router's books, so
                # submitted = finished + rejected + timed out + failed holds
                router.metrics.record_submit(routed.request_id, int(handle.prompt_ids.size),
                                             priority=routed.priority)
                router.metrics.record_dispatch(routed.request_id, r.rid, load=r.engine.load)
                if router._obs_on:
                    router._obs.async_begin("router.request", routed.request_id,
                                            prompt_len=int(handle.prompt_ids.size))
                handles.append(routed)
            per_replica[f"r{r.rid}"] = info
        # the router journal's parked submits: their only durable copy. One
        # whose session a replica journal holds already landed there before
        # the death (its close record was lost): the replica's copy stands
        parked: List[RoutedRequest] = []
        rj_dir = router._router_journal_dir
        if os.path.isdir(rj_dir):
            rj_state = read_journal(rj_dir)
            dispatched = set().union(*per_journal_ids.values())
            mirror = []
            now_wall = time.time()
            for s in rj_state.sessions:
                if s.session is not None and s.session in dispatched:
                    continue
                if len(s.rng) != 1:
                    raise ValueError(f"router journal session rid={s.rid} carries a {len(s.rng)}-word rng {s.rng} "
                                     f"(a JAX key); this router's requests are seeded by one integer, [seed]")
                pin = s.version if s.version is not None else router._primary_version
                if pin not in router._versions:
                    raise ValueError(f"router journal holds a parked admission pinned to parameter version {pin}, "
                                     f"which this router does not hold: pass its parameters as "
                                     f"versions={{{pin}: state_dict}}")
                routed = RoutedRequest(request_id=next(router._ids), prompt_ids=np.asarray(s.prompt, np.int64),
                                       config=GenerationConfig(**s.config), seed=int(s.rng[0]), priority=s.priority,
                                       submitted_at=now,
                                       # deadlines kept counting through the outage
                                       deadline_s=s.remaining_deadline(now_wall), session_id=s.session, version=pin)
                routed._router_journaled = True
                if routed.deadline_s is not None:
                    router._deadlines_seen = True
                router.metrics.record_submit(routed.request_id, int(routed.prompt_ids.size),
                                             priority=routed.priority, version=routed.version)
                if router._obs_on:
                    router._obs.async_begin("router.request", routed.request_id,
                                            prompt_len=int(routed.prompt_ids.size))
                router._pending.append(routed)
                parked.append(routed)
                mirror.append((routed.request_id, JournalSession(
                    rid=routed.request_id, prompt=list(s.prompt), config=dict(s.config), rng=list(s.rng),
                    priority=s.priority, deadline_s=routed.deadline_s, accepted_ts=now_wall, session=s.session,
                    version=s.version)))
            # the generation swap: the new generation holds the re-admitted
            # entries under their new ids
            router._router_journal = RequestJournal(rj_dir, fsync=fsync, segment_max_records=segment_max_records,
                                                    _recovered_from=rj_state, _sessions=mirror)
        else:
            router._router_journal = RequestJournal(rj_dir, fsync=fsync, segment_max_records=segment_max_records)
        return router, {
            "sessions": len(handles),
            "replayed_tokens": sum(i["replayed_tokens"] for i in per_replica.values()),
            "deduped": sum(i["deduped"] for i in per_replica.values()),
            "replicas": per_replica,
            "handles": handles,
            "router_parked": len(parked),
            "parked_handles": parked,
        }

    # ---------------------------------------------------------------- submit
    def submit(self, prompt_ids: Sequence[int], config: Optional[GenerationConfig] = None, seed: int = 0,
               deadline_s: Optional[float] = None, priority: int = 0, **kwargs) -> RoutedRequest:
        """Queue one request and return its handle, as
        ``ServingEngine.submit``: malformed requests raise; well-formed ones
        the fleet cannot serve come back REJECTED, also ``shed_infeasible``
        (the live latency estimates say the deadline cannot be met).
        ``seed`` seeds a sampled request's generator on whichever replica
        runs it; ``priority`` is its class there. The request pins its
        parameter version here (``_pick_version``) for its whole life."""
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
        routed = RoutedRequest(request_id=next(self._ids), prompt_ids=prompt, config=config, seed=int(seed),
                               priority=int(priority), submitted_at=time.perf_counter(),
                               deadline_s=deadline_s if deadline_s is not None else self.default_deadline_s,
                               version=self._pick_version())
        routed.session_id = f"{self._fleet_id}:{routed.request_id}"
        if routed.deadline_s is not None:
            self._deadlines_seen = True
        self.metrics.record_submit(routed.request_id, int(prompt.size), priority=routed.priority,
                                   version=routed.version)
        if self._obs_on:
            self._obs.async_begin("router.request", routed.request_id, prompt_len=int(prompt.size))
        if self._draining:
            return self._refuse(routed, "draining")
        if prompt.size > self._window:
            return self._refuse(routed, "prompt_too_long")
        if routed.deadline_s is not None and self.shed_infeasible:
            est = self._estimate_completion_s(config.max_new_tokens)
            if est is not None and est > routed.deadline_s:
                self.metrics.record_shed(routed.request_id, routed.deadline_s, est)
                if self._obs_on:
                    self._obs.counter_inc("router.shed_infeasible")
                return self._refuse(routed, "shed_infeasible")
        self._dispatch(routed)
        return routed

    def _refuse(self, routed: RoutedRequest, reason: str) -> RoutedRequest:
        self._resolve(routed, RequestStatus.REJECTED, reason)
        return routed

    # -------------------------------------------------------------- dispatch
    def _pick_version(self) -> int:
        """The version pin of one new admission: the primary, or during a
        rollout the rollout's version for a ``fraction`` of admissions
        (admission k takes it when ``floor((k + 1) f) > floor(k f)``: a
        function of the submit count alone)."""
        if self._rollout is None:
            return self._primary_version
        f, k = self._rollout["fraction"], self._rollout["count"]
        self._rollout["count"] = k + 1
        return self._rollout["version"] if math.floor((k + 1) * f) > math.floor(k * f) else self._primary_version

    def _serving_replicas(self, version: Optional[int] = None, include_flipping: bool = False) -> List[_Replica]:
        """Replicas that take new work: breaker CLOSED, neither recycling nor
        retired, serving ``version`` when one is given; least loaded first,
        ties on the lowest index. A replica waiting to flip takes no fresh
        work; with ``include_flipping`` (accepted work) it comes last, since
        it still serves its version until it empties."""
        eligible = [r for r in self.replicas if r.breaker == BREAKER_CLOSED and not r.recycling and not r.retired
                    and (version is None or r.version == version)
                    and (include_flipping or r.version == r.target_version)]
        return sorted(eligible, key=lambda r: (r.version != r.target_version, r.engine.load, r.rid))

    def _active_replicas(self) -> List[_Replica]:
        """Every replica not retired (a recycling one included)."""
        return [r for r in self.replicas if not r.retired]

    def _remaining_deadline(self, routed: RoutedRequest, now: float) -> Optional[float]:
        """The deadline left for an engine hand-off: an engine counts its TTL
        from its own submit, so time spent parked or on a lost replica is
        taken off (a failover never extends a deadline)."""
        if routed.deadline_s is None:
            return None
        return max(routed.deadline_at - now, 0.0)

    def _engine_submit(self, r: _Replica, routed: RoutedRequest, now: float) -> ServedRequest:
        """Hand ``routed`` to ``r``'s engine: the original prompt, seed and
        class, with the tokens it emitted as the forced replay. Accepted work
        re-enters as a resume (a draining engine takes it); the session id
        and version ride the accept record."""
        emitted = routed._salvaged
        return r.engine.submit(routed.prompt_ids, config=routed.config, seed=routed.seed,
                               deadline_s=self._remaining_deadline(routed, now),
                               replay_ids=emitted if emitted else None, priority=routed.priority,
                               resume=routed._accepted, session_id=routed.session_id, version=routed.version)

    def _landed(self, routed: RoutedRequest, r: _Replica, handle: ServedRequest, load: int,
                migrating: bool = False) -> None:
        """Bookkeeping of a hand-off ``r`` accepted. The salvage is kept:
        ``output_ids`` reads the longer of it and the engine's stream."""
        routed._engine_handle = handle
        routed.replica = r.rid
        routed._accepted = True
        r.assigned[handle.request_id] = routed
        if migrating:
            # the destination's accept is durable and the origin's entry
            # still live: the one window with the session in two journals
            faults.fire_migrate_kill()
        # the continuation's accept is durable on r now: close the origin's
        # live entry, and the router journal's parking entry
        note = routed._move_note or ("failed", "replica_failover")
        routed._move_note = None
        self._journal_note_moved(routed, status=note[0], reason=note[1])
        self._router_journal_close(routed, "moved", "dispatched")
        self.metrics.record_dispatch(routed.request_id, r.rid, load=load)
        if self._obs_on:
            self._obs.async_instant("router.request", routed.request_id, "dispatch", replica=r.rid,
                                    failover_n=routed.failovers)

    def _dispatch(self, routed: RoutedRequest, requeue: bool = False, exclude_rid: Optional[int] = None) -> bool:
        """Place one request, fresh or a failover's continuation, on the least
        loaded healthy replica. True when it reached a terminal or assigned
        state, False when it was parked. ``requeue`` marks accepted work
        (continuations, parked retries): a fresh submit that finds every
        healthy queue at its bound is REJECTED ``queue_full``, accepted work
        is never killed by a full queue: the caller parks it."""
        emitted = routed._salvaged
        if emitted and len(emitted) >= routed.config.max_new_tokens:
            # a continuation with nothing left to decode is complete
            self._resolve(routed, RequestStatus.FINISHED, "length")
            return True
        now = time.perf_counter()
        saw_closed = False
        for r in self._serving_replicas(routed.version, include_flipping=requeue):
            if r.breaker != BREAKER_CLOSED:
                continue  # opened mid-scan by a dispatch failure
            if r.rid == exclude_rid:
                continue
            saw_closed = True
            load = r.engine.load  # submit() moves it
            try:
                handle = self._engine_submit(r, routed, now)
            except Exception as exc:  # noqa: BLE001 — a replica's fault, contained
                # a journal append dying in the replica's submit (ENOSPC,
                # EIO, a fail-stopped journal) is that replica's fault: the
                # engine closed the request's own books, the breaker takes a
                # strike, and the request tries the next healthy replica
                self._on_tick_failure(r, exc)
                continue
            if handle.status is RequestStatus.REJECTED:
                if handle.finish_reason == "queue_full":
                    continue  # backpressure here: try the next
                self._resolve(routed, RequestStatus.REJECTED, handle.finish_reason)
                return True
            self._landed(routed, r, handle, load)
            return True
        routed.replica = None
        if requeue:
            return False  # accepted work: the caller parks it, in order
        if saw_closed:
            # healthy replicas, every queue at its bound: their answer
            self._resolve(routed, RequestStatus.REJECTED, "queue_full")
            return True
        # no healthy replica: park (the bound still applies). A fresh submit
        # parked here never reached an engine journal, so the router's own
        # journal makes it durable
        if self.max_queue_depth is not None and len(self._pending) >= self.max_queue_depth:
            self._resolve(routed, RequestStatus.REJECTED, "queue_full")
            return True
        if self._router_journal is not None and not routed._accepted and not routed._router_journaled:
            try:
                self._router_journal.append_accept(
                    routed.request_id, routed.prompt_ids.tolist(), _journal_config_payload(routed.config),
                    [routed.seed], priority=routed.priority, deadline_s=routed.deadline_s,
                    session_id=routed.session_id, version=routed.version)
                routed._router_journaled = True
            except BaseException:
                # an accept that could not be made durable is REJECTED, and
                # the error propagates
                self._resolve(routed, RequestStatus.REJECTED, "journal_error")
                raise
        self._pending.append(routed)
        return False

    def _dispatch_pending(self) -> None:
        while self._pending and any(r.breaker == BREAKER_CLOSED and not r.recycling and not r.retired
                                    for r in self.replicas):
            routed = self._pending.popleft()
            if routed.done:  # expired while parked
                continue
            if not self._dispatch(routed, requeue=True):
                self._pending.appendleft(routed)  # back in its place
                break

    def _expire_pending(self, now: float) -> None:
        """Deadlines of parked requests (the engines enforce their own): an
        expiry while every replica is down still ends TIMED_OUT."""
        if not self._pending:
            return
        kept: Deque[RoutedRequest] = deque()
        for routed in self._pending:
            if routed.deadline_at is not None and now >= routed.deadline_at:
                self._resolve(routed, RequestStatus.TIMED_OUT, "deadline")
            else:
                kept.append(routed)
        self._pending = kept

    def _journal_note_moved(self, routed: RoutedRequest, status: str = "failed",
                            reason: str = "replica_failover") -> None:
        """Close a failed-over session's entry in its origin replica's
        journal, once the continuation is durable elsewhere or terminal.
        Until then the entry stays live: it is the continuation's only
        durable copy while parked. Best effort: a broken origin journal must
        not break dispatch (the worst case is one superseded copy that a
        later recovery shows)."""
        origin = routed._journal_origin
        if origin is None:
            return
        routed._journal_origin = None
        replica_idx, engine_rid = origin
        journal = self.replicas[replica_idx].engine.journal
        if journal is None or journal.failed or not journal.tracks(engine_rid):
            return
        try:
            journal.append_tick([], {}, [(engine_rid, status, reason)])
        except Exception:  # noqa: BLE001 — durability bookkeeping, not control flow
            pass

    def _router_journal_close(self, routed: RoutedRequest, status: str, reason: str) -> None:
        """Close a parked submit's live entry in the router's journal: on
        dispatch (the engine's accept takes over) or when it ends parked.
        Best effort, as ``_journal_note_moved``."""
        if not routed._router_journaled:
            return
        routed._router_journaled = False
        journal = self._router_journal
        if journal is None or journal.failed or not journal.tracks(routed.request_id):
            return
        try:
            journal.append_tick([], {}, [(routed.request_id, status, reason)])
        except Exception:  # noqa: BLE001 — durability bookkeeping, not control flow
            pass

    # ------------------------------------------- moving a session by plan
    def _find_live(self, request_id: int) -> Optional[RoutedRequest]:
        """The live handle of a router request id (on a replica or parked),
        or None for an unknown or terminal one."""
        for r in self.replicas:
            for routed in r.assigned.values():
                if routed.request_id == request_id and not routed.done:
                    return routed
        for routed in self._pending:
            if routed.request_id == request_id and not routed.done:
                return routed
        return None

    def _detach_session(self, r: _Replica, engine_rid: int, routed: RoutedRequest, reason: str = "migrated") -> None:
        """Lift one live session off a healthy replica: its slot and pages
        go back through the engine's eviction, its known tokens become the
        continuation's replay, and its origin journal entry stays live (the
        continuation's durable copy until it lands elsewhere, which closes
        the entry as ``("moved", reason)``): planned migration and the
        drains of a recycle, a retirement and a flip."""
        handle = routed._engine_handle
        r.assigned.pop(engine_rid, None)
        r.engine.evict_request(engine_rid, reason, status=RequestStatus.REJECTED, journal_terminal=False)
        # the evicted engine handle is bookkeeping, not an outcome
        r.engine.finished = [h for h in r.engine.finished if h is not handle]
        # the longest known prefix: a handle mid-replay holds the whole
        # stream in replay_ids while its output_ids trail
        streams = [routed._salvaged]
        if handle is not None:
            streams.append(list(handle.output_ids))
            if handle.replay_ids is not None:
                streams.append([int(t) for t in handle.replay_ids])
        routed._salvaged = max(streams, key=len)
        if r.engine.journal is not None and r.engine.journal.tracks(engine_rid):
            routed._journal_origin = (r.rid, engine_rid)
        routed._move_note = ("moved", reason)
        routed._engine_handle = None
        routed.replica = None

    def _hand_off_to(self, routed: RoutedRequest, r: _Replica) -> bool:
        """Land one detached or parked session on replica ``r`` (migration's
        targeting; ``_dispatch`` scans by load). True when it landed (or was
        complete); False leaves it as it was, durable through its origin
        entry, for the caller to re-home."""
        emitted = routed._salvaged
        if emitted and len(emitted) >= routed.config.max_new_tokens:
            self._resolve(routed, RequestStatus.FINISHED, "length")
            return True
        load = r.engine.load
        try:
            handle = self._engine_submit(r, routed, time.perf_counter())
        except Exception as exc:  # noqa: BLE001 — a replica's fault, contained
            self._on_tick_failure(r, exc)
            return False
        if handle.status is RequestStatus.REJECTED:
            return False
        self._landed(routed, r, handle, load, migrating=True)
        return True

    def migrate(self, request_id: int, dst: int) -> bool:
        """Planned migration: lift the session off its replica through the
        live engine's eviction and land it on replica ``dst`` as a forced
        replay, with the tokens of a run that never moved, no failover
        spent and no new capture. The journals close and open exactly once
        (the origin's entry closes once the destination's accept is
        durable). An unknown or terminal request, a bad or non-serving
        destination and one that serves another version than the session's
        pin raise ``ValueError``. True once the session runs on ``dst`` (or
        already did); False when ``dst`` refused it for capacity, and the
        session went to another replica of its version or parked at the
        front, durable."""
        if not 0 <= dst < len(self.replicas):
            raise ValueError(f"unknown replica index {dst}")
        routed = self._find_live(request_id)
        if routed is None:
            raise ValueError(f"unknown or terminal request {request_id}")
        r_dst = self.replicas[dst]
        if r_dst.retired or r_dst.recycling or r_dst.breaker != BREAKER_CLOSED:
            raise ValueError(f"replica {dst} is not serving (breaker {r_dst.breaker}, recycling={r_dst.recycling}, "
                             f"retired={r_dst.retired})")
        if r_dst.version != routed.version or r_dst.version != r_dst.target_version:
            raise ValueError(f"migration respects the version pin: request {request_id} is pinned to "
                             f"v{routed.version}, replica {dst} serves v{r_dst.version} (target "
                             f"v{r_dst.target_version})")
        if routed.replica == dst:
            return True
        src = routed.replica
        handle = routed._engine_handle
        if src is not None and handle is not None:
            if handle.done:
                return False  # terminal at the engine: the harvest resolves it
            self._detach_session(self.replicas[src], handle.request_id, routed)
        elif routed in self._pending:
            self._pending.remove(routed)  # a parked session just lands
        routed._move_note = ("moved", "migrated")
        if self._hand_off_to(routed, r_dst):
            if routed.replica == dst:  # not resolved complete on the way
                self.metrics.record_migration(routed.request_id, src if src is not None else -1, dst,
                                              emitted_tokens=len(routed._salvaged))
                if self._obs_on:
                    self._obs.counter_inc("router.migrations")
                    self._obs.async_instant("router.request", routed.request_id, "migrate", src=src, dst=dst)
            return True
        # refused: accepted work goes to any replica of its version, else
        # parks at the front (it is older than anything parked behind it)
        routed._move_note = None
        if routed.done:
            return False
        if not self._dispatch(routed, requeue=True):
            self._pending.appendleft(routed)
        return False

    def _drain_replica(self, r: _Replica, reason: str = "recycle") -> int:
        """Move every live session off replica ``r`` (a recycle, a
        retirement or a flip): each is detached through the live engine and
        goes to a sibling of its version, or parks at the front in admission
        order, durable through its origin entry (a recycle's rebuild adopts
        it again from the journal). Returns the sessions moved or parked."""
        moved = 0
        parked: List[RoutedRequest] = []
        for engine_rid, routed in sorted(r.assigned.items()):
            handle = routed._engine_handle
            if handle is not None and handle.done:
                r.assigned.pop(engine_rid, None)  # terminal, unharvested: the outcome stands
                self._resolve(routed, handle.status, handle.finish_reason)
                continue
            self._detach_session(r, engine_rid, routed, reason=reason)
            if not self._dispatch(routed, requeue=True, exclude_rid=r.rid):
                parked.append(routed)
            moved += 1
        self._pending.extendleft(reversed(parked))
        return moved

    # ------------------------------------------------------ rolling restart
    @property
    def restart_in_progress(self) -> bool:
        return bool(self._restart_queue) or self._recycle_rid is not None

    def begin_rolling_restart(self) -> bool:
        """Start a rolling restart: every replica in service is recycled in
        index order, one at a time, its sessions moved to siblings or parked
        and its engine rebuilt through its journal, and it serves again
        before the next one starts; ``step()`` advances it. False while
        draining; True when a restart is (or already was) under way."""
        if self._draining:
            return False
        if not self.restart_in_progress:
            self._restart_queue = [r.rid for r in self.replicas if not r.retired]
            if self._obs_on:
                self._obs.counter_inc("router.rolling_restarts")
        return True

    def rolling_restart(self, max_steps: Optional[int] = None) -> bool:
        """Begin a rolling restart and step the fleet until every replica
        is recycled; requests submitted meanwhile are served throughout.
        False when refused (draining)."""
        if not self.begin_rolling_restart():
            return False
        steps = 0
        while self.restart_in_progress:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"rolling restart incomplete after {max_steps} steps")
        return True

    def _start_recycle(self, r: _Replica, mode: str) -> None:
        """Take replica ``r`` out of service to rebuild it ("restart") or
        retire it ("retire"): it reads as OPEN everywhere from now on (a
        planned recycle is no failure: no strike, no rung on the ladder),
        and its sessions drain out. The rebuild or close comes next tick
        (``_finish_recycle``)."""
        r.recycling = True
        self._recycle_rid = r.rid
        self._recycle_mode = mode
        self._recycle_moved = self._drain_replica(r, reason=mode)

    def _finish_recycle(self, r: _Replica) -> None:
        """Complete the recycle begun last tick: close the engine (its
        journal flushed), then retire the replica, or rebuild it through its
        journal at the version it served (a session it adopts again decoded
        under that version), adopt what the journal still holds live, and
        give it a fresh health record. In process mode the rebuild is a
        fresh worker."""
        mode, self._recycle_mode = self._recycle_mode, None
        self._recycle_rid = None
        r.engine.discard_pending_harvest()
        r.engine.close()
        if mode == "retire":
            r.retired = True
            r.recycling = False
            r.orphaned.clear()
            return
        fresh, info = self._build_fresh(r.rid, r.version)
        self._swap_engine(r, fresh)
        leftovers = info["sessions"] if info else 0
        if info:
            self._adopt_recovered(r, info)
        r.recycling = False
        r.orphaned.clear()
        self._reset_health(r)
        self.metrics.record_recycle(r.rid, sessions_moved=self._recycle_moved, leftover_sessions=leftovers,
                                    tick=self._tick)
        if self._obs_on:
            self._obs.counter_inc("router.recycles")
            self._obs.instant("router.recycle", replica=r.rid, sessions_moved=self._recycle_moved,
                              leftovers=leftovers)

    def _reset_health(self, r: _Replica) -> None:
        """A fresh engine's clean slate: breaker CLOSED (set here without a
        transition: a planned rebuild is not a recovery), strikes and the
        ladder reset, the capture baseline at the fresh engine's count."""
        r.breaker = BREAKER_CLOSED
        r.consecutive_failures = r.consecutive_slow = r.nan_failures = 0
        r.open_count = r.cooldown_ticks = 0
        r._programs_seen = r.engine.total_compilations
        r.last_tick = self._tick
        r.last_error = None

    def _swap_engine(self, r: _Replica, fresh) -> None:
        """Put ``fresh`` in place of ``r``'s engine and close the old one
        (idempotent); in process mode keep the old client's last transport
        counters, so that the fleet's stay lifetime totals."""
        old, r.engine = r.engine, fresh
        old.close()
        if self._replica_mode == "process":
            self.retired_transport.append(old.transport_stats())

    # -------------------------------------------------------------- versions
    def _register_version(self, version: int, params) -> None:
        """Hold ``params`` (by name, as ``state_dict()`` gives them) as
        ``version``, copied to the CPU, once its layout matches the model's:
        a set of other names, shapes or dtypes is refused here, through the
        engine's ``tree_layout_mismatch`` gate, rather than at a flip."""
        probe = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in params.items()}
        if tree_layout_mismatch(self._layout, probe):
            raise ValueError("a parameter version needs the names, shapes and dtypes of the model's state_dict "
                             "(the engines serve its tensors in place)")
        record = self._versions.setdefault(version, _Version(None))
        record.state_dict = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
        self._next_version = max(self._next_version, version + 1)

    def _serve_version(self, r: _Replica, version: int, through_journal: bool = True) -> None:
        """Make replica ``r``, which holds no session, serve ``version``. A
        worker takes the parameters in place (``set_params``: no new
        capture). An in-process engine serves a model its siblings may
        share, so the replica gets a fresh engine on the version's model
        (one capture), rebuilt through its journal when
        ``through_journal``."""
        if self._replica_mode == "process":
            r.engine.set_params(self._version_params(version))
            r.version = version
            return
        info = None
        if through_journal:
            r.engine.close()
            fresh, info = self._build_fresh(r.rid, version)
        else:
            fresh = self._make_engine(r.rid, journal_path=None, version=version)
        self._swap_engine(r, fresh)
        r._programs_seen = fresh.total_compilations
        r.version = version
        if info:
            self._adopt_recovered(r, info)

    def deploy(self, state_dict, fraction: float = 1.0) -> Optional[int]:
        """Register a parameter version and roll it out: a deterministic
        ``fraction`` of new admissions pins it (``_pick_version``) and the
        last ``ceil(fraction x replicas)`` replicas in service are targeted
        to flip to it, each once empty (its sessions move to replicas of
        their version or finish in place). ``state_dict``: the parameters by
        name, of the model's layout (checked now). Returns the version
        (None while draining). A session keeps its pin for life."""
        if self._draining:
            return None
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError(f"fraction must lie in [0, 1], got {fraction}")
        version = self._next_version
        self._register_version(version, state_dict)
        base = self._primary_version
        self._rollout = {"version": version, "fraction": float(fraction), "count": 0, "base": base}
        active = self._active_replicas()
        k = math.ceil(float(fraction) * len(active)) if fraction > 0 else 0
        targets = [r.rid for r in active[len(active) - k:]] if k else []
        for r in active:
            r.target_version = version if r.rid in targets else base
        self.metrics.record_deploy(version, float(fraction), targets)
        self.metrics.set_fleet_gauges(len(active), self.restart_in_progress, self._primary_version)
        if self._obs_on:
            self._obs.counter_inc("router.deploys")
            self._obs.instant("router.deploy", version=version, fraction=float(fraction))
        return version

    def rollback(self) -> bool:
        """Roll the rollout back: new admissions pin the version before it
        at once, and the replicas flip back as they empty; sessions pinned
        to the rollout's version finish on it. False with no rollout (a
        full rollout that was promoted has none)."""
        if self._rollout is None:
            return False
        version, base = self._rollout["version"], self._rollout["base"]
        self._rollout = None
        self._primary_version = base
        for r in self.replicas:
            if not r.retired:
                r.target_version = base
        self._prune_versions()
        self.metrics.record_rollback(version, base)
        if self._obs_on:
            self._obs.counter_inc("router.rollbacks")
            self._obs.instant("router.rollback", from_version=version, to_version=base)
        return True

    def _prune_versions(self) -> None:
        """Drop the versions nothing refers to (not the primary, nor the
        rollout's, nor a replica's current or target version, nor a live
        session's pin), with their in-process models."""
        keep = {self._primary_version}
        if self._rollout is not None:
            keep |= {self._rollout["version"], self._rollout["base"]}
        for r in self.replicas:
            keep |= {r.version, r.target_version}
            keep.update(routed.version for routed in r.assigned.values())
        keep.update(p.version for p in self._pending)
        for v in [v for v in self._versions if v not in keep]:
            del self._versions[v]

    def _advance_rollout_flips(self) -> None:
        """Flip each replica whose target differs and that can: an empty one
        now; one with sessions drains them to replicas of its version when
        there are any, else they finish in place and the flip waits. The
        last replica of a version that parked work is pinned to waits too.
        Then a full rollout whose version every replica serves, with no
        parked work of another version, becomes the primary."""
        for r in self.replicas:
            if r.retired or r.recycling or r.version == r.target_version:
                continue
            if r.assigned:
                if self._serving_replicas(version=r.version):
                    self._drain_replica(r, reason="version_flip")
                continue  # checked again next tick
            if r.engine.scheduler.has_work:
                continue  # resumed work queued at the engine
            others = any(o is not r and not o.retired and not o.recycling and o.version == r.version
                         for o in self.replicas)
            if not others and any(p.version == r.version for p in self._pending):
                continue
            if self._replica_mode == "process" and (r.breaker != BREAKER_CLOSED or not r.engine.alive):
                # a worker out of service or dead flips once it is back (the
                # respawn or the half-open swap builds it at r.version)
                continue
            try:
                self._serve_version(r, r.target_version)
            except TransportError as exc:
                # a worker that died or hung since its last tick: a strike
                # (a journaled fleet respawns a dead one), and the flip waits
                self._on_tick_failure(r, exc)
                continue
            if self._obs_on:
                self._obs.instant("router.version_flip", replica=r.rid, version=r.version)
            # the version it left may have no user now: free its model
            self._prune_versions()
        if self._rollout is not None and self._rollout["fraction"] >= 1.0:
            v = self._rollout["version"]
            active = self._active_replicas()
            if (active and all(r.version == v and r.target_version == v for r in active)
                    and not any(p.version != v for p in self._pending)):
                self._primary_version = v
                self._rollout = None
                self._prune_versions()
                self.metrics.set_fleet_gauges(len(active), self.restart_in_progress, v)
                if self._obs_on:
                    self._obs.instant("router.version_promoted", version=v)

    # ------------------------------------------------------------- autoscale
    def _fleet_load(self) -> int:
        """The autoscaler's signal: parked requests plus each serving
        replica's queue beyond its slots."""
        return len(self._pending) + sum(max(r.engine.load, 0) for r in self.replicas
                                        if not r.retired and not r.recycling and r.breaker != BREAKER_OPEN)

    def _autoscale_eval(self) -> None:
        a = self._autoscale
        if self._tick % a["every_ticks"] != 0:
            return
        load = self._fleet_load()
        active = len(self._active_replicas())
        over, under = load >= a["scale_up_load"], load <= a["scale_down_load"]
        self._scale_up_streak = self._scale_up_streak + 1 if over else 0
        self._scale_down_streak = self._scale_down_streak + 1 if under and not over else 0
        if self._scale_up_streak >= a["patience"] and active < a["max_replicas"]:
            self._scale_up_streak = 0
            self._scale_up(load)
        elif (self._scale_down_streak >= a["patience"] and active > a["min_replicas"]
              and self._recycle_rid is None and not self._restart_queue):
            self._scale_down_streak = 0
            self._scale_down(load)

    def _scale_up_version(self) -> int:
        """The version a new replica serves: the primary, unless a rollout
        would have fewer than ``ceil(fraction x replicas)`` replicas
        targeting its version after the scale-up (its pinned admissions
        would park)."""
        if self._rollout is None:
            return self._primary_version
        v = self._rollout["version"]
        want = math.ceil(self._rollout["fraction"] * (len(self._active_replicas()) + 1))
        targeting = sum(1 for r in self.replicas if not r.retired and r.target_version == v)
        return v if targeting < want else self._primary_version

    def _scale_up(self, load: int) -> None:
        """Add a replica: revive the lowest retired one (through its journal
        when it has one), else append one at the next index, serving
        ``_scale_up_version()``."""
        version = self._scale_up_version()
        retired = [r for r in self.replicas if r.retired]
        if retired:
            r = min(retired, key=lambda x: x.rid)
            fresh, info = self._build_fresh(r.rid, version)
            self._swap_engine(r, fresh)
            r.retired = r.recycling = False
        else:
            fresh, info = self._build_fresh(len(self.replicas), version)
            r = _Replica(rid=len(self.replicas), engine=fresh)
            self.replicas.append(r)
        r.version = r.target_version = version
        self._reset_health(r)
        if info:
            self._adopt_recovered(r, info)
        self.metrics.record_autoscale("up", r.rid, active=len(self._active_replicas()), load=load, tick=self._tick)
        if self._obs_on:
            self._obs.counter_inc("router.scale_ups")

    def _scale_down(self, load: int) -> None:
        """Retire the highest replica whose retirement strands nothing (its
        version lives on a sibling while a session pins it, and a rollout
        keeps one replica targeting its version), through the recycle's
        drain; it closes next tick."""
        for r in sorted((r for r in self.replicas if not r.retired and not r.recycling), key=lambda x: -x.rid):
            others = any(o is not r and not o.retired and o.version == r.version for o in self.replicas)
            pinned = bool(r.assigned) or any(p.version == r.version for p in self._pending)
            if pinned and not others:
                continue
            if self._rollout is not None:
                v = self._rollout["version"]
                if r.target_version == v and not any(o is not r and not o.retired and o.target_version == v
                                                     for o in self.replicas):
                    continue
            self.metrics.record_autoscale("down", r.rid, active=len(self._active_replicas()) - 1, load=load,
                                          tick=self._tick)
            if self._obs_on:
                self._obs.counter_inc("router.scale_downs")
            self._start_recycle(r, mode="retire")
            return

    def _advance_fleet_ops(self) -> None:
        """One tick of the fleet operations, early in ``step()``: finish the
        recycle begun last tick; then, unless draining, flip what can flip,
        start the next restart's recycle (after the last one's parked work
        had a tick to land) and evaluate the autoscaler."""
        if self._recycle_rid is not None:
            self._finish_recycle(self.replicas[self._recycle_rid])
        if self._draining:
            # parked work may need the recycled replica back; nothing new starts
            self._restart_queue = []
            return
        self._advance_rollout_flips()
        if self._recycle_rid is None and self._restart_queue:
            r = self.replicas[self._restart_queue.pop(0)]
            if not r.retired:
                self._start_recycle(r, mode="restart")
        if self._autoscale is not None:
            self._autoscale_eval()

    # ---------------------------------------------------------------- breaker
    def _transition(self, r: _Replica, new: str) -> None:
        old, r.breaker = r.breaker, new
        self.metrics.record_breaker(r.rid, old, new, self._tick)
        if self._obs_on:
            self._obs.counter_inc(f"router.breaker.{old}->{new}")
            self._obs.instant("router.breaker", replica=r.rid, transition=f"{old}->{new}")

    def _open_breaker(self, r: _Replica, cause: str) -> None:
        """Take a replica out of service with the next cooldown on the
        ladder, then fail its live requests over."""
        if r.breaker == BREAKER_OPEN:
            return  # two triggers in one tick open it once
        r.open_count += 1
        r.cooldown_ticks = max(int(self._breaker_policy.delay(r.open_count, self._breaker_rng)), 1)
        r.opened_at_tick = self._tick
        r.consecutive_failures = 0
        r.consecutive_slow = 0
        r.last_error = cause
        self._transition(r, BREAKER_OPEN)
        self._failover_replica(r)

    def _promote_breakers(self) -> None:
        for r in self.replicas:
            if r.recycling or r.retired:
                continue  # out of service by plan, not by the breaker
            if r.breaker == BREAKER_OPEN and self._tick - r.opened_at_tick >= r.cooldown_ticks:
                self._transition(r, BREAKER_HALF_OPEN)
                if self._replica_mode == "process" and not r.engine.alive:
                    # a worker the transport put down (wedged) or that died
                    # or exited after a CUDA error: the probe needs a live
                    # process. A journaled respawn closes the breaker
                    # itself; without a journal a fresh, empty worker takes
                    # the probe. A worker that does not come up leaves the
                    # dead client in place, whose probe tick fails and opens
                    # the breaker again
                    if self._replica_journal(r.rid) is not None:
                        self._respawn_worker(r)
                        continue
                    if not self._swap_in_empty_worker(r):
                        continue
                # a half-tick the loss left unharvested never lands: its
                # requests go back to the engine's queue (discard), where the
                # reclaim below finds them
                r.engine.discard_pending_harvest()
                # reclaim the queued orphans before the probe tick (host
                # bookkeeping only), so the probe spends no prefill on
                # requests running elsewhere; running orphans wait for the
                # probe's success (_recover_replica)
                for engine_req_id in sorted(r.orphaned):
                    routed = r.orphaned[engine_req_id]
                    # a parked continuation's origin entry is its only
                    # durable copy: journal no terminal for it
                    anchored = routed._journal_origin == (r.rid, engine_req_id)
                    if r.engine.evict_request(engine_req_id, "replica_failover", status=RequestStatus.FAILED,
                                              queued_only=True, journal_terminal=not anchored):
                        r.orphaned.pop(engine_req_id)

    def _on_tick_failure(self, r: _Replica, exc: BaseException) -> None:
        if self._replica_mode == "process" and isinstance(exc, WorkerDiedError) and self._respawn_worker(r):
            return  # the supervisor healed it: no strike
        r.consecutive_failures += 1
        r.last_error = f"{type(exc).__name__}: {exc}"
        if r.breaker == BREAKER_HALF_OPEN or r.consecutive_failures >= self.failure_threshold:
            # a failed probe opens it again at once, with a longer cooldown
            self._open_breaker(r, r.last_error)

    def _on_tick_success(self, r: _Replica, duration_s: float) -> None:
        r.last_tick = self._tick  # the heartbeat
        slow = self.slow_tick_threshold_s is not None and duration_s > self.slow_tick_threshold_s
        if slow:
            # a tick that captured a graph is slow, not wedged
            programs = r.engine.total_compilations
            if programs != r._programs_seen:
                r._programs_seen = programs
                slow = False
        if slow:
            r.consecutive_slow += 1
            if r.breaker == BREAKER_HALF_OPEN:
                self._open_breaker(r, f"slow probe tick ({duration_s:.3f}s)")
            elif r.consecutive_slow >= self.slow_ticks_to_open:
                self._open_breaker(r, f"{r.consecutive_slow} consecutive slow ticks")
            return
        r.consecutive_failures = 0
        r.consecutive_slow = 0
        if r.breaker == BREAKER_HALF_OPEN:
            self._recover_replica(r)

    def _recover_replica(self, r: _Replica) -> None:
        """The HALF_OPEN probe tick succeeded: evict the orphans still
        holding slots through the engine (their requests moved on), drop
        their handles and close the breaker; the cooldown ladder resets."""
        r.engine.discard_pending_harvest()
        for engine_req_id, routed in sorted(r.orphaned.items()):
            anchored = routed._journal_origin == (r.rid, engine_req_id)
            r.engine.evict_request(engine_req_id, "replica_failover", status=RequestStatus.FAILED,
                                   journal_terminal=not anchored)
        r.orphaned.clear()
        r.engine.finished = [h for h in r.engine.finished if h.request_id in r.assigned]
        r.open_count = 0
        r.nan_failures = 0
        self._transition(r, BREAKER_CLOSED)

    # ------------------------------------------------------------- supervisor
    def _replica_journal(self, rid: int) -> Optional[str]:
        """Replica ``rid``'s journal directory, where the fleet journals and
        it exists, else None."""
        journal_dir = self._journal_template.format(i=rid) if self._journal_template else None
        return journal_dir if journal_dir is not None and os.path.isdir(journal_dir) else None

    def _build_fresh(self, rid: int, version: int):
        """A fresh engine for replica ``rid`` serving ``version``: when the
        fleet journals and the replica's directory exists, built THROUGH
        journal recovery (the swap starts a new generation holding its live
        sessions, which the caller adopts), else built with the journal
        attached. Returns ``(engine, info or None)``."""
        journal_dir = self._journal_template.format(i=rid) if self._journal_template else None
        if self._replica_journal(rid) is not None:
            fresh = self._make_engine(rid, journal_path=None, version=version)
            try:
                info = fresh._recover_attach(journal_dir, fsync=self._journal_fsync,
                                             segment_max_records=self._journal_segment_max)
            except BaseException:
                fresh.close()
                raise
            return fresh, info
        return self._make_engine(rid, journal_path=journal_dir, version=version), None

    def _adopt_recovered(self, r: _Replica, info: Dict) -> None:
        """Wire a rebuilt replica's recovered sessions into the router's
        books. A session whose id matches a PARKED request is that request:
        the parked handle adopts the fresh engine handle (no duplicate, and
        its origin anchor clears, since the new generation holds it under
        the new engine id); a parked session pinned to another version than
        the replica serves stays parked, lifted off the engine and anchored
        to the new generation's entry. Any other enters the books as a fresh
        submit and dispatch, as ``recover()`` does, pinned to the replica's
        version (it decoded there)."""
        now = time.perf_counter()
        parked = {p.session_id: p for p in self._pending if p.session_id is not None and not p.done}
        for handle in info.pop("handles"):
            routed = parked.get(handle.session_id)
            if routed is not None and routed.version != r.version:
                r.engine.evict_request(handle.request_id, "version_mismatch", status=RequestStatus.REJECTED,
                                       journal_terminal=False)
                r.engine.finished = [h for h in r.engine.finished if h is not handle]
                routed._journal_origin = (r.rid, handle.request_id)
                continue
            if routed is not None:
                self._pending.remove(routed)
                routed._journal_origin = None
                routed._move_note = None
            else:
                routed = RoutedRequest(request_id=next(self._ids), prompt_ids=handle.prompt_ids, config=handle.config,
                                       seed=handle.seed, priority=handle.priority, submitted_at=now,
                                       deadline_s=handle.deadline_s, session_id=handle.session_id, version=r.version)
                if routed.deadline_s is not None:
                    self._deadlines_seen = True
                self.metrics.record_submit(routed.request_id, int(handle.prompt_ids.size), priority=routed.priority,
                                           version=routed.version)
                if self._obs_on:
                    self._obs.async_begin("router.request", routed.request_id,
                                          prompt_len=int(handle.prompt_ids.size))
            routed._engine_handle = handle
            routed._accepted = True
            # accepted work, which a later drain keeps: through the engine's
            # method, so that the flag reaches a worker process too (a write
            # to a mirror handle would not)
            r.engine.mark_resume(handle.request_id)
            routed.replica = r.rid
            r.assigned[handle.request_id] = routed
            self.metrics.record_dispatch(routed.request_id, r.rid, load=r.engine.load)

    def _respawn_worker(self, r: _Replica) -> bool:
        """Process mode: replace a replica whose worker PROCESS died (or was
        put down) by a fresh one, through the replica's own journal
        recovery, the path a whole-fleet ``recover`` takes: its sessions
        come back with the same tokens while the siblings keep ticking.
        True when the respawn healed the replica (no breaker strike: a dead
        process says nothing about the fresh one); False falls through to
        the breaker and failover. Without a journal there is nothing to
        respawn through: False at once, the dead client stays until the
        breaker opens (its sessions fail over from the mirrors) and at
        half-open a fresh, empty worker takes its place
        (``_swap_in_empty_worker``). The JAX router swaps that empty worker
        in here, inside the failed tick (ROADMAP C15).

        A recovered session is adopted when the router holds it parked (the
        sessions this respawn lifted off the replica, and continuations
        anchored to its journal); any other has moved on (continuing on a
        sibling, or ended there) and is closed with a terminal record, so it
        is served exactly once. The JAX router keeps those that have ended
        elsewhere; it respawns only at the dead worker's next RPC, before a
        sibling can end one. A replica out of service by plan is not
        respawned."""
        if r.recycling or r.retired or self._replica_journal(r.rid) is None:
            return False
        # park every live hand-off as a failover would, but spend no
        # failover budget: the respawn adopts the SAME sessions from the
        # replica's journal (matched by session id below)
        victims = sorted(r.assigned.items())
        r.assigned.clear()
        parked: List[RoutedRequest] = []
        for engine_req_id, routed in victims:
            handle = routed._engine_handle
            if handle is not None and handle.done:
                self._resolve(routed, handle.status, handle.finish_reason)
                continue
            salvaged = list(handle.output_ids) if handle is not None else []
            if len(salvaged) > len(routed._salvaged):
                routed._salvaged = salvaged
            routed._engine_handle = None
            routed.replica = None
            # the journal on disk holds the session live: its durable anchor
            # while the respawn is under way
            routed._journal_origin = (r.rid, engine_req_id)
            parked.append(routed)
        if parked:
            self._pending.extendleft(reversed(parked))
        r.engine.close()  # reaps the dead worker; never raises
        try:
            fresh, info = self._build_fresh(r.rid, r.version)
        except Exception as exc:  # noqa: BLE001 — the respawn failed: a strike instead
            r.last_error = f"respawn failed: {type(exc).__name__}: {exc}"
            return False
        self._swap_engine(r, fresh)
        recovered = info["sessions"] if info else 0
        if info:
            waiting = {p.session_id for p in self._pending if p.session_id is not None and not p.done}
            kept = []
            for handle in info["handles"]:
                if handle.session_id not in waiting:
                    r.engine.evict_request(handle.request_id, "superseded", status=RequestStatus.FAILED,
                                           journal_terminal=True)
                    r.engine.finished = [h for h in r.engine.finished if h is not handle]
                    continue
                kept.append(handle)
            info["handles"] = kept
            self._adopt_recovered(r, info)
        # a clean slate: a fresh process with a fresh health record (its
        # capture count starts again)
        r.orphaned.clear()
        if r.breaker != BREAKER_CLOSED:
            self._transition(r, BREAKER_CLOSED)
        self._reset_health(r)
        self.metrics.record_respawn(r.rid, sessions=recovered, tick=self._tick)
        if self._obs_on:
            self._obs.counter_inc("router.worker_respawns")
            self._obs.instant("router.respawn", replica=r.rid, sessions=recovered)
        return True

    def _swap_in_empty_worker(self, r: _Replica) -> bool:
        """Process mode without a journal, at half-open: a fresh, empty
        worker in place of ``r``'s dead one, to take the probe. The orphans
        died with the old process (their requests failed over from the
        mirrors). False when the worker does not come up."""
        try:
            fresh = self._make_engine(r.rid, journal_path=None, version=r.version)
        except Exception as exc:  # noqa: BLE001 — the probe tick then fails and opens the breaker again
            r.last_error = f"respawn failed: {type(exc).__name__}: {exc}"
            return False
        self._swap_engine(r, fresh)
        r.orphaned.clear()
        r._programs_seen = fresh.total_compilations
        return True

    # --------------------------------------------------------------- failover
    def _failover_replica(self, r: _Replica) -> None:
        """Re-dispatch every live request of a lost replica, in admission
        order. The lost engine is not touched: its stale slots are reclaimed
        if it recovers."""
        victims = sorted(r.assigned.items())
        r.assigned.clear()
        parked: List[RoutedRequest] = []
        for engine_req_id, routed in victims:
            handle = routed._engine_handle
            if handle is not None and handle.done:
                # terminal at the engine, not yet harvested: the outcome stands
                self._resolve(routed, handle.status, handle.finish_reason)
                continue
            r.orphaned[engine_req_id] = routed
            if r.engine.journal is not None and r.engine.journal.tracks(engine_req_id):
                # the lost replica's journal keeps the session live until the
                # continuation is durable elsewhere or ends
                routed._journal_origin = (r.rid, engine_req_id)
            # the longest prefix seen: a crash mid-replay leaves a handle
            # shorter than the salvage it was rebuilding
            salvaged = list(handle.output_ids) if handle is not None else []
            if len(salvaged) > len(routed._salvaged):
                routed._salvaged = salvaged
            routed._engine_handle = None
            routed.replica = None
            routed.failovers += 1
            self.metrics.record_failover(routed.request_id, r.rid, emitted_tokens=len(routed._salvaged),
                                         failover_n=routed.failovers)
            if self._obs_on:
                self._obs.counter_inc("router.failovers")
                self._obs.async_instant("router.request", routed.request_id, "failover", from_replica=r.rid,
                                        emitted=len(routed._salvaged))
            if routed.failovers > self.max_failovers:
                self._resolve(routed, RequestStatus.FAILED, "max_failovers")
                continue
            if not self._dispatch(routed, requeue=True):
                parked.append(routed)
        # continuations park at the front, in admission order
        self._pending.extendleft(reversed(parked))

    # ---------------------------------------------------------------- harvest
    def _harvest_finished(self, r: _Replica) -> None:
        nan_hits = 0
        for handle in r.engine.finished:
            routed = r.assigned.pop(handle.request_id, None)
            if handle.finish_reason == "nonfinite_logits":
                nan_hits += 1
            if routed is None:
                continue  # an orphan's bookkeeping: not ours
            self._resolve(routed, handle.status, handle.finish_reason)
        r.engine.finished.clear()
        if nan_hits:
            r.nan_failures += nan_hits
            if (self.nan_failures_to_open is not None and r.breaker == BREAKER_CLOSED
                    and r.nan_failures >= self.nan_failures_to_open):
                # a replica that keeps producing non-finite logits is sick:
                # stop feeding it (the count stays on its snapshot while open)
                self._open_breaker(r, f"{r.nan_failures} NaN containments")

    def _resolve(self, routed: RoutedRequest, status: RequestStatus, reason: Optional[str]) -> None:
        """The one terminal path: refusals, rejections, harvested outcomes,
        failover exhaustion and drain all land here. A parked continuation
        ending here closes its origin journal entry with the real outcome."""
        routed._move_note = None
        self._journal_note_moved(routed, status=status.value, reason=reason or "resolved")
        self._router_journal_close(routed, status.value, reason or "resolved")
        routed._terminal_status = status
        routed.finish_reason = reason
        routed.finished_at = time.perf_counter()
        self.finished.append(routed)
        self.metrics.record_finish(routed.request_id, status.value, reason, new_tokens=len(routed.output_ids),
                                   failovers=routed.failovers, version=routed.version)
        if self._obs_on:
            if status is RequestStatus.REJECTED:
                self._obs.counter_inc("router.rejected")
            self._obs.async_end("router.request", routed.request_id, status=status.value, reason=reason,
                                new_tokens=len(routed.output_ids), failovers=routed.failovers)

    # ------------------------------------------------------------------- tick
    @property
    def has_work(self) -> bool:
        """True while a non-terminal request can still progress: parked,
        handed off, or engine work on a replica the router ticks (an OPEN
        replica's stale slots do not count: their requests moved on), or
        while a rolling restart is under way (it ends in bounded ticks)."""
        return (bool(self._pending) or self.restart_in_progress or any(r.assigned for r in self.replicas)
                or any(r.breaker != BREAKER_OPEN and not r.recycling and not r.retired and r.engine.scheduler.has_work
                       for r in self.replicas))

    def step(self) -> bool:
        """One router tick: promote breakers, advance the fleet operations
        (finish last tick's recycle, flip, start the next recycle, the
        autoscaler: before placing parked work, so that work a drain parked
        lands this tick), place parked work, then tick every replica that
        serves or probes in two halves, DISPATCH all (each replica's decode
        goes on the device) and then HARVEST all (each one's sync and
        evictions). A replica recycling or retired is not ticked. Returns
        True while work remains."""
        if self._preempt_requested and not self._draining:
            self.preempted = True
            self._begin_drain()
        self._tick += 1
        with self._obs.span("router.tick"):
            self._tick_replicas()
        has_work = self.has_work
        self._maybe_flush_preempted(has_work)
        return has_work

    def _take_spare(self):
        """The spare worker (process, socket), a new spare started in its
        place; a worker started now if the spare died waiting."""
        proc, sock = self._spare
        self._spare = spawn_worker(self.model.device)
        if proc.poll() is None:
            return proc, sock
        sock.close()
        return spawn_worker(self.model.device)

    def _end_spare(self) -> None:
        """Close the spare's socket (its worker reads EOF and exits) and reap it."""
        if self._spare is None:
            return
        proc, sock = self._spare
        self._spare = None
        sock.close()
        try:
            proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 — then it is killed
            proc.kill()
            proc.wait()

    def _tick_replicas(self) -> None:
        """``step()``'s work inside the ``router.tick`` span."""
        if self._deadlines_seen:
            self._expire_pending(time.perf_counter())
        self._promote_breakers()
        self._advance_fleet_ops()
        self._dispatch_pending()
        # CLOSED replicas serve; HALF_OPEN ones always get their probe tick
        ticking = [r for r in self.replicas if r.breaker != BREAKER_OPEN and not r.recycling and not r.retired]
        dispatched: List[_Replica] = []
        for r in ticking:
            try:
                t0 = time.perf_counter()
                faults.fire_replica_tick(r.rid)
                r.engine.step_dispatch()
                r._own_tick_s = time.perf_counter() - t0
                dispatched.append(r)
            except Exception as e:  # noqa: BLE001 — a replica's loss is the failure domain
                self._on_tick_failure(r, e)
        for r in dispatched:
            try:
                t0 = time.perf_counter()
                faults.fire_replica_harvest(r.rid)
                r.engine.step_harvest()
                r._own_tick_s += time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001
                self._on_tick_failure(r, e)
                if r.breaker != BREAKER_OPEN:
                    # below the failure threshold the replica serves on: its
                    # unharvested half-tick goes back to its queue
                    r.engine.discard_pending_harvest()
                continue
            self._harvest_finished(r)
            self._on_tick_success(r, r._own_tick_s)
        if self._obs_on:
            self._obs.gauge_set("router.pending", len(self._pending))
            self._obs.gauge_set("router.replicas_closed", sum(1 for r in self.replicas if r.breaker == BREAKER_CLOSED))

    def run_until_drained(self, max_steps: Optional[int] = None) -> List[RoutedRequest]:
        """Step until every submitted request is terminal; returns (and
        clears) the requests finished since the last call."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"router not drained after {max_steps} steps")
        drained, self.finished = self.finished, []
        return drained

    def _begin_drain(self) -> None:
        """Close admission fleet-wide: reject the parked fresh submits and
        every serving replica's queued backlog; running slots keep decoding.
        Parked continuations are accepted work: they stay parked and finish
        (landing on draining engines as resumes). A rolling restart stops:
        its queued recycles never start; the one under way completes."""
        self._draining = True
        kept: Deque[RoutedRequest] = deque()
        while self._pending:
            routed = self._pending.popleft()
            if routed._accepted:
                kept.append(routed)
            else:
                self._resolve(routed, RequestStatus.REJECTED, "draining")
        self._pending = kept
        self._restart_queue = []
        for r in self.replicas:
            if r.breaker != BREAKER_OPEN and not r.recycling and not r.retired:
                r.engine._begin_drain()

    def drain(self, max_steps: Optional[int] = None) -> List[RoutedRequest]:
        """Graceful fleet shutdown: refuse new work, reject the backlogs,
        finish every running slot. Returns the drained terminal handles."""
        self._begin_drain()
        return self.run_until_drained(max_steps=max_steps)

    def _maybe_flush_preempted(self, has_work: bool) -> None:
        if self.preempted and not self._preempt_flushed and not has_work:
            self._preempt_flushed = True
            self.write_snapshot()
            self.close()

    # --------------------------------------------------------------- shedding
    def _estimate_completion_s(self, max_new_tokens: int) -> Optional[float]:
        """The best completion-time estimate over the healthy replicas:
        p95 queue wait + p95 prefill + ``max_new_tokens`` x p95 decode step.
        None while every healthy replica is cold: a cold fleet never sheds."""
        best = None
        for r in self.replicas:
            if r.breaker != BREAKER_CLOSED or r.recycling or r.retired:
                continue
            est = r.engine.metrics.latency_estimates()
            if est is None or est["decode_steps"] < self.shed_min_samples:
                continue
            total = est["queue_wait_p95_s"] + est["prefill_p95_s"] + max_new_tokens * est["decode_step_p95_s"]
            if best is None or total < best:
                best = total
        return best

    # ---------------------------------------------------------------- metrics
    def snapshot(self) -> Dict:
        """The router's serving-metrics/v12 snapshot with a section a replica."""
        return self.metrics.snapshot(self._replica_snapshots())

    def write_snapshot(self) -> Dict:
        return self.metrics.write_snapshot(self._replica_snapshots())

    def _transport_stats(self) -> Optional[Dict]:
        """The fleet's transport gauges for the snapshot's ``transport``
        block: RPCs, retries, timeouts, frames and bytes summed over the
        process replicas' clients (the replaced ones too), the workers
        alive, and p50/p95 RPC ms over each client's last 4096 RPCs. None
        in-process."""
        if self._replica_mode != "process":
            return None
        totals = {"rpcs": 0, "retries": 0, "timeouts": 0, "frames_sent": 0, "frames_recv": 0, "bytes_sent": 0,
                  "bytes_recv": 0}
        samples: List[float] = []
        for stats in self.retired_transport + [r.engine.transport_stats() for r in self.replicas]:
            for key in totals:
                totals[key] += stats[key]
            samples.extend(stats["rpc_ms"])
        totals["workers_alive"] = sum(r.engine.alive for r in self.replicas)
        totals["rpc_p50_ms"] = round(float(np.percentile(samples, 50)), 3) if samples else None
        totals["rpc_p95_ms"] = round(float(np.percentile(samples, 95)), 3) if samples else None
        return totals

    def _replica_snapshots(self) -> Dict[str, Dict]:
        self.metrics.set_fleet_gauges(sum(not r.retired and not r.recycling for r in self.replicas),
                                      self.restart_in_progress, self._primary_version)
        self.metrics.set_transport(self._transport_stats())
        out = {}
        for r in self.replicas:
            snap = r.engine.metrics.snapshot()
            snap["breaker"] = r.breaker
            snap["last_tick"] = r.last_tick
            snap["nan_failures"] = r.nan_failures
            if r.recycling:
                snap["recycling"] = True
            if r.retired:
                snap["retired"] = True
            if self._next_version > 1:
                # version markers once a second version exists
                snap["version"] = r.version
                snap["target_version"] = r.target_version
            if r.last_error:
                snap["last_error"] = r.last_error
            out[f"r{r.rid}"] = snap
        return out

    # -------------------------------------------------------------- telemetry
    @property
    def telemetry(self):
        """The shared recorder (the no-op recorder when off)."""
        return self._obs

    def telemetry_summary(self) -> Optional[Dict]:
        """The shared recorder's summary with the replicas' compile reports
        merged (watch names carry the replica's namespace, so none collide;
        a replaced engine's watchdog is closed and not counted). None when
        telemetry is off."""
        if not self._obs_on:
            return None
        out = self._obs.summary()
        per_fn: Dict = {}
        unexpected: List = []
        backend = 0
        for r in self.replicas:
            watchdog = getattr(r.engine, "watchdog", None)
            if r.retired or watchdog is None:
                continue
            s = watchdog.summary()
            per_fn.update(s["per_function"])
            unexpected.extend(s["unexpected"])
            backend = max(backend, s.get("backend_compiles", 0))
        out["compile"] = {"per_function": per_fn, "backend_compiles": backend, "unexpected": unexpected}
        return out

    def close(self) -> None:
        """Restore the signal handlers, close every replica (its journal and
        stream), the router's journal, its metrics stream and a recorder the
        router made from its knob (which writes its trace when it has a
        path). Idempotent."""
        restore_preemption_handler(self._preempt_handler, self._preempt_previous)
        self._preempt_handler = None
        for r in self.replicas:
            r.engine.close()
        self._end_spare()
        if self._router_journal is not None:
            try:
                self._router_journal.close()
            except Exception:  # noqa: BLE001 — close is best-effort teardown
                pass
        self.metrics.close()
        if self._owns_telemetry:
            self._obs.close()
