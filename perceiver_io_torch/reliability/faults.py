"""Deterministic fault injection: named points, armed on demand, inert by default.

Port of ``perceiver_io_tpu/reliability/faults.py``: ``FaultSpec``,
``FaultRegistry``, the process-wide ``FAULTS``, ``armed(...)``, environment
arming, ``KilledMidWrite``, ``ReplicaCrashed``, the training hooks (the
checkpoint writer's, the prefetcher's and the fit loop's) and the serving,
journal, replica and transport hooks. The points:

  ``checkpoint.write.flaky``  raise ``TransientIOError`` before a checkpoint
                        is serialised (absorbed by the writer's retry policy)
  ``checkpoint.write.kill``  leave a partial checkpoint directory, as a kill
                        mid-flush would, and raise ``KilledMidWrite``
  ``checkpoint.corrupt``  truncate the largest file of a just-written
                        checkpoint (a torn write, found at restore)
  ``loader.fetch.slow`` sleep ``value`` seconds in a batch fetch (on the
                        prefetch worker, or on the step thread without one)
  ``loader.fetch.flaky``  raise ``TransientIOError`` in a batch fetch
                        (absorbed by the fetch's retry policy)
  ``batch.nan``         make every floating tensor of a training batch NaN
                        (exercises ``skip_nonfinite_updates``)

  ``serving.nan``       poison one slot's next-step logits with NaN (``slot``
                        param, None = the first occupied slot; exercises
                        FAILED containment)
  ``serving.deadline``  sleep ``value`` seconds at a serving tick boundary
                        (forces deadline overruns)
  ``serving.journal.torn_write``  stop a request-journal append halfway and
                        raise (power loss mid-append; the torn tail is
                        truncated at recovery)
  ``serving.journal.corrupt_record``  write a journal record whose CRC
                        disagrees with its body (bit rot, caught by the
                        reader's checksum, which truncates the read there)
  ``serving.journal.compact.kill``  raise ``KilledMidWrite`` during a journal
                        compaction or recovery swap; ``slot`` picks the
                        stage (0 = before the atomic rename, 1 = after it,
                        before the old generation is deleted)
  ``router.migrate.kill``  raise ``KilledMidWrite`` inside a planned
                        migration, after the destination's accept is
                        durable and before the origin journal's close
                        record: the one window where a session is live in
                        two journals, which recovery dedupes to one
  ``replica.crash``     raise ``ReplicaCrashed`` at the top of a router
                        replica's tick (``slot`` selects the replica index,
                        None = every replica): a lost engine; exercises
                        failover
  ``replica.stall``     sleep ``value`` seconds at a replica's tick: a
                        wedged engine; exercises the slow-tick detector
  ``replica.slow_tick`` sleep ``value`` seconds at a replica's tick: a
                        degraded (not dead) engine
  ``replica.crash.harvest``  raise ``ReplicaCrashed`` in the harvest half of
                        a replica's tick, after its decode was dispatched
                        and before the tick's sync (``slot`` as above): the
                        half-tick whose tokens must never land. The port's
                        own point (ROADMAP C14); the JAX router fires its
                        replica points only before the dispatch
  ``transport.send.torn``  corrupt the CRC of one outgoing RPC frame to a
                        worker-process replica (``slot`` selects the
                        replica): the worker NACKs it and the client's retry
                        policy sends it again (``serving/transport.py``)
  ``transport.recv.timeout``  the client takes one RPC reply as timed out
                        without reading it (``slot`` as above): the retry
                        sends again and the worker's at-most-once cache
                        answers the repeat
  ``transport.worker.kill``  SIGKILL the worker process behind a replica
                        right before an RPC: a real process death, which the
                        router's supervisor answers with a respawn through
                        the replica's journal
  ``transport.worker.hang``  SIGSTOP the worker: alive but wedged; every RPC
                        times out until the retries are spent and the
                        breaker takes the strike
  ``transport.worker.device_fault``  counted by the client at its replica's
                        (``slot``) step_dispatch and made INSIDE the worker,
                        which that dispatch asks for it: an out-of-bounds
                        gather on its device, a real device-side assert on
                        the card, after which the worker exits (ROADMAP
                        C15). Armed in the client's process, like the other
                        transport points. The port's own point

Arming: ``FAULTS.arm(point, after=..., times=..., value=..., slot=...)`` in
process, or the environment variable
``PERCEIVER_IO_TORCH_FAULT="point:key=val,key=val;point2"``. Firing is decided
only by deterministic hit counters (``after`` qualifying hits skipped, then at
most ``times`` firings): no clocks, no randomness. With nothing armed every
hook is a dict lookup returning None, and no value anywhere changes.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

from perceiver_io_torch.reliability.retry import TransientIOError

FAULT_ENV = "PERCEIVER_IO_TORCH_FAULT"

POINTS = frozenset({"checkpoint.write.flaky", "checkpoint.write.kill", "checkpoint.corrupt", "loader.fetch.slow",
                    "loader.fetch.flaky", "batch.nan", "serving.nan", "serving.deadline", "serving.journal.torn_write",
                    "serving.journal.corrupt_record", "serving.journal.compact.kill", "router.migrate.kill",
                    "replica.crash", "replica.stall", "replica.slow_tick", "replica.crash.harvest",
                    "transport.send.torn", "transport.recv.timeout", "transport.worker.kill",
                    "transport.worker.hang", "transport.worker.device_fault"})


class KilledMidWrite(RuntimeError):
    """Injected kill in the middle of a durable write (a checkpoint's flush,
    a journal compaction's generation swap, a migration between its two
    journal writes)."""


class ReplicaCrashed(RuntimeError):
    """Injected loss of a serving-engine replica (``replica.crash``): the
    router sees what a dead engine would give it, an exception out of the
    replica's tick."""


@dataclass
class FaultSpec:
    """One armed point: fires on qualifying hits ``after < hit <= after + times``."""

    point: str
    after: int = 0  # skip the first `after` qualifying hits
    times: Optional[int] = 1  # fire at most this many times; None = every hit
    value: float = 0.0  # point-specific magnitude (sleep seconds)
    slot: Optional[int] = None  # serving.nan's slot (None = first occupied); a replica point's replica
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    @classmethod
    def parse(cls, point: str, spec: str) -> "FaultSpec":
        """``"after=3,times=2,value=0.5,slot=1"`` (all fields optional;
        ``times=inf`` = unlimited)."""
        kw: Dict[str, object] = {}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            key, _, val = item.partition("=")
            if key == "after":
                kw["after"] = int(val)
            elif key == "times":
                kw["times"] = None if val in ("inf", "") else int(val)
            elif key == "value":
                kw["value"] = float(val)
            elif key == "slot":
                kw["slot"] = int(val)
            else:
                raise ValueError(f"unknown fault spec key {key!r} in {point}:{spec}")
        return cls(point=point, **kw)


class FaultRegistry:
    """Thread-safe registry of armed fault points."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, FaultSpec] = {}
        self._env_loaded = False

    def arm(self, point: str, after: int = 0, times: Optional[int] = 1, value: float = 0.0,
            slot: Optional[int] = None) -> FaultSpec:
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} (known: {sorted(POINTS)})")
        spec = FaultSpec(point=point, after=after, times=times, value=value, slot=slot)
        with self._lock:
            self._armed[point] = spec
        return spec

    def disarm(self, point: Optional[str] = None) -> None:
        """Disarm one point, or everything (``None``) including env arming."""
        with self._lock:
            if point is None:
                self._armed.clear()
                self._env_loaded = True  # a full disarm also suppresses env re-arming
            else:
                self._armed.pop(point, None)

    def reset(self) -> None:
        """Forget all arming and re-read the environment on next use."""
        with self._lock:
            self._armed.clear()
            self._env_loaded = False

    def armed_points(self):
        with self._lock:
            return sorted(self._armed)

    def _load_env_locked(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        raw = os.environ.get(FAULT_ENV, "").strip()
        if not raw:
            return
        for entry in filter(None, (s.strip() for s in raw.split(";"))):
            point, _, spec = entry.partition(":")
            if point not in POINTS:
                raise ValueError(f"{FAULT_ENV} names unknown fault point {point!r} (known: {sorted(POINTS)})")
            self._armed[point] = FaultSpec.parse(point, spec)

    def fire(self, point: str, target: Optional[int] = None) -> Optional[FaultSpec]:
        """Count a hit at ``point``; return the spec iff this hit fires.
        ``target`` scopes multi-instance points: a spec armed with
        ``slot=k`` neither fires nor counts hits at other instances."""
        with self._lock:
            self._load_env_locked()
            spec = self._armed.get(point)
            if spec is None:
                return None
            if spec.slot is not None and target is not None and spec.slot != target:
                return None
            spec.hits += 1
            if spec.hits <= spec.after:
                return None
            if spec.times is not None and spec.fired >= spec.times:
                return None
            spec.fired += 1
            return spec


FAULTS = FaultRegistry()


@contextmanager
def armed(point: str, **kwargs):
    """Arm ``point`` for the duration of a with-block."""
    spec = FAULTS.arm(point, **kwargs)
    try:
        yield spec
    finally:
        FAULTS.disarm(point)


def _firing(spec: FaultSpec) -> str:
    return f"firing {spec.fired}{'' if spec.times is None else f'/{spec.times}'}"


def fire_loader_fetch() -> None:
    """Batch-fetch hook: ``loader.fetch.slow`` sleeps, ``loader.fetch.flaky``
    raises a transient error that the fetch's retry policy absorbs."""
    spec = FAULTS.fire("loader.fetch.slow")
    if spec is not None:
        time.sleep(spec.value or 0.05)
    spec = FAULTS.fire("loader.fetch.flaky")
    if spec is not None:
        raise TransientIOError(f"injected flaky loader fetch ({_firing(spec)})")


def poison_batch(batch):
    """Training-loop hook: when ``batch.nan`` fires, every floating tensor of
    the batch (a dict) becomes all-NaN; integer token tensors pass through.
    Returns the batch itself, uncopied, when the point is not armed."""
    spec = FAULTS.fire("batch.nan")
    if spec is None:
        return batch
    import torch

    return {k: torch.full_like(v, float("nan")) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
            for k, v in batch.items()}


def fire_checkpoint_write(path: str) -> None:
    """Checkpoint-save hook, before serialisation: ``checkpoint.write.flaky``
    raises a transient error for the writer's retry policy;
    ``checkpoint.write.kill`` leaves the partial directory a kill mid-flush
    would and raises ``KilledMidWrite``."""
    spec = FAULTS.fire("checkpoint.write.flaky")
    if spec is not None:
        raise TransientIOError(f"injected flaky checkpoint write ({_firing(spec)})")
    spec = FAULTS.fire("checkpoint.write.kill")
    if spec is not None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "_PARTIAL_WRITE"), "w") as f:
            f.write("injected kill mid-flush: this checkpoint is incomplete\n")
        raise KilledMidWrite(f"injected kill mid-checkpoint-flush at {path}")


def fire_checkpoint_corrupt(path: str) -> bool:
    """Post-save hook: when ``checkpoint.corrupt`` fires, tear the checkpoint
    just written (``corrupt_checkpoint_dir``), to be found at restore."""
    if FAULTS.fire("checkpoint.corrupt") is None:
        return False
    corrupt_checkpoint_dir(path)
    return True


def corrupt_checkpoint_dir(path: str) -> str:
    """Truncate the largest file under ``path`` to half its size (also called
    by tests directly). Returns that file's path."""
    largest, size = None, -1
    for root, _, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            s = os.path.getsize(p)
            if s > size:
                largest, size = p, s
    if largest is None:
        raise FileNotFoundError(f"no files to corrupt under {path}")
    with open(largest, "r+b") as f:
        f.truncate(max(size // 2, 0))
    return largest


def fire_serving_tick_delay() -> None:
    """Serving-engine tick hook: an injected stall that pushes the wall clock
    past request deadlines."""
    spec = FAULTS.fire("serving.deadline")
    if spec is not None:
        time.sleep(spec.value or 0.05)


def fire_serving_nan() -> Optional[FaultSpec]:
    """Serving-engine poison hook: the engine writes NaN into the spec's
    slot's logits."""
    return FAULTS.fire("serving.nan")


def fire_journal_compact_kill(stage: int) -> None:
    """Request-journal compaction hook (``serving/journal.py``). The armed
    spec's ``slot`` selects the kill point: 0 = after the new generation is
    written to its temporary file, before the atomic rename (the old
    generation stays the truth), 1 = after the rename, before the old
    generation's segments are deleted (readers must ignore them). Raises
    ``KilledMidWrite`` at the matching stage."""
    spec = FAULTS.fire("serving.journal.compact.kill", target=stage)
    if spec is not None:
        raise KilledMidWrite(f"injected kill mid-journal-compaction (stage {stage}, firing "
                             f"{spec.fired}{'' if spec.times is None else f'/{spec.times}'})")


def fire_migrate_kill() -> None:
    """Planned-migration hook (``ServingRouter.migrate``), after the
    destination journaled its accept and before the origin journal's close
    record: raises ``KilledMidWrite`` when armed."""
    spec = FAULTS.fire("router.migrate.kill")
    if spec is not None:
        raise KilledMidWrite(f"injected kill mid-migration (firing {spec.fired}"
                             f"{'' if spec.times is None else f'/{spec.times}'})")


def _crash(point: str, replica_id: int) -> None:
    spec = FAULTS.fire(point, target=replica_id)
    if spec is not None:
        raise ReplicaCrashed(f"injected crash of replica {replica_id} (firing {spec.fired}"
                             f"{'' if spec.times is None else f'/{spec.times}'})")


def fire_replica_tick(replica_id: int) -> None:
    """Router hook at the top of one replica's tick. The armed spec's
    ``slot`` selects the replica (None = every replica). ``replica.crash``
    raises; ``replica.stall`` and ``replica.slow_tick`` sleep ``value``
    seconds (the router's slow-tick detector decides, by its own threshold,
    whether the replica is wedged)."""
    _crash("replica.crash", replica_id)
    for point in ("replica.stall", "replica.slow_tick"):
        spec = FAULTS.fire(point, target=replica_id)
        if spec is not None:
            time.sleep(spec.value or 0.05)


def fire_replica_harvest(replica_id: int) -> None:
    """Router hook between a replica's dispatch and its harvest:
    ``replica.crash.harvest`` raises, leaving the dispatched decode
    unharvested."""
    _crash("replica.crash.harvest", replica_id)


def fire_transport_send_torn(replica_id: Optional[int] = None) -> bool:
    """Client-side framing hook: True when this outgoing frame's CRC is to
    be corrupted on the wire (the frame stays well formed, so the worker
    reads it whole, fails its checksum and NACKs)."""
    return FAULTS.fire("transport.send.torn", target=replica_id) is not None


def fire_transport_recv_timeout(replica_id: Optional[int] = None) -> bool:
    """Client-side receive hook: True when this reply is to be taken as
    timed out WITHOUT reading it (the worker may well have run the op and
    answered, as a real timeout leaves it). The retry sends the same seq;
    the worker's reply cache makes the repeat harmless."""
    return FAULTS.fire("transport.recv.timeout", target=replica_id) is not None


def fire_transport_worker_kill(replica_id: Optional[int] = None) -> Optional[FaultSpec]:
    """Client-side hook before an RPC: when it fires, the caller SIGKILLs
    its worker process (a real ``kill -9``). Returns the spec so that the
    caller sends the signal; the registry holds no pid."""
    return FAULTS.fire("transport.worker.kill", target=replica_id)


def fire_transport_worker_hang(replica_id: Optional[int] = None) -> Optional[FaultSpec]:
    """Client-side hook before an RPC: when it fires, the caller SIGSTOPs
    its worker process, alive but wedged. The RPC and its retries time out
    and the breaker takes the strike."""
    return FAULTS.fire("transport.worker.hang", target=replica_id)


def fire_transport_worker_device_fault(replica_id: Optional[int] = None) -> Optional[FaultSpec]:
    """Client-side hook at a replica's ``step_dispatch`` (the port's own
    point): when it fires, the dispatch asks its worker to gather out of
    bounds on its device."""
    return FAULTS.fire("transport.worker.device_fault", target=replica_id)
