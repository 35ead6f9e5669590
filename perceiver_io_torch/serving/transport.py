"""Fault-tolerant RPC transport for serving replicas in worker processes.

Port of ``perceiver_io_tpu/serving/transport.py``.
``ServingRouter(replica_mode="process")`` replaces each in-process
``ServingEngine`` by an ``EngineClient``: the engine runs in an OS process of
its own (``serving/worker.py``, started with ``subprocess``, never forked),
and every call the router makes (submit, step_dispatch, step_harvest, evict,
drain, set_params, journal bookkeeping) crosses a length-prefixed,
CRC-framed socketpair RPC. The process boundary is the point: a worker that
segfaults, runs out of memory, is ``kill -9``-ed or hits a sticky CUDA error
(which poisons every CUDA context of its process) takes one replica's
interpreter with it, and each worker has its own CUDA context, stream and
host thread.

Frame format (one frame per RPC message, both directions; the JAX package's
bytes)::

    MAGIC(4) | payload_len(4, big-endian) | crc32(payload)(4, big-endian) | payload

The payload is a pickled dict ``{"seq", "op", "payload"}`` (requests) or
``{"seq", "ok", "value"/"error", "state"}`` (replies). A CRC mismatch at the
worker gets a NACK (``seq=None``) and the worker runs NOTHING: the client
retries the frame from scratch.

Reliability contract:

  * Deterministic timeout, retry and backoff: every RPC runs under
    ``reliability/retry.py``'s ``retry_call`` with a jitter-0 ``RetryPolicy``,
    so the schedule is reproducible. Retryable failures: torn or NACKed
    frames, socket timeouts, transient socket errors.
  * At most once: requests carry a monotone ``seq``; the worker caches its
    last replies and answers a retried ``seq`` from the cache without
    running the op again, and the client discards stale buffered replies
    whose ``seq`` is not the RPC in flight.
  * Dead or wedged: when the retries are spent, a worker process that has
    EXITED surfaces ``WorkerDiedError`` (the router's supervisor respawns it
    through its journal); a worker still running but silent is SIGKILLed by
    the client and surfaces ``TransportError`` (a breaker strike), and so
    is one whose channel fell out of step (a reply cut off mid-frame).
  * Faults: four client-side points (``reliability/faults.py``):
    ``transport.send.torn`` corrupts one frame's CRC,
    ``transport.recv.timeout`` reads one reply as timed out without
    consuming it, ``transport.worker.kill`` SIGKILLs the worker,
    ``transport.worker.hang`` SIGSTOPs it, each scoped to a replica by
    ``slot``. The port's own ``transport.worker.device_fault`` is counted
    here too, at the replica's ``step_dispatch``, whose payload then asks
    the worker for a device-side assert (see ``serving/worker.py``).

Mirror handles: ``EngineClient.submit`` returns a real ``ServedRequest``
whose state (status, output_ids, admitted_at, ...) is refreshed from the
state bundle every reply carries, so the router's identity-based bookkeeping
works unchanged: the same mirror object stands wherever its worker-side twin
would.

The model crosses the boundary as the recipe to build it again (its config,
``dtype``, ``param_dtype``, device and CPU ``state_dict``), never as a
pickled module or a CUDA tensor, and the worker applies the client's
``torch`` numerics flags (default dtype, TF32 switches) before it builds the
engine. The worker runs on the model's device: the card unless the model
was built on the CPU; a worker that finds no card raises in ``init``.
Unlike the JAX package there is no kill switch that turns process replicas
back into in-process ones (ROADMAP C15).
"""

from __future__ import annotations

import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perceiver_io_torch.ops import cuda_build
from perceiver_io_torch.reliability import faults
from perceiver_io_torch.reliability.retry import RetryError, RetryPolicy, retry_call
from perceiver_io_torch.serving.engine import RequestStatus, ServedRequest

MAGIC = b"PIOr"
_HEADER = struct.Struct(">II")  # payload length, crc32(payload)

# the kernel sources a serving worker loads (B2; B3 and B4; every serving
# attention call has a cache, so flash never runs): built by spawn_worker
# before the worker starts, so that two workers never run one nvcc
SERVING_SOURCES = ("decode_attention", "paged_attention")


class TransportError(RuntimeError):
    """The RPC channel to a worker failed for good (retries spent on a
    worker that is still running: a wedged process). The client has
    SIGKILLed the worker when this is raised."""


class WorkerDiedError(TransportError):
    """The worker PROCESS is gone (exited, crashed or ``kill -9``-ed). On a
    journaled fleet the router's supervisor respawns it through journal
    recovery instead of striking the breaker."""


class WorkerOpError(RuntimeError):
    """An op RAN in the worker and raised. Not a transport failure: the
    channel is healthy and at-most-once held; the remote exception (its
    type's name and traceback in the message) propagates as the in-process
    call would have raised."""

    def __init__(self, op: str, err_type: str, err_msg: str, remote_tb: str = ""):
        self.op = op
        self.err_type = err_type
        self.remote_tb = remote_tb
        super().__init__(f"worker op {op!r} raised {err_type}: {err_msg}")


class FrameError(OSError):
    """A frame failed its CRC check (a torn write). An OSError, so the retry
    policy's default ``retry_on`` takes it as transient: nothing ran."""


# ------------------------------------------------------------------- framing


def encode_frame(payload: bytes, corrupt_crc: bool = False) -> bytes:
    """One wire frame for ``payload``. ``corrupt_crc`` flips the stored CRC
    (fault injection: the frame stays well-formed, magic and length intact,
    so the receiver reads it whole and rejects it on its checksum)."""
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if corrupt_crc:
        crc ^= 0xDEADBEEF
    return MAGIC + _HEADER.pack(len(payload), crc) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    # into one buffer of the frame's size: a recv(n) asks the allocator for
    # n bytes on every call, which for a model's weights (~1 GB) a socket
    # buffer at a time took minutes
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise EOFError("transport peer closed the connection")
        got += k
    return bytes(buf)


def recv_frame(sock: socket.socket) -> bytes:
    """Read one frame. Raises ``FrameError`` on a CRC mismatch (the payload
    was read, so the stream stays in step), ``EOFError`` on a closed peer,
    ``TimeoutError`` when the socket's timeout passes, and
    ``TransportError`` on a wrong magic (a desync nothing recovers)."""
    header = _read_exact(sock, len(MAGIC) + _HEADER.size)
    if header[: len(MAGIC)] != MAGIC:
        raise TransportError(f"bad frame magic {header[:len(MAGIC)]!r}")
    length, crc = _HEADER.unpack(header[len(MAGIC):])
    payload = _read_exact(sock, length)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise FrameError(f"frame CRC mismatch ({length} bytes)")
    return payload


# ------------------------------------------------------------- the recipe


def model_recipe(model, state_dict=None) -> bytes:
    """What a worker needs to build ``model`` again, pickled: its config,
    compute and parameter dtypes, device and ``state_dict`` (or the
    ``state_dict`` given: another parameter version of the same layout)
    moved to the CPU. Pickled once, it can go to several workers."""
    state = model.state_dict() if state_dict is None else state_dict
    return pickle.dumps({"config": model.config, "dtype": model.dtype, "param_dtype": model.param_dtype,
                         "device": str(model.device),
                         "state_dict": {k: v.detach().cpu() for k, v in state.items()}},
                        protocol=pickle.HIGHEST_PROTOCOL)


def spawn_worker(device) -> Tuple[subprocess.Popen, socket.socket]:
    """Start ``python -m perceiver_io_torch.serving.worker`` on one end of a
    socketpair (exec, never fork: the parent may hold a CUDA context) for a
    model on ``device`` (required: the caller names the model's device).
    Returns the process and the client's end. For a worker on the card the
    serving path's kernels (``SERVING_SOURCES``) are built here first, so
    that the workers load them and no two of them run one ``nvcc``."""
    if torch.device(device).type == "cuda":
        cuda_build.build(list(SERVING_SOURCES))
    sock, child = socket.socketpair()
    # the worker must resolve this package from a checkout that was never
    # installed: its root goes first on PYTHONPATH
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = os.environ.copy()
    env["PYTHONPATH"] = pkg_root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen([sys.executable, "-m", "perceiver_io_torch.serving.worker", "--fd", str(child.fileno())],
                            pass_fds=(child.fileno(),), env=env, close_fds=True)
    proc.spawned_at = time.perf_counter()
    child.close()
    return proc, sock


# ------------------------------------------------------------- client shims


class _ClientJournal:
    """The part of ``RequestJournal`` the router touches on a replica
    (``failed``, ``tracks``, ``append_tick``), proxied to the worker that
    owns the real journal. ``tracks`` reads the live ids every reply ships;
    a DEAD worker reads as ``failed`` (its journal takes no close record,
    the fail-stop case ``_journal_note_moved`` handles)."""

    def __init__(self, client: "EngineClient"):
        self._client = client
        self._live: set = set()
        self._worker_failed = False

    @property
    def failed(self) -> bool:
        return self._worker_failed or not self._client.alive

    def tracks(self, rid: int) -> bool:
        return rid in self._live

    def append_tick(self, admitted, tokens, terminals) -> None:
        self._client._rpc("journal_tick", {
            "admitted": list(admitted), "tokens": dict(tokens),
            "terminals": [(int(r), str(s), str(why)) for r, s, why in terminals],
        })


class _ClientMetrics:
    """The replica's metrics: ``latency_estimates()`` from every reply's
    bundle (the shedding estimate reads it at each submit); ``snapshot()``
    is an RPC that falls back to the last good one, so a router snapshot
    never raises on a fleet with a dead replica."""

    def __init__(self, client: "EngineClient"):
        self._client = client
        self._latency: Optional[Dict] = None
        self._last_snapshot: Optional[Dict] = None

    def latency_estimates(self) -> Optional[Dict]:
        return self._latency

    def snapshot(self) -> Dict:
        try:
            snap = self._client._rpc("snapshot", {})
            self._last_snapshot = snap
            return snap
        except TransportError:
            snap = dict(self._last_snapshot) if self._last_snapshot else {}
            snap["worker_unreachable"] = True
            return snap


class _SchedulerView:
    """``engine.scheduler.has_work``, from the last bundle."""

    def __init__(self, client: "EngineClient"):
        self._client = client

    @property
    def has_work(self) -> bool:
        return self._client._has_work


# ------------------------------------------------------------------- client


class EngineClient:
    """``ServingEngine``'s surface, served by a worker process.

    The client starts the worker (or takes one ``spawn_worker`` started) and
    ships it what rebuilds the engine: the model's recipe
    (``model_recipe``, or ``_recipe`` when the caller pickled it for several
    workers), the fleet's engine options, the replica's journal
    directory and metrics stream, the numerics flags and the thread count
    (``num_threads``, default the client's). A worker on the card runs each
    admission path once before it replies to ``init`` (``worker.warm_up``).
    The worker serves with ``weight_dtype`` applied to its own copy of the
    weights; the client's model is never handed to an engine.

    Each public method is one RPC (see the module docstring). The state the
    router reads between calls (``load``, ``scheduler.has_work``,
    ``total_compilations``, handle attributes, ``finished``) comes from the
    bundle on every reply, so a tick costs two RPCs a replica (dispatch and
    harvest). ``transport_stats()`` also carries the worker's B2/B3/B4
    launch counts since its engine was built and its graph replays, from
    its last reply (keys of the port's own)."""

    def __init__(self, model, replica_id: int = 0, metrics_jsonl: Optional[str] = None,
                 journal: Optional[str] = None, rpc_timeout_s: float = 120.0, init_timeout_s: float = 600.0,
                 retry: Optional[RetryPolicy] = None, on_retry=None, num_threads: Optional[int] = None,
                 _sleep=time.sleep, _worker: Optional[Tuple[subprocess.Popen, socket.socket]] = None,
                 _recipe: Optional[bytes] = None, **engine_kwargs):
        self._rid = int(replica_id)
        # jitter 0: the retry schedule is reproducible, as the breaker's ladder
        self._policy = retry if retry is not None else RetryPolicy(attempts=3, base_delay_s=0.05, max_delay_s=2.0,
                                                                   jitter=0.0)
        self._rpc_timeout_s = float(rpc_timeout_s)
        self._on_retry = on_retry
        self._sleep = _sleep
        self._seq = 0
        self._requests: Dict[int, ServedRequest] = {}
        self.finished: List[ServedRequest] = []
        self.journal: Optional[_ClientJournal] = None
        # the worker runs telemetry-off: no compile report crosses the process
        self.watchdog = None
        self.metrics = _ClientMetrics(self)
        self.scheduler = _SchedulerView(self)
        self._load = 0
        self._has_work = False
        self._compilations = 0
        self._launches: Dict[str, int] = {"B2": 0, "B3": 0, "B4": 0}
        self._graph_replays = 0
        self._closed = False
        # transport counters (the serving-metrics/v12 ``transport`` block)
        self.rpcs = 0
        self.retries = 0
        self.timeouts = 0
        self.frames_sent = 0
        self.frames_recv = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.rpc_ms: deque = deque(maxlen=4096)  # the last 4096 RPCs' ms
        self.rpc_ops: deque = deque(maxlen=4096)  # their ops, in the same order

        self._proc, self._sock = _worker if _worker is not None else spawn_worker(model.device)
        try:
            sent_at = time.perf_counter()
            info = self._rpc("init", {
                "model": model_recipe(model) if _recipe is None else _recipe,
                "engine_kwargs": dict(engine_kwargs),
                "metrics_jsonl": metrics_jsonl,
                "journal": journal,
                # the torch settings that decide the arithmetic (the JAX
                # package ships jax_enable_x64)
                "numerics": {"default_dtype": torch.get_default_dtype(),
                             "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                             "cudnn_tf32": torch.backends.cudnn.allow_tf32},
                "num_threads": int(num_threads) if num_threads is not None else torch.get_num_threads(),
                "replica_id": self._rid,
                # the replica's telemetry namespace (the worker records nothing)
                "obs_ns": f"serving.r{self._rid}",
            }, timeout=float(init_timeout_s))
        except BaseException:
            self._kill()
            raise
        # where the worker's start went, in seconds: its interpreter and
        # imports, the recipe's wait and transfer (from the later of the
        # worker's readiness and this client's send), the model's build and
        # load, the engine's build and capture, the warm-up of its paths
        # (on the card: worker.warm_up)
        self.startup = {"interpreter_s": info["ready_at"] - self._proc.spawned_at,
                        "recipe_s": info["init_at"] - max(info["ready_at"], sent_at),
                        "model_s": info["model_at"] - info["init_at"], "engine_s": info["engine_at"] - info["model_at"],
                        "warm_up_s": info["warm_at"] - info["engine_at"], "warm_up_requests": info["warm_requests"]}
        if journal is not None:
            self.journal = _ClientJournal(self)

    # ------------------------------------------------------------- liveness
    @property
    def pid(self) -> Optional[int]:
        """The worker's OS pid (a real ``kill -9`` target)."""
        return self._proc.pid if self._proc is not None else None

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def _kill(self) -> None:
        if self._proc is not None:
            try:
                # SIGCONT first: a SIGSTOPped (hung) worker is reaped only
                # once it runs again to take the KILL
                os.kill(self._proc.pid, signal.SIGCONT)
            except OSError:
                pass
            try:
                self._proc.kill()
            except OSError:
                pass
            try:
                self._proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 — a best-effort reap
                pass
            self._proc = None
        try:
            self._sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------------ rpc
    def _attempt(self, body: bytes, seq: int, timeout: float):
        if self._proc is None:
            raise WorkerDiedError(f"replica {self._rid}: worker already closed")
        if self._proc.poll() is not None:
            raise WorkerDiedError(f"replica {self._rid}: worker exited rc={self._proc.returncode}")
        # the fault points fire here, in the client, scoped to this replica
        if faults.fire_transport_worker_hang(self._rid) is not None:
            os.kill(self._proc.pid, signal.SIGSTOP)
        if faults.fire_transport_worker_kill(self._rid) is not None:
            os.kill(self._proc.pid, signal.SIGKILL)
            self._proc.wait(timeout=10)
        torn = faults.fire_transport_send_torn(self._rid)
        frame = encode_frame(body, corrupt_crc=torn)
        try:
            self._sock.sendall(frame)
        except OSError as e:
            if self._proc.poll() is not None:
                raise WorkerDiedError(f"replica {self._rid}: worker exited mid-send") from e
            raise
        self.frames_sent += 1
        self.bytes_sent += len(frame)
        if faults.fire_transport_recv_timeout(self._rid):
            self.timeouts += 1
            raise TimeoutError(f"injected transport recv timeout (replica {self._rid})")
        self._sock.settimeout(timeout)
        while True:
            try:
                payload = recv_frame(self._sock)
            except EOFError as e:
                raise WorkerDiedError(f"replica {self._rid}: worker closed the connection") from e
            except (TimeoutError, socket.timeout):
                self.timeouts += 1
                raise
            self.frames_recv += 1
            self.bytes_recv += len(payload)
            msg = pickle.loads(payload)
            if msg.get("seq") is None:
                # the worker NACKed a torn frame: nothing ran, retry it clean
                raise FrameError("worker rejected frame (crc mismatch)")
            if msg["seq"] != seq:
                continue  # a stale duplicate from an earlier timed-out attempt
            return msg

    def _rpc(self, op: str, payload: Optional[dict], timeout: Optional[float] = None, _pre_apply=None):
        """One at-most-once RPC under the retry policy. Returns the op's
        value; raises ``WorkerOpError`` (a remote exception),
        ``WorkerDiedError`` (the process is gone) or ``TransportError`` (a
        wedged worker, now killed). ``_pre_apply(value)`` runs between the
        reply's arrival and its bundle's application: submit and recovery
        register new mirrors there, so that a ``finished`` entry in the same
        reply (a rejection at submit) finds its mirror."""
        self._seq += 1
        seq = self._seq
        body = pickle.dumps({"seq": seq, "op": op, "payload": payload}, protocol=pickle.HIGHEST_PROTOCOL)
        timeout = self._rpc_timeout_s if timeout is None else timeout
        self.rpcs += 1
        t0 = time.perf_counter()

        def note_retry(attempt, exc, delay):
            self.retries += 1
            if self._on_retry is not None:
                self._on_retry(self._rid, op, attempt, type(exc).__name__, delay)

        try:
            msg = retry_call(self._attempt, body, seq, timeout, policy=self._policy, sleep=self._sleep,
                             on_retry=note_retry)
        except RetryError as e:
            if self._proc is not None and self._proc.poll() is None:
                # running but silent: a wedged worker is as lost as a dead
                # one, but it must be put down first
                self._kill()
                raise TransportError(f"replica {self._rid}: worker unresponsive after {self._policy.attempts} "
                                     f"attempts (killed)") from e
            raise WorkerDiedError(f"replica {self._rid}: worker died mid-RPC") from e
        except WorkerDiedError:
            raise
        except (TransportError, FrameError) as e:
            # a channel out of step (a reply cut off by a timeout mid-frame,
            # whose rest the retry then read as a header): nothing brings it
            # back, so the worker is put down as a wedged one, and the
            # breaker's half-open replaces it
            self._kill()
            raise TransportError(f"replica {self._rid}: channel out of step ({e}); worker killed") from e
        self.rpc_ms.append((time.perf_counter() - t0) * 1e3)
        self.rpc_ops.append(op)
        result = msg.get("value")
        if msg["ok"] and _pre_apply is not None:
            result = _pre_apply(result)
        self._apply(msg.get("state"))
        if not msg["ok"]:
            err_type, err_msg, tb = msg["error"]
            raise WorkerOpError(op, err_type, err_msg, tb)
        return result

    # ----------------------------------------------------------- state sync
    @staticmethod
    def _update_mirror(mirror: ServedRequest, st: Dict) -> None:
        mirror.status = RequestStatus(st["status"])
        mirror.finish_reason = st["finish_reason"]
        mirror.output_ids = list(st["output_ids"])
        mirror.admitted_at = st["admitted_at"]
        mirror.finished_at = st["finished_at"]
        mirror.preemptions = st["preemptions"]
        mirror.slot = st["slot"]

    def _apply(self, bundle: Optional[Dict]) -> None:
        if bundle is None:
            return
        self._load = bundle["load"]
        self._has_work = bundle["has_work"]
        self._compilations = bundle["total_compilations"]
        self._launches = bundle["launches"]
        self._graph_replays = bundle["graph_replays"]
        self.metrics._latency = bundle["latency_estimates"]
        for rid, st in bundle["requests"].items():
            mirror = self._requests.get(rid)
            if mirror is not None:
                self._update_mirror(mirror, st)
        for rid, st in bundle["finished"]:
            mirror = self._requests.pop(rid, None)
            if mirror is None:
                continue  # a handle this client never tracked
            self._update_mirror(mirror, st)
            self.finished.append(mirror)
        if self.journal is not None:
            self.journal._live = set(bundle["journal_live"] or ())
            self.journal._worker_failed = bool(bundle["journal_failed"])

    def _make_mirror(self, st: Dict) -> ServedRequest:
        mirror = ServedRequest(
            request_id=st["rid"], prompt_ids=np.asarray(st["prompt"], np.int64), config=st["config"],
            seed=st["seed"], priority=st["priority"], deadline_s=st["deadline_s"], submitted_at=st["submitted_at"],
            enqueued_at=st["submitted_at"], session_id=st["session_id"], version=st["version"],
            is_resume=st["is_resume"],
            replay_ids=None if st["replay"] is None else np.asarray(st["replay"], np.int64))
        self._update_mirror(mirror, st)
        return mirror

    # -------------------------------------------------------- engine surface
    @property
    def load(self) -> int:
        return self._load

    @property
    def total_compilations(self) -> int:
        return self._compilations

    @property
    def decode_compilations(self) -> int:
        """The worker engine's decode-graph captures (it captures nothing
        else)."""
        return self._compilations

    def submit(self, prompt_ids: Sequence[int], config=None, seed: int = 0, deadline_s: Optional[float] = None,
               replay_ids: Optional[Sequence[int]] = None, priority: int = 0, resume: bool = False,
               session_id: Optional[str] = None, version: Optional[int] = None, **kwargs) -> ServedRequest:
        """``ServingEngine.submit`` in the worker; the handle returned is a
        mirror the following RPCs refresh."""
        def register(value):
            mirror = self._make_mirror(value["state"])
            self._requests[mirror.request_id] = mirror
            return mirror

        return self._rpc("submit", {
            "prompt": np.asarray(prompt_ids, np.int64).reshape(-1), "config": config, "kwargs": kwargs,
            "seed": int(seed), "deadline_s": deadline_s,
            "replay_ids": None if replay_ids is None else np.asarray(replay_ids, np.int64),
            "priority": int(priority), "resume": bool(resume), "session_id": session_id, "version": version,
        }, _pre_apply=register)

    def step_dispatch(self) -> bool:
        fault = faults.fire_transport_worker_device_fault(self._rid) is not None
        return self._rpc("step_dispatch", {"device_fault": fault})

    def step_harvest(self) -> bool:
        return self._rpc("step_harvest", {})

    def discard_pending_harvest(self) -> None:
        try:
            self._rpc("discard_pending_harvest", {})
        except TransportError:
            pass  # a dead worker has nothing pending to discard

    def _begin_drain(self) -> None:
        self._rpc("begin_drain", {})

    def evict_request(self, request_id: int, reason: str = "cancelled", status: RequestStatus = RequestStatus.FAILED,
                      queued_only: bool = False, journal_terminal: bool = True) -> Optional[ServedRequest]:
        mirror = self._requests.get(request_id)
        evicted = self._rpc("evict", {"rid": int(request_id), "reason": reason, "status": status.value,
                                      "queued_only": bool(queued_only), "journal_terminal": bool(journal_terminal)})
        # the mirror moved to ``finished`` with the reply's bundle: return
        # the object the in-process evict would
        return mirror if evicted else None

    def mark_resume(self, request_id: int) -> None:
        mirror = self._requests.get(request_id)
        if mirror is not None:
            mirror.is_resume = True
        self._rpc("mark_resume", {"rid": int(request_id)})

    def set_params(self, params) -> None:
        """``ServingEngine.set_params`` in the worker: ``params`` by name,
        moved to the CPU to cross the boundary."""
        self._rpc("set_params", {"params": {k: v.detach().cpu() for k, v in params.items()}})

    def _recover_attach(self, journal_path, fsync: str = "accept", segment_max_records: int = 4096,
                        skip_session_ids=frozenset(), _state=None) -> dict:
        """``ServingEngine._recover_attach`` across the boundary: the worker
        replays the journal directory into its fresh engine and swaps the
        generation; the client builds mirrors of the recovered handles.
        ``_state`` (the router's parsed scan) is not shipped: the worker
        reads the same directory, so the result is the same."""
        def register(info):
            handles = []
            for st in info.pop("handle_states"):
                mirror = self._make_mirror(st)
                self._requests[mirror.request_id] = mirror
                handles.append(mirror)
            info["handles"] = handles
            return info

        info = self._rpc("recover_attach", {
            "path": os.path.abspath(os.fspath(journal_path)), "fsync": fsync,
            "segment_max_records": int(segment_max_records), "skip_session_ids": sorted(skip_session_ids),
        }, _pre_apply=register)
        if self.journal is None:
            self.journal = _ClientJournal(self)
            self.journal._live = set(h.request_id for h in info["handles"])
        return info

    def device_stats(self) -> Dict:
        """The worker's pid, device, a probe that launches a kernel there
        and reads it back, and its device memory now and at its peak (bytes;
        None on the CPU)."""
        return self._rpc("device_stats", {})

    def transport_stats(self) -> Dict:
        """The transport counters and the last 4096 RPCs' latencies (ms),
        summed over the replicas into the v12 ``transport`` block, and, from the
        worker's last reply, its B2/B3/B4 launches since its engine was
        built and its decode graph's replays (``launches`` and
        ``graph_replays``, the port's own keys)."""
        return {
            "rpcs": self.rpcs,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "frames_sent": self.frames_sent,
            "frames_recv": self.frames_recv,
            "bytes_sent": self.bytes_sent,
            "bytes_recv": self.bytes_recv,
            "rpc_ms": list(self.rpc_ms),
            "launches": dict(self._launches),
            "graph_replays": self._graph_replays,
        }

    def close(self) -> None:
        """Shut the worker down: one best-effort close RPC (it flushes the
        worker's journal and metrics), then the process is reaped.
        Idempotent; never raises (the router's teardown must work on a dead
        replica)."""
        if self._closed:
            return
        self._closed = True
        if self.alive:
            try:
                self._rpc("close", {}, timeout=30.0)
            except Exception:  # noqa: BLE001 — teardown is best effort
                pass
            if self._proc is not None:
                try:
                    self._proc.wait(timeout=30)
                except Exception:  # noqa: BLE001
                    pass
        self._kill()

    def __del__(self):  # pragma: no cover - interpreter-shutdown ordering
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
