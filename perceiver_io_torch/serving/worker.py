"""A replica's worker process: one ``ServingEngine`` behind the framed RPC.

Port of ``perceiver_io_tpu/serving/worker.py``. ``serving/transport.py``'s
``EngineClient`` starts it as::

    python -m perceiver_io_torch.serving.worker --fd <socket fd>

and drives it over that socket alone: one CRC-framed pickled request in,
one framed reply out (the frame format and the reliability contract are in
transport.py's docstring). The first op must be ``init``: it ships the
model's recipe (config, dtypes, device, CPU ``state_dict``), the fleet's
engine options, the replica's journal directory and metrics stream, the
client's ``torch`` numerics flags (applied BEFORE the engine is built, so
float64 and TF32 settings hold across the boundary), the thread count and
the replica id. The journal and the metrics stream are written HERE, by the
process that owns the engine, so their crash semantics are the engine's.
The worker's engine runs with telemetry off (its spans would not reach the
router's recorder), as the JAX package's does.

Guarantees on this side:

  * NACK, don't run: a frame that fails its CRC gets a ``seq=None`` error
    reply and nothing runs; the client retries the op.
  * At most once: replies are cached by ``seq``; a repeated ``seq`` (the
    client timed out reading the reply) is answered from the cache, byte
    for byte, without running the op again.
  * The state bundle: every reply carries what the router reads between
    calls (load, has_work, captures, latency estimates, live handle states,
    newly finished handles, the journal's live ids) and the worker's
    B2/B3/B4 launch counts and graph replays.
  * A sticky CUDA error: an op that raised one (``torch.AcceleratorError``
    where this torch has it, else a "CUDA error" message) poisons this
    process's CUDA context for good, so the worker sends its error reply
    and then exits; the client's next RPC finds the process gone
    (``WorkerDiedError``) and the router respawns it through its journal
    (ROADMAP C15).
  * Warm before serving: on the card, ``init`` runs every admission path
    and a decode step once on a throwaway eager engine of one slot with the
    fleet's other options (``warm_up``) before it replies, so the work a
    fresh process does lazily on its first use of each path (kernel modules
    loaded at their first launch, library handles) is part of the init,
    which has minutes, and not of the first ticks' RPCs, whose timeout is
    seconds. The warm-up hands its memory back to the card
    (``empty_cache``), and the peak that ``device_stats`` reports leaves it
    out: a warmed worker holds and reports the memory an unwarmed one
    would.
  * The port's fault point ``transport.worker.device_fault`` is counted by
    the client, at this replica's step_dispatch, and made here: the
    dispatch's payload asks for it, and the worker gathers at an
    out-of-bounds index on the engine's device, a real device-side assert
    on the card (on the CPU the same gather raises ``IndexError`` at once,
    a plain op error).
"""

from __future__ import annotations

import argparse
import gc
import os
import pickle
import socket
import time
import traceback
from typing import Dict, Optional

import torch

import perceiver_io_torch.ops.decode_kernel as dk
import perceiver_io_torch.ops.paged_decode_kernel as pk
import perceiver_io_torch.ops.ragged_paged_kernel as rk
from perceiver_io_torch.serving.transport import FrameError, encode_frame, recv_frame

_KERNELS = {"B2": dk, "B3": pk, "B4": rk}


def _req_state(h) -> Dict:
    """The slice of a handle's state that refreshes its mirror
    (``EngineClient._update_mirror``)."""
    return {
        "status": h.status.value,
        "finish_reason": h.finish_reason,
        "output_ids": list(h.output_ids),
        "admitted_at": h.admitted_at,
        "finished_at": h.finished_at,
        "preemptions": h.preemptions,
        "slot": h.slot,
    }


def _full_state(h) -> Dict:
    """Everything that BUILDS a mirror on the client (submit and
    recover_attach replies). ``seed`` stands where the JAX package ships
    ``rng`` (ROADMAP C11, C13)."""
    st = _req_state(h)
    st.update({
        "rid": h.request_id,
        "prompt": h.prompt_ids.tolist(),
        "config": h.config,
        "seed": h.seed,
        "priority": h.priority,
        "deadline_s": h.deadline_s,
        "submitted_at": h.submitted_at,
        "session_id": h.session_id,
        "version": h.version,
        "is_resume": h.is_resume,
        "replay": None if h.replay_ids is None else h.replay_ids.tolist(),
    })
    return st


def is_device_error(exc: BaseException) -> bool:
    """True for a CUDA error, which leaves the process's context unusable."""
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(exc, accel)) or "CUDA error" in str(exc)


def device_side_assert(device: torch.device) -> None:
    """Gather at an out-of-bounds index on ``device`` and wait for it: a
    device-side assert on the card, an ``IndexError`` on the CPU."""
    x = torch.zeros(4, device=device)
    x[torch.tensor([1 << 20], device=device)].sum().item()


def warm_up(model, engine_kwargs: Dict) -> int:
    """Serve one request at each prompt length that picks a different
    admission path or prefill bucket (``max_latents - 1``: the bucket
    prefill; each bucket's full length: the split path of a paged engine,
    the bucket prefill of a dense one) and a sampled one, two tokens each,
    on an eager engine of one slot (its pool one window: the default
    ``num_kv_pages`` of one slot, no queue bound) built with the other
    options of ``engine_kwargs`` over ``model``, then close it and, on the
    card, hand its memory back (``empty_cache``). It shares nothing with
    the replica's engine but the model (no journal, no metrics stream, no
    telemetry), so it changes no served token. Returns the requests it
    served to completion."""
    from perceiver_io_torch.generation.generate import GenerationConfig
    from perceiver_io_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, **{**engine_kwargs, "num_slots": 1, "num_kv_pages": None, "max_queue_depth": None,
                                     "max_prefill_slots": None, "cuda_graph": False, "telemetry": False})
    try:
        lengths = sorted({max(model.max_latents - 1, 1), *engine.prefill_buckets})
        greedy = GenerationConfig(max_new_tokens=2)
        sampled = GenerationConfig(max_new_tokens=2, do_sample=True, temperature=0.8, top_k=50)
        handles = [engine.submit([1] * n, config=greedy) for n in lengths]
        handles.append(engine.submit([1] * lengths[0], config=sampled, seed=1))
        engine.run_until_drained()
        served = sum(h.ok for h in handles)
    finally:
        engine.close()
    del engine, handles
    gc.collect()  # the engine's cycles hold its pool until collected
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    return served


class _Worker:
    def __init__(self):
        self.engine = None
        self.replica_id: Optional[int] = None
        self.build_peak = 0  # on the card: the peak allocation of the model's and the engine's build
        self.ready_at = time.perf_counter()  # imports done, serving

    # ------------------------------------------------------------------ ops
    def op_init(self, p):
        if self.engine is not None:
            raise RuntimeError("worker already initialized")
        init_at = time.perf_counter()
        flags = p["numerics"]
        torch.set_default_dtype(flags["default_dtype"])
        torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
        torch.set_num_threads(p["num_threads"])
        self.replica_id = p["replica_id"]
        from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
        from perceiver_io_torch.serving.engine import ServingEngine

        recipe = pickle.loads(p["model"])
        device = torch.device(recipe["device"])
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the client's model is on {device}, and this worker finds no CUDA device")
        model = CausalSequenceModel(recipe["config"], device=device, dtype=recipe["dtype"],
                                    param_dtype=recipe["param_dtype"])
        model.load_state_dict(recipe["state_dict"])
        del recipe
        model_at = time.perf_counter()
        self.engine = ServingEngine(model, metrics_jsonl=p["metrics_jsonl"], journal=p["journal"], telemetry=False,
                                    obs_ns=p["obs_ns"], **p["engine_kwargs"])
        engine_at = time.perf_counter()
        warmed = 0
        if device.type == "cuda":
            # after the replica's engine, which may take the model over
            # (served weights); the peak statistic restarts after it, and
            # device_stats reports the build's peak beside it
            self.build_peak = torch.cuda.max_memory_allocated(device)
            warmed = warm_up(model, p["engine_kwargs"])
            torch.cuda.reset_peak_memory_stats(device)
        # the launch counts a reply carries start at the engine's first tick
        for m in _KERNELS.values():
            m.launches = 0
        # perf_counter stamps (a clock the host's processes share): imports
        # done, the init op received and unpickled, the model built and
        # loaded, the engine built (its graph captured), the warm-up done
        return {"journaled": self.engine.journal is not None, "pid": os.getpid(), "ready_at": self.ready_at,
                "init_at": init_at, "model_at": model_at, "engine_at": engine_at, "warm_at": time.perf_counter(),
                "warm_requests": warmed}

    def op_submit(self, p):
        handle = self.engine.submit(p["prompt"], config=p["config"], seed=p["seed"], deadline_s=p["deadline_s"],
                                    replay_ids=p["replay_ids"], priority=p["priority"], resume=p["resume"],
                                    session_id=p["session_id"], version=p["version"], **(p["kwargs"] or {}))
        return {"state": _full_state(handle)}

    def op_step_dispatch(self, p):
        if p["device_fault"]:  # transport.worker.device_fault, counted by the client
            device_side_assert(self.engine.device)
        return bool(self.engine.step_dispatch())

    def op_step_harvest(self, p):
        return bool(self.engine.step_harvest())

    def op_discard_pending_harvest(self, p):
        self.engine.discard_pending_harvest()

    def op_begin_drain(self, p):
        self.engine._begin_drain()

    def op_evict(self, p):
        from perceiver_io_torch.serving.engine import RequestStatus

        handle = self.engine.evict_request(p["rid"], p["reason"], status=RequestStatus(p["status"]),
                                           queued_only=p["queued_only"], journal_terminal=p["journal_terminal"])
        return handle is not None

    def op_mark_resume(self, p):
        self.engine.mark_resume(p["rid"])

    def op_set_params(self, p):
        self.engine.set_params(p["params"])

    def op_journal_tick(self, p):
        journal = self.engine.journal
        if journal is None:
            raise RuntimeError("engine has no journal")
        journal.append_tick(p["admitted"], p["tokens"], [tuple(t) for t in p["terminals"]])

    def op_snapshot(self, p):
        return self.engine.metrics.snapshot()

    def op_recover_attach(self, p):
        info = self.engine._recover_attach(p["path"], fsync=p["fsync"], segment_max_records=p["segment_max_records"],
                                           skip_session_ids=frozenset(p["skip_session_ids"]))
        info["handle_states"] = [_full_state(h) for h in info.pop("handles")]
        return info

    def op_device_stats(self, p):
        device = self.engine.device
        probe = torch.arange(8, device=device, dtype=torch.float32).sum().item()
        on_card = device.type == "cuda"
        # the peak over the build and the serving since; the warm-up's engine is not in it
        return {"pid": os.getpid(), "device": str(device), "probe": probe,
                "memory_allocated": torch.cuda.memory_allocated(device) if on_card else None,
                "memory_reserved": torch.cuda.memory_reserved(device) if on_card else None,
                "max_memory_allocated": max(self.build_peak, torch.cuda.max_memory_allocated(device))
                if on_card else None}

    def op_close(self, p):
        if self.engine is not None:
            self.engine.close()

    # ---------------------------------------------------------------- bundle
    def bundle(self) -> Optional[Dict]:
        engine = self.engine
        if engine is None:
            return None
        finished = [(h.request_id, _req_state(h)) for h in engine.finished]
        engine.finished = []  # shipped: the CLIENT's list owns them now
        journal = engine.journal
        return {
            "load": engine.load,
            "has_work": engine.scheduler.has_work,
            "total_compilations": engine.total_compilations,
            "latency_estimates": engine.metrics.latency_estimates(),
            "requests": {rid: _req_state(h) for rid, h in engine._requests.items()},
            "finished": finished,
            "journal_live": sorted(journal._live) if journal is not None else None,
            "journal_failed": journal.failed if journal is not None else False,
            "launches": {k: m.launches for k, m in _KERNELS.items()},
            "graph_replays": engine.graph_replays,
        }

    # ------------------------------------------------------------------ loop
    def serve(self, sock: socket.socket) -> None:
        replies: Dict[int, bytes] = {}
        order = []
        while True:
            try:
                payload = recv_frame(sock)
            except FrameError:
                # a torn frame: reject it WITHOUT running anything; the client retries
                nack = pickle.dumps({"seq": None, "ok": False, "error": ("FrameError", "frame crc mismatch", ""),
                                     "state": None}, protocol=pickle.HIGHEST_PROTOCOL)
                sock.sendall(encode_frame(nack))
                continue
            except (EOFError, OSError):
                return  # the client is gone: nothing to serve
            msg = pickle.loads(payload)
            seq = msg["seq"]
            if seq in replies:
                # a repeat of an op that ran (the client timed out reading
                # its reply): answer from the cache, at most once
                sock.sendall(replies[seq])
                continue
            op = msg["op"]
            handler = getattr(self, f"op_{op}", None)
            fatal = False
            try:
                if handler is None:
                    raise ValueError(f"unknown op {op!r}")
                value = handler(msg["payload"])
                reply = {"seq": seq, "ok": True, "value": value}
            except BaseException as e:  # noqa: BLE001 — shipped to the client
                fatal = is_device_error(e)
                reply = {"seq": seq, "ok": False, "error": (type(e).__name__, str(e), traceback.format_exc())}
            # a poisoned CUDA context cannot be read for the bundle
            reply["state"] = None if fatal else self.bundle()
            raw = encode_frame(pickle.dumps(reply, protocol=pickle.HIGHEST_PROTOCOL))
            replies[seq] = raw
            order.append(seq)
            while len(order) > 8:  # the client never retries further back
                replies.pop(order.pop(0), None)
            try:
                sock.sendall(raw)
            except OSError:
                return
            if fatal:
                # no flush, no destructors: they would touch the dead context
                os._exit(3)
            if op == "close":
                return


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--fd", type=int, required=True, help="the inherited socketpair fd connected to the client")
    args = parser.parse_args()
    sock = socket.socket(fileno=args.fd)
    try:
        _Worker().serve(sock)
    finally:
        try:
            sock.close()
        except OSError:
            pass


if __name__ == "__main__":
    main()
