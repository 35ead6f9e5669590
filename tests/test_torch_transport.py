"""Port parity of process replicas: the CRC-framed RPC transport, the engine
worker process and the router's supervisor, in float64 on the CPU with
workers spawned for real.

Frames are the JAX package's byte for byte, and each package reads the
other's. Retries follow the JAX package's jitter-0 schedule and run each op
at most once. A hung worker (SIGSTOP) is a breaker strike and its requests
fail over; a killed worker (SIGKILL) on a journaled fleet is respawned
through its journal with no failover and no strike, and without a journal
it fails over and is replaced at half-open; torn frames are NACKed and
retried, or put a wedged channel down, as a reply cut off mid-frame does. The router's journal keeps parked
submits through a whole-fleet crash in process mode. Greedy tokens equal the
JAX router's and an uninterrupted port engine's; sampled ones are held port
against port (ROADMAP C11). The JAX router runs in process mode once, in the
kill test, for the keys of its ``respawn`` event and ``transport`` block.
Every wait on a worker has a timeout (the transport's RPC timeouts), so a
hang fails a test instead of stalling the run."""

import os
import signal
import socket

import pytest
import torch
from test_torch_support import SERVING, build_pair

from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.reliability import FAULTS, RetryPolicy, armed
from perceiver_io_torch.serving import (BREAKER_CLOSED, EngineClient, FrameError, ServingEngine, ServingRouter,
                                        TransportError, WorkerDiedError, WorkerOpError, load_metrics_jsonl,
                                        read_journal)
from perceiver_io_torch.serving import transport as port_transport
from perceiver_io_torch.serving.worker import is_device_error, warm_up
from perceiver_io_tpu.reliability import FAULTS as JAX_FAULTS
from perceiver_io_tpu.reliability import armed as jax_armed
from perceiver_io_tpu.reliability.retry import RetryError as JaxRetryError
from perceiver_io_tpu.reliability.retry import RetryPolicy as JaxRetryPolicy
from perceiver_io_tpu.reliability.retry import retry_call as jax_retry_call
from perceiver_io_tpu.serving import RouterMetrics as JaxRouterMetrics
from perceiver_io_tpu.serving import ServingRouter as JaxRouter
from perceiver_io_tpu.serving import load_metrics_jsonl as jax_load_metrics_jsonl
from perceiver_io_tpu.serving import transport as jax_transport

# one thread a worker: two workers a router under six test processes would
# otherwise oversubscribe the cores
T = dict(num_threads=1, rpc_timeout_s=30.0)
# a hung worker's RPC: two attempts of 2 s, far above a healthy tiny tick
HANG = dict(num_threads=1, rpc_timeout_s=2.0,
            retry=RetryPolicy(attempts=2, base_delay_s=0.01, max_delay_s=0.02, jitter=0.0))
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)


@pytest.fixture(scope="module")
def pair(x64):
    return build_pair(SERVING)


@pytest.fixture(autouse=True)
def _fault_isolation():
    """No arming leaks between tests (both registries are process-wide)."""
    FAULTS.reset()
    JAX_FAULTS.reset()
    yield
    FAULTS.reset()
    JAX_FAULTS.reset()


def _prompt(n, start=3):
    return [(start + i) % 63 + 1 for i in range(n)]


# prompts of at least max_latents tokens, where the packages agree (ROADMAP C1)
PROMPTS = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (12, 40))]


def _reference(tm, prompts, max_new, configs=None, seeds=None):
    """An uninterrupted single port engine's tokens."""
    engine = ServingEngine(tm, num_slots=len(prompts))
    handles = [engine.submit(p, config=configs[i] if configs else GenerationConfig(max_new_tokens=m),
                             seed=seeds[i] if seeds else 0) for i, (p, m) in enumerate(zip(prompts, max_new))]
    engine.run_until_drained(max_steps=500)
    assert all(h.ok for h in handles)
    return [h.result().tolist() for h in handles]


def _events(path, kind=None):
    return [{k: v for k, v in e.items() if k != "ts"} for e in load_metrics_jsonl(str(path))["events"]
            if e["event"] != "snapshot" and (kind is None or e["event"] == kind)]


def _breaker(path):
    return [(e["replica"], e["transition"], e["tick"]) for e in _events(path, "breaker")]


# ------------------------------------------------------------------ frames
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_frames_are_the_jax_packages_byte_for_byte(writer):
    """The port's frames are the JAX package's bytes, plain and with a
    corrupted CRC; each package's ``recv_frame`` reads the other's frames
    (one longer than a recv chunk), rejects a torn one with its
    ``FrameError`` and stays in step, refuses a wrong magic with its
    ``TransportError`` and reads a closed peer as ``EOFError``."""
    payloads = [b"", b"x", b"x" * 70_000, bytes(range(256)) * 3]
    for payload in payloads:
        for torn in (False, True):
            assert port_transport.encode_frame(payload, torn) == jax_transport.encode_frame(payload, torn)
    assert port_transport.MAGIC == jax_transport.MAGIC and port_transport._HEADER.format == jax_transport._HEADER.format
    encode = (port_transport if writer == "port" else jax_transport).encode_frame
    reader = jax_transport if writer == "port" else port_transport
    a, b = socket.socketpair()
    try:
        b.settimeout(10.0)
        for payload in payloads:
            a.sendall(encode(payload))
            assert reader.recv_frame(b) == payload
        a.sendall(encode(b"torn payload", corrupt_crc=True))
        a.sendall(encode(b"clean payload"))
        with pytest.raises(reader.FrameError):
            reader.recv_frame(b)
        assert reader.recv_frame(b) == b"clean payload"
        a.sendall(b"XXXX" + encode(b"late")[4:])
        with pytest.raises(reader.TransportError):
            reader.recv_frame(b)
        a.close()
        with pytest.raises(EOFError):
            reader.recv_frame(b)
    finally:
        for s in (a, b):
            s.close()
    assert issubclass(FrameError, OSError) and issubclass(WorkerDiedError, TransportError)


# ----------------------------------------------------------------- retries
def test_recv_timeouts_retry_on_the_jax_schedule_at_most_once(pair, tmp_path):
    """Two ``transport.recv.timeout`` on one dispatch RPC: ``retries ==
    timeouts == 2``, the backoff sleeps are the JAX package's schedule for
    the same policy, the worker runs the dispatch once (its engine ticks as
    an in-process one does, and the two cached replies are skipped), the
    tokens are the uninterrupted run's, and the two ``rpc_retry`` events are
    the JAX router's for the same retries."""
    tm = pair[2]
    policy = dict(attempts=3, base_delay_s=0.05, max_delay_s=2.0, jitter=0.0)
    [expected] = _reference(tm, [PROMPTS[0]], [4])
    inproc = ServingRouter(tm, num_replicas=1, num_slots=1)
    inproc.submit(PROMPTS[0], max_new_tokens=4)
    inproc.run_until_drained(max_steps=100)
    want_steps = inproc.snapshot()["replicas"]["r0"]["decode_steps"]
    inproc.close()

    sleeps = []
    path = tmp_path / "port.jsonl"
    router = ServingRouter(tm, num_replicas=1, num_slots=1, replica_mode="process", metrics_jsonl=str(path),
                           transport=dict(T, retry=RetryPolicy(**policy), _sleep=sleeps.append))
    try:
        handle = router.submit(PROMPTS[0], max_new_tokens=4)
        with armed("transport.recv.timeout", slot=0, times=2):
            router.step()  # both timeouts land on this tick's dispatch RPC
        router.run_until_drained(max_steps=100)
        snap = router.snapshot()
        stats = router.replicas[0].engine.transport_stats()
    finally:
        router.close()
    jax_sleeps = []

    def always_times_out():
        raise TimeoutError("no reply")

    with pytest.raises(JaxRetryError):
        jax_retry_call(always_times_out, policy=JaxRetryPolicy(**policy), sleep=jax_sleeps.append)
    assert sleeps == jax_sleeps == [0.05, 0.1]
    assert handle.ok and handle.result().tolist() == expected
    assert stats["retries"] == stats["timeouts"] == 2 and stats["frames_sent"] == stats["rpcs"] + 2
    assert snap["transport"]["retries"] == snap["transport"]["rpc_retries"] == 2
    assert snap["replicas"]["r0"]["decode_steps"] == want_steps and snap["failovers"] == 0
    jax_path = tmp_path / "jax.jsonl"
    jm = JaxRouterMetrics(num_replicas=1, jsonl_path=str(jax_path))
    for attempt, delay in enumerate(jax_sleeps, 1):
        jm.record_rpc_retry(0, "step_dispatch", attempt, "TimeoutError", delay)
    jm.close()
    jax_events = [{k: v for k, v in e.items() if k != "ts"} for e in jax_load_metrics_jsonl(str(jax_path))["events"]]
    assert _events(path, "rpc_retry") == jax_events and len(jax_events) == 2


# ------------------------------------------------------------------- hang
def test_a_hung_worker_strikes_the_breaker_and_fails_over(pair, tmp_path):
    """``transport.worker.hang`` SIGSTOPs replica 0's worker at its next
    RPC: the dispatch times out, the retries are spent, the client kills
    and reaps the process and raises ``TransportError``, the breaker opens
    and the victims fail over by forced-token replay. Tokens, failovers and
    the breaker's transitions by tick equal the JAX router's in process with
    that replica crashing at the same tick, and the uninterrupted run's. At
    half-open the dead worker is replaced before the probe, which closes
    the breaker; no respawn through a journal is counted."""
    jm, params, tm = pair
    expected = _reference(tm, PROMPTS, [6, 6, 6])
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        if pkg == "port":
            router = ServingRouter(tm, num_replicas=2, num_slots=1, breaker_cooldown_ticks=3,
                                   metrics_jsonl=str(path), replica_mode="process", transport=HANG)
        else:
            router = JaxRouter(jm, params, num_replicas=2, num_slots=1, breaker_cooldown_ticks=3,
                               metrics_jsonl=str(path))
        try:
            handles = [router.submit(p, max_new_tokens=6) for p in PROMPTS]
            router.step()
            victim = handles[0].replica
            if pkg == "port":
                hung = router.replicas[victim].engine
                with armed("transport.worker.hang", slot=victim, times=1):
                    router.step()
                assert not hung.alive and hung.pid is None  # killed and reaped by the client
                assert "TransportError" in router.replicas[victim].last_error
            else:
                with jax_armed("replica.crash", slot=victim, times=1):
                    router.step()
            router.run_until_drained(max_steps=300)
            for _ in range(4):
                router.step()
            snap = router.snapshot()
        finally:
            router.close()
        got[pkg] = ([h.result().tolist() for h in handles], [h.failovers for h in handles], _breaker(path), snap)
    assert got["port"][0] == got["jax"][0] == expected
    assert got["port"][1] == got["jax"][1] and got["port"][1][0] == 1
    assert got["port"][2] == got["jax"][2] and [t for _, t, _ in got["port"][2]] == [
        "closed->open", "open->half_open", "half_open->closed"]
    snap = got["port"][3]
    assert snap["failovers"] == got["jax"][3]["failovers"] and snap["transport"]["worker_respawns"] == 0
    assert snap["transport"]["workers_alive"] == 2 and snap["transport"]["timeouts"] == 2
    assert all(r["breaker"] == BREAKER_CLOSED for r in snap["replicas"].values())


# ------------------------------------------------------------------- kill -9
def test_kill9_respawns_the_worker_through_its_journal(pair, tmp_path):
    """A real SIGKILL of a journaled worker mid-decode
    (``transport.worker.kill``): the supervisor respawns it through the
    replica's journal, once, with no failover and no breaker transition;
    the sessions finish with the tokens of the JAX router in process mode in
    the same scenario (run once here, as ``scripts/chaos_check.py`` runs
    it) and of an uninterrupted port engine.
    The ``respawn`` event and the snapshot's ``transport`` block have the
    JAX process-mode router's keys, the event its values too."""
    jm, params, tm = pair
    expected = _reference(tm, PROMPTS, [6, 6, 6])
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        template = str(tmp_path / pkg / "r{i}")
        if pkg == "port":
            router = ServingRouter(tm, num_replicas=2, num_slots=2, journal=template, metrics_jsonl=str(path),
                                   replica_mode="process", transport=T)
        else:
            router = JaxRouter(jm, params, num_replicas=2, num_slots=2, journal=template, metrics_jsonl=str(path),
                               replica_mode="process")
        try:
            handles = [router.submit(p, max_new_tokens=6) for p in PROMPTS]
            for _ in range(3):
                router.step()  # tokens out: the kill lands mid-decode
            victim = handles[0].replica
            pid = router.replicas[victim].engine.pid
            with (armed if pkg == "port" else jax_armed)("transport.worker.kill", slot=victim, times=1):
                router.run_until_drained(max_steps=300)
            assert router.replicas[victim].engine.pid != pid
            snap = router.snapshot()
        finally:
            router.close()
        got[pkg] = dict(tokens=[h.result().tolist() for h in handles], statuses=[h.status.value for h in handles],
                        failovers=[h.failovers for h in handles], respawn=_events(path, "respawn"), snap=snap)
    port, jax = got["port"], got["jax"]
    assert port["tokens"] == jax["tokens"] == expected
    assert port["statuses"] == ["finished"] * 3 and port["failovers"] == [0, 0, 0]
    snap = port["snap"]
    assert snap["failovers"] == 0 and snap["breaker_transitions"] == {}
    assert snap["transport"]["worker_respawns"] == 1 and snap["transport"]["workers_alive"] == 2
    assert snap["requests_submitted"] == snap["requests_finished"] + snap["rejected"] + snap["timed_out"] + snap[
        "failed"]
    assert port["respawn"] == jax["respawn"] and len(port["respawn"]) == 1
    assert set(snap["transport"]) == set(jax["snap"]["transport"])
    assert {k: jax["snap"]["transport"][k] for k in ("worker_respawns", "workers_alive", "rpc_retries")} == {
        k: snap["transport"][k] for k in ("worker_respawns", "workers_alive", "rpc_retries")}


# -------------------------------------------------------------------- torn
@pytest.mark.parametrize("tear", ["one", "every"])
def test_torn_frames(pair, tear):
    """One torn frame (``transport.send.torn``) is NACKed by the worker,
    which runs nothing, and the retry absorbs it: no failover, no breaker
    transition. With every frame to replica 1 torn the retries are spent,
    the wedged worker is killed, the breaker opens and its requests fail
    over. The tokens are the uninterrupted run's either way."""
    tm = pair[2]
    prompts = PROMPTS[:2]
    expected = _reference(tm, prompts, [6, 6])
    router = ServingRouter(tm, num_replicas=2, num_slots=1, replica_mode="process", breaker_cooldown_ticks=500,
                           transport=T)
    try:
        handles = [router.submit(p, max_new_tokens=6) for p in prompts]
        router.step()
        arming = dict(times=1) if tear == "one" else dict(slot=1, times=None)
        with armed("transport.send.torn", **arming):
            router.run_until_drained(max_steps=300)
        snap = router.snapshot()
    finally:
        router.close()
    assert [h.result().tolist() for h in handles] == expected and all(h.ok for h in handles)
    t = snap["transport"]
    if tear == "one":
        assert t["rpc_retries"] == 1 and snap["failovers"] == 0 and snap["breaker_transitions"] == {}
        assert t["workers_alive"] == 2 and t["frames_sent"] == t["rpcs"] + 1
    else:
        assert snap["breaker_transitions"] == {"closed->open": 1} and snap["failovers"] == 1
        assert t["workers_alive"] == 1 and t["worker_respawns"] == 0 and t["rpc_retries"] >= 2
        assert "TransportError" in snap["replicas"]["r1"]["last_error"]


# ------------------------------------------------ a lost worker, no journal
@pytest.mark.parametrize("fault", ["kill", "cut"])
def test_a_lost_worker_without_a_journal_fails_over_and_is_replaced_at_half_open(pair, monkeypatch, fault):
    """A worker lost on a fleet without a journal, whose breaker takes two
    strikes to open: SIGKILLed (``transport.worker.kill``), or put down by
    its client after a socket timeout partway through a reply frame left
    the channel out of step (the retry sends the request again, the worker
    answers from its reply cache, and the rest of the old reply reads as a
    header with a bad magic: ``TransportError``). There is nothing to
    respawn it through: the dead client stays in place, the next tick's RPC
    to it (``WorkerDiedError``) is the second strike, the breaker opens and
    the requests fail over from the client's mirrors with the uninterrupted
    run's tokens. At half-open a fresh, empty worker takes the probe and
    closes the breaker; no error leaves ``step()`` and no respawn through a
    journal is counted."""
    tm = pair[2]
    expected = _reference(tm, PROMPTS, [6, 6, 6])
    real = port_transport.recv_frame
    cut = {}

    def recv_frame(sock):
        if cut.get("sock") is sock:
            del cut["sock"]
            header = port_transport._read_exact(sock, len(port_transport.MAGIC) + port_transport._HEADER.size)
            length, _ = port_transport._HEADER.unpack(header[len(port_transport.MAGIC):])
            port_transport._read_exact(sock, length // 2)
            raise socket.timeout("timed out mid-frame")
        return real(sock)

    monkeypatch.setattr(port_transport, "recv_frame", recv_frame)
    router = ServingRouter(tm, num_replicas=2, num_slots=1, breaker_cooldown_ticks=3, failure_threshold=2,
                           replica_mode="process", transport=T)
    try:
        handles = [router.submit(p, max_new_tokens=6) for p in PROMPTS]
        router.step()
        victim = handles[0].replica
        lost = router.replicas[victim].engine
        if fault == "kill":
            with armed("transport.worker.kill", slot=victim, times=1):
                router.step()
            assert router.replicas[victim].last_error.startswith("WorkerDiedError")
        else:
            cut["sock"] = lost._sock
            router.step()
            assert not cut and lost.pid is None  # killed and reaped by the client
            error = router.replicas[victim].last_error
            assert error.startswith("TransportError") and "bad frame magic" in error
        assert not lost.alive and router.replicas[victim].engine is lost
        assert router.replicas[victim].breaker == BREAKER_CLOSED  # one strike of two
        router.run_until_drained(max_steps=300)
        for _ in range(4):
            router.step()
        replaced = router.replicas[victim].engine is not lost
        snap = router.snapshot()
    finally:
        router.close()
    assert [h.result().tolist() for h in handles] == expected and all(h.ok for h in handles)
    assert handles[0].failovers == 1 and replaced
    assert snap["breaker_transitions"] == {"closed->open": 1, "open->half_open": 1, "half_open->closed": 1}
    t = snap["transport"]
    assert t["worker_respawns"] == 0 and t["workers_alive"] == 2
    assert t["timeouts"] == t["rpc_retries"] == (fault == "cut")
    assert all(r["breaker"] == BREAKER_CLOSED for r in snap["replicas"].values())


# ---------------------------------------------------------- router journal
def _kill_fleet(router):
    """The whole fleet dies: every worker is SIGKILLed and the router is
    abandoned unflushed."""
    for r in router.replicas:
        os.kill(r.engine.pid, signal.SIGKILL)


def test_router_journal_replays_parked_submits_after_a_full_fleet_crash(pair, tmp_path):
    """In process mode: fresh submits parked while the one-replica fleet is
    breaker-open are durable only in the router's journal; after the worker
    is SIGKILLed and the router abandoned, ``ServingRouter.recover`` brings
    back the replica journal's session and both parked submits, and each
    finishes with the uninterrupted run's tokens."""
    tm = pair[2]
    prompts = [_prompt(n, s) for n, s in ((7, 3), (8, 40), (6, 50))]
    expected = _reference(tm, prompts, [4, 4, 4])
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=1, num_slots=1, journal=template, breaker_cooldown_ticks=512,
                           replica_mode="process", transport=T)
    h1 = router.submit(prompts[0], max_new_tokens=4)
    router.step()
    with armed("replica.crash", slot=0, times=1):
        router.step()  # the whole (one-replica) fleet is breaker-open
    parked = [router.submit(p, max_new_tokens=4) for p in prompts[1:]]
    assert all(h.status.value == "queued" for h in parked)
    assert len(read_journal(template.format(i="router")).sessions) == 2
    assert len(read_journal(template.format(i=0)).sessions) == 1
    _kill_fleet(router)
    del router, h1
    router2, info = ServingRouter.recover(tm, template, num_replicas=1, num_slots=1, replica_mode="process",
                                          transport=T)
    try:
        assert info["sessions"] == 1 and info["router_parked"] == 2
        router2.run_until_drained(max_steps=500)
        by_prompt = {tuple(h.prompt_ids.tolist()): h for h in info["handles"] + info["parked_handles"]}
        for p, want in zip(prompts, expected):
            h = by_prompt[tuple(p)]
            assert h.ok and h.result().tolist() == want, p
        assert read_journal(template.format(i="router")).sessions == []
    finally:
        router2.close()


def test_router_journal_dedups_a_session_already_in_a_replica_journal(pair, tmp_path):
    """In process mode: a parked submit lands on the replica (its accept is
    in the worker's journal) and the fleet dies before the router journal's
    close record; recovery admits the session once, from the replica's
    journal, with the uninterrupted tokens."""
    tm = pair[2]
    prompt = _prompt(7, 3)
    [expected] = _reference(tm, [prompt], [6])
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=1, num_slots=1, journal=template, breaker_cooldown_ticks=2,
                           replica_mode="process", transport=T)
    router.submit(_prompt(6, 30), max_new_tokens=2)
    router.step()
    with armed("replica.crash", slot=0, times=1):
        router.step()
    h = router.submit(prompt, max_new_tokens=6)  # parked: in the router journal
    assert len(read_journal(template.format(i="router")).sessions) == 1
    router._router_journal_close = lambda *a, **k: None  # the close record is lost
    for _ in range(30):
        router.step()
        if h.status.value == "running" and h.output_ids:
            break
    assert h.status.value == "running"
    assert any(s.session == h.session_id for s in read_journal(template.format(i=0)).sessions)
    _kill_fleet(router)
    del router
    router2, info = ServingRouter.recover(tm, template, num_replicas=1, num_slots=1, replica_mode="process",
                                          transport=T)
    try:
        assert info["router_parked"] == 0 and info["sessions"] == 1
        router2.run_until_drained(max_steps=300)
        [recovered] = info["handles"]
        assert recovered.ok and recovered.result().tolist() == expected
    finally:
        router2.close()


# ----------------------------------------------------------------- sampled
def test_sampled_requests_match_the_in_process_fleet(pair, tmp_path):
    """Sampled and greedy requests through a journaled process fleet whose
    worker 1 is SIGKILLed mid-decode give the in-process fleet's tokens,
    port against port (C11): the seed crosses the boundary on the mirror
    and through the journal's recovery."""
    tm = pair[2]
    prompts = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (9, 40), (12, 7))]
    configs = [GenerationConfig(max_new_tokens=7, **(SAMPLED if i % 2 else {})) for i in range(4)]
    seeds = [11, 12, 13, 14]
    got = {}
    for mode in ("inproc", "process"):
        router = ServingRouter(tm, num_replicas=2, num_slots=2, replica_mode=mode, journal=str(tmp_path / mode / "r{i}"),
                               transport=T if mode == "process" else None)
        try:
            handles = [router.submit(p, config=c, seed=s) for p, c, s in zip(prompts, configs, seeds)]
            for _ in range(3):
                router.step()
            with armed("transport.worker.kill", slot=1, times=1):
                router.run_until_drained(max_steps=300)
            snap = router.snapshot()
        finally:
            router.close()
        got[mode] = [h.result().tolist() for h in handles]
        assert all(h.ok for h in handles) and snap["failovers"] == 0
    assert got["process"] == got["inproc"] == _reference(tm, prompts, [7] * 4, configs, seeds)
    assert snap["transport"]["worker_respawns"] == 1


# ---------------------------------------------------------- remote errors
def test_remote_errors_come_back_as_worker_op_errors(pair):
    """An op that raises in the worker comes back as ``WorkerOpError`` with
    the remote type's name and traceback, and the channel stays healthy. In
    a router, the port's ``transport.worker.device_fault`` (armed in this
    process and counted by the client, targeted by replica id) gathers
    out of bounds in worker 1 at its second dispatch: on the CPU an
    ``IndexError``, a breaker strike, and the victims fail over with the
    uninterrupted tokens while worker 0 serves on."""
    tm = pair[2]
    client = EngineClient(tm, replica_id=0, num_slots=1, **T)
    try:
        with pytest.raises(WorkerOpError) as err:
            client.submit(_prompt(6), config=GenerationConfig(max_new_tokens=2, num_beams=3))
        assert err.value.err_type == "ValueError" and err.value.op == "submit" and "beam" in str(err.value)
        assert "Traceback" in err.value.remote_tb
        handle = client.submit(_prompt(6), max_new_tokens=2)
        for _ in range(10):
            client.step_dispatch()
            client.step_harvest()
            if handle.done:
                break
        assert handle.ok and client.alive
    finally:
        client.close()
    assert not client.alive

    expected = _reference(tm, PROMPTS, [6, 6, 6])
    router = ServingRouter(tm, num_replicas=2, num_slots=1, breaker_cooldown_ticks=2, replica_mode="process",
                           transport=T)
    try:
        handles = [router.submit(p, max_new_tokens=6) for p in PROMPTS]
        with armed("transport.worker.device_fault", slot=1, after=1):
            router.run_until_drained(max_steps=300)
        snap = router.snapshot()
    finally:
        router.close()
    assert [h.result().tolist() for h in handles] == expected
    assert "WorkerOpError" in snap["replicas"]["r1"]["last_error"] and "IndexError" in snap["replicas"]["r1"][
        "last_error"]
    assert snap["breaker_transitions"] == {"closed->open": 1, "open->half_open": 1, "half_open->closed": 1}
    assert snap["failovers"] >= 1 and snap["transport"]["workers_alive"] == 2


def test_device_error_detection():
    """The worker exits after a CUDA error (its context is poisoned for
    good) and after nothing else."""
    assert is_device_error(RuntimeError("CUDA error: device-side assert triggered"))
    assert not is_device_error(IndexError("index 1048576 is out of bounds for dimension 0 with size 4"))
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert is_device_error(accel("illegal memory access"))


def test_spawn_worker_needs_the_models_device():
    """``spawn_worker`` takes the model's device as a required argument: a
    call without it raises before any process starts, so no caller can start
    a CPU worker for a card model (and skip the kernels' one build)."""
    with pytest.raises(TypeError, match="device"):
        port_transport.spawn_worker()


@pytest.mark.parametrize("options", [dict(num_slots=2), dict(num_slots=2, kv_page_size=4),
                                     dict(num_slots=2, kv_page_size=4, kv_quant="int4")],
                         ids=["dense", "paged", "paged_int4"])
def test_worker_warm_up_serves_each_admission_path_and_leaves_the_model(pair, options):
    """``worker.warm_up`` serves one request a bucket length, one below the
    latents and one sampled, on a throwaway eager engine of one slot, and
    leaves the model's weights as they were; a CPU worker skips it (its
    start records 0 warm-up requests) and serves as before."""
    tm = pair[2]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    buckets = ServingEngine(tm, **options).prefill_buckets
    assert warm_up(tm, options) == len({tm.max_latents - 1, *buckets}) + 1
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
    client = EngineClient(tm, replica_id=0, **options, **T)
    try:
        assert client.startup["warm_up_requests"] == 0 and client.startup["warm_up_s"] >= 0
        handle = client.submit(_prompt(6), max_new_tokens=2)
        while not handle.done:
            client.step_dispatch()
            client.step_harvest()
        assert handle.ok and [op for op in client.rpc_ops][:2] == ["init", "submit"]
    finally:
        client.close()


def test_spare_worker_takes_the_respawn(pair, tmp_path):
    """A process fleet keeps one started worker ahead (an in-process one
    none); a SIGKILLed replica's respawn through its journal takes it (the
    respawned pid is the spare's), a new spare starts in its place, the
    tokens are the uninterrupted ones, and close() ends the spare."""
    tm = pair[2]
    expected = _reference(tm, PROMPTS, [8, 8, 8])
    in_process = ServingRouter(tm, num_replicas=1, num_slots=1)
    assert in_process._spare is None
    in_process.close()
    router = ServingRouter(tm, num_replicas=2, num_slots=2, replica_mode="process", journal=str(tmp_path / "r{i}"),
                           transport=T)
    try:
        spare, _ = router._spare
        assert spare.poll() is None and spare.pid not in [r.engine.pid for r in router.replicas]
        handles = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
        router.step()
        os.kill(router.replicas[1].engine.pid, signal.SIGKILL)
        router.run_until_drained(max_steps=300)
        assert router.replicas[1].engine.pid == spare.pid
        assert router.snapshot()["transport"]["worker_respawns"] == 1
        assert [h.result().tolist() for h in handles] == expected and all(h.ok for h in handles)
        refill, _ = router._spare
        assert refill.pid != spare.pid and refill.poll() is None
    finally:
        router.close()
    assert router._spare is None and refill.poll() is not None
