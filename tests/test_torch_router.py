"""Port parity of the serving router over in-process replicas: dispatch,
failover by forced-token replay, the circuit breaker, NaN containment, the
slow-tick detector, SLO shedding, drain and SIGTERM, and ``RouterMetrics``,
against the JAX router on the same converted weights, in float64 on the CPU.

Greedy tokens, failover counts, breaker transitions by tick and the JSONL
events (``ts`` left out) equal the JAX router's in the same scenario, and
every request's tokens equal an uninterrupted single engine's. Prompts
shorter than ``max_latents`` and sampled requests are held port against port
(ROADMAP C1, C11): a sampled continuation restarts its generator from its
seed. A crash in the harvest half of a tick (the port's
``replica.crash.harvest``, ROADMAP C14) is port only: the JAX router fires
its replica points before the dispatch. Each router arms its own package's
fault registry. Breaker tests use crash and NaN faults, or a stall far above
its threshold."""

import copy
import signal

import pytest
from test_torch_support import SERVING, build_pair

from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.obs import load_chrome_trace, validate_chrome_trace
from perceiver_io_torch.reliability import FAULTS, armed
from perceiver_io_torch.serving import (BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN, RouterMetrics,
                                        ServingEngine, ServingRouter, load_metrics_jsonl)
from perceiver_io_tpu.obs.trace import validate_chrome_trace as jax_validate_chrome_trace
from perceiver_io_tpu.reliability import FAULTS as JAX_FAULTS
from perceiver_io_tpu.reliability import armed as jax_armed
from perceiver_io_tpu.serving import ServingEngine as JaxEngine
from perceiver_io_tpu.serving import ServingRouter as JaxRouter
from perceiver_io_tpu.serving import load_metrics_jsonl as jax_load_metrics_jsonl

WINDOW, LATENTS = SERVING["max_seq_len"], SERVING["max_latents"]
PAGE = 2
POOLS = {"dense": {}, "paged-fp": dict(kv_page_size=PAGE), "paged-int8": dict(kv_page_size=PAGE, kv_quant="int8"),
         "paged-int4": dict(kv_page_size=PAGE, kv_quant="int4")}
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


def _router(pair, pkg, **kw):
    jm, params, tm = pair
    return ServingRouter(tm, **kw) if pkg == "port" else JaxRouter(jm, params, **kw)


def _armed(pkg, point, **kw):
    return (armed if pkg == "port" else jax_armed)(point, **kw)


def _reference(tm, prompts, max_new, pool="dense", configs=None, seeds=None):
    """An uninterrupted single port engine's tokens (the failover gate)."""
    engine = ServingEngine(tm, num_slots=len(prompts), **POOLS[pool])
    handles = [engine.submit(p, config=configs[i] if configs else GenerationConfig(max_new_tokens=m),
                             seed=seeds[i] if seeds else 0) for i, (p, m) in enumerate(zip(prompts, max_new))]
    engine.run_until_drained(max_steps=500)
    assert all(h.ok for h in handles)
    return [h.result().tolist() for h in handles]


def _events(path):
    """The router's JSONL events without their wall-clock stamps and
    snapshots (which hold timings)."""
    return [{k: v for k, v in e.items() if k != "ts"} for e in load_metrics_jsonl(str(path))["events"]
            if e["event"] != "snapshot"]


def _transitions(snap):
    return snap["breaker_transitions"]


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("pool", list(POOLS))
def test_greedy_parity_mixed_lengths(pair, pool):
    """Dispatch is invisible to outputs: the router's greedy tokens equal
    the JAX router's and an uninterrupted engine's, work spreads over both
    replicas, and each replica has its own pool."""
    prompts = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (12, 40), (9, 7))]
    max_new = [5, 3, 6, 4]
    got = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=2, **POOLS[pool])
        handles = [router.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
        router.run_until_drained(max_steps=300)
        assert all(h.ok and h.failovers == 0 for h in handles)
        snap = router.snapshot()
        got[pkg] = ([h.result().tolist() for h in handles], [h.replica for h in handles], snap)
        router.close()
    assert got["port"][0] == got["jax"][0] == _reference(pair[2], prompts, max_new, pool)
    assert got["port"][1] == got["jax"][1] and set(got["port"][1]) == {0, 1}
    snap = got["port"][2]
    assert snap["schema"] == "serving-metrics/v12" and snap["failovers"] == 0 and snap["breaker_transitions"] == {}
    assert all(s["requests_admitted"] > 0 for s in snap["replicas"].values())
    assert snap["page_pool"] is None and snap["kv_quant"] is None and snap["transport"] is None
    assert snap["fleet_ops"] == {k: v for k, v in got["jax"][2]["fleet_ops"].items()}
    for key in ("requests_submitted", "requests_dispatched", "requests_finished", "rejected", "failed"):
        assert snap[key] == got["jax"][2][key], key
    if pool != "dense":
        assert all(s["page_pool"]["pages_in_use"] == 0 for s in snap["replicas"].values())
        assert {s["kv_quant"]["mode"] if s["kv_quant"] else None for s in snap["replicas"].values()} == {
            POOLS[pool].get("kv_quant")}


@pytest.mark.parametrize("pool", list(POOLS))
def test_failover_token_identity_at_bucket_boundaries(pair, pool):
    """A replica crashes after k emitted tokens; the continuation (prompt
    prefilled at its bucket, the k tokens replayed on the sibling) equals the
    uninterrupted run for prompt and continuation lengths on every side of
    the ladder's boundaries, and the JAX router's continuation where C1
    lets them agree (n >= max_latents)."""
    k, max_new = 2, 5
    lengths = sorted({1, LATENTS - k, LATENTS, LATENTS + 1 - k, LATENTS + 1, WINDOW - k})
    results = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=1, breaker_cooldown_ticks=1, **POOLS[pool])
        for n in lengths if pkg == "port" else [n for n in lengths if n >= LATENTS]:
            victim = router.submit(_prompt(n), max_new_tokens=max_new)
            for _ in range(k):
                router.step()
            assert len(victim.output_ids) == k
            origin = victim.replica
            with _armed(pkg, "replica.crash", slot=origin, times=1):
                router.run_until_drained(max_steps=300)
            assert victim.ok and victim.failovers == 1 and victim.replica != origin, (pkg, n, victim.status)
            results[(pkg, n)] = victim.result().tolist()
            for _ in range(4):
                router.step()  # the 1-tick cooldown, the probe: closed again
            assert all(r.breaker == BREAKER_CLOSED for r in router.replicas)
        router.close()
    for n in lengths:
        assert results[("port", n)] == _reference(pair[2], [_prompt(n)], [max_new], pool)[0], n
        if n >= LATENTS:
            assert results[("port", n)] == results[("jax", n)], n


@pytest.mark.parametrize("phase", ["dispatch", "harvest"])
@pytest.mark.parametrize("pool", ["dense", "paged-fp", "paged-int4"])
def test_crash_failover_survivors_and_breaker_cycle(pair, pool, phase, tmp_path):
    """Four requests on two replicas; replica 0 crashes at its third tick,
    before its dispatch (both packages: the JSONL events, breaker
    transitions by tick included, equal the JAX router's) or between its
    dispatch and its harvest (the port's point: the half-tick's tokens never
    land, the probe's engine replays from known tokens). Every request
    equals the uninterrupted run, the survivors never fail over, and the
    breaker goes open, half-open, closed."""
    prompts = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (9, 40), (12, 7))]
    max_new = [6, 5, 7, 6]
    expected = _reference(pair[2], prompts, max_new, pool)
    got = {}
    for pkg in ("port", "jax") if phase == "dispatch" else ("port",):
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=2, num_slots=2, breaker_cooldown_ticks=2, metrics_jsonl=str(path),
                         **POOLS[pool])
        handles = [router.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
        point = "replica.crash" if phase == "dispatch" else "replica.crash.harvest"
        with _armed(pkg, point, slot=0, after=2, times=1):
            router.run_until_drained(max_steps=300)
        for _ in range(4):
            router.step()
        assert [h.result().tolist() for h in handles] == expected
        assert all(h.ok for h in handles)
        assert [h.failovers for h in handles] == [1, 0, 1, 0]
        snap = router.snapshot()
        assert _transitions(snap) == {"closed->open": 1, "open->half_open": 1, "half_open->closed": 1}
        assert snap["failovers"] == 2 and snap["replicas"]["r0"]["breaker"] == BREAKER_CLOSED
        assert "ReplicaCrashed" in snap["replicas"]["r0"]["last_error"]
        if pool != "dense":
            assert all(r.engine._pool.pages_in_use == 0 for r in router.replicas)
        router.close()
        got[pkg] = _events(path)
    breaker = [e for e in got["port"] if e["event"] == "breaker"]
    assert [(e["replica"], e["transition"]) for e in breaker] == [
        (0, "closed->open"), (0, "open->half_open"), (0, "half_open->closed")]
    assert breaker[1]["tick"] - breaker[0]["tick"] == 2
    failovers = [e for e in got["port"] if e["event"] == "failover"]
    assert [e["emitted_tokens"] for e in failovers] == [2, 2]  # the half-tick's token never landed
    if phase == "dispatch":
        assert got["port"] == got["jax"]
        # the JAX package reads the port's stream
        assert jax_load_metrics_jsonl(str(tmp_path / "port.jsonl"))["events"]


@pytest.mark.parametrize("pool", ["dense", "paged-int8"])
def test_a_harvest_failure_below_the_threshold_keeps_serving(pair, pool):
    """``failure_threshold=2``: one crash in a replica's harvest half is a
    strike, not an outage. The replica stays closed, its unharvested
    half-tick goes back to its queue, and every request (none failed over)
    finishes with the uninterrupted tokens."""
    prompts = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (9, 40), (12, 7))]
    expected = _reference(pair[2], prompts, [6] * 4, pool)
    router = ServingRouter(pair[2], num_replicas=2, num_slots=2, failure_threshold=2, **POOLS[pool])
    handles = [router.submit(p, max_new_tokens=6) for p in prompts]
    with armed("replica.crash.harvest", slot=0, after=2, times=1):
        router.run_until_drained(max_steps=300)
    r0 = router.replicas[0]
    assert r0.breaker == BREAKER_CLOSED and r0.consecutive_failures == 0 and "ReplicaCrashed" in r0.last_error
    assert [h.failovers for h in handles] == [0] * 4 and router.snapshot()["breaker_transitions"] == {}
    assert [h.result().tolist() for h in handles] == expected
    router.close()


def test_nan_containment_opens_the_breaker(pair, tmp_path):
    """A NaN containment on a replica with ``nan_failures_to_open=1`` opens
    its breaker at the harvest: the poisoned request ends FAILED, its
    healthy slot-mate fails over and finishes with the uninterrupted run's
    tokens; the events equal the JAX router's."""
    prompts = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (9, 40))]
    expected = _reference(pair[2], prompts, [8, 8, 8])
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=2, num_slots=2, nan_failures_to_open=1, breaker_cooldown_ticks=64,
                         metrics_jsonl=str(path))
        a, b, c = [router.submit(p, max_new_tokens=8) for p in prompts]
        router.step()
        r0 = router.replicas[a.replica]
        assert c.replica == a.replica != b.replica
        with _armed(pkg, "serving.nan", times=1):  # replica 0 ticks first
            router.step()
        assert a.status.value == "failed" and a.finish_reason == "nonfinite_logits"
        assert r0.breaker == BREAKER_OPEN and c.failovers == 1 and not c.done
        router.run_until_drained(max_steps=200)
        assert b.ok and c.ok
        assert [b.result().tolist(), c.result().tolist()] == expected[1:]
        assert a.result().tolist() == expected[0][:len(a.output_ids)]
        snap = router.snapshot()
        assert snap["replicas"]["r0"]["breaker"] == BREAKER_OPEN and snap["replicas"]["r0"]["nan_failures"] == 1
        assert _transitions(snap) == {"closed->open": 1} and snap["failed"] == 1
        router.close()
        got[pkg] = _events(path)
    assert got["port"] == got["jax"]


def test_failover_bounded_and_partial_output_kept(pair):
    """A request that keeps losing replicas ends FAILED after
    ``max_failovers`` re-dispatches with every token it emitted, a prefix of
    the uninterrupted run; ``output_ids`` never shrinks through the replay.
    The same as the JAX router."""
    prompt = _prompt(7)
    expected = _reference(pair[2], [prompt], [8])[0]
    got = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=1, max_failovers=1, breaker_cooldown_ticks=64)
        victim = router.submit(prompt, max_new_tokens=8)
        router.step()
        router.step()
        seen = len(victim.output_ids)
        with _armed(pkg, "replica.crash", slot=victim.replica, times=1):
            router.step()
        assert victim.failovers == 1 and not victim.done
        for _ in range(2):
            router.step()
            assert len(victim.output_ids) >= seen
            seen = len(victim.output_ids)
        before = list(victim.output_ids)
        with _armed(pkg, "replica.crash", slot=victim.replica, times=1):
            router.step()
        assert victim.status.value == "failed" and victim.finish_reason == "max_failovers"
        assert victim.failovers == 2 and victim.result().tolist() == before
        got[pkg] = before
        router.close()
    assert got["port"] == got["jax"] == expected[:len(got["port"])] and len(got["port"]) >= 3


def test_failover_parks_on_backpressure_not_rejected(pair):
    """A continuation is accepted work: with the survivor's queue at its
    bound it parks at the router (QUEUED) and finishes once a slot frees."""
    prompts = [_prompt(6), _prompt(7, 20)]
    expected = _reference(pair[2], prompts, [6, 8])
    got = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=1, max_queue_depth=0, breaker_cooldown_ticks=64)
        a = router.submit(prompts[0], max_new_tokens=6)
        b = router.submit(prompts[1], max_new_tokens=8)
        router.step()
        with _armed(pkg, "replica.crash", slot=a.replica, times=1):
            router.step()
        assert not a.done and a.failovers == 1 and a.status.value == "queued" and a.replica is None
        router.run_until_drained(max_steps=300)
        assert a.ok and b.ok
        got[pkg] = [a.result().tolist(), b.result().tolist()]
        router.close()
    assert got["port"] == got["jax"] == expected


def test_stall_opens_the_breaker_then_half_open_recovery(pair, tmp_path):
    """``replica.stall`` of 1 s against a 0.25 s threshold, twice: the
    slow-tick detector opens the breaker at the second strike (the victim
    fails over), the cooldown counts two ticks, the probe closes it, and the
    replica serves again. Breaker events by tick equal the JAX router's."""
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=2, num_slots=1, slow_tick_threshold_s=0.25, slow_ticks_to_open=2,
                         breaker_cooldown_ticks=2, metrics_jsonl=str(path))
        warm = [router.submit(_prompt(n), max_new_tokens=1) for n in (6, 7)]
        router.run_until_drained(max_steps=20)  # the JAX engines compile here (exempt ticks)
        assert all(h.ok for h in warm) and all(r.consecutive_slow == 0 for r in router.replicas)
        victim = router.submit(_prompt(6, 3), max_new_tokens=10)
        survivor = router.submit(_prompt(7, 20), max_new_tokens=10)
        router.step()
        r0 = router.replicas[victim.replica]
        with _armed(pkg, "replica.stall", slot=r0.rid, times=2, value=1.0):
            router.step()
            assert r0.breaker == BREAKER_CLOSED and r0.consecutive_slow == 1
            router.step()
        assert r0.breaker == BREAKER_OPEN and victim.failovers == 1 and not victim.done
        router.step()
        assert r0.breaker == BREAKER_OPEN
        router.step()
        assert r0.breaker in (BREAKER_HALF_OPEN, BREAKER_CLOSED)
        router.step()
        assert r0.breaker == BREAKER_CLOSED
        router.run_until_drained(max_steps=200)
        assert victim.ok and survivor.ok and len(victim.output_ids) == 10
        after = router.submit(_prompt(8), max_new_tokens=2)
        router.run_until_drained(max_steps=50)
        assert after.ok
        got[pkg] = ([victim.result().tolist(), survivor.result().tolist()],
                    [(e["replica"], e["transition"], e["tick"]) for e in _events(path) if e["event"] == "breaker"])
        router.close()
    assert got["port"] == got["jax"]
    assert [t for _r, t, _k in got["port"][1]] == ["closed->open", "open->half_open", "half_open->closed"]


def test_sampled_requests_fail_over_to_the_uninterrupted_tokens(pair):
    """Port against port: sampled requests (each with its seed) and a short
    prompt lose their replica mid-decode; the continuations restart their
    generators from the seed and replay, so every request's tokens equal an
    uninterrupted engine's."""
    prompts = [_prompt(n, s) for n, s in ((6, 3), (3, 20), (9, 40), (7, 7))]
    configs = [GenerationConfig(max_new_tokens=6, **SAMPLED) for _ in prompts]
    seeds = [11, 12, 13, 14]
    for pool in ("dense", "paged-int4"):
        expected = _reference(pair[2], prompts, [6] * 4, pool, configs, seeds)
        router = ServingRouter(pair[2], num_replicas=2, num_slots=2, **POOLS[pool])
        handles = [router.submit(p, config=c, seed=s) for p, c, s in zip(prompts, configs, seeds)]
        router.step()
        router.step()
        with armed("replica.crash", slot=0, times=1):
            router.run_until_drained(max_steps=300)
        assert [h.failovers for h in handles] == [1, 0, 1, 0]
        assert [h.result().tolist() for h in handles] == expected, pool
        router.close()


@pytest.mark.parametrize("pool", ["dense", "paged-fp", "paged-int4"])
def test_discard_pending_harvest_requeues_and_changes_no_token(pair, pool):
    """A dispatched half-tick dropped unharvested: its requests go back to
    the queue PREEMPTED with their known tokens (no replay-mux entry, no
    slot, no preemption spent, the cache lengths still pinned), and the
    engine stepped on gives every request the uninterrupted run's tokens,
    greedy and sampled."""
    tm = pair[2]
    prompts = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (9, 40))]
    configs = [GenerationConfig(max_new_tokens=6), GenerationConfig(max_new_tokens=5, **SAMPLED),
               GenerationConfig(max_new_tokens=6)]
    expected = _reference(tm, prompts, [6, 5, 6], pool, configs, [0, 7, 0])
    engine = ServingEngine(tm, num_slots=2, **POOLS[pool])
    handles = [engine.submit(p, config=c, seed=s) for p, c, s in zip(prompts, configs, [0, 7, 0])]
    engine.step()
    engine.step()
    assert engine.step_dispatch()
    running = [h for h in handles if h.status.value == "running"]
    engine.discard_pending_harvest()
    assert engine._pending_harvest is None and not engine._replay_slots
    assert engine.scheduler.active_slots == 0
    assert all(h.status.value == "preempted" and h.preemptions == 0 and h.replay_ids.size == 2
               for h in running)
    engine._check_pinned()
    engine.discard_pending_harvest()  # nothing pending: a no-op
    engine.run_until_drained(max_steps=200)
    assert [h.result().tolist() for h in handles] == expected
    if pool != "dense":
        assert engine._pool.pages_in_use == 0


# ----------------------------------------------------------------- shedding
def _prime(router, wait_s, prefill_s, step_s, samples):
    for r in router.replicas:
        m = r.engine.metrics
        for i in range(samples):
            m.record_submit(1000 + i, prompt_len=6)
            m.record_admit(1000 + i, slot=0, wait_s=wait_s, prefill_s=prefill_s)
            m.record_decode_step(active_slots=1, seconds=step_s, tokens=1)


def test_shed_infeasible_deadline_rejected_at_admission(pair, tmp_path):
    """After warm-up (primed latency windows) a deadline the estimate (p95
    queue wait + prefill + max_new x p95 decode step) cannot meet is
    REJECTED ``shed_infeasible`` at submit; a feasible one and one without a
    deadline finish. The shed event, its estimate included, equals the JAX
    router's."""
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=2, num_slots=1, shed_min_samples=1, metrics_jsonl=str(path))
        _prime(router, 0.5, 0.05, 0.2, 4)
        est = router.replicas[0].engine.metrics.latency_estimates()
        shed = router.submit(_prompt(6), max_new_tokens=10, deadline_s=0.5)
        assert shed.status.value == "rejected" and shed.finish_reason == "shed_infeasible"
        ok_deadline = router.submit(_prompt(6), max_new_tokens=1, deadline_s=60.0)
        ok_plain = router.submit(_prompt(7), max_new_tokens=2)
        router.run_until_drained(max_steps=100)
        assert ok_deadline.ok and ok_plain.ok
        snap = router.snapshot()
        assert snap["shed_infeasible"] == 1 and snap["rejected"] == 1
        got[pkg] = (est, [e for e in _events(path) if e["event"] in ("shed", "submit")])
        router.close()
    assert got["port"] == got["jax"]
    assert got["port"][1][1]["estimate_s"] == pytest.approx(0.5 + 0.05 + 10 * 0.2)


def test_shed_off_and_cold_fleet_never_sheds(pair):
    tm = pair[2]
    cold = ServingRouter(tm, num_replicas=1, num_slots=1)
    assert cold.replicas[0].engine.metrics.latency_estimates() is None
    h = cold.submit(_prompt(6), max_new_tokens=2, deadline_s=30.0)
    cold.run_until_drained(max_steps=50)
    assert h.ok
    cold.close()
    off = ServingRouter(tm, num_replicas=1, num_slots=1, shed_infeasible=False, shed_min_samples=1)
    _prime(off, 5.0, 0.5, 5.0, 1)
    h2 = off.submit(_prompt(6), max_new_tokens=2, deadline_s=1e-4)
    assert h2.finish_reason != "shed_infeasible"
    off.run_until_drained(max_steps=50)
    assert h2.status.value == "timed_out"
    off.close()
    below = ServingRouter(tm, num_replicas=1, num_slots=1, shed_min_samples=3)
    _prime(below, 5.0, 0.5, 5.0, 2)  # two decode steps: still cold
    h3 = below.submit(_prompt(6), max_new_tokens=2, deadline_s=30.0)
    below.run_until_drained(max_steps=50)
    assert h3.ok
    below.close()


# ------------------------------------------------------------ drain, signals
def test_drain_rejects_backlog_finishes_running(pair):
    tm = pair[2]
    router = ServingRouter(tm, num_replicas=2, num_slots=1)
    active = [router.submit(_prompt(6, s), max_new_tokens=4) for s in (3, 20)]
    assert all(h.status.value == "queued" for h in active)
    router.step()
    assert all(h.status.value == "running" for h in active)
    backlog = router.submit(_prompt(7), max_new_tokens=2)
    drained = router.drain(max_steps=100)
    assert all(h.ok and len(h.output_ids) == 4 for h in active)
    assert backlog.status.value == "rejected" and backlog.finish_reason == "draining"
    post = router.submit(_prompt(6), max_new_tokens=2)
    assert post.finish_reason == "draining"
    assert {h.request_id for h in drained} == {h.request_id for h in active} | {backlog.request_id}
    router.close()


def test_drain_finishes_a_parked_continuation(pair):
    """A continuation parked at the router is accepted work: a drain keeps
    it and it finishes once a replica frees, while a parked fresh submit is
    rejected."""
    tm = pair[2]
    prompts = [_prompt(6), _prompt(7, 20)]
    expected = _reference(tm, prompts, [6, 8])
    router = ServingRouter(tm, num_replicas=2, num_slots=1, max_queue_depth=0, breaker_cooldown_ticks=64)
    a = router.submit(prompts[0], max_new_tokens=6)
    b = router.submit(prompts[1], max_new_tokens=8)
    router.step()
    with armed("replica.crash", slot=a.replica, times=1):
        router.step()
    assert a.status.value == "queued" and a.replica is None
    router.drain(max_steps=300)
    assert [a.result().tolist(), b.result().tolist()] == expected and a.ok and b.ok
    router.close()


def test_sigterm_drains_and_flushes_the_metrics(pair, tmp_path):
    """SIGTERM closes admission at the next tick, rejects the backlog,
    finishes running work and writes the last snapshot (the handler is
    once-only); each replica writes its own engine stream."""
    tm = pair[2]
    prev = signal.getsignal(signal.SIGTERM)
    log = tmp_path / "router.jsonl"
    router = ServingRouter(tm, num_replicas=2, num_slots=1, handle_preemption=True, metrics_jsonl=str(log),
                           replica_metrics_jsonl=str(tmp_path / "eng.r{i}.jsonl"))
    active = [router.submit(_prompt(6, s), max_new_tokens=6) for s in (3, 20)]
    router.step()
    backlog = router.submit(_prompt(7), max_new_tokens=2)
    signal.raise_signal(signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) == prev
    drained = router.run_until_drained(max_steps=100)
    assert router.preempted and len(drained) == 3
    assert all(h.ok and len(h.output_ids) == 6 for h in active)
    assert backlog.finish_reason == "draining"
    assert router.submit(_prompt(6), max_new_tokens=1).finish_reason == "draining"
    got = load_metrics_jsonl(str(log))
    assert got["snapshots"] and got["snapshots"][-1]["requests_finished"] == 2
    assert jax_load_metrics_jsonl(str(log))["snapshots"][-1]["requests_finished"] == 2
    for i in range(2):
        assert any(e["event"] == "admit" for e in load_metrics_jsonl(str(tmp_path / f"eng.r{i}.jsonl"))["events"])
    router.close()  # idempotent after the flush


def test_expired_parked_continuation_keeps_its_tokens(pair, tmp_path):
    """A continuation parked through a whole-fleet outage expires TIMED_OUT
    with its salvaged tokens, on the handle and on the terminal event."""
    import time

    tm = pair[2]
    log = tmp_path / "router.jsonl"
    router = ServingRouter(tm, num_replicas=1, num_slots=1, breaker_cooldown_ticks=512, metrics_jsonl=str(log))
    victim = router.submit(_prompt(6), max_new_tokens=10, deadline_s=1.0)
    for _ in range(3):
        router.step()
    assert len(victim.output_ids) == 3
    with armed("replica.crash", slot=0, times=1):
        router.step()
    assert not victim.done and victim.status.value == "queued" and len(victim.output_ids) == 3
    stop = time.perf_counter() + 10.0
    while not victim.done and time.perf_counter() < stop:
        router.step()
        time.sleep(0.02)
    assert victim.status.value == "timed_out" and victim.finish_reason == "deadline"
    assert len(victim.result()) == 3
    finish = next(e for e in _events(log) if e["event"] == "finish" and e["request_id"] == victim.request_id)
    assert finish["status"] == "timed_out" and finish["new_tokens"] == 3
    router.close()


# ------------------------------------------------------- the engine surface
def test_engine_evict_request_status_and_queued_only(pair):
    """``evict_request(status=, queued_only=)`` as the JAX engine's: a
    queued request cancels as REJECTED, ``queued_only`` leaves a running
    one alone, a running one ends FAILED with its tokens, unknown and
    terminal ids give None; the counters equal the JAX engine's."""
    jm, params, tm = pair
    out = {}
    for pkg, engine in (("port", ServingEngine(tm, num_slots=1)), ("jax", JaxEngine(jm, params, num_slots=1))):
        running = engine.submit(_prompt(6), max_new_tokens=10)
        queued = engine.submit(_prompt(7, 20), max_new_tokens=4)
        engine.step()
        assert engine.evict_request(queued.request_id, "cancelled", status=type(queued.status).REJECTED) is queued
        assert queued.status.value == "rejected" and queued.finish_reason == "cancelled"
        assert engine.evict_request(running.request_id, queued_only=True) is None
        assert running.status.value == "running"
        assert engine.evict_request(running.request_id, "replica_failover") is running
        assert running.status.value == "failed" and len(running.output_ids) == 1
        assert engine.evict_request(running.request_id) is None and engine.evict_request(10_000) is None
        assert engine.scheduler.active_slots == 0 and engine.scheduler.queue_depth == 0
        snap = engine.metrics.snapshot()
        out[pkg] = (running.result().tolist(), snap["rejected"], snap["failed"], snap["requests_submitted"])
    assert out["port"] == out["jax"] and out["port"][1:3] == (1, 1)


def test_replicas_share_one_model_transformed_once(pair):
    """Under ``weight_dtype`` the first replica transforms the shared
    model's parameters and its siblings serve them as they stand: one set
    of served tensors, each replica reporting the float bytes, and tokens
    equal to a single engine over its own copy of the model."""
    tm = pair[2]
    prompts = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (9, 40))]
    for weight_dtype in ("bf16", "int8"):
        single = ServingEngine(copy.deepcopy(tm), num_slots=3, weight_dtype=weight_dtype)
        handles = [single.submit(p, max_new_tokens=4) for p in prompts]
        single.run_until_drained(max_steps=100)
        model = copy.deepcopy(tm)
        router = ServingRouter(model, num_replicas=2, num_slots=2, weight_dtype=weight_dtype)
        e0, e1 = (r.engine for r in router.replicas)
        assert e0.params is e1.params
        assert e0.metrics.weight_serving == e1.metrics.weight_serving == single.metrics.weight_serving
        routed = [router.submit(p, max_new_tokens=4) for p in prompts]
        router.run_until_drained(max_steps=100)
        assert [h.result().tolist() for h in routed] == [h.result().tolist() for h in handles], weight_dtype
        assert router.snapshot()["weight_serving"] is None
        router.close()


# ----------------------------------------------------------------- metrics
def test_router_metrics_jsonl_read_by_both_packages(tmp_path):
    """``RouterMetrics`` writes the JAX router's events and a v12 snapshot
    with replica sections; both packages' readers take the file, and a JAX
    router's stream reads back in the port."""
    from perceiver_io_torch.serving import EngineMetrics
    from perceiver_io_tpu.serving import RouterMetrics as JaxRouterMetrics

    files = {}
    for pkg, cls in (("port", RouterMetrics), ("jax", JaxRouterMetrics)):
        path = tmp_path / f"{pkg}.jsonl"
        rm = cls(num_replicas=2, jsonl_path=str(path))
        rm.record_submit(0, prompt_len=3, version=0)
        rm.record_dispatch(0, replica=1, load=-1)
        rm.record_failover(0, from_replica=1, emitted_tokens=2, failover_n=1)
        rm.record_breaker(1, "closed", "open", tick=5)
        rm.record_shed(1, deadline_s=0.5, estimate_s=2.5)
        rm.record_finish(0, "finished", "length", new_tokens=6, failovers=1, version=0)
        em = EngineMetrics(num_slots=2)
        em.record_decode_step(active_slots=1, seconds=0.1, tokens=1)
        rm.write_snapshot({"r0": em.snapshot(), "r1": EngineMetrics(num_slots=2).snapshot()})
        rm.close()
        files[pkg] = path
    strip = lambda got: [{k: v for k, v in e.items() if k != "ts"} for e in got["events"] if e["event"] != "snapshot"]
    port, jax = load_metrics_jsonl(str(files["port"])), jax_load_metrics_jsonl(str(files["port"]))
    assert strip(port) == strip(jax) == strip(load_metrics_jsonl(str(files["jax"])))
    snaps = [port["snapshots"][0], jax_load_metrics_jsonl(str(files["jax"]))["snapshots"][0]]
    for key in ("schema", "num_replicas", "requests_submitted", "requests_dispatched", "requests_finished",
                "failovers", "shed_infeasible", "breaker_transitions", "tokens_generated", "fleet_ops", "transport",
                "page_pool", "queue_wait_by_priority"):
        assert snaps[0][key] == snaps[1][key], key
    assert set(snaps[0]) == set(snaps[1]) and set(snaps[0]["replicas"]) == {"r0", "r1"}


def test_submit_validation_and_unported_options(pair, tmp_path):
    tm = pair[2]
    router = ServingRouter(tm, num_replicas=1, num_slots=1)
    with pytest.raises(ValueError, match="non-empty"):
        router.submit([])
    with pytest.raises(ValueError, match="beam"):
        router.submit(_prompt(6), config=GenerationConfig(max_new_tokens=2, num_beams=3))
    with pytest.raises(ValueError, match="config or keyword"):
        router.submit(_prompt(6), config=GenerationConfig(), max_new_tokens=2)
    too_long = router.submit(list(range(WINDOW + 1)), max_new_tokens=2)
    assert too_long.status.value == "rejected" and too_long.finish_reason == "prompt_too_long"
    router.close()
    with pytest.raises(ValueError, match="num_replicas"):
        ServingRouter(tm, num_replicas=0)
    with pytest.raises(ValueError, match="max_failovers"):
        ServingRouter(tm, max_failovers=-1)
    with pytest.raises(ValueError, match="replica_mode"):
        ServingRouter(tm, replica_mode="thread")
    # autoscale is ported: its knobs are validated as the JAX router's are
    with pytest.raises(ValueError, match="unknown autoscale knobs"):
        ServingRouter(tm, num_replicas=1, autoscale=dict(max_replicas=2, bogus=1))
    with pytest.raises(ValueError, match="min_replicas"):
        ServingRouter(tm, num_replicas=1, autoscale=dict(min_replicas=2, max_replicas=4))
    # telemetry is ported: a trace path knob writes a valid Chrome trace on close()
    trace = tmp_path / "t.json"
    router = ServingRouter(tm, num_replicas=2, num_slots=1, telemetry=str(trace))
    router.submit(_prompt(6), max_new_tokens=2)
    router.run_until_drained(max_steps=50)
    assert not trace.exists()
    router.close()
    loaded = load_chrome_trace(str(trace))
    assert validate_chrome_trace(loaded) == [] and jax_validate_chrome_trace(loaded) == []
    assert loaded["metadata"]["summary"]["phases"]["router.tick"]["count"] >= 2
