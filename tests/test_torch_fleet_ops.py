"""Port parity of the router's fleet operations: planned migration, the
rolling restart, versioned deploy and rollback, and autoscaling, against the
JAX router on the same converted weights, in float64 on the CPU.

Each case of ``tests/test_fleet_ops.py`` (its kill-switch test and its
``serve_bench`` smoke aside) runs here in both packages: greedy tokens,
failovers, breaker transitions, the fleet's counters and events equal the
JAX router's, and every request's tokens equal an uninterrupted single
engine's of its pinned version. Sampled requests are held port against port
(ROADMAP C11): a migrated sampled request restarts its generator from its
seed, so its tokens are the port's uninterrupted run's. Prompts are at least
``max_latents`` tokens, where the packages agree (C1). In-process replicas
of one version share its model, and a partial deploy leaves the replicas
still on version 0 with their weights (C14). The rolling restart and an
in-place flip also run over worker processes."""

import copy
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_support import SERVING, build_pair

from perceiver_io_torch.convert_jax import jax_params_to_state_dict
from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.reliability import FAULTS, KilledMidWrite, armed
from perceiver_io_torch.serving import (BREAKER_CLOSED, BREAKER_OPEN, RouterMetrics, ServingEngine, ServingRouter,
                                        load_metrics_jsonl, read_journal)
from perceiver_io_tpu.reliability import FAULTS as JAX_FAULTS
from perceiver_io_tpu.reliability import armed as jax_armed
from perceiver_io_tpu.reliability.faults import KilledMidWrite as JaxKilledMidWrite
from perceiver_io_tpu.serving import RouterMetrics as JaxRouterMetrics
from perceiver_io_tpu.serving import ServingEngine as JaxEngine
from perceiver_io_tpu.serving import ServingRouter as JaxRouter
from perceiver_io_tpu.serving import load_metrics_jsonl as jax_load_metrics_jsonl

WINDOW, LATENTS = SERVING["max_seq_len"], SERVING["max_latents"]
PAGE = 2
POOLS = {"dense": {}, "paged-fp": dict(kv_page_size=PAGE), "paged-int4": dict(kv_page_size=PAGE, kv_quant="int4")}
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
SPIKE = 47  # the variant version's output bias dominates the argmax at this token
# worker processes: one thread each (two a router under six test processes)
T = dict(num_threads=1, rpc_timeout_s=30.0)


def _prompt(n, start=3):
    return [(start + i) % 63 + 1 for i in range(n)]


PROMPTS = [_prompt(n, s) for n, s in ((6, 3), (7, 20), (9, 40), (8, 7), (6, 30), (7, 50))]


@pytest.fixture(scope="module")
def pair(x64):
    return build_pair(SERVING)


@pytest.fixture(scope="module")
def variant(pair):
    """A second version of the same layout whose greedy tokens differ
    visibly (its output bias spiked at one token): the JAX tree and the
    port's state_dict."""
    params = pair[1]
    out = jax.tree_util.tree_map(lambda x: x, params)
    out["params"]["output_adapter"]["bias"] = params["params"]["output_adapter"]["bias"].at[SPIKE].add(100.0)
    return out, jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, out))


@pytest.fixture(autouse=True)
def _fault_isolation():
    """No arming leaks between tests (both registries are process-wide)."""
    FAULTS.reset()
    JAX_FAULTS.reset()
    yield
    FAULTS.reset()
    JAX_FAULTS.reset()


def _router(pair, pkg, **kw):
    jm, params, tm = pair
    return ServingRouter(tm, **kw) if pkg == "port" else JaxRouter(jm, params, **kw)


def _armed(pkg, point, **kw):
    return (armed if pkg == "port" else jax_armed)(point, **kw)


def _version_model(tm, state_dict):
    model = copy.deepcopy(tm)
    model.load_state_dict(state_dict)
    return model


def _reference(model, prompts, max_new, pool="dense", configs=None, seeds=None, **engine_kw):
    """An uninterrupted single port engine's tokens."""
    engine = ServingEngine(model, num_slots=len(prompts), **POOLS[pool], **engine_kw)
    handles = [engine.submit(p, config=configs[i] if configs else GenerationConfig(max_new_tokens=m),
                             seed=seeds[i] if seeds else 0) for i, (p, m) in enumerate(zip(prompts, max_new))]
    engine.run_until_drained(max_steps=500)
    assert all(h.ok for h in handles)
    return [h.result().tolist() for h in handles]


def _events(path, kinds, load=load_metrics_jsonl):
    return [{k: v for k, v in e.items() if k != "ts"} for e in load(str(path))["events"] if e["event"] in kinds]


def _accounted(snap):
    return snap["requests_submitted"] == (snap["requests_finished"] + snap["rejected"] + snap["timed_out"]
                                          + snap["failed"])


# ---------------------------------------------------------------- migration
@pytest.mark.parametrize("pool", list(POOLS))
def test_migrate_token_identity_greedy(pair, pool, tmp_path):
    """Every live session migrated to the other replica mid-decode: the
    tokens equal the JAX router's and an unmigrated engine's, no failover is
    spent, no breaker moves, and the ``migrate`` events and the snapshot's
    ``fleet_ops`` equal the JAX router's."""
    prompts = PROMPTS[:4]
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=2, num_slots=2, metrics_jsonl=str(path), **POOLS[pool])
        handles = [router.submit(p, max_new_tokens=6) for p in prompts]
        router.step()
        router.step()
        emitted = [len(h.output_ids) for h in handles]
        moved = [router.migrate(h.request_id, 1 - h.replica) for h in handles]
        router.run_until_drained(max_steps=300)
        snap = router.snapshot()
        router.close()
        got[pkg] = dict(tokens=[h.result().tolist() for h in handles], emitted=emitted, moved=moved,
                        failovers=[h.failovers for h in handles], fleet=snap["fleet_ops"],
                        breaker=snap["breaker_transitions"], events=_events(path, {"migrate"}))
    port, jax_ = got["port"], got["jax"]
    assert port["tokens"] == jax_["tokens"] == _reference(pair[2], prompts, [6] * 4, pool)
    assert port["moved"] == jax_["moved"] == [True] * 4 and min(port["emitted"]) > 0
    assert port["failovers"] == [0] * 4 and port["breaker"] == {}
    assert port["fleet"] == jax_["fleet"] and port["fleet"]["migrations"] == 4
    assert port["events"] == jax_["events"] and len(port["events"]) == 4


def test_migrate_sampled_keeps_the_uninterrupted_tokens(pair):
    """Port against port (C11): migrated sampled requests restart their
    generators from their seeds and replay, so their tokens equal an
    uninterrupted engine's; no failover spent."""
    tm = pair[2]
    prompts = PROMPTS[:3]
    configs = [GenerationConfig(max_new_tokens=6, **SAMPLED) for _ in prompts]
    seeds = [7, 8, 9]
    expected = _reference(tm, prompts, [6] * 3, configs=configs, seeds=seeds)
    router = ServingRouter(tm, num_replicas=2, num_slots=2)
    handles = [router.submit(p, config=c, seed=s) for p, c, s in zip(prompts, configs, seeds)]
    router.step()
    router.step()
    assert all(router.migrate(h.request_id, 1 - h.replica) for h in handles)
    router.run_until_drained(max_steps=300)
    assert [h.result().tolist() for h in handles] == expected
    assert [h.failovers for h in handles] == [0, 0, 0] and router.snapshot()["fleet_ops"]["migrations"] == 3
    router.close()


def test_migrate_validation_refusal_and_repeat(pair):
    """Malformed migrations raise (a bad index, an unknown request, a
    destination whose breaker is open); migrating to the current replica is
    a no-op; a destination at its queue bound refuses and the session is
    re-homed without loss, as in the JAX router."""
    got = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=1, max_queue_depth=0, breaker_cooldown_ticks=1)
        a = router.submit(PROMPTS[0], max_new_tokens=6)
        b = router.submit(PROMPTS[1], max_new_tokens=6)
        router.step()
        with pytest.raises(ValueError, match="unknown replica"):
            router.migrate(a.request_id, 5)
        with pytest.raises(ValueError, match="unknown or terminal"):
            router.migrate(10_000, 0)
        assert router.migrate(a.request_id, a.replica) is True
        landed = router.migrate(a.request_id, b.replica)
        assert not a.done
        router.run_until_drained(max_steps=300)
        with pytest.raises(ValueError, match="unknown or terminal"):
            router.migrate(a.request_id, 0)
        c = router.submit(PROMPTS[2], max_new_tokens=4)
        with _armed(pkg, "replica.crash", slot=1, times=1):
            router.step()
        assert router.replicas[1].breaker == BREAKER_OPEN
        with pytest.raises(ValueError, match="not serving"):
            router.migrate(c.request_id, 1)
        router.run_until_drained(max_steps=300)
        snap = router.snapshot()
        router.close()
        got[pkg] = dict(landed=landed, tokens=[h.result().tolist() for h in (a, b, c)],
                        ok=[h.ok for h in (a, b, c)], migrations=snap["fleet_ops"]["migrations"],
                        failovers=snap["failovers"])
    assert got["port"] == got["jax"]
    assert got["port"]["ok"] == [True] * 3
    assert got["port"]["tokens"] == _reference(pair[2], PROMPTS[:3], [6, 6, 4])


def test_migrate_journal_exactly_once_and_the_kill_window(pair, tmp_path):
    """After a clean migration the origin's journal entry is closed and the
    destination's live (one durable copy). ``router.migrate.kill`` between
    the destination's accept and the origin's close leaves the session live
    in both journals; ``recover`` dedupes it to one, whose tokens are the
    unmigrated run's, in both packages."""
    jm, params, tm = pair
    expected = _reference(tm, PROMPTS[:1], [6])[0]
    got = {}
    for pkg in ("port", "jax"):
        template = str(tmp_path / pkg / "clean" / "r{i}")
        router = _router(pair, pkg, num_replicas=2, num_slots=1, journal=template)
        victim = router.submit(PROMPTS[0], max_new_tokens=6)
        router.step()
        router.step()
        src = victim.replica
        assert router.migrate(victim.request_id, 1 - src)
        live = [len(read_journal(template.format(i=i)).sessions) for i in (src, 1 - src)]
        router.run_until_drained(max_steps=300)
        clean = victim.result().tolist()
        router.close()

        template = str(tmp_path / pkg / "kill" / "r{i}")
        router = _router(pair, pkg, num_replicas=2, num_slots=1, journal=template)
        victim = router.submit(PROMPTS[0], max_new_tokens=6)
        router.step()
        router.step()
        with _armed(pkg, "router.migrate.kill", times=1):
            with pytest.raises(KilledMidWrite if pkg == "port" else JaxKilledMidWrite):
                router.migrate(victim.request_id, 1 - victim.replica)
        both = [len(read_journal(template.format(i=i)).sessions) for i in range(2)]
        # the process dies here: the router is abandoned, the fleet recovered
        if pkg == "port":
            router2, info = ServingRouter.recover(tm, template, num_replicas=2, num_slots=1)
        else:
            router2, info = JaxRouter.recover(jm, params, template, num_replicas=2, num_slots=1)
        router2.run_until_drained(max_steps=300)
        got[pkg] = dict(live=live, clean=clean, both=both, sessions=info["sessions"], deduped=info["deduped"],
                        recovered=info["handles"][0].result().tolist(), ok=info["handles"][0].ok)
        router2.close()
    assert got["port"] == got["jax"]
    assert got["port"]["live"] == [0, 1] and got["port"]["both"] == [1, 1]
    assert got["port"]["clean"] == got["port"]["recovered"] == expected
    assert got["port"]["sessions"] == 1 and got["port"]["deduped"] == 1 and got["port"]["ok"]


# ---------------------------------------------------------- rolling restart
@pytest.mark.parametrize("pool", ["dense", "paged-fp"])
def test_rolling_restart_under_load_token_identity(pair, pool, tmp_path):
    """A rolling restart while requests keep arriving rebuilds every
    replica through its journal (fresh engines, a new journal generation)
    with no session lost or served twice, no breaker transition, and the
    JAX router's tokens and ``recycle`` events."""
    prompts = PROMPTS
    got = {}
    for pkg in ("port", "jax"):
        template = str(tmp_path / pkg / "r{i}")
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=2, num_slots=2, journal=template, metrics_jsonl=str(path),
                         **POOLS[pool])
        handles = [router.submit(p, max_new_tokens=6) for p in prompts[:3]]
        router.step()
        router.step()
        engines = [r.engine for r in router.replicas]
        assert router.begin_rolling_restart()
        i, steps = 3, 0
        while router.restart_in_progress:
            if i < len(prompts):
                handles.append(router.submit(prompts[i], max_new_tokens=6))
                i += 1
            router.step()
            steps += 1
            assert steps < 100
        rebuilt = all(r.engine is not e for r, e in zip(router.replicas, engines))
        handles += [router.submit(p, max_new_tokens=6) for p in prompts[i:]]
        router.run_until_drained(max_steps=500)
        snap = router.snapshot()
        router.close()
        journals = [read_journal(template.format(i=k)) for k in range(2)]
        got[pkg] = dict(tokens=[h.result().tolist() for h in handles], ok=all(h.ok for h in handles),
                        rebuilt=rebuilt, steps=steps, recycles=snap["fleet_ops"]["recycles"],
                        breaker=snap["breaker_transitions"], accounted=_accounted(snap),
                        submitted=snap["requests_submitted"], live=[len(j.sessions) for j in journals],
                        generations=[j.generation >= 2 for j in journals],
                        events=_events(path, {"recycle"}))
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["tokens"] == _reference(pair[2], prompts, [6] * len(prompts), pool)
    assert port["ok"] and port["rebuilt"] and port["recycles"] == 2 and port["breaker"] == {}
    assert port["accounted"] and port["submitted"] == len(prompts)
    assert port["live"] == [0, 0] and port["generations"] == [True, True]


def test_mid_recycle_replica_treated_as_open_no_strike_cascade(pair):
    """A recycling replica reads as OPEN: it holds no session, takes no
    work and is not ticked, and under a tight slow-tick threshold the
    restart trips no breaker, its own or a sibling's."""
    tm = pair[2]
    expected = _reference(tm, PROMPTS[:2], [6, 6])
    # warm: a process's first prefill at each length is slow on the CPU
    # (the JAX router exempts such ticks as compiles), and a session moved
    # by the restart replays its prompt and tokens at a length of its own
    _reference(tm, [_prompt(n) for n in range(LATENTS, WINDOW + 1)], [1] * (WINDOW + 1 - LATENTS))
    router = ServingRouter(tm, num_replicas=2, num_slots=1, slow_tick_threshold_s=0.2, slow_ticks_to_open=1)
    warm = [router.submit(PROMPTS[i], max_new_tokens=6) for i in range(2)]
    router.run_until_drained(max_steps=30)
    assert all(h.ok for h in warm) and router.snapshot()["breaker_transitions"] == {}
    handles = [router.submit(PROMPTS[i], max_new_tokens=6) for i in range(2)]
    router.step()
    assert router.begin_rolling_restart()
    saw_recycling, steps = False, 0
    while router.restart_in_progress:
        for r in router.replicas:
            if r.recycling:
                saw_recycling = True
                assert not r.assigned and r not in router._serving_replicas()
        router.step()
        steps += 1
        assert steps < 100
    assert saw_recycling
    router.run_until_drained(max_steps=300)
    assert [h.result().tolist() for h in handles] == expected
    snap = router.snapshot()
    assert snap["breaker_transitions"] == {}
    assert all(r.breaker == BREAKER_CLOSED and r.consecutive_slow == 0 for r in router.replicas)
    router.close()


# ------------------------------------------------------- drain parked seam
@pytest.mark.parametrize("cause", ["crash", "recycle"])
def test_router_drain_finishes_parked_continuations(pair, cause):
    """A continuation parked at the router (its sibling's queue at its
    bound), after a crash's failover or a recycle's drain, is accepted
    work: ``drain()`` finishes it with the uninterrupted tokens and rejects
    only a fresh submit, as the JAX router does."""
    got = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=1, max_queue_depth=0, breaker_cooldown_ticks=64)
        a = router.submit(PROMPTS[0], max_new_tokens=6)
        b = router.submit(PROMPTS[1], max_new_tokens=8)
        router.step()
        if cause == "crash":
            with _armed(pkg, "replica.crash", slot=a.replica, times=1):
                router.step()
        else:
            assert router.begin_rolling_restart()
            router.step()  # replica 0 starts its recycle: its session parks
        parked = a.status.value if a.replica is None else b.status.value
        drained = router.drain(max_steps=300)
        post = router.submit(PROMPTS[2], max_new_tokens=2)
        got[pkg] = dict(parked=parked, tokens=[a.result().tolist(), b.result().tolist()], ok=[a.ok, b.ok],
                        drained=sorted(h.request_id for h in drained), post=post.finish_reason,
                        failovers=[a.failovers, b.failovers])
        router.close()
    assert got["port"] == got["jax"]
    assert got["port"]["parked"] == "queued" and got["port"]["ok"] == [True, True]
    assert got["port"]["tokens"] == _reference(pair[2], PROMPTS[:2], [6, 8])
    assert got["port"]["post"] == "draining"


# ------------------------------------------------------------------ rollout
def test_deploy_rollout_pins_rollback_and_metrics(pair, variant, tmp_path):
    """``deploy(fraction=0.5)`` flips the last replica and splits new
    admissions by the submit count; each session decodes under its pinned
    version alone; the rollout table, the ``deploy`` and ``rollback``
    events and the replicas' versions equal the JAX router's; rollback pins
    new admissions to version 0 at once and the flipped replica flips back
    once empty."""
    jm, params, tm = pair
    jax_v1, sd1 = variant
    p = PROMPTS[0]
    r0 = _reference(tm, [p], [5])[0]
    r1 = _reference(_version_model(tm, sd1), [p], [5])[0]
    assert r0 != r1
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=2, num_slots=2, metrics_jsonl=str(path))
        v1 = router.deploy(sd1 if pkg == "port" else jax_v1, fraction=0.5)
        router.step()  # the targeted (empty) replica flips
        flipped = [r.version for r in router.replicas]
        a = router.submit(p, max_new_tokens=5)
        b = router.submit(p, max_new_tokens=5)
        router.run_until_drained(max_steps=200)
        rollout = router.snapshot()["fleet_ops"]["rollout"]
        assert router.rollback()
        c = router.submit(p, max_new_tokens=5)
        router.run_until_drained(max_steps=200)
        for _ in range(3):
            router.step()
        snap = router.write_snapshot()
        router.close()
        got[pkg] = dict(v1=v1, flipped=flipped, pins=[a.version, b.version, c.version],
                        tokens=[h.result().tolist() for h in (a, b, c)], rollout=rollout,
                        after=[(r.version, r.target_version) for r in router.replicas],
                        replica_versions=[(s["version"], s["target_version"]) for s in snap["replicas"].values()],
                        events=_events(path, {"deploy", "rollback"}),
                        finish_versions=[e["version"] for e in _events(path, {"finish"})])
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["v1"] == 1 and port["flipped"] == [0, 1] and port["pins"] == [0, 1, 0]
    assert port["tokens"] == [r0, r1, r0]
    assert port["rollout"]["rollout_version"] == 1 and port["rollout"]["fraction"] == 0.5
    assert port["rollout"]["versions"]["1"] == {"submitted": 1, "finished": 1, "tokens_generated": 5}
    assert port["after"] == [(0, 0), (0, 0)]
    port_events = {e["event"] for e in load_metrics_jsonl(str(tmp_path / "jax.jsonl"))["events"]}
    jax_events = {e["event"] for e in jax_load_metrics_jsonl(str(tmp_path / "port.jsonl"))["events"]}
    assert {"deploy", "rollback", "submit", "finish", "snapshot"} <= port_events & jax_events


def test_version_flip_invalidates_prefix_cache(pair, variant):
    """``set_params`` starts the prefix cache cold: its pages hold KV of the
    old weights, so a prompt of the new version sharing a cached preamble
    decodes the new version's tokens, as the JAX engine's does."""
    jm, params, tm = pair
    jax_v1, sd1 = variant
    preamble = [7] * 9
    p_a, p_b = preamble + [1], preamble + [2]
    got = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            engine = ServingEngine(copy.deepcopy(tm), num_slots=2, kv_page_size=2, prefix_cache=True)
        else:
            engine = JaxEngine(jm, params, num_slots=2, kv_page_size=2, prefix_cache=True)
        donor = engine.submit(p_a, max_new_tokens=2)
        engine.run_until_drained(max_steps=200)
        cached = engine._prefix_cache.stats()["cached_pages"]
        engine.set_params(sd1 if pkg == "port" else jax_v1)
        cold = engine._prefix_cache.stats()["cached_pages"]
        h = engine.submit(p_b, max_new_tokens=2)
        engine.run_until_drained(max_steps=200)
        got[pkg] = dict(ok=[donor.ok, h.ok], cached=cached > 0, cold=cold, tokens=h.result().tolist())
        engine.close()
    assert got["port"] == got["jax"]
    assert got["port"]["cold"] == 0 and got["port"]["cached"]
    assert got["port"]["tokens"] == _reference(_version_model(tm, sd1), [p_b], [2])[0]


def test_full_rollout_promotes_primary(pair, variant):
    """A fraction-1.0 deploy becomes the primary once every replica has
    flipped: new admissions pin it, and rollback has nothing to roll back."""
    tm = pair[2]
    jax_v1, sd1 = variant
    got = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=1)
        v1 = router.deploy(sd1 if pkg == "port" else jax_v1, fraction=1.0)
        for _ in range(3):
            router.step()
        flipped = [r.version for r in router.replicas]
        primary, rolled_back = router._primary_version, router.rollback()
        h = router.submit(PROMPTS[0], max_new_tokens=4)
        router.run_until_drained(max_steps=200)
        got[pkg] = dict(v1=v1, flipped=flipped, primary=primary, rolled_back=rolled_back, pin=h.version,
                        tokens=h.result().tolist(), versions=sorted(router._versions),
                        rollout=router.snapshot()["fleet_ops"]["rollout"])
        router.close()
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["flipped"] == [1, 1] and port["primary"] == 1 and port["rolled_back"] is False
    assert port["pin"] == 1 and port["versions"] == [1]
    assert port["tokens"] == _reference(_version_model(tm, sd1), PROMPTS[:1], [4])[0]


def test_migrate_respects_version_pin(pair, variant):
    """A migration to a replica serving another version than the session's
    pin raises; the session finishes where it is, with its version's
    tokens."""
    jax_v1, sd1 = variant
    got = {}
    for pkg in ("port", "jax"):
        router = _router(pair, pkg, num_replicas=2, num_slots=2)
        router.deploy(sd1 if pkg == "port" else jax_v1, fraction=0.5)
        router.step()
        a = router.submit(PROMPTS[0], max_new_tokens=6)
        router.step()
        assert a.version == 0 and router.replicas[a.replica].version == 0
        other = next(r.rid for r in router.replicas if r.version == 1)
        with pytest.raises(ValueError, match="version pin"):
            router.migrate(a.request_id, other)
        router.run_until_drained(max_steps=200)
        got[pkg] = (a.ok, a.replica, a.result().tolist())
        router.close()
    assert got["port"] == got["jax"]
    assert got["port"][2] == _reference(pair[2], PROMPTS[:1], [6])[0]


def test_in_process_partial_deploy_leaves_version_0_weights(pair, variant):
    """In-process replicas share one model a version (ROADMAP C14): after a
    partial deploy the flipped replica serves a model of its own, built for
    version 1, while the replica still on version 0 keeps its engine, the
    caller's model and its weights, and decodes version 0's tokens. Under
    int8 weights too, on a copy of the model."""
    tm = pair[2]
    sd1 = variant[1]
    prompts = PROMPTS[:4]
    for weight_dtype in (None, "int8"):
        model = copy.deepcopy(tm)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        r0 = _reference(copy.deepcopy(tm), prompts, [5] * 4, weight_dtype=weight_dtype)
        r1 = _reference(_version_model(tm, sd1), prompts, [5] * 4, weight_dtype=weight_dtype)
        router = ServingRouter(model, num_replicas=2, num_slots=2, weight_dtype=weight_dtype)
        e0 = router.replicas[0].engine
        served0 = {k: (v.clone() if isinstance(v, torch.Tensor) else v.q.clone()) for k, v in e0.params.items()}
        router.deploy(sd1, fraction=0.5)
        router.step()
        assert [r.version for r in router.replicas] == [0, 1]
        assert router.replicas[0].engine is e0 and router.replicas[1].engine.model is not model
        handles = [router.submit(p, max_new_tokens=5) for p in prompts]
        router.run_until_drained(max_steps=200)
        assert [h.version for h in handles] == [0, 1, 0, 1]
        assert [h.replica for h in handles] == [0, 1, 0, 1]
        assert [h.result().tolist() for h in handles] == [r0[0], r1[1], r0[2], r1[3]], weight_dtype
        for k, v in e0.params.items():
            assert torch.equal(v if isinstance(v, torch.Tensor) else v.q, served0[k]), k
        if weight_dtype is None:
            assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        router.close()


def test_deploy_refuses_another_layout(pair, variant):
    """The layout gate runs at ``deploy``: another name set, shape or dtype
    raises there, and no version is registered."""
    tm = pair[2]
    sd1 = variant[1]
    router = ServingRouter(tm, num_replicas=2, num_slots=1)
    name = next(iter(sd1))
    for bad in ({k: v for k, v in sd1.items() if k != name}, {**sd1, name: sd1[name].float()},
                {**sd1, name: sd1[name][..., :1]}):
        with pytest.raises(ValueError, match="names, shapes and dtypes"):
            router.deploy(bad, fraction=0.5)
    with pytest.raises(ValueError, match="fraction"):
        router.deploy(sd1, fraction=1.5)
    assert sorted(router._versions) == [0] and router._rollout is None
    router.close()


# ---------------------------------------------------------------- autoscale
@pytest.mark.parametrize("pool", ["dense", "paged-int4"])
def test_autoscale_up_down_zero_lost(pair, pool, tmp_path):
    """The controller grows the fleet under a backlog and retires replicas
    through the recycle's drain when idle: every session finishes with the
    uninterrupted tokens, none lost, and the ``autoscale`` events and the
    counters equal the JAX router's."""
    prompts = PROMPTS + PROMPTS[:2]
    got = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        router = _router(pair, pkg, num_replicas=1, num_slots=1, metrics_jsonl=str(path), **POOLS[pool],
                         autoscale=dict(min_replicas=1, max_replicas=3, scale_up_load=2, scale_down_load=0,
                                        every_ticks=2, patience=1))
        handles = [router.submit(p, max_new_tokens=6) for p in prompts]
        seen = set()
        while router.step():
            seen.add(sum(not r.retired and not r.recycling for r in router.replicas))
        for _ in range(30):
            router.step()
        snap = router.snapshot()
        router.close()
        fleet = snap["fleet_ops"]
        got[pkg] = dict(tokens=[h.result().tolist() for h in handles], ok=all(h.ok for h in handles),
                        peak=max(seen), ups=fleet["scale_ups"], downs=fleet["scale_downs"],
                        active=fleet["replicas_active"], accounted=_accounted(snap),
                        events=_events(path, {"autoscale"}), retired=[r.retired for r in router.replicas])
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["tokens"] == _reference(pair[2], prompts, [6] * len(prompts), pool)
    assert port["ok"] and port["peak"] > 1 and port["ups"] >= 1 and port["downs"] >= 1
    assert port["active"] == 1 and port["accounted"]


def test_autoscale_knob_validation(pair, tmp_path):
    tm = pair[2]
    with pytest.raises(ValueError, match="min_replicas"):
        ServingRouter(tm, num_replicas=1, autoscale=dict(min_replicas=2, max_replicas=4))
    with pytest.raises(ValueError, match="unknown autoscale"):
        ServingRouter(tm, num_replicas=1, autoscale=dict(max_replicas=2, bogus=1))
    flat = tmp_path / "flat-journal"
    with pytest.raises(ValueError, match="template"):
        ServingRouter(tm, num_replicas=1, journal=str(flat), autoscale=dict(max_replicas=2))
    assert not flat.exists() and not (tmp_path / "flat-journal-router").exists()
    router = ServingRouter(tm, num_replicas=2, num_slots=1, autoscale=dict(max_replicas=3))
    assert router._autoscale == dict(min_replicas=1, max_replicas=3, scale_up_load=1, scale_down_load=0,
                                     every_ticks=8, patience=2)
    router.close()


# ----------------------------------------------------------------- recovery
def test_recover_takes_the_versions_the_journals_pin(pair, variant, tmp_path):
    """A fleet that deployed version 1 dies mid-decode; ``recover`` given
    ``versions={1: ...}`` serves each replica's sessions at their pin, with
    each version's tokens, as the JAX router does. Without the version it
    raises a ``ValueError`` naming it."""
    jm, params, tm = pair
    jax_v1, sd1 = variant
    prompts = PROMPTS[:4]
    got = {}
    for pkg in ("port", "jax"):
        template = str(tmp_path / pkg / "r{i}")
        router = _router(pair, pkg, num_replicas=2, num_slots=2, journal=template)
        router.deploy(sd1 if pkg == "port" else jax_v1, fraction=0.5)
        router.step()
        handles = [router.submit(p, max_new_tokens=6) for p in prompts]
        router.step()
        router.step()
        pins = [h.version for h in handles]
        # the process dies: the router is abandoned
        if pkg == "port":
            with pytest.raises(ValueError, match=r"versions=\{1"):
                ServingRouter.recover(tm, template, num_replicas=2, num_slots=2)
            router2, info = ServingRouter.recover(tm, template, num_replicas=2, num_slots=2, versions={1: sd1})
        else:
            router2, info = JaxRouter.recover(jm, params, template, num_replicas=2, num_slots=2,
                                              versions={1: jax_v1})
        router2.run_until_drained(max_steps=300)
        by_session = {h.session_id.rsplit(":", 1)[1]: h for h in info["handles"]}
        got[pkg] = dict(pins=pins, sessions=info["sessions"],
                        recovered={k: (h.version, h.result().tolist()) for k, h in sorted(by_session.items())},
                        versions=[r.version for r in router2.replicas])
        router2.close()
    assert got["port"] == got["jax"]
    port = got["port"]
    r0 = _reference(tm, prompts, [6] * 4)
    r1 = _reference(_version_model(tm, sd1), prompts, [6] * 4)
    assert port["pins"] == [0, 1, 0, 1] and port["sessions"] == 4 and port["versions"] == [0, 1]
    assert port["recovered"] == {str(i): (v, (r1 if v else r0)[i]) for i, v in enumerate(port["pins"])}


# ------------------------------------------------------------------ metrics
def test_fleet_metrics_jsonl_read_by_both_packages(tmp_path):
    """``RouterMetrics`` writes the JAX router's fleet events (``migrate``,
    ``recycle``, ``deploy``, ``autoscale``, ``rollback``) and its
    ``fleet_ops`` section with the rollout's ``versions`` table; each
    package's reader takes the other's file, and an engine's snapshot has
    no fleet section."""
    from perceiver_io_torch.serving import EngineMetrics

    files = {}
    for pkg, cls in (("port", RouterMetrics), ("jax", JaxRouterMetrics)):
        path = tmp_path / f"{pkg}.jsonl"
        rm = cls(num_replicas=2, jsonl_path=str(path))
        rm.record_submit(0, prompt_len=3, version=0)
        rm.record_migration(0, src=0, dst=1, emitted_tokens=2)
        rm.record_recycle(0, sessions_moved=1, leftover_sessions=0, tick=7)
        rm.record_deploy(1, fraction=0.25, target_replicas=[1])
        rm.set_fleet_gauges(2, True, 0)
        rm.record_autoscale("up", 2, active=3, load=5, tick=8)
        rm.record_autoscale("down", 2, active=2, load=0, tick=16)
        rm.record_rollback(1, 0)
        rm.record_submit(1, prompt_len=4, version=1)
        rm.record_finish(0, "finished", "length", new_tokens=6, failovers=0, version=0)
        rm.record_finish(1, "timed_out", "deadline", new_tokens=2, failovers=0, version=1)
        rm.write_snapshot({"r0": EngineMetrics(num_slots=2).snapshot()})
        rm.close()
        files[pkg] = path
    strip = lambda got: [{k: v for k, v in e.items() if k != "ts"} for e in got["events"] if e["event"] != "snapshot"]
    port, jax_ = load_metrics_jsonl(str(files["port"])), jax_load_metrics_jsonl(str(files["port"]))
    assert strip(port) == strip(jax_) == strip(load_metrics_jsonl(str(files["jax"])))
    snaps = [port["snapshots"][0], jax_load_metrics_jsonl(str(files["jax"]))["snapshots"][0]]
    assert snaps[0]["fleet_ops"] == snaps[1]["fleet_ops"]
    fleet = snaps[0]["fleet_ops"]
    assert (fleet["migrations"], fleet["recycles"], fleet["scale_ups"], fleet["scale_downs"]) == (1, 1, 1, 1)
    assert fleet["replicas_active"] == 2 and fleet["restart_in_progress"] is True
    assert fleet["rollout"] == {"rollout_version": 1, "fraction": 0.25, "primary_version": 0, "versions": {
        "0": {"submitted": 1, "finished": 1, "tokens_generated": 6},
        "1": {"submitted": 1, "finished": 0, "tokens_generated": 2}}}
    assert snaps[0]["replicas"]["r0"]["fleet_ops"] is None


# ---------------------------------------------------------- worker processes
def test_rolling_restart_over_worker_processes(pair, tmp_path):
    """The rolling restart over worker processes: each replica's worker is
    replaced by a fresh one built through its journal, the sessions it held
    move to the sibling or park and come back, and every request's tokens
    are an uninterrupted engine's; no breaker transition, no failover, both
    workers alive, the replaced workers' counters kept."""
    tm = pair[2]
    prompts = PROMPTS[:4]
    router = ServingRouter(tm, num_replicas=2, num_slots=2, journal=str(tmp_path / "r{i}"), replica_mode="process",
                           transport=T)
    try:
        pids = [r.engine.pid for r in router.replicas]
        handles = [router.submit(p, max_new_tokens=6) for p in prompts[:2]]
        router.step()
        assert router.begin_rolling_restart()
        handles += [router.submit(p, max_new_tokens=6) for p in prompts[2:]]
        steps = 0
        while router.restart_in_progress:
            router.step()
            steps += 1
            assert steps < 50
        router.run_until_drained(max_steps=300)
        snap = router.snapshot()
        new_pids = [r.engine.pid for r in router.replicas]
    finally:
        router.close()
    assert [h.result().tolist() for h in handles] == _reference(tm, prompts, [6] * 4)
    assert all(p not in pids for p in new_pids)
    assert snap["fleet_ops"]["recycles"] == 2 and snap["breaker_transitions"] == {} and snap["failovers"] == 0
    assert snap["transport"]["workers_alive"] == 2 and len(router.retired_transport) == 2
    assert _accounted(snap)


def test_worker_processes_flip_in_place(pair, variant):
    """Over worker processes a flip is ``set_params`` in the worker: the
    same process serves the new version, with each pin's tokens."""
    tm = pair[2]
    sd1 = variant[1]
    router = ServingRouter(tm, num_replicas=2, num_slots=2, replica_mode="process", transport=T)
    try:
        pids = [r.engine.pid for r in router.replicas]
        router.deploy(sd1, fraction=0.5)
        router.step()
        flipped = [r.version for r in router.replicas]
        handles = [router.submit(p, max_new_tokens=5) for p in PROMPTS[:2]]
        router.run_until_drained(max_steps=200)
        same = [r.engine.pid for r in router.replicas] == pids
    finally:
        router.close()
    r0 = _reference(tm, PROMPTS[:2], [5, 5])
    r1 = _reference(_version_model(tm, sd1), PROMPTS[:2], [5, 5])
    assert flipped == [0, 1] and same and not router.retired_transport
    assert [h.version for h in handles] == [0, 1]
    assert [h.result().tolist() for h in handles] == [r0[0], r1[1]]


@pytest.mark.parametrize("journaled", [True, False])
def test_flip_waits_for_a_dead_workers_return(pair, variant, tmp_path, journaled):
    """A full deploy that targets an idle replica whose worker died:
    ``step()`` raises nothing, the flip waits for the worker to come back
    (respawned through its journal at the tick that finds it dead, or
    without a journal swapped for an empty one at half-open, both at the
    version it served) and then lands in place, and the fleet serves the
    deployed version's tokens."""
    tm = pair[2]
    sd1 = variant[1]
    kw = dict(journal=str(tmp_path / "r{i}")) if journaled else {}
    router = ServingRouter(tm, num_replicas=2, num_slots=2, replica_mode="process", transport=T, **kw)
    try:
        victim = router.replicas[1]
        pid = victim.engine.pid
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while victim.engine.alive:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        router.deploy(sd1, fraction=1.0)
        steps = 0
        while any(r.version != 1 for r in router.replicas):
            router.step()
            steps += 1
            assert steps < 50
        back = victim.engine.pid not in (None, pid) and victim.engine.alive
        handles = [router.submit(p, max_new_tokens=5) for p in PROMPTS[:2]]
        router.run_until_drained(max_steps=200)
        snap = router.snapshot()
    finally:
        router.close()
    assert back and router._primary_version == 1 and router._rollout is None
    assert [h.version for h in handles] == [1, 1]
    assert [h.result().tolist() for h in handles] == _reference(_version_model(tm, sd1), PROMPTS[:2], [5, 5])
    assert all(r["breaker"] == BREAKER_CLOSED for r in snap["replicas"].values()) and _accounted(snap)
