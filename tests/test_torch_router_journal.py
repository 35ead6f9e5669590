"""The serving router's durability on the port: per-replica journals, the
router's own journal for parked submits, ``ServingRouter.recover`` and the
journal bookkeeping of failover and of moving a session by plan, in float64
on the CPU with journals under pytest's temporary directory.

A fleet abandoned mid-stream (the process death of the JAX tests) recovers
every accepted session once, and each finishes with an uninterrupted
engine's tokens, greedy and sampled (ROADMAP C14); the uninterrupted engine
equals the JAX engine on these prompts (``tests/test_torch_router.py``)."""

import time

import pytest
import torch
from test_torch_support import SERVING, build_pair

from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.reliability import FAULTS, armed
from perceiver_io_torch.serving import BREAKER_OPEN, ServingEngine, ServingRouter, read_journal
from perceiver_io_tpu.serving import read_journal as jax_read_journal

SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)


@pytest.fixture(scope="module")
def tm(x64):
    return build_pair(SERVING)[2]


@pytest.fixture(autouse=True)
def _fault_isolation():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _prompt(n, start=3):
    return [(start + i) % 63 + 1 for i in range(n)]


STREAM = [(_prompt(6, 3), GenerationConfig(max_new_tokens=5), 0),
          (_prompt(7, 20), GenerationConfig(max_new_tokens=4, **SAMPLED), 21),
          (_prompt(3, 40), GenerationConfig(max_new_tokens=6), 0),
          (_prompt(9, 7), GenerationConfig(max_new_tokens=3, **SAMPLED), 23)]


def _reference(tm, stream=STREAM):
    engine = ServingEngine(tm, num_slots=len(stream))
    handles = [engine.submit(p, config=c, seed=s) for p, c, s in stream]
    engine.run_until_drained(max_steps=500)
    return [h.result().tolist() for h in handles]


def _by_prompt(handles):
    return {tuple(h.prompt_ids.tolist()): h for h in handles}


def test_recovery_gives_the_uninterrupted_tokens(tm, tmp_path):
    """Two replicas of one slot, two requests running and two queued, the
    fleet abandoned after two ticks: ``recover`` rebuilds both replicas from
    their journals (placement kept, one capture budget each) and every
    request, greedy and sampled, finishes with the uninterrupted run's
    tokens; the router's books close (submitted = finished)."""
    expected = _reference(tm)
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=2, num_slots=1, journal=template)
    handles = [router.submit(p, config=c, seed=s) for p, c, s in STREAM]
    placement = [h.replica for h in handles]
    for _ in range(2):
        router.step()
    assert sorted(len(read_journal(template.format(i=i)).sessions) for i in range(2)) == [2, 2]
    # the JAX package reads the port router's replica journals
    assert [s.session for s in jax_read_journal(template.format(i=0)).sessions] == [
        s.session for s in read_journal(template.format(i=0)).sessions]
    router2, info = ServingRouter.recover(tm, template, num_replicas=2, num_slots=1)
    assert info["sessions"] == 4 and info["router_parked"] == 0 and info["deduped"] == 0
    assert info["replayed_tokens"] == 4  # two running requests, two tokens each
    got = _by_prompt(info["handles"])
    assert [got[tuple(p)].replica for p, _c, _s in STREAM] == placement
    router2.run_until_drained(max_steps=500)
    for (p, _c, _s), want in zip(STREAM, expected):
        assert got[tuple(p)].ok and got[tuple(p)].result().tolist() == want, p
    snap = router2.snapshot()
    assert snap["requests_submitted"] == 4 == snap["requests_finished"]
    assert all(read_journal(template.format(i=i)).sessions == [] for i in range(2))
    router2.close()


def test_journal_template_validation(tm, tmp_path):
    with pytest.raises(ValueError, match="template"):
        ServingRouter(tm, num_replicas=2, journal=str(tmp_path / "flat"))
    with pytest.raises(ValueError, match="template"):
        ServingRouter.recover(tm, str(tmp_path / "flat"), num_replicas=2)
    # versions= is ported: a version's parameters pass the layout gate first
    with pytest.raises(ValueError, match="names, shapes and dtypes"):
        ServingRouter.recover(tm, str(tmp_path / "r{i}"), versions={1: {"bogus": torch.zeros(1)}})
    # a live journal beyond num_replicas is refused, a drained one is not
    template = str(tmp_path / "fleet{i}")
    router = ServingRouter(tm, num_replicas=3, num_slots=1, journal=template)
    handles = [router.submit(_prompt(6, s), max_new_tokens=4) for s in (3, 20, 40)]
    router.step()
    assert handles[2].replica == 2
    with pytest.raises(ValueError, match="beyond num_replicas"):
        ServingRouter.recover(tm, template, num_replicas=2, num_slots=1)
    router.run_until_drained(max_steps=100)
    router.close()
    router2, info = ServingRouter.recover(tm, template, num_replicas=2, num_slots=1)
    assert info["sessions"] == 0
    router2.close()


def test_journal_failure_is_contained_as_a_replica_fault(tm, tmp_path):
    """A torn journal append in replica 0's submit is replica 0's fault: the
    breaker takes the strike, the request lands on replica 1, and every later
    dispatch to the fail-stopped journal strikes again while the fleet keeps
    serving."""
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=2, num_slots=1, journal=template)
    with armed("serving.journal.torn_write", times=1):
        h = router.submit(_prompt(6), max_new_tokens=3)
    assert h.replica == 1 and router.replicas[0].engine.journal.failed
    assert router.replicas[0].breaker == BREAKER_OPEN
    router.run_until_drained(max_steps=200)
    assert h.ok and len(h.result()) == 3
    handles = [router.submit(_prompt(6, s), max_new_tokens=2) for s in range(2, 8)]
    router.run_until_drained(max_steps=400)
    assert all(x.ok and x.replica == 1 for x in handles)
    snap = router.snapshot()
    assert snap["requests_submitted"] == 7 == snap["requests_finished"]
    router.close()


def test_failover_closes_the_origin_entry_once_the_continuation_lands(tm, tmp_path):
    """Once a failover lands on replica 1 (its accept, replay prefix
    included, journaled there), replica 0's entry is closed: a process death
    now recovers the session once, with the uninterrupted tokens."""
    stream = STREAM[:1]
    expected = _reference(tm, stream)
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=2, num_slots=1, journal=template)
    victim = router.submit(stream[0][0], config=stream[0][1])
    for _ in range(2):
        router.step()
    assert victim.replica == 0
    with armed("replica.crash", slot=0, times=1):
        router.step()
    assert victim.replica == 1
    assert read_journal(template.format(i=0)).sessions == []
    (landed,) = read_journal(template.format(i=1)).sessions
    assert landed.session == victim.session_id and landed.replay == victim.output_ids[:2]
    router2, info = ServingRouter.recover(tm, template, num_replicas=2, num_slots=1)
    assert info["sessions"] == 1
    router2.run_until_drained(max_steps=300)
    assert info["handles"][0].ok and info["handles"][0].result().tolist() == expected[0]
    snap = router2.snapshot()
    assert snap["requests_submitted"] == 1 == snap["requests_finished"]
    router2.close()


def test_parked_continuation_is_durable_across_process_death(tm, tmp_path):
    """The only replica is lost: the continuation parks and its origin entry
    stays live (its one durable copy); recovery from it finishes the
    request with the uninterrupted tokens."""
    stream = STREAM[1:2]  # sampled
    expected = _reference(tm, stream)
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=1, num_slots=1, journal=template, breaker_cooldown_ticks=512)
    victim = router.submit(stream[0][0], config=stream[0][1], seed=stream[0][2])
    for _ in range(2):
        router.step()
    with armed("replica.crash", slot=0, times=1):
        router.step()
    assert victim.status.value == "queued" and victim.replica is None
    assert len(read_journal(template.format(i=0)).sessions) == 1
    router2, info = ServingRouter.recover(tm, template, num_replicas=1, num_slots=1)
    assert info["sessions"] == 1
    router2.run_until_drained(max_steps=300)
    assert info["handles"][0].ok and info["handles"][0].result().tolist() == expected[0]
    router2.close()


def test_parked_expiry_closes_the_origin_entry(tm, tmp_path):
    """A parked continuation that expires at the router closes its origin
    entry with the real outcome: nothing to resurrect."""
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=1, num_slots=1, journal=template, breaker_cooldown_ticks=512)
    victim = router.submit(_prompt(6), max_new_tokens=10, deadline_s=1.0)
    for _ in range(2):
        router.step()
    with armed("replica.crash", slot=0, times=1):
        router.step()
    stop = time.perf_counter() + 10.0
    while not victim.done and time.perf_counter() < stop:
        router.step()
        time.sleep(0.02)
    assert victim.status.value == "timed_out" and len(victim.output_ids) == 2
    assert read_journal(template.format(i=0)).sessions == []
    router2, info = ServingRouter.recover(tm, template, num_replicas=1, num_slots=1)
    assert info["sessions"] == 0
    router2.close()
    router.close()


def _outage(tm, template):
    """One replica, lost at its first tick (a long cooldown keeps it out):
    the next fresh submit parks in the router's journal."""
    router = ServingRouter(tm, num_replicas=1, num_slots=1, journal=template, breaker_cooldown_ticks=3)
    with armed("replica.crash", slot=0, times=1):
        router.step()
    assert router.replicas[0].breaker == BREAKER_OPEN
    p, c, s = STREAM[3]
    parked = router.submit(p, config=c, seed=s)
    assert parked.replica is None and parked._router_journaled
    (entry,) = read_journal(template.format(i="router")).sessions
    assert entry.session == parked.session_id and entry.rng == [s]
    return router, parked


def test_parked_submit_is_durable_in_the_router_journal(tm, tmp_path):
    """A fresh submit parked through a whole-fleet outage lives in the
    router's own journal: a process death recovers it parked, and it
    finishes with the uninterrupted tokens."""
    expected = _reference(tm, STREAM[3:])
    template = str(tmp_path / "r{i}")
    _router, _parked = _outage(tm, template)
    router2, info = ServingRouter.recover(tm, template, num_replicas=1, num_slots=1)
    assert info["sessions"] == 0 and info["router_parked"] == 1
    (handle,) = info["parked_handles"]
    router2.run_until_drained(max_steps=300)
    assert handle.ok and handle.result().tolist() == expected[0]
    assert read_journal(template.format(i="router")).sessions == []
    router2.close()


def test_parked_submit_that_landed_is_recovered_once(tm, tmp_path):
    """The dispatch race: the parked submit lands on the recovered replica
    (its accept journaled there) but the router journal's close record is
    lost with the process. Recovery keeps the replica's copy and drops the
    stale parking entry by session id."""
    expected = _reference(tm, STREAM[3:])
    template = str(tmp_path / "r{i}")
    router, parked = _outage(tm, template)
    router._router_journal_close = lambda *args, **kwargs: None  # the close record dies with the process
    for _ in range(4):
        router.step()
    assert parked.replica == 0
    assert len(read_journal(template.format(i="router")).sessions) == 1
    router2, info = ServingRouter.recover(tm, template, num_replicas=1, num_slots=1)
    assert info["sessions"] == 1 and info["router_parked"] == 0
    router2.run_until_drained(max_steps=300)
    assert info["handles"][0].ok and info["handles"][0].result().tolist() == expected[0]
    router2.close()


def test_a_session_moved_by_plan_keeps_its_tokens_and_recovers_once(tm, tmp_path):
    """``_detach_session`` lifts a running session off a healthy replica
    (its origin entry stays live), ``_hand_off_to`` lands it on the sibling
    and closes the origin as moved; the request finishes with the
    uninterrupted tokens, and a death after the move recovers it once."""
    stream = STREAM[:2]
    expected = _reference(tm, stream)
    template = str(tmp_path / "r{i}")
    router = ServingRouter(tm, num_replicas=2, num_slots=2, journal=template)
    a, b = [router.submit(p, config=c, seed=s) for p, c, s in stream]
    router.step()
    router.step()
    assert a.replica == 0 and router._find_live(a.request_id) is a
    r0, r1 = router.replicas
    (engine_rid,) = [k for k, v in r0.assigned.items() if v is a]
    router._detach_session(r0, engine_rid, a)
    assert a.replica is None and a.output_ids == expected[0][:2] and a._journal_origin == (0, engine_rid)
    assert len(read_journal(template.format(i=0)).sessions) == 1  # still live: the durable copy
    assert router._hand_off_to(a, r1) and a.replica == 1 and a.failovers == 0
    assert read_journal(template.format(i=0)).sessions == []
    router2, info = ServingRouter.recover(tm, template, num_replicas=2, num_slots=2)
    assert info["sessions"] == 2
    router2.run_until_drained(max_steps=300)
    assert [h.result().tolist() for h in info["handles"]] == [expected[1], expected[0]]
    router.run_until_drained(max_steps=300)
    assert [a.result().tolist(), b.result().tolist()] == expected
    router2.close()
    router.close()
