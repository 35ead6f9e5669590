"""Port parity: the radix ``PrefixCache`` and ``PagePool.shared_count``
against the JAX package over seeded random operation sequences (page ids,
refcounts and ``stats()`` equal at every step), and the engine's admission
accounting with the cache: eviction yields to a live reservation before the
engine reports ``queue_full``, shared pages are counted once (so strictly
more sessions run), and the constructor validates its options with the JAX
engine's messages. Float64 on the CPU."""

import numpy as np
import pytest
from test_torch_support import build_pair

from perceiver_io_torch.serving import PagePool, PrefixCache, ServingEngine, pages_for_request
from perceiver_io_tpu.serving import ServingEngine as JaxEngine
from perceiver_io_tpu.serving.paging import PagePool as JaxPagePool
from perceiver_io_tpu.serving.paging import PrefixCache as JaxPrefixCache

WINDOW, LATENTS, PS = 24, 6, 3
CONFIG = dict(vocab_size=64, max_seq_len=WINDOW, max_latents=LATENTS, num_channels=16, num_heads=2,
              num_self_attention_layers=2, cross_attention_dropout=0.0, init_scale=0.5)
POOL = 24


def _same(port, ref, port_pool, ref_pool):
    assert port.stats() == ref.stats()
    assert port.cached_page_ids() == ref.cached_page_ids()
    assert sorted(port.reclaimable_page_ids()) == sorted(ref.reclaimable_page_ids())
    assert [port_pool.refcount(p) for p in range(POOL)] == [ref_pool.refcount(p) for p in range(POOL)]
    assert (port_pool.free_pages, port_pool.pages_in_use) == (ref_pool.free_pages, ref_pool.pages_in_use)
    held = [p for p in range(1, POOL) if ref_pool.refcount(p)]
    assert port_pool.shared_count(held) == ref_pool.shared_count(held)


@pytest.mark.parametrize("seed", range(6))
def test_prefix_cache_matches_jax_step_for_step(seed):
    """Sessions insert their page runs, later ones probe and fork them,
    touch, evict, invalidate, clear and release, over a small key alphabet
    so that prefixes share and diverge."""
    rs = np.random.RandomState(seed)
    port_pool, ref_pool = PagePool(POOL), JaxPagePool(POOL)
    port, ref = PrefixCache(port_pool, 2), JaxPrefixCache(ref_pool, 2)
    alphabet = [(a, b) for a in range(2) for b in range(2)]
    sessions = []  # page lists the sessions hold one reference each to

    def keys():
        return tuple(alphabet[i] for i in rs.randint(len(alphabet), size=rs.randint(1, 5)))

    for _ in range(120):
        op = rs.choice(["session", "session", "probe", "touch", "evict", "invalidate", "clear", "release"],
                       p=[0.2, 0.1, 0.2, 0.1, 0.15, 0.08, 0.02, 0.15])
        k = keys()
        if op == "session":
            shared = port.probe(k)
            assert shared == ref.probe(k)
            need = len(k) - len(shared)
            if not ref_pool.can_allocate(need):
                assert not port_pool.can_allocate(need)
                continue
            for pool in (port_pool, ref_pool):
                pool.retain(shared)
            private = port_pool.allocate(need)
            assert private == ref_pool.allocate(need)
            run = shared + private
            assert port.insert(k, run) == ref.insert(k, run)
            sessions.append(run)
        elif op == "probe":
            assert port.peek_match_pages(k) == ref.peek_match_pages(k)
            assert port.peek_match(k) == ref.peek_match(k)
            assert port.probe(k) == ref.probe(k)
        elif op == "touch":
            port.touch(k)
            ref.touch(k)
        elif op == "evict":
            n = int(rs.randint(1, 6))
            assert port.evict(n) == ref.evict(n)
        elif op == "invalidate":
            assert port.invalidate(k) == ref.invalidate(k)
        elif op == "clear":
            assert port.clear() == ref.clear()
        elif sessions:
            run = sessions.pop(rs.randint(len(sessions)))
            port_pool.release(run)
            ref_pool.release(run)
        _same(port, ref, port_pool, ref_pool)
    assert port.invalidate(()) == ref.invalidate(()) == 0
    with pytest.raises(ValueError, match="shorter than keys"):
        port.insert(((0, 0), (0, 1)), [1])
    with pytest.raises(ValueError, match="across quantization modes"):
        port.ensure_mode("int8")
    port.ensure_mode(None)


@pytest.fixture(scope="module")
def pair(x64):
    return build_pair(CONFIG)


def test_eviction_yields_to_a_live_reservation_before_queue_full(pair):
    """A pool whose free pages are held by a stale cached run: a request
    that needs them is accepted at a queue bound of 0 (the cached pages
    count as supply), admits at once by evicting them, and no alloc_failure
    is counted, as in the JAX engine."""
    jm, params, tm = pair
    dense = pages_for_request(WINDOW, 4, WINDOW, PS)  # 8 pages
    kw = dict(num_slots=2, kv_page_size=PS, num_kv_pages=dense + 3, prefix_cache=True, max_queue_depth=0)
    results = []
    for engine in (ServingEngine(tm, **kw), JaxEngine(jm, params, **kw)):
        donor = engine.submit([7] * 18 + [1], max_new_tokens=4)
        engine.run_until_drained(max_steps=200)
        assert donor.ok and engine._prefix_cache.cached_pages == 4
        # 10 allocatable, 4 held by the stale run: 8 needed > 6 free
        fresh = engine.submit(list(range(30, 50)), max_new_tokens=4)
        assert fresh.status.value == "queued"
        engine.step()
        assert fresh.status.value == "running"
        engine.run_until_drained(max_steps=200)
        stats = engine._prefix_cache.stats()
        assert fresh.ok and stats["evictions"] >= 1 and stats["evicted_pages"] >= 2
        assert engine.metrics.snapshot()["page_pool"]["alloc_failures"] == 0
        results.append((donor.result().tolist(), fresh.result().tolist(), stats))
    assert results[0] == results[1]


def test_a_blocked_head_counts_one_alloc_failure_an_episode(pair):
    tm = pair[2]
    engine = ServingEngine(tm, num_slots=2, kv_page_size=PS, num_kv_pages=9, prefix_cache=True)
    first = engine.submit(list(range(30, 50)), max_new_tokens=4)  # 8 pages: the whole pool
    second = engine.submit(list(range(40, 60)), max_new_tokens=4)
    for _ in range(3):
        engine.step()
    assert first.status.value == "running" and second.status.value == "queued"
    assert engine.metrics.snapshot()["page_pool"]["alloc_failures"] == 1
    engine.run_until_drained(max_steps=200)
    assert first.ok and second.ok


def test_shared_accounting_admits_strictly_more_sessions(pair):
    """Pages a prompt shares with the cache are retained, not allocated: at a
    fixed pool an 80 %-shared workload runs strictly more sessions at once
    than without the cache, with the JAX engine's peaks and tokens."""
    jm, params, tm = pair
    preamble = [7] * 18  # four cacheable pages below the latent boundary
    dense = pages_for_request(WINDOW, 4, WINDOW, PS)

    def peak_sessions(make, cache_on):
        engine = make(num_slots=6, kv_page_size=PS, num_kv_pages=2 * dense + 1, prefix_cache=cache_on)
        engine.submit(preamble + [1], max_new_tokens=4)
        engine.run_until_drained(max_steps=200)  # warm the cache
        handles = [engine.submit(preamble + [10 + i], max_new_tokens=4) for i in range(5)]
        peak = 0
        while engine.step():
            peak = max(peak, engine.scheduler.active_slots)
        assert all(h.ok for h in handles)
        if cache_on:
            assert engine._prefix_cache.stats()["hits"] >= 5
        return peak, [h.result().tolist() for h in handles]

    port = [peak_sessions(lambda **kw: ServingEngine(tm, **kw), on) for on in (False, True)]
    ref = [peak_sessions(lambda **kw: JaxEngine(jm, params, **kw), on) for on in (False, True)]
    assert port == ref
    (dense_peak, dense_tokens), (shared_peak, shared_tokens) = port
    assert shared_peak > dense_peak  # 16 free / 8 = 2 at once; 12 free / 4 private = 3
    assert shared_tokens == dense_tokens


@pytest.mark.parametrize("kwargs", [
    dict(prefill_chunk_tokens=4),
    dict(prefix_cache=True),
    dict(kv_page_size=PS, prefill_chunk_tokens=0),
    dict(kv_page_size=PS, max_prefill_slots=0),
    dict(kv_page_size=PS, kv_quant="int8", prefill_chunk_tokens=4),
], ids=["chunk-without-pages", "cache-without-pages", "chunk-zero", "prefill-slots-zero", "quant-chunk-unaligned"])
def test_constructor_validates_with_the_jax_messages(pair, kwargs):
    jm, params, tm = pair
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, params, num_slots=2, **kwargs)
    with pytest.raises(ValueError) as got:
        ServingEngine(tm, num_slots=2, **kwargs)
    assert str(got.value) == str(want.value)
