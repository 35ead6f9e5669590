"""Port parity: the serving engine's chunked prefill, radix prefix cache and
ragged tick against the JAX engine (which runs its ragged tick by default)
on the same converted weights, in float64 on the CPU.

Greedy tokens, finish reasons, prefix-cache hits and chunk counts must be
equal for ``prefill_chunk_tokens`` of one and two pages, with the prefix
cache on and off, over fp, int8 and int4 pools; a running slot keeps
decoding while another chunks; and ``step()`` is ``step_dispatch()``
followed by ``step_harvest()``."""

import pytest
from test_torch_support import build_pair

from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.serving import ServingEngine
from perceiver_io_tpu.generation.generate import GenerationConfig as JaxConfig
from perceiver_io_tpu.serving import ServingEngine as JaxEngine

WINDOW, LATENTS, PS = 24, 6, 3  # 8 pages a window; prefill buckets 6, 12, 24
CONFIG = dict(vocab_size=64, max_seq_len=WINDOW, max_latents=LATENTS, num_channels=16, num_heads=2,
              num_self_attention_layers=2, cross_attention_dropout=0.0, init_scale=0.5)
PREAMBLE = [11, 12, 13, 14, 15, 16, 17, 18, 19]  # three cacheable pages
# (prompt, max_new_tokens): four prompts extend the preamble; 13 + 12 > 24
# wraps its ring (no page keys); the others straddle the ladder's rungs. No
# prompt is shorter than the latents: there the JAX engine puts pads among
# them and disagrees with its own generate() (ROADMAP C1)
REQUESTS = [(PREAMBLE + [1, 2, 3], 4), ([7, 3, 9, 4, 4, 1], 3), (PREAMBLE + [4, 5, 6, 7, 8], 3),
            (list(range(30, 43)), 12), (PREAMBLE + [20, 21, 22, 23, 24, 25, 26, 27], 4),
            (list(range(40, 47)), 5), (PREAMBLE + [2, 2], 2)]
MODES = [(PS, False), (2 * PS, False), (None, True), (PS, True), (2 * PS, True)]


@pytest.fixture(scope="module")
def pair(x64):
    return build_pair(CONFIG)


def _run(engine, config_cls):
    handles = [engine.submit(p, config=config_cls(max_new_tokens=m)) for p, m in REQUESTS]
    engine.run_until_drained(max_steps=400)
    return handles


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("chunk,cache", MODES, ids=[f"chunk{c}-{'cache' if p else 'nocache'}" for c, p in MODES])
def test_engine_matches_the_jax_engine(pair, quant, chunk, cache):
    jm, params, tm = pair
    kw = dict(num_slots=3, kv_page_size=PS, kv_quant=quant, prefill_chunk_tokens=chunk, prefix_cache=cache,
              max_prefill_slots=2 if chunk else None)
    jax_engine = JaxEngine(jm, params, **kw)
    want = _run(jax_engine, JaxConfig)
    engine = ServingEngine(tm, **kw)
    got = _run(engine, GenerationConfig)

    assert [h.result().tolist() for h in got] == [h.result().tolist() for h in want]
    assert [h.finish_reason for h in got] == [h.finish_reason for h in want]
    assert [h.pages_allocated for h in got] == [h.pages_allocated for h in want]
    assert [h.page_keys for h in got] == [h.page_keys for h in want]  # the wrap gate too
    assert len({t for h in got for t in h.output_ids}) > 3  # the tokens vary
    snap, jsnap = engine.metrics.snapshot(), jax_engine.metrics.snapshot()
    if chunk:
        assert snap["chunked_prefill"] == jsnap["chunked_prefill"]
        assert snap["chunked_prefill"]["chunks_dispatched"] > len(REQUESTS)
    else:
        assert snap["chunked_prefill"] is None
    if cache:
        assert engine._prefix_cache.stats() == jax_engine._prefix_cache.stats()
        assert engine._prefix_cache.stats()["hits"] >= 3
        assert engine._pool.pages_in_use == engine._prefix_cache.cached_pages
        assert engine._prefix_cache.clear() == jax_engine._prefix_cache.clear()
    assert engine._pool.pages_in_use == jax_engine._pool.pages_in_use == 0
    assert snap["ragged_tick"]["ticks"] == jsnap["ragged_tick"]["ticks"]


def test_cache_on_and_off_give_the_same_tokens(pair):
    """Warm, cold and evicted cache: the same tokens as no cache at all."""
    tm = pair[2]
    off = [h.result().tolist() for h in _run(ServingEngine(tm, num_slots=3, kv_page_size=PS), GenerationConfig)]
    engine = ServingEngine(tm, num_slots=3, kv_page_size=PS, prefix_cache=True, prefill_chunk_tokens=PS)
    assert [h.result().tolist() for h in _run(engine, GenerationConfig)] == off  # cold
    hits = engine._prefix_cache.stats()["hits"]
    assert [h.result().tolist() for h in _run(engine, GenerationConfig)] == off  # warm
    assert engine._prefix_cache.stats()["hits"] > hits
    engine._prefix_cache.evict(2)
    assert [h.result().tolist() for h in _run(engine, GenerationConfig)] == off  # part evicted


def test_running_slot_keeps_decoding_while_another_chunks(pair):
    """A window-long prompt chunk-prefills over several ticks; the running
    slot emits one token every one of them."""
    tm = pair[2]
    engine = ServingEngine(tm, num_slots=2, kv_page_size=PS, prefill_chunk_tokens=6)
    bg = engine.submit([1, 2, 3], max_new_tokens=20)
    engine.step()
    long = engine.submit(list(range(30, 30 + WINDOW)), max_new_tokens=2)
    chunk_ticks = 0
    while long.admitted_at is None:
        before = len(bg.output_ids)
        engine.step()
        chunk_ticks += 1
        assert len(bg.output_ids) == before + 1
        assert chunk_ticks < 10
    assert chunk_ticks == 4  # 24 tokens in chunks of 6, the finish on the last chunk's tick
    engine.run_until_drained(max_steps=200)
    assert bg.ok and long.ok
    snap = engine.metrics.snapshot()["chunked_prefill"]
    assert snap["chunks_dispatched"] == 4 and snap["chunked_admissions"] == 1
    one_shot = ServingEngine(tm, num_slots=2, kv_page_size=PS)
    ref = [one_shot.submit(p, max_new_tokens=m) for p, m in (([1, 2, 3], 20), (list(range(30, 30 + WINDOW)), 2))]
    one_shot.run_until_drained(max_steps=200)
    assert [bg.result().tolist(), long.result().tolist()] == [h.result().tolist() for h in ref]


@pytest.mark.parametrize("quant", [None, "int4"])
def test_step_is_dispatch_then_harvest(pair, quant):
    tm = pair[2]
    kw = dict(num_slots=3, kv_page_size=PS, kv_quant=quant, prefill_chunk_tokens=PS, prefix_cache=True)
    composed = ServingEngine(tm, **kw)
    want = _run(composed, GenerationConfig)
    engine = ServingEngine(tm, **kw)
    got = [engine.submit(p, config=GenerationConfig(max_new_tokens=m)) for p, m in REQUESTS]
    while True:
        in_flight = engine.step_dispatch()
        assert in_flight == (engine._pending_harvest is not None)
        if in_flight:
            with pytest.raises(RuntimeError, match="step_harvest"):
                engine.step_dispatch()
        if not engine.step_harvest():
            break
    assert [h.result().tolist() for h in got] == [h.result().tolist() for h in want]
    assert engine.metrics.snapshot()["decode_steps"] == composed.metrics.snapshot()["decode_steps"]
    assert engine.step_harvest() is False  # nothing in flight: a no-op

    engine = ServingEngine(tm, **kw)
    handle = engine.submit(PREAMBLE + [1, 2, 3], max_new_tokens=3)
    while not engine.step_dispatch():
        engine.step_harvest()
    engine.discard_pending_harvest()  # the tick's token never lands
    assert handle.output_ids == [] and engine._pending_harvest is None
    engine.run_until_drained(max_steps=50)
    assert len(handle.output_ids) == 3
