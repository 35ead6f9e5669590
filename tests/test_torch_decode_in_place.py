"""The decode step updates its state in place.

A CUDA graph replays the addresses it captured, so a decode step that
reassigns a cache or engine-state tensor instead of writing into it would
make every replay read the tensor from before the capture. These CPU tests
run ``decode_step`` and ``decode_step_paged`` (directly and through the
serving engine's ticks, with admissions, chunks and evictions between them)
and require every tensor the cache and the engine state hold to keep its
``data_ptr``."""

import dataclasses

import pytest
import torch

from perceiver_io_torch.models.core.config import CausalSequenceModelConfig
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.serving import ServingEngine

CONFIG = CausalSequenceModelConfig(vocab_size=64, max_seq_len=16, max_latents=6, num_channels=16, num_heads=2,
                                   num_self_attention_layers=2, cross_attention_dropout=0.0, init_scale=0.5)


@pytest.fixture(scope="module")
def model():
    return CausalSequenceModel(CONFIG, device="cpu", seed=3)


def _held(obj, prefix=""):
    """{path: tensor} of every tensor a dataclass holds, nested dataclasses included."""
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(value, torch.Tensor):
            out[prefix + f.name] = value
        elif dataclasses.is_dataclass(value):
            out.update(_held(value, f"{prefix}{f.name}."))
    return out


def _pointers(tensors):
    return {name: t.data_ptr() for name, t in tensors.items()}


def test_decode_step_writes_the_dense_cache_in_place(model):
    """Past capacity, where every step rolls the caches and the pad-slot mask."""
    ids = torch.randint(1, 64, (2, 12), generator=torch.Generator().manual_seed(0))
    pad = torch.zeros(2, 12, dtype=torch.bool)
    pad[1, :3] = True
    _, cache = model.prefill(ids, 6, model.init_cache(2), pad_mask=pad)
    tok = ids[:, -1:]
    _, cache = model.decode_step(tok, cache)  # the cache's tensors after the prefill's own
    held = _held(cache)
    before = _pointers(held)
    for _ in range(8):
        logits, cache = model.decode_step(tok, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    assert cache.ca.length == cache.ca.capacity
    assert _pointers(_held(cache)) == before
    assert set(held) == {"ca.k", "ca.v", "sa.k", "sa.v", "pad_slots", "shift", "live"}


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_decode_step_paged_writes_the_pool_in_place(model, quant):
    cache = model.init_paged_cache(3, 13, 4, kv_quant=quant)
    cache.sa.length = [cache.sa.capacity] * len(cache.sa.length)
    cache.ca.page_table[0] = torch.arange(1, 5)
    cache.live[0] = 5
    before = _pointers(_held(cache))
    tok = torch.tensor([[3], [4], [5]])
    for _ in range(20):  # wraps the ring of slot 0
        logits, cache = model.decode_step_paged(tok, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    assert int(cache.ca.start[0]) == 20 % 16
    assert _pointers(_held(cache)) == before


@pytest.mark.parametrize("page,quant,chunk", [(None, None, None), (4, None, 4), (4, "int8", 4), (4, "int4", None)])
def test_engine_ticks_keep_every_state_tensor(model, page, quant, chunk):
    """The engine's cache, its slot state and its static token buffer keep
    their storage through admissions (classic, split and chunked), decode
    ticks and evictions; and the tensors the engine saves and restores
    around a graph capture are all of them."""
    kw = {} if page is None else dict(kv_page_size=page, kv_quant=quant, prefill_chunk_tokens=chunk,
                                      prefix_cache=True)
    engine = ServingEngine(model, num_slots=3, **kw)
    held = {**_held(engine._cache, "cache."), **_held(engine._state, "state."), "tok_in": engine._tok_in}
    assert {t.data_ptr() for t in engine._cache_tensors()} == {t.data_ptr() for t in held.values()}
    before = _pointers(held)
    for i, (n, m) in enumerate([(3, 5), (12, 6), (16, 3), (7, 9), (10, 2)]):
        engine.submit(list(range(1 + i, 1 + i + n)), max_new_tokens=m)
        engine.step()
    engine.run_until_drained(max_steps=100)
    assert engine.metrics.snapshot()["requests_finished"] == 5
    assert _pointers(held) == before
    assert _pointers({**_held(engine._cache, "cache."), **_held(engine._state, "state."),
                      "tok_in": engine._tok_in}) == before
