"""Port parity of telemetry (``perceiver_io_torch/obs/``) against the JAX
package's ``perceiver_io_tpu/obs/``, in float64 on the CPU.

- The recorder: both packages' recorders fed one event script under one
  fake clock give equal summaries and Chrome traces (pid and tid aside); the
  JAX package's recorder, trace, validator, null-recorder, environment,
  flush-thread and double-close cases, on the port; a trace either package
  writes passes the other's validator.
- The engine (dense, paged fp, paged int4, chunked admission with the
  prefix cache and a priority preemption): tokens with telemetry on equal
  those with it off, and the phase span counts, the counters and each
  request's async events (names and args) equal the JAX engine's on the same
  stream. The JAX engine's compile names (``jax.compile.backend``,
  ``compile.backend_total``) have no counterpart (ROADMAP C18).
- The router: counters and ``router.request`` event sequences equal the JAX
  router's across a failover, a deploy and a rollback.
- The fit loop at prefetch depth 0 and 2, with eval and checkpoints: the
  loss trajectory with telemetry on is the one with it off in every bit,
  and the phase counts equal the JAX ``Trainer.fit``'s. ``profile_dir``
  writes a ``torch.profiler`` trace and the ``profile`` event at the JAX
  loop's step.
- The watchdog: a fake probe over budget and a kernel-library load after
  ``mark_steady`` are flagged; engine churn flags nothing; dropped
  watchdogs and engines are not pinned.
- Manifests, ``_jsonable`` against the JAX package's, and the report run end
  to end on the port's artifacts with the tables ``scripts/obs_report.py``
  prints on the same files.
"""

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_support import SERVING, SMALL, build_pair

import perceiver_io_torch.obs.watchdog as port_watchdog
from perceiver_io_torch.convert_jax import jax_params_to_state_dict
from perceiver_io_torch.data.loader import DataLoader
from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.obs import (ARTIFACT_SCHEMAS, NULL_RECORDER, TELEMETRY_ENV, CompileWatchdog, NullRecorder,
                                    TelemetryRecorder, build_run_manifest, load_chrome_trace, resolve_recorder,
                                    validate_chrome_trace, write_run_manifest)
from perceiver_io_torch.obs import manifest as port_manifest
from perceiver_io_torch.obs import report as port_report
from perceiver_io_torch.ops import cuda_build
from perceiver_io_torch.reliability import FAULTS, armed
from perceiver_io_torch.serving import EngineMetrics, ServingEngine, ServingRouter
from perceiver_io_torch.training.fit import Trainer, TrainerConfig
from perceiver_io_torch.training.trainer import (TrainState, build_optimizer, make_causal_lm_eval_step,
                                                 make_causal_lm_train_step)
from perceiver_io_tpu.data.loader import DataLoader as JaxLoader
from perceiver_io_tpu.obs import core as jax_core
from perceiver_io_tpu.obs import manifest as jax_manifest
from perceiver_io_tpu.obs import trace as jax_trace
from perceiver_io_tpu.reliability import FAULTS as JAX_FAULTS
from perceiver_io_tpu.reliability import armed as jax_armed
from perceiver_io_tpu.serving import ServingEngine as JaxEngine
from perceiver_io_tpu.serving import ServingRouter as JaxRouter
from perceiver_io_tpu.training import fit as jfit
from perceiver_io_tpu.training import trainer as jtr

# the JAX package's compile names, with no counterpart in the port (ROADMAP C18)
JAX_COMPILE_PHASES = {"jax.compile.backend", "cuda.kernel_load"}
COMPILE_COUNTERS = {"compile.backend_total"}
WINDOW, LATENTS = SERVING["max_seq_len"], SERVING["max_latents"]
PAGE = 2


@pytest.fixture(autouse=True)
def _fault_isolation():
    FAULTS.reset()
    JAX_FAULTS.reset()
    yield
    FAULTS.reset()
    JAX_FAULTS.reset()


@pytest.fixture(scope="module")
def pair(x64):
    return build_pair(SERVING)


def _phase_counts(summary):
    return {k: v["count"] for k, v in summary["phases"].items() if k not in JAX_COMPILE_PHASES}


def _counters(summary):
    return {k: v for k, v in summary["counters"].items() if k not in COMPILE_COUNTERS}


def _async_sequences(trace, category=None):
    """Each async span's events as (phase, milestone name, args), keyed by
    (category, id); engine categories (``request.e{n}``, numbered per process) are
    renamed by their order of first appearance."""
    rename, out = {}, {}
    for ev in trace["traceEvents"]:
        if ev["ph"] not in ("b", "n", "e"):
            continue
        cat = ev["cat"]
        if category is not None and cat != category:
            continue
        if cat.startswith("request.e"):
            cat = rename.setdefault(cat, f"engine{len(rename)}")
        # a begin's and an end's name is the category: only milestones carry their own
        name = ev["name"] if ev["ph"] == "n" else None
        out.setdefault((cat, ev["id"]), []).append((ev["ph"], name, ev.get("args", {})))
    return out


def _strip_ids(trace):
    return [{k: v for k, v in ev.items() if k not in ("pid", "tid")} for ev in trace["traceEvents"]]


# ------------------------------------------------------------ recorder core
def _event_script(rec, t):
    """One script of every recorder call, advancing the fake clock ``t``."""
    for dur in (0.25, 0.5, 0.25, 1.0):
        with rec.span("phase.a", tag="x"):
            t[0] += dur
        t[0] += 0.125
    rec.span_begin("phase.b")
    t[0] += 2.0
    rec.span_end("phase.b")
    rec.span_end("phase.unopened")  # ignored by both
    rec.async_begin("request", 1, prompt_len=4)
    rec.async_instant("request", 1, "queued")
    t[0] += 0.03
    rec.async_end("request", 1, status="finished", new_tokens=2)
    rec.instant("marker", note="hello")
    rec.counter_inc("n", 3)
    rec.counter_inc("n")
    rec.gauge_set("g", 0.75)
    rec.observe("phase.c", 0.5)


@pytest.mark.parametrize("max_events", [1000, 5])
def test_recorder_matches_the_jax_recorder(max_events):
    """One event script under one fake clock: summaries and Chrome traces
    equal, pid and tid aside (with and without evicted events)."""
    got = {}
    for name, cls in (("port", TelemetryRecorder), ("jax", jax_core.TelemetryRecorder)):
        t = [100.0]
        rec = cls(clock=lambda: t[0], max_events=max_events)
        _event_script(rec, t)
        got[name] = (rec.summary(), rec.chrome_trace())
    assert got["port"][0] == got["jax"][0]
    assert _strip_ids(got["port"][1]) == _strip_ids(got["jax"][1])
    assert got["port"][1]["metadata"] == got["jax"][1]["metadata"]
    assert ("trace_events_dropped" in got["port"][0]) == (max_events == 5)


def test_fake_clock_spans_and_histograms_are_deterministic():
    t = [100.0]
    rec = TelemetryRecorder(clock=lambda: t[0])
    _event_script(rec, t)
    s = rec.summary()
    a = s["phases"]["phase.a"]
    assert (a["count"], a["total_s"], a["mean_s"], a["max_s"]) == (4, 2.0, 0.5, 1.0)
    assert a["p50_s"] == pytest.approx(0.375, abs=1e-9)  # midway 0.25..0.5 over [0.25, 0.25, 0.5, 1.0]
    assert s["phases"]["phase.b"]["total_s"] == pytest.approx(2.0, abs=1e-12)
    assert s["counters"] == {"n": 4} and s["gauges"] == {"g": 0.75}
    xs = [e for e in rec.chrome_trace()["traceEvents"] if e["ph"] == "X" and e["name"] == "phase.a"]
    assert [e["ts"] for e in xs] == [0.0, 375000.0, 1000000.0, 1375000.0]
    assert [e["dur"] for e in xs] == [250000.0, 500000.0, 250000.0, 1000000.0]


def test_chrome_trace_artifact_is_valid(tmp_path):
    t = [0.0]
    rec = TelemetryRecorder(clock=lambda: t[0])
    _event_script(rec, t)
    path = rec.write_chrome_trace(str(tmp_path / "trace.json"))
    trace = load_chrome_trace(path)
    assert validate_chrome_trace(trace) == []
    assert {"X", "b", "n", "e", "i"} <= {e["ph"] for e in trace["traceEvents"]}
    assert trace["metadata"]["schema"] == "chrome-trace/v1" and "phase.a" in trace["metadata"]["summary"]["phases"]
    (tmp_path / "not.json").write_text("[]")
    with pytest.raises(ValueError, match="not a Chrome trace"):
        load_chrome_trace(str(tmp_path / "not.json"))


def test_validator_catches_unbalanced_and_negative():
    bad = {"traceEvents": [{"ph": "b", "cat": "r", "id": 1, "ts": 5.0}, {"ph": "X", "name": "x", "ts": -1.0, "dur": 2.0},
                           {"ph": "b", "cat": "r", "id": 2, "ts": 5.0}, {"ph": "e", "cat": "r", "id": 2, "ts": 4.0},
                           {"ph": "X", "name": "y", "ts": 1.0}, {"ts": 1.0}]}
    problems = validate_chrome_trace(bad)
    assert problems == jax_trace.validate_chrome_trace(bad)
    for words in ("never ended", "negative ts", "ends before it begins", "bad dur", "missing ph/ts"):
        assert any(words in p for p in problems), words


def test_validator_tolerates_truncated_trace_imbalance():
    truncated = {"traceEvents": [{"ph": "e", "cat": "request", "id": 3, "ts": 9.0},
                                 {"ph": "n", "cat": "request", "name": "prefill", "id": 4, "ts": 2.0}],
                 "metadata": {"events_dropped": 17}}
    assert validate_chrome_trace(truncated) == []
    truncated["metadata"]["events_dropped"] = 0
    assert validate_chrome_trace(truncated) != []


def test_null_recorder_is_shared_and_inert():
    assert resolve_recorder(None)[0] is NULL_RECORDER
    assert resolve_recorder(False) == (NULL_RECORDER, False)
    span = NULL_RECORDER.span("anything", k=1)
    assert span is NULL_RECORDER.span("other")
    with span:
        pass
    assert NULL_RECORDER.summary() == {} and NULL_RECORDER.chrome_trace() == {"traceEvents": []}
    assert not NullRecorder.enabled
    mine = TelemetryRecorder()
    assert resolve_recorder(mine) == (mine, False)  # a recorder passed in stays the caller's


def test_env_enables_telemetry(monkeypatch, tmp_path):
    assert TELEMETRY_ENV == "PERCEIVER_IO_TORCH_TELEMETRY"
    monkeypatch.setenv(TELEMETRY_ENV, "1")
    rec, owned = resolve_recorder(None)
    assert rec.enabled and owned and rec.trace_path is None
    rec.close()
    path = str(tmp_path / "env_trace.json")
    monkeypatch.setenv(TELEMETRY_ENV, path)
    rec, owned = resolve_recorder(None)
    assert rec.enabled and owned and rec.trace_path == path
    rec.close()
    assert os.path.exists(path)
    assert resolve_recorder(False)[0] is NULL_RECORDER  # False beats the environment
    monkeypatch.setenv(TELEMETRY_ENV, "false")
    assert resolve_recorder(None)[0] is NULL_RECORDER
    monkeypatch.setenv(jax_core.TELEMETRY_ENV, "1")  # the JAX package's variable is not the port's
    assert resolve_recorder(None)[0] is NULL_RECORDER


def test_recorder_flush_thread_writes_and_joins(tmp_path):
    path = str(tmp_path / "flush_trace.json")
    rec = TelemetryRecorder(trace_path=path, flush_interval_s=0.02)
    with rec.span("alive"):
        pass
    waiter = threading.Event()
    for _ in range(200):
        if os.path.exists(path):
            break
        waiter.wait(0.02)
    assert os.path.exists(path)
    assert any(t.name == "perceiver-telemetry-flush" for t in threading.enumerate())
    rec.close()
    assert not any(t.name == "perceiver-telemetry-flush" for t in threading.enumerate())
    assert validate_chrome_trace(load_chrome_trace(path)) == []


def test_recorder_and_metrics_double_close(tmp_path):
    rec = TelemetryRecorder(trace_path=str(tmp_path / "t.json"))
    rec.close()
    rec.close()
    m = EngineMetrics(num_slots=1, jsonl_path=str(tmp_path / "m.jsonl"))
    m.record_submit(0, 3)
    m.close()
    m.close()
    m.record_submit(1, 3)  # dropped after close
    with open(tmp_path / "m.jsonl") as f:
        assert len(f.readlines()) == 1


def test_recording_from_threads_is_safe():
    """The prefetcher and the checkpoint writer record from their own
    threads: with more threads than cores and a short switch interval, no
    counter increment, span or async event is lost."""
    rec = TelemetryRecorder()
    n_threads, rounds = (os.cpu_count() or 1) + 3, 200

    def work(i):
        for j in range(rounds):
            with rec.span("t.span"):
                rec.counter_inc("t.n")
            rec.span_begin("t.pair")
            rec.span_end("t.pair")
            rec.async_begin("t.req", (i, j))
            rec.async_end("t.req", (i, j))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    s, total = rec.summary(), n_threads * rounds
    assert s["counters"]["t.n"] == total and s["phases"]["t.span"]["count"] == total
    assert s["phases"]["t.pair"]["count"] == total and validate_chrome_trace(rec.chrome_trace()) == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_traces_validate_across_packages(tmp_path, writer):
    """A trace either package writes passes the other's loader and validator."""
    t = [0.0]
    cls = TelemetryRecorder if writer == "port" else jax_core.TelemetryRecorder
    rec = cls(clock=lambda: t[0], trace_path=str(tmp_path / "x.json"))
    _event_script(rec, t)
    rec.close()
    for load, validate in ((load_chrome_trace, validate_chrome_trace),
                           (jax_trace.load_chrome_trace, jax_trace.validate_chrome_trace)):
        assert validate(load(str(tmp_path / "x.json"))) == []


# ----------------------------------------------------------------- engines
# (pool options, prompts, max_new) of each engine case; prompts reach
# max_latents, where the packages agree (ROADMAP C1)
ENGINE_CASES = {
    "dense": (dict(num_slots=2), [(6, 3), (7, 20), (12, 40), (9, 7)], [5, 3, 6, 4]),
    "paged-fp": (dict(num_slots=2, kv_page_size=PAGE), [(6, 3), (7, 20), (12, 40), (9, 7)], [5, 3, 6, 4]),
    "paged-int4": (dict(num_slots=2, kv_page_size=PAGE, kv_quant="int4"), [(6, 3), (7, 20), (12, 40), (9, 7)],
                   [5, 3, 6, 4]),
}


def _prompt(n, start=3):
    return [(start + i) % 63 + 1 for i in range(n)]


def _engine_run(engine, prompts, max_new):
    handles = [engine.submit(_prompt(n, s), max_new_tokens=m) for (n, s), m in zip(prompts, max_new)]
    engine.run_until_drained(max_steps=400)
    return [h.result().tolist() for h in handles]


def _observed(rec):
    return dict(phases=_phase_counts(rec.summary()), counters=_counters(rec.summary()),
                gauges=rec.summary()["gauges"], requests=_async_sequences(rec.chrome_trace()))


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_telemetry_matches_the_jax_engine(pair, case):
    jm, params, tm = pair
    options, prompts, max_new = ENGINE_CASES[case]
    off = ServingEngine(tm, telemetry=False, **options)
    tokens_off = _engine_run(off, prompts, max_new)
    assert off.telemetry is NULL_RECORDER and off.watchdog is None and off.telemetry_summary() is None
    off.close()
    got = {}
    for pkg in ("port", "jax"):
        rec = TelemetryRecorder() if pkg == "port" else jax_core.TelemetryRecorder()
        engine = ServingEngine(tm, telemetry=rec, **options) if pkg == "port" else JaxEngine(
            jm, params, telemetry=rec, **options)
        tokens = _engine_run(engine, prompts, max_new)
        summary = engine.telemetry_summary()
        engine.close()
        got[pkg] = dict(tokens=tokens, **_observed(rec))
        assert validate_chrome_trace(rec.chrome_trace()) == []
        if pkg == "port":
            assert summary["compile"]["per_function"] == {"serving.decode_step": {"compilations": 0, "budget": 1}}
            assert summary["compile"]["unexpected"] == []
            ticks = engine.metrics.snapshot()["decode_steps"]
            assert got[pkg]["phases"]["serving.sample_sync"] == got[pkg]["phases"]["serving.evict"] == ticks
    assert got["port"]["tokens"] == tokens_off == got["jax"]["tokens"]
    assert got["port"] == got["jax"]
    assert {"serving.tick", "serving.admit", "serving.decode_dispatch"} <= set(got["port"]["phases"])
    assert all(seq[0][0] == "b" and seq[-1][0] == "e" for seq in got["port"]["requests"].values())


# chunked admission with the prefix cache, and a priority preemption
CHUNK_CONFIG = dict(vocab_size=64, max_seq_len=24, max_latents=6, num_channels=16, num_heads=2,
                    num_self_attention_layers=2, cross_attention_dropout=0.0, init_scale=0.5)
PREAMBLE = [11, 12, 13, 14, 15, 16, 17, 18, 19]


@pytest.fixture(scope="module")
def chunk_pair(x64):
    return build_pair(CHUNK_CONFIG)


def _chunked_scenario(engine):
    """Two class-0 requests sharing a cached preamble run; a class-1
    arrival blocked on pages preempts one and admits the same tick; all
    finish."""
    low = [engine.submit(PREAMBLE + [1, 2, 3], max_new_tokens=6),
           engine.submit(PREAMBLE + [4, 5, 6, 7], max_new_tokens=6)]
    for _ in range(4):
        engine.step()
    high = engine.submit(PREAMBLE + [20, 21, 22], max_new_tokens=4, priority=1)
    engine.run_until_drained(max_steps=400)
    handles = low + [high]
    return [h.result().tolist() for h in handles], sum(h.preemptions for h in handles)


def test_chunked_prefix_preemption_telemetry_matches_the_jax_engine(chunk_pair):
    jm, params, tm = chunk_pair
    options = dict(num_slots=3, kv_page_size=3, prefill_chunk_tokens=3, prefix_cache=True, max_prefill_slots=2,
                   num_kv_pages=13)
    off = ServingEngine(tm, telemetry=False, **options)
    tokens_off, _ = _chunked_scenario(off)
    off.close()
    got = {}
    for pkg in ("port", "jax"):
        rec = TelemetryRecorder() if pkg == "port" else jax_core.TelemetryRecorder()
        engine = ServingEngine(tm, telemetry=rec, **options) if pkg == "port" else JaxEngine(
            jm, params, telemetry=rec, **options)
        tokens, preemptions = _chunked_scenario(engine)
        engine.close()
        got[pkg] = dict(tokens=tokens, preemptions=preemptions, **_observed(rec))
    assert got["port"]["tokens"] == tokens_off
    assert got["port"] == got["jax"]
    assert got["port"]["preemptions"] == got["port"]["counters"]["serving.preemptions"] == 1
    assert got["port"]["counters"]["serving.prefix_hits"] >= 1
    names = [n for seq in got["port"]["requests"].values() for _, n, _ in seq]
    assert "preempted" in names and names.count("prefill") >= 4  # the victim's prefill comes twice


def test_two_engines_sharing_one_recorder_do_not_collide(pair):
    rec = TelemetryRecorder()
    engines = [ServingEngine(pair[2], num_slots=1, telemetry=rec) for _ in range(2)]
    for engine in engines:
        engine.submit(_prompt(6), max_new_tokens=2)
        engine.run_until_drained(max_steps=50)
    trace = rec.chrome_trace()
    assert validate_chrome_trace(trace) == []
    assert len({e["cat"] for e in trace["traceEvents"] if e["ph"] == "b"}) == 2
    for engine in engines:
        engine.close()
    assert not rec._closed  # a recorder passed in stays open
    rec.close()


def test_engine_trace_path_and_environment(pair, tmp_path, monkeypatch):
    """A path knob, and the environment variable with the knob None, give an
    engine-owned recorder whose trace lands at close; rejected requests end
    their spans; ``discard_pending_harvest`` balances the tick span."""
    path = tmp_path / "engine.json"
    monkeypatch.setenv(TELEMETRY_ENV, str(path))
    engine = ServingEngine(pair[2], num_slots=1, max_queue_depth=0)
    assert engine.telemetry.enabled and engine._owns_telemetry
    ok = engine.submit(_prompt(6), max_new_tokens=3)
    full = engine.submit(_prompt(7), max_new_tokens=3)
    assert full.finish_reason == "queue_full"
    engine.step_dispatch()
    engine.discard_pending_harvest()  # the half-tick goes back to the queue
    engine.run_until_drained(max_steps=50)
    assert ok.ok and not path.exists()
    engine.close()
    engine.close()
    trace = load_chrome_trace(str(path))
    assert validate_chrome_trace(trace) == [] and jax_trace.validate_chrome_trace(trace) == []
    counters = trace["metadata"]["summary"]["counters"]
    assert counters["serving.rejected"] == 1
    ends = [e["args"] for e in trace["traceEvents"] if e["ph"] == "e"]
    assert {"status": "rejected", "reason": "queue_full"} in ends
    assert engine.telemetry._open_spans == {}


# ------------------------------------------------------------------ router
SCENARIOS = ("failover", "deploy_rollback")


@pytest.fixture(scope="module")
def variant(pair):
    params = pair[1]
    out = jax.tree_util.tree_map(lambda x: x, params)
    out["params"]["output_adapter"]["bias"] = params["params"]["output_adapter"]["bias"].at[47].add(100.0)
    return out, jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, out))


def _router_scenario(router, pkg, scenario, v1):
    if scenario == "failover":
        handles = [router.submit(_prompt(n, s), max_new_tokens=m)
                   for (n, s), m in zip(((6, 3), (7, 20), (9, 40), (12, 7)), (6, 5, 7, 6))]
        with (armed if pkg == "port" else jax_armed)("replica.crash", slot=0, after=2, times=1):
            router.run_until_drained(max_steps=300)
        for _ in range(4):
            router.step()
    else:
        router.deploy(v1, fraction=0.5)
        router.step()
        handles = [router.submit(_prompt(6), max_new_tokens=5) for _ in range(2)]
        router.run_until_drained(max_steps=200)
        assert router.rollback()
        handles.append(router.submit(_prompt(6), max_new_tokens=5))
        router.run_until_drained(max_steps=200)
        for _ in range(3):
            router.step()
    return [h.result().tolist() for h in handles]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_router_telemetry_matches_the_jax_router(pair, variant, scenario):
    jm, params, tm = pair
    jax_v1, sd1 = variant
    got = {}
    for pkg in ("port", "jax"):
        rec = TelemetryRecorder() if pkg == "port" else jax_core.TelemetryRecorder()
        kw = dict(num_replicas=2, num_slots=2, breaker_cooldown_ticks=2, telemetry=rec)
        router = ServingRouter(tm, **kw) if pkg == "port" else JaxRouter(jm, params, **kw)
        tokens = _router_scenario(router, pkg, scenario, sd1 if pkg == "port" else jax_v1)
        summary = router.telemetry_summary()
        router.close()
        s = rec.summary()
        got[pkg] = dict(tokens=tokens, counters=_counters(s),
                        router_phases={k: v for k, v in _phase_counts(s).items() if k.startswith("router.")},
                        gauges={k: v for k, v in s["gauges"].items() if k.startswith("router.")},
                        requests=_async_sequences(rec.chrome_trace(), "router.request"),
                        instants=[(e["name"], e.get("args", {})) for e in rec.chrome_trace()["traceEvents"]
                                  if e["ph"] == "i" and e["name"].startswith("router.")])
        if pkg == "port":
            assert validate_chrome_trace(rec.chrome_trace()) == []
            compile_block = summary["compile"]
            assert sorted(compile_block["per_function"]) == ["serving.r0.decode_step", "serving.r1.decode_step"]
            assert compile_block["unexpected"] == []
            replica_ticks = _phase_counts(s)
            assert replica_ticks["serving.r0.tick"] > 0 and replica_ticks["serving.r1.tick"] > 0
    assert got["port"] == got["jax"]
    counters = got["port"]["counters"]
    if scenario == "failover":
        assert counters["router.failovers"] == 2 and counters["router.breaker.closed->open"] == 1
        assert counters["router.breaker.half_open->closed"] == 1
    else:
        assert counters["router.deploys"] == counters["router.rollbacks"] == 1
        assert [n for n, _ in got["port"]["instants"]].count("router.version_flip") == 2


def test_router_flips_do_not_double_count_replaced_watchdogs(pair, variant):
    """An in-process flip builds a fresh engine (a watchdog of its own) on
    the shared recorder; the merged compile report holds one entry a
    replica, and the replaced engines' watchdogs are closed."""
    sd1 = variant[1]
    router = ServingRouter(pair[2], num_replicas=2, num_slots=1, telemetry=True)
    old = [r.engine.watchdog for r in router.replicas]
    router.deploy(sd1, fraction=1.0)
    for _ in range(3):
        router.step()
    assert [r.version for r in router.replicas] == [1, 1]
    assert all(w._closed for w in old) and not any(r.engine.watchdog._closed for r in router.replicas)
    report = router.telemetry_summary()["compile"]
    assert sorted(report["per_function"]) == ["serving.r0.decode_step", "serving.r1.decode_step"]
    assert all(w not in port_watchdog._LIVE_WATCHDOGS for w in old)
    recorder = router.telemetry
    router.close()
    assert recorder._closed  # the router made it from its knob


# ---------------------------------------------------------------- fit loop
TINY = dict(SMALL, num_channels=16)


def _sequences(n=12, seed=7):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, TINY["vocab_size"], size=TINY["max_seq_len"]).astype(np.int64) for _ in range(n)]


def _collate(ex):
    x = np.stack(ex)
    return {"input_ids": x, "labels": np.roll(x, -1, axis=1)}


def _loader(cls=DataLoader):
    return cls(_sequences(), 2, collate_fn=_collate, shuffle=True, rng=np.random.default_rng(3))


FIT = dict(max_steps=8, log_every=2, eval_every=4, checkpoint_every=3)


def _port_fit(tm, base, depth, telemetry, ckpt=None, **extra):
    tm.load_state_dict(base)
    tx = build_optimizer(1e-3, max_grad_norm=0.5)
    state = TrainState.create(tm, tx, seed=11)
    step = make_causal_lm_train_step(tm, tx, max_latents=TINY["max_latents"])
    losses, lines = [], []

    def recording(state, batch):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        return state, metrics

    cfg = TrainerConfig(**{**FIT, **extra}, prefetch_depth=depth, telemetry=telemetry, checkpoint_dir=ckpt)
    trainer = Trainer(cfg, log_fn=lambda line: lines.append(json.loads(line)))
    trainer.fit(state, recording, _loader, eval_step=make_causal_lm_eval_step(tm, TINY["max_latents"]),
                eval_loader_fn=lambda: _loader())
    trainer.close()
    return losses, trainer, lines


def _jax_fit(jm, params, depth, rec, ckpt):
    tx = jtr.build_optimizer(1e-3, max_grad_norm=0.5)
    state = jtr.TrainState.create(jax.tree_util.tree_map(jnp.array, params), tx)
    trainer = jfit.Trainer(jfit.TrainerConfig(**FIT, prefetch_depth=depth, telemetry=rec, checkpoint_dir=ckpt),
                           log_fn=lambda line: None)
    trainer.fit(state, jtr.make_causal_lm_train_step(jm, tx, max_latents=TINY["max_latents"]),
                lambda: _loader(JaxLoader), eval_step=jtr.make_causal_lm_eval_step(jm, TINY["max_latents"]),
                eval_loader_fn=lambda: _loader(JaxLoader))
    trainer.close()
    return trainer


@pytest.fixture
def one_thread():
    """CPU GEMMs over several threads may round differently from run to run
    while a prefetch thread competes for the cores: bit-for-bit comparisons
    of two fits run on one thread (the card is deterministic either way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fit_pair(x64):
    jm, params, tm = build_pair(TINY, seed=3)
    return jm, params, tm, {k: v.clone() for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("depth", [0, 2])
def test_fit_telemetry_is_inert_and_matches_the_jax_phases(fit_pair, tmp_path, depth, one_thread):
    jm, params, tm, base = fit_pair
    off, _, _ = _port_fit(tm, base, depth, False, ckpt=str(tmp_path / "off"))
    rec = TelemetryRecorder()
    on, trainer, _ = _port_fit(tm, base, depth, rec, ckpt=str(tmp_path / "on"))
    assert on == off and len(on) == FIT["max_steps"]  # every bit
    jrec = jax_core.TelemetryRecorder()
    jtrainer = _jax_fit(jm, params, depth, jrec, str(tmp_path / "jax"))
    port, jax_ = trainer.telemetry_summary, jtrainer.telemetry_summary
    assert trainer.telemetry is rec and not rec._closed  # a recorder passed in stays the caller's
    assert _phase_counts(port) == _phase_counts(jax_)
    assert _phase_counts(port) == {"train.fetch_wait": 8, "train.step_dispatch": 8, "train.log_sync": 4,
                                   "train.eval": 2, "train.ckpt_submit": 3, "train.ckpt_drain": 1}
    assert set(port["gauges"]) == set(jax_["gauges"]) == {"train.fetch_wait_frac"}
    assert port["compile"]["unexpected"] == [] and port["compile"]["per_function"] == {
        "train.step": {"compilations": 0, "budget": None}, "train.eval": {"compilations": 0, "budget": None}}
    modes = [e["args"]["mode"] for e in rec.chrome_trace()["traceEvents"] if e["name"] == "train.ckpt_submit"]
    jmodes = [e["args"]["mode"] for e in jrec.chrome_trace()["traceEvents"] if e["name"] == "train.ckpt_submit"]
    assert modes == jmodes == ["async", "async", "final"]


def test_fit_owned_recorder_closes_once_also_when_fit_unwinds(fit_pair, tmp_path):
    jm, params, tm, base = fit_pair
    path = tmp_path / "fit.json"
    _, trainer, _ = _port_fit(tm, base, 2, str(path), max_steps=4)
    trace = load_chrome_trace(str(path))
    assert jax_trace.validate_chrome_trace(trace) == [] and trainer.telemetry._closed
    assert trace["metadata"]["summary"]["phases"]["train.step_dispatch"]["count"] == 4

    def failing(state, batch):
        raise RuntimeError("step failed")

    path2 = tmp_path / "unwound.json"
    trainer = Trainer(TrainerConfig(max_steps=4, telemetry=str(path2), prefetch_depth=2), log_fn=lambda line: None)
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.fit(TrainState.create(tm, build_optimizer(1e-3)), failing, _loader)
    assert trainer.telemetry._closed and path2.exists() and trainer.telemetry_summary is not None
    assert not any(t.name.startswith("perceiver-") for t in threading.enumerate())


def test_profile_dir_writes_a_trace_and_the_event_at_the_jax_step(fit_pair, tmp_path):
    jm, params, tm, base = fit_pair
    prof = tmp_path / "prof"
    _, _, lines = _port_fit(tm, base, 0, None, max_steps=8, profile_dir=str(prof), profile_start_step=3,
                            profile_steps=3, checkpoint_every=0, eval_every=100)
    events = [line for line in lines if "profile_trace" in line]
    assert events == [{"step": 6, "profile_trace": str(prof)}]  # the JAX loop's step: start + steps
    files = os.listdir(prof)
    assert files == ["profile_steps_4-6.json"]
    with open(prof / files[0]) as f:
        trace = json.load(f)
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
    # max_steps inside the window: the trace is exported at the end
    _, _, lines = _port_fit(tm, base, 0, None, max_steps=4, profile_dir=str(tmp_path / "short"),
                            profile_start_step=3, profile_steps=5, checkpoint_every=0, eval_every=100)
    assert os.listdir(tmp_path / "short") == ["profile_steps_4-4.json"]


# ---------------------------------------------------------------- watchdog
class _Probe:
    def __init__(self, n=0):
        self.n = n

    def _cache_size(self):
        return self.n


def test_watchdog_flags_a_probe_over_budget():
    rec = TelemetryRecorder()
    wd = CompileWatchdog(recorder=rec)
    probe = _Probe(1)
    wd.watch("victim", probe, budget=1)
    wd.watch("plain", lambda: None)  # no probe: a watchable no-op
    assert wd.check() == [] and wd.compile_counts() == {"victim": 1, "plain": 0}
    probe.n = 2
    violations = wd.check()
    assert [(v["kind"], v["function"]) for v in violations] == [("budget_exceeded", "victim")]
    assert wd.check() == []  # reported once
    wd.mark_steady()
    probe.n = 3
    assert [v["kind"] for v in wd.check()] == ["budget_exceeded"]
    assert rec.counters["compile.unexpected"] == 2
    assert [e["name"] for e in rec.chrome_trace()["traceEvents"] if e["ph"] == "i"] == ["compile.unexpected"] * 2
    wd.close()
    wd.close()


def test_a_kernel_load_after_mark_steady_is_flagged(monkeypatch):
    """``cuda_build.library``'s first load of a library fires the listener:
    counted, its seconds in ``cuda.kernel_load``, and after ``mark_steady`` a
    violation (the build and the load faked: no nvcc here)."""
    monkeypatch.setattr(cuda_build, "build", lambda names: {n: {"seconds": 0.5, "ptxas": []} for n in names})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(cuda_build, "_target", lambda name: name)
    monkeypatch.setattr(cuda_build, "_libs", {})
    rec = TelemetryRecorder()
    wd = CompileWatchdog(recorder=rec)
    seen = []
    other = CompileWatchdog(on_violation=seen.append)
    cuda_build.library("warm")
    wd.mark_steady()
    other.mark_steady()
    assert wd.check() == []
    cuda_build.library("warm")  # loaded already: no event
    cuda_build.library("late")
    violations = wd.check()
    assert [(v["kind"], v["libraries"]) for v in violations] == [("backend_compile_after_steady", ["late"])]
    assert wd.check() == []
    assert other.check() and seen and seen[0]["compilations"] == 2
    s = rec.summary()
    assert s["counters"]["compile.backend_total"] == 2 and s["phases"]["cuda.kernel_load"]["count"] == 2
    assert wd.summary()["backend_compiles"] == 2
    wd.close()
    other.close()
    cuda_build.library("after_close")
    assert wd.backend_compiles == 2


def test_watchdog_silent_across_engine_churn(pair):
    engine = ServingEngine(pair[2], num_slots=2, kv_page_size=PAGE, telemetry=True)
    engine.watchdog.mark_steady()
    for i, n in enumerate([6, 7, 12, 8, 6, 9, 11]):
        engine.submit(_prompt(n, 3 + i), max_new_tokens=2 + i % 3)
    engine.run_until_drained(max_steps=200)
    assert engine.watchdog.violations == []
    summary = engine.telemetry_summary()
    assert summary["compile"]["unexpected"] == [] and summary["phases"]["serving.tick"]["count"] > 0
    engine.close()


def test_dropped_watchdogs_and_engines_are_not_pinned(pair):
    wd = CompileWatchdog()
    ref = weakref.ref(wd)
    assert wd in port_watchdog._LIVE_WATCHDOGS
    del wd
    gc.collect()
    assert ref() is None
    engine = ServingEngine(pair[2], num_slots=1, telemetry=True)
    engine_ref, wd_ref = weakref.ref(engine), weakref.ref(engine.watchdog)
    del engine
    gc.collect()
    assert engine_ref() is None and wd_ref() is None


# ---------------------------------------------------------------- manifests
def test_run_manifest_contents(tmp_path):
    artifact = tmp_path / "trace.json"
    artifact.write_text("{}\n")
    path = write_run_manifest(str(artifact), config={"preset": "tiny", "slots": 4}, extra={"note": "x"})
    assert path == str(tmp_path / "trace.manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    jax_fields = set(jax_manifest.build_run_manifest())
    assert set(manifest) == jax_fields | {"note"}
    assert manifest["schema"] == "run-manifest/v1"
    assert manifest["versions"] == {"torch": torch.__version__, "cuda": torch.version.cuda,
                                    "python": manifest["versions"]["python"]}
    assert manifest["devices"] == ({"backend": "cpu", "count": 1, "kinds": ["cpu"]} if not torch.cuda.is_available()
                                   else manifest["devices"])
    assert manifest["config"] == {"preset": "tiny", "slots": 4}
    assert manifest["artifact_schemas"] == ARTIFACT_SCHEMAS == jax_manifest.ARTIFACT_SCHEMAS
    json.dumps(build_run_manifest(config={"fn": open}))


@dataclasses.dataclass
class _Cfg:
    steps: int = 3
    name: str = "x"
    nested: dict = dataclasses.field(default_factory=lambda: {"a": [1, 2]})


@dataclasses.dataclass
class _Unpicklable:
    lock: object = dataclasses.field(default_factory=threading.Lock)
    steps: int = 2


@pytest.mark.parametrize("kind", ["dataclass", "namespace", "unpicklable"])
def test_jsonable_matches_jax(kind):
    obj = {"dataclass": _Cfg(), "namespace": argparse.Namespace(lr=1e-3, fn=print, tags=("a",)),
           "unpicklable": _Unpicklable()}[kind]
    got = port_manifest._jsonable(obj)
    assert got == jax_manifest._jsonable(obj)
    json.dumps(got)


# ------------------------------------------------------------------ report
def test_report_matches_the_jax_script_on_the_ports_artifacts(pair, fit_pair, tmp_path, capsys):
    tm = pair[2]
    trace_path, serving = str(tmp_path / "engine.json"), str(tmp_path / "serving.jsonl")
    engine = ServingEngine(tm, num_slots=2, kv_page_size=PAGE, prefix_cache=True, telemetry=trace_path,
                           metrics_jsonl=serving)
    _engine_run(engine, [(6, 3), (9, 20), (12, 40)], [3, 2, 4])
    engine.metrics.write_snapshot()
    engine.close()
    router_trace = str(tmp_path / "router.json")
    router = ServingRouter(tm, num_replicas=2, num_slots=1, telemetry=router_trace)
    router.submit(_prompt(6), max_new_tokens=2)
    router.submit(_prompt(7, 20), max_new_tokens=2)
    router.run_until_drained(max_steps=50)
    router.close()
    jm, params, ftm, base = fit_pair
    train_metrics = str(tmp_path / "train.jsonl")
    _port_fit(ftm, base, 0, None, metrics_jsonl=train_metrics, checkpoint_every=0)

    args = ["--trace", trace_path, "--trace", router_trace, "--serving-metrics", serving,
            "--train-metrics", train_metrics]
    report = port_report.main(args)
    port_out = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "obs_report_reference", os.path.join(os.path.dirname(__file__), "..", "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax_report = mod.main(args)
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert {k: v for k, v in jax_report.items() if k != "benches"} == report
    assert "phase breakdown" in port_out and "[serving.r1]" in port_out and "router.tick" in port_out
    assert report["traces"][0]["validation_problems"] == [] and report["traces"][1]["validation_problems"] == []
    assert report["serving_metrics"][0]["last_snapshot"]["requests_finished"] == 3
    assert report["train_metrics"][0]["train_log_windows"] > 0
    assert port_report.main(args + ["--json"]) == report
    with pytest.raises(SystemExit):
        port_report.main([])
