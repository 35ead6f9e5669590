"""The port's metrics JSONL stream against the JAX package's, on the CPU.

The port's engine and the JAX engine, on the same converted weights and one
stream of greedy requests in float64, write event streams that agree in
event names, request ids, slots, statuses, reasons and counts (timestamps
and timings left out), on dense and paged pools, under preemption, with
chunked prefill and the prefix cache, and with the journal's ``recovery``
event. Each package's ``load_metrics_jsonl`` reads the other's file; the
reader normalises the fields older schemas lack; ``close`` is idempotent;
a signal's drain writes the final snapshot. A quantized engine's greedy
agreement with a float reference (``record_quant_agreement``) rides its
``quant_agreement`` event and its ``kv_quant`` section, as in the JAX
engine."""

import json
import signal

import pytest
from test_torch_support import SERVING, build_pair

from perceiver_io_torch.serving import KNOWN_SCHEMAS, SCHEMA, EngineMetrics, ServingEngine, load_metrics_jsonl
from perceiver_io_torch.serving.metrics import LATENCY_WINDOW
from perceiver_io_tpu.serving import ServingEngine as JaxEngine
from perceiver_io_tpu.serving import load_metrics_jsonl as jax_load_metrics_jsonl
from perceiver_io_tpu.serving.metrics import KNOWN_SCHEMAS as JAX_KNOWN_SCHEMAS
from perceiver_io_tpu.serving.metrics import SCHEMA as JAX_SCHEMA

PAGE = 2
# timings and clocks: left out of the comparison
TIMED = {"ts", "wait_s", "prefill_s", "seconds"}
# the snapshot counters both engines keep under the same keys
COUNTERS = ("requests_submitted", "requests_admitted", "requests_finished", "rejected", "timed_out", "failed",
            "tokens_generated", "decode_steps", "prefills", "preemptions", "preempted_replays", "queue_depth",
            "failovers", "shed_infeasible", "breaker_transitions", "fleet_ops", "transport", "kv_quant", "schema")
SCENARIOS = {
    "dense": (dict(num_slots=2), False),
    "paged-fp": (dict(num_slots=3, kv_page_size=PAGE), False),
    "paged-int8-preempt": (dict(num_slots=2, kv_page_size=PAGE, kv_quant="int8"), True),
    "dense-preempt": (dict(num_slots=2), True),
    "chunked-prefix": (dict(num_slots=3, kv_page_size=PAGE, prefill_chunk_tokens=4, prefix_cache=True,
                            max_prefill_slots=2), False),
}


@pytest.fixture(scope="module")
def pair(x64):
    return build_pair(SERVING)


def _prompts():
    shared = [5, 9, 13, 17]  # two pages a prompt shares
    return [shared + [(7 * i + j) % 63 + 1 for j in range(n - 4)] for i, n in enumerate([8, 8, 9, 12, 8, 10])]


def _drive(engine, preempt):
    """Six greedy requests of at least max_latents tokens; with ``preempt``
    a class-1 request arrives after two ticks, a queue-full rejection and
    a cancellation go in, and the engine drains."""
    prompts = _prompts()
    handles = [engine.submit(p, max_new_tokens=4) for p in prompts[:4]]
    engine.step()
    engine.step()
    if preempt:
        handles.append(engine.submit(prompts[4], max_new_tokens=3, priority=1))
        engine.step()
        engine.evict_request(handles[3].request_id)
        engine.max_queue_depth = 0
        handles.append(engine.submit(prompts[5], max_new_tokens=2))  # rejected: queue_full
        engine.max_queue_depth = None
    engine.run_until_drained(max_steps=300)
    engine.metrics.write_snapshot()
    engine.close()
    return handles


def _normal(events):
    out = []
    for e in events:
        if e["event"] == "snapshot":
            out.append({k: e[k] for k in COUNTERS} | {"event": "snapshot"})
        else:
            out.append({k: v for k, v in e.items() if k not in TIMED})
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_event_stream_equals_the_jax_engine(pair, scenario, tmp_path):
    jm, params, tm = pair
    kw, preempt = SCENARIOS[scenario]
    port_handles = _drive(ServingEngine(tm, metrics_jsonl=str(tmp_path / "port.jsonl"), **kw), preempt)
    jax_handles = _drive(JaxEngine(jm, params, metrics_jsonl=str(tmp_path / "jax.jsonl"), **kw), preempt)
    assert [h.result().tolist() for h in port_handles] == [h.result().tolist() for h in jax_handles]
    port = load_metrics_jsonl(str(tmp_path / "port.jsonl"))
    jax_read = jax_load_metrics_jsonl(str(tmp_path / "port.jsonl"))  # the JAX reader takes the port's file
    assert jax_read["events"] == port["events"]
    jax = load_metrics_jsonl(str(tmp_path / "jax.jsonl"))  # and the port's reader the JAX file
    assert _normal(port["events"]) == _normal(jax["events"])
    names = {e["event"] for e in port["events"]}
    assert {"submit", "admit", "decode_step", "finish", "snapshot"} <= names
    if preempt:
        assert {"preempt", "reject"} <= names
    if scenario == "chunked-prefix":
        assert {"chunk", "prefix_hit"} <= names
    snap = port["snapshots"][-1]
    assert snap["requests_submitted"] == (snap["requests_finished"] + snap["rejected"] + snap["timed_out"]
                                          + snap["failed"])
    submits = [e for e in port["events"] if e["event"] == "submit"]
    terminal = [e for e in port["events"] if e["event"] in ("finish", "reject")]
    assert len(submits) == len(terminal) == snap["requests_submitted"]


def test_journal_gauges_and_the_recovery_event(pair, tmp_path):
    jm, params, tm = pair
    streams = {}
    for name, engine_cls, args in (("port", ServingEngine, (tm,)), ("jax", JaxEngine, (jm, params))):
        path = tmp_path / f"{name}.jsonl"
        engine = engine_cls(*args, num_slots=2, journal=str(tmp_path / f"j-{name}"), metrics_jsonl=str(path))
        for p in _prompts()[:3]:
            engine.submit(p, max_new_tokens=3)
        engine.step()
        engine.step()
        snap = engine.metrics.write_snapshot()
        assert snap["journal"]["records_appended"] >= 5 and snap["journal"]["fsyncs"] >= 4
        assert snap["journal"]["live_sessions"] == 3
        # process death: recovery writes the recovery event to the same stream
        recovered, info = engine_cls.recover(*args, str(tmp_path / f"j-{name}"), num_slots=2,
                                             metrics_jsonl=str(path))
        recovered.run_until_drained(max_steps=300)
        snap = recovered.metrics.write_snapshot()
        assert snap["journal"]["live_sessions"] == 0 and snap["journal"]["sessions_recovered"] == 3
        assert snap["journal"]["generation"] == 2
        recovered.close()
        streams[name] = load_metrics_jsonl(str(path))
        rec = next(e for e in streams[name]["events"] if e["event"] == "recovery")
        assert rec["sessions"] == 3 and rec["truncated"] is False and rec["replayed_tokens"] == 4
    assert _normal(streams["port"]["events"]) == _normal(streams["jax"]["events"])
    # the bytes differ with the rng field ([seed] against a two-word key) and the timestamps' digits
    journal_keys = lambda name: [{k: v for k, v in s["journal"].items() if k not in ("path", "bytes_written")}
                                 for s in streams[name]["snapshots"]]
    assert journal_keys("port") == journal_keys("jax")


@pytest.mark.parametrize("schema", list(KNOWN_SCHEMAS))
def test_reader_normalises_older_schemas(tmp_path, schema):
    path = tmp_path / "old.jsonl"
    path.write_text(json.dumps({"event": "submit", "request_id": 0}) + "\n\n"
                    + json.dumps({"event": "snapshot", "schema": schema, "requests_submitted": 1,
                                  "queue_wait_s": {"mean": 1.0, "max": 1.0}}) + "\n")
    got = load_metrics_jsonl(str(path))
    assert got == jax_load_metrics_jsonl(str(path))
    snap = got["snapshots"][0]
    version = int(schema.rsplit("v", 1)[1])
    for key, since in (("rejected", 3), ("failovers", 4), ("page_pool", 5), ("preemptions", 6), ("journal", 7),
                       ("prefix_cache", 8), ("weight_serving", 9), ("fleet_ops", 10), ("ragged_tick", 11),
                       ("transport", 12)):
        assert (key in snap) == (version < since) and snap.get(key) is None
    if version == 1:
        assert snap["queue_wait_s"]["p50"] is None and snap["prefill_s"]["p95"] is None


def test_schema_constants_and_an_unknown_schema(tmp_path):
    assert SCHEMA == JAX_SCHEMA == "serving-metrics/v12" and KNOWN_SCHEMAS == JAX_KNOWN_SCHEMAS
    path = tmp_path / "foreign.jsonl"
    path.write_text(json.dumps({"event": "snapshot", "schema": "serving-metrics/v99"}) + "\n")
    with pytest.raises(ValueError, match="unknown metrics schema"):
        load_metrics_jsonl(str(path))


def test_close_is_idempotent_and_final(tmp_path):
    path = tmp_path / "m.jsonl"
    metrics = EngineMetrics(num_slots=2, jsonl_path=str(path))
    metrics.record_submit(0, 5)
    metrics.record_reject(0, "queue_full")
    metrics.close()
    metrics.close()
    metrics.record_submit(1, 5)  # after close: counted, not written
    events = load_metrics_jsonl(str(path))["events"]
    assert [e["event"] for e in events] == ["submit", "reject"]
    assert metrics.requests_submitted == 2
    silent = EngineMetrics(num_slots=2)  # no path: no file, the counters only
    silent.record_submit(0, 5)
    for _ in range(LATENCY_WINDOW + 10):
        silent.record_decode_step(1, 0.001, 1)
    snap = silent.write_snapshot()
    assert snap["requests_submitted"] == 1 and snap["decode_steps"] == LATENCY_WINDOW + 10
    assert len(silent._decode_times) == LATENCY_WINDOW  # latency statistics are windowed


def test_a_signal_drain_writes_the_final_snapshot(pair, tmp_path):
    tm = pair[2]
    path = tmp_path / "m.jsonl"
    engine = ServingEngine(tm, num_slots=2, handle_preemption=True, journal=str(tmp_path / "j"),
                           metrics_jsonl=str(path))
    running = [engine.submit(p, max_new_tokens=4) for p in _prompts()[:2]]
    engine.step()
    backlog = engine.submit(_prompts()[2], max_new_tokens=4)
    signal.raise_signal(signal.SIGTERM)
    engine.run_until_drained(max_steps=100)
    assert engine.preempted and all(h.ok for h in running) and backlog.finish_reason == "draining"
    got = load_metrics_jsonl(str(path))
    assert got["events"][-1]["event"] == "snapshot"
    snap = got["snapshots"][-1]
    assert snap["requests_finished"] == 2 and snap["rejected"] == 1 and snap["journal"]["live_sessions"] == 0
    assert engine.journal._closed and engine.metrics._closed


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_agreement_event_and_kv_quant_section(pair, mode, tmp_path):
    """``record_quant_agreement`` folds samples into the ``kv_quant``
    section's ``agreement_tokens``, ``agreement_matched`` and
    ``agreement_rate`` (None before any sample) and writes a
    ``quant_agreement`` event, as the JAX engine's does on the same pool;
    each package's reader takes the other's file."""
    jm, params, tm = pair
    files, snaps = {}, {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        kw = dict(num_slots=2, kv_page_size=PAGE, kv_quant=mode, metrics_jsonl=str(path))
        engine = ServingEngine(tm, **kw) if pkg == "port" else JaxEngine(jm, params, **kw)
        cold = engine.metrics.snapshot()["kv_quant"]
        assert cold["agreement_tokens"] == cold["agreement_matched"] == 0 and cold["agreement_rate"] is None
        engine.metrics.record_quant_agreement(matched=7, total=8)
        engine.metrics.record_quant_agreement(matched=2, total=4)
        snaps[pkg] = engine.metrics.write_snapshot()["kv_quant"]
        engine.close()
        files[pkg] = path
    assert snaps["port"] == snaps["jax"]
    assert (snaps["port"]["agreement_tokens"], snaps["port"]["agreement_matched"]) == (12, 9)
    assert snaps["port"]["agreement_rate"] == 0.75 and snaps["port"]["mode"] == mode
    for writer in ("port", "jax"):
        for reader in (load_metrics_jsonl, jax_load_metrics_jsonl):
            got = reader(str(files[writer]))
            events = [{k: v for k, v in e.items() if k != "ts"} for e in got["events"]
                      if e["event"] == "quant_agreement"]
            assert events == [{"event": "quant_agreement", "matched": 7, "total": 8},
                              {"event": "quant_agreement", "matched": 2, "total": 4}]
            assert got["snapshots"][-1]["kv_quant"] == snaps["port"]
