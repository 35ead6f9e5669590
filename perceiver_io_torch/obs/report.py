"""Telemetry report: phase tables from the port's observability artifacts.

Port of ``scripts/obs_report.py``, reading through the port's own readers
(``obs/trace.py``, ``serving/metrics.py``, ``training/metrics.py``)::

    python -m perceiver_io_torch.obs.report --trace trace.json \
        --serving-metrics serving.jsonl --train-metrics train.jsonl [--json]

  * ``--trace``           a Chrome trace written by a ``TelemetryRecorder``
                          (the serving engine, the router, ``Trainer.fit``);
                          the recorder's summary rides in its metadata.
  * ``--serving-metrics`` a serving-metrics JSONL event stream (any schema
                          version ``serving/metrics.py`` reads).
  * ``--train-metrics``   a train-metrics/v1 JSONL stream.

The JAX script's ``--bench`` (a benchmark JSON's embedded telemetry block)
waits for the port's benchmark and is left out.

Output: one phase table a source (count, total, mean, p50, p95, max, share
of the accounted time; a router's trace one table a replica namespace), the
counters and gauges, the compile watchdog's report (per-watch counts against
budgets, unexpected captures and kernel loads, loud when any), request
lifetimes from the async spans, and summaries of the metric streams.
``--json`` prints the same as one object. A trace is validated before it is
trusted; problems are reported, not swallowed. It reads JSON only and runs
on the CPU, wherever the files are.
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Dict, List

from perceiver_io_torch.obs.trace import load_chrome_trace, validate_chrome_trace


def phase_table(phases: Dict[str, Dict], title: str) -> List[str]:
    """Render one summary['phases'] dict as an aligned text table."""
    lines = [title, "-" * len(title)]
    if not phases:
        lines.append("(no phases recorded)")
        return lines
    total_known = sum(p.get("total_s", 0.0) for p in phases.values())
    header = f"{'phase':<28} {'count':>7} {'total_s':>9} {'mean_ms':>9} {'p50_ms':>8} {'p95_ms':>8} {'max_ms':>8} {'share':>6}"
    lines.append(header)
    for name, p in sorted(phases.items(), key=lambda kv: -kv[1].get("total_s", 0.0)):
        share = p.get("total_s", 0.0) / total_known if total_known > 0 else 0.0
        lines.append(
            f"{name:<28} {p.get('count', 0):>7} {p.get('total_s', 0.0):>9.4f} "
            f"{p.get('mean_s', 0.0) * 1e3:>9.3f} {p.get('p50_s', 0.0) * 1e3:>8.3f} "
            f"{p.get('p95_s', 0.0) * 1e3:>8.3f} {p.get('max_s', 0.0) * 1e3:>8.3f} "
            f"{share:>6.1%}"
        )
    return lines


_REPLICA_NS = re.compile(r"^(serving\.r\d+)\.")


def split_replica_phases(phases: Dict[str, Dict]) -> Dict[str, Dict[str, Dict]]:
    """Group phase names by replica namespace (``serving.rN.*`` — the span
    prefixes a ServingRouter gives its engines on ONE shared recorder) so a
    multi-replica trace renders one phase table per replica. Everything else
    (router spans, training phases, plain ``serving.*`` engines) lands under
    the ``""`` key — the shared table."""
    groups: Dict[str, Dict[str, Dict]] = {}
    for name, p in phases.items():
        m = _REPLICA_NS.match(name)
        groups.setdefault(m.group(1) if m else "", {})[name] = p
    return groups


def replica_phase_tables(phases: Dict[str, Dict], source: str) -> List[str]:
    """Aligned tables for one phase dict: the shared table first, then one
    per replica namespace when the trace came from a router fleet."""
    groups = split_replica_phases(phases)
    lines: List[str] = []
    shared = groups.pop("", {})
    if shared or not groups:
        lines += phase_table(shared if groups else phases,
                             f"phase breakdown — {source}")
    for ns in sorted(groups):
        lines.append("")
        lines += phase_table(groups[ns], f"phase breakdown — {source} [{ns}]")
    return lines


def compile_report(compile_block: Dict) -> List[str]:
    lines = ["compile watchdog", "----------------"]
    per_fn = compile_block.get("per_function", {})
    for name, info in sorted(per_fn.items()):
        budget = info.get("budget")
        lines.append(
            f"{name:<28} {info.get('compilations', 0):>3} compiled"
            + (f"  (budget {budget})" if budget is not None else "")
        )
    lines.append(f"{'backend compiles (process)':<28} {compile_block.get('backend_compiles', 0):>3}")
    unexpected = compile_block.get("unexpected", [])
    if unexpected:
        lines.append(f"!! {len(unexpected)} UNEXPECTED compile event(s):")
        for v in unexpected:
            lines.append(f"   - {json.dumps(v)}")
    else:
        lines.append("no unexpected recompiles")
    return lines


def summarize_trace_events(trace: Dict) -> Dict:
    """Fallback aggregation from raw complete events, for traces whose
    metadata carries no summary (foreign or truncated artifacts)."""
    phases: Dict[str, Dict] = {}
    for ev in trace.get("traceEvents", []):
        # tolerate malformed events: the validator reports them, the
        # aggregation must not crash on them
        if ev.get("ph") != "X" or not isinstance(ev.get("dur"), (int, float)):
            continue
        sec = ev["dur"] / 1e6
        p = phases.setdefault(ev.get("name", "?"), {"count": 0, "total_s": 0.0, "max_s": 0.0, "_durs": []})
        p["count"] += 1
        p["total_s"] += sec
        p["max_s"] = max(p["max_s"], sec)
        p["_durs"].append(sec)
    for p in phases.values():
        durs = sorted(p.pop("_durs"))
        p["mean_s"] = p["total_s"] / p["count"]
        p["p50_s"] = durs[len(durs) // 2]
        p["p95_s"] = durs[min(int(len(durs) * 0.95), len(durs) - 1)]
        p["total_s"] = round(p["total_s"], 6)
    return phases


def report_trace(path: str) -> Dict:
    trace = load_chrome_trace(path)
    problems = validate_chrome_trace(trace)
    meta = trace.get("metadata", {})
    summary = meta.get("summary") or {}
    phases = summary.get("phases") or summarize_trace_events(trace)
    out = {
        "source": path,
        "events": len(trace.get("traceEvents", [])),
        "phases": phases,
        "counters": summary.get("counters", {}),
        "gauges": summary.get("gauges", {}),
        "validation_problems": problems,
    }
    # request-lifecycle stats from async spans (serving traces); events with
    # no numeric ts are skipped — the validator already reported them
    begins = {(e.get("cat"), e.get("id")): e["ts"] for e in trace.get("traceEvents", [])
              if e.get("ph") == "b" and isinstance(e.get("ts"), (int, float))}
    by_cat: Dict[str, List[float]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "e" or not isinstance(e.get("ts"), (int, float)):
            continue
        key = (e.get("cat"), e.get("id"))
        if key in begins:
            by_cat.setdefault(e.get("cat") or "?", []).append((e["ts"] - begins[key]) / 1e6)

    def _stats(xs: List[float]) -> Dict:
        xs = sorted(xs)
        return {"count": len(xs), "p50": round(xs[len(xs) // 2], 6),
                "max": round(xs[-1], 6)}

    lifetimes = [d for durs in by_cat.values() for d in durs]
    if lifetimes:
        out["request_lifetimes_s"] = _stats(lifetimes)
        if len(by_cat) > 1:
            # per-category breakdown: each engine owns a collision-safe
            # ``request.eN`` namespace, so a router fleet's shared trace
            # splits into per-replica request-lifetime stats here
            out["request_lifetimes_by_cat"] = {
                cat: _stats(durs) for cat, durs in sorted(by_cat.items())
            }
    return out


def _lifetimes_by_priority(events: List[Dict]) -> Dict[str, Dict]:
    """Per-priority-class request-lifetime stats from the v6 event stream:
    join each ``submit`` (carrying ``priority``) against its terminal
    ``finish``/``reject`` by request id and aggregate the wall deltas per
    class. Pre-v6 streams have no ``priority`` on submits — those requests
    land in the ``"unknown"`` class rather than being silently dropped."""
    submits: Dict = {}
    for e in events:
        if e.get("event") == "submit" and isinstance(e.get("ts"), (int, float)):
            prio = e.get("priority")
            submits[e.get("request_id")] = (
                e["ts"], "unknown" if prio is None else str(prio)
            )
    by_class: Dict[str, List[float]] = {}
    for e in events:
        if e.get("event") not in ("finish", "reject"):
            continue
        if not isinstance(e.get("ts"), (int, float)):
            continue
        hit = submits.get(e.get("request_id"))
        if hit is None:
            continue
        ts0, prio = hit
        by_class.setdefault(prio, []).append(e["ts"] - ts0)

    def _stats(xs: List[float]) -> Dict:
        xs = sorted(xs)
        return {"count": len(xs), "p50_s": round(xs[len(xs) // 2], 6),
                "p95_s": round(xs[min(int(len(xs) * 0.95), len(xs) - 1)], 6),
                "max_s": round(xs[-1], 6)}

    return {prio: _stats(xs) for prio, xs in sorted(by_class.items())}


def report_serving_metrics(path: str) -> Dict:
    from perceiver_io_torch.serving.metrics import load_metrics_jsonl

    loaded = load_metrics_jsonl(path)
    out: Dict = {"source": path, "events": len(loaded["events"])}
    if loaded["snapshots"]:
        snap = loaded["snapshots"][-1]
        out["last_snapshot"] = {
            k: snap.get(k)
            for k in ("schema", "requests_submitted", "requests_finished", "rejected",
                      "timed_out", "failed", "tokens_generated", "decode_tokens_per_s",
                      "wall_tokens_per_s", "mean_slot_occupancy")
        }
        # serving-metrics/v5 page pool (None: dense engine or pre-v5 stream)
        out["page_pool"] = snap.get("page_pool")
        alloc_failures = sum(1 for e in loaded["events"] if e.get("event") == "alloc_failure")
        if alloc_failures:
            out["alloc_failure_events"] = alloc_failures
        # serving-metrics/v6 priority/preemption (None on pre-v6 streams)
        out["preemptions"] = snap.get("preemptions")
        out["preempted_replays"] = snap.get("preempted_replays")
        out["queue_wait_by_priority"] = snap.get("queue_wait_by_priority")
        # serving-metrics/v7 journal gauges (None: journal-less engine or
        # pre-v7 stream) + the recovery events ServingEngine.recover emits
        out["journal"] = snap.get("journal")
        # serving-metrics/v8 prefix-cache / chunked-prefill gauges (None:
        # feature off, router snapshot, or pre-v8 stream)
        out["prefix_cache"] = snap.get("prefix_cache")
        out["chunked_prefill"] = snap.get("chunked_prefill")
        # serving-metrics/v9 quantized-serving gauges (None: fp pages /
        # untouched params, router snapshot, or pre-v9 stream)
        out["kv_quant"] = snap.get("kv_quant")
        out["weight_serving"] = snap.get("weight_serving")
        # serving-metrics/v10 fleet-operations gauges (None: plain engine
        # or pre-v10 stream; real on router snapshots)
        out["fleet_ops"] = snap.get("fleet_ops")
        # serving-metrics/v11 unified-ragged-tick gauges (None: dense
        # engine, router snapshot, or pre-v11 stream)
        out["ragged_tick"] = snap.get("ragged_tick")
        # serving-metrics/v12 out-of-process transport gauges (None:
        # in-process fleet, plain engine, or pre-v12 stream)
        out["transport"] = snap.get("transport")
        respawns = [e for e in loaded["events"] if e.get("event") == "respawn"]
        if respawns:
            out["respawn_events"] = {
                "count": len(respawns),
                "sessions_recovered": sum(e.get("sessions", 0)
                                          for e in respawns),
            }
        rpc_retries = [e for e in loaded["events"]
                       if e.get("event") == "rpc_retry"]
        if rpc_retries:
            out["rpc_retry_events"] = {
                "count": len(rpc_retries),
                "by_op": {op: sum(1 for e in rpc_retries if e.get("op") == op)
                          for op in sorted({e.get("op") for e in rpc_retries})},
            }
        migrations = [e for e in loaded["events"] if e.get("event") == "migrate"]
        if migrations:
            out["migrate_events"] = {
                "count": len(migrations),
                "emitted_tokens": sum(e.get("emitted_tokens", 0)
                                      for e in migrations),
            }
        recycles = [e for e in loaded["events"] if e.get("event") == "recycle"]
        if recycles:
            out["recycle_events"] = {
                "count": len(recycles),
                "sessions_moved": sum(e.get("sessions_moved", 0)
                                      for e in recycles),
                "leftover_sessions": sum(e.get("leftover_sessions", 0)
                                         for e in recycles),
            }
        autoscales = [e for e in loaded["events"]
                      if e.get("event") == "autoscale"]
        if autoscales:
            out["autoscale_events"] = {
                "count": len(autoscales),
                "ups": sum(1 for e in autoscales if e.get("direction") == "up"),
                "downs": sum(1 for e in autoscales
                             if e.get("direction") == "down"),
            }
        prefix_hits = [e for e in loaded["events"] if e.get("event") == "prefix_hit"]
        if prefix_hits:
            out["prefix_hit_events"] = {
                "count": len(prefix_hits),
                "shared_pages": sum(e.get("shared_pages", 0) for e in prefix_hits),
                "shared_tokens": sum(e.get("shared_tokens", 0) for e in prefix_hits),
            }
        prefix_evicts = [e for e in loaded["events"] if e.get("event") == "prefix_evict"]
        if prefix_evicts:
            out["prefix_evict_events"] = {
                "count": len(prefix_evicts),
                "pages_freed": sum(e.get("pages_freed", 0) for e in prefix_evicts),
            }
    recoveries = [e for e in loaded["events"] if e.get("event") == "recovery"]
    if recoveries:
        out["recoveries"] = {
            "count": len(recoveries),
            "sessions_recovered": sum(e.get("sessions", 0) for e in recoveries),
            "replayed_tokens": sum(e.get("replayed_tokens", 0) for e in recoveries),
            "torn_tails": sum(1 for e in recoveries if e.get("truncated")),
            "dropped_records": sum(e.get("dropped_records", 0) for e in recoveries),
        }
    lifetimes = _lifetimes_by_priority(loaded["events"])
    if lifetimes:
        out["request_lifetimes_by_priority"] = lifetimes
    return out


def report_train_metrics(path: str) -> Dict:
    from perceiver_io_torch.training.metrics import load_metrics_jsonl, summarize

    loaded = load_metrics_jsonl(path)
    return {"source": path, "events": len(loaded["events"]),
            **summarize(loaded["events"])}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 epilog="--bench (a benchmark's embedded telemetry block) waits for the port's "
                                        "benchmark and is not offered yet.")
    ap.add_argument("--trace", action="append", default=[],
                    help="Chrome trace JSON written by a TelemetryRecorder")
    ap.add_argument("--serving-metrics", action="append", default=[],
                    help="serving-metrics JSONL event log")
    ap.add_argument("--train-metrics", action="append", default=[],
                    help="train-metrics JSONL stream")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    if not (args.trace or args.serving_metrics or args.train_metrics):
        ap.error("nothing to report: pass at least one artifact "
                 "(--trace/--serving-metrics/--train-metrics)")

    report: Dict = {"traces": [], "serving_metrics": [], "train_metrics": []}
    for path in args.trace:
        report["traces"].append(report_trace(path))
    for path in args.serving_metrics:
        report["serving_metrics"].append(report_serving_metrics(path))
    for path in args.train_metrics:
        report["train_metrics"].append(report_train_metrics(path))

    if args.json:
        print(json.dumps(report, indent=1))
        return report

    for section in report["traces"]:
        src = section.get("source", "?")
        if "error" in section:
            print(f"\n== {src}: {section['error']}")
            continue
        print()
        for line in replica_phase_tables(section.get("phases", {}), src):
            print(line)
        if section.get("counters") or section.get("gauges"):
            print("counters:", json.dumps(section.get("counters", {})))
            print("gauges:  ", json.dumps(section.get("gauges", {})))
        if section.get("compile"):
            print()
            for line in compile_report(section["compile"]):
                print(line)
        if section.get("request_lifetimes_s"):
            print("request lifetimes:", json.dumps(section["request_lifetimes_s"]))
        for cat, stats in (section.get("request_lifetimes_by_cat") or {}).items():
            print(f"  [{cat}]", json.dumps(stats))
        problems = section.get("validation_problems")
        if problems:
            print(f"!! trace validation problems ({len(problems)}):")
            for p in problems[:10]:
                print("   -", p)
    for section in report["serving_metrics"]:
        print(f"\nserving metrics — {section['source']}: {section['events']} events")
        if "last_snapshot" in section:
            print(json.dumps(section["last_snapshot"], indent=1))
        pool = section.get("page_pool")
        if pool:
            ppr = pool.get("pages_per_request") or {}
            print("page pool: "
                  f"{pool.get('pages_in_use')}/{pool.get('pages_total')} pages in use, "
                  f"pages/request p50={ppr.get('p50')} p95={ppr.get('p95')}, "
                  f"alloc failures={pool.get('alloc_failures')}")
        # v9 quantized-serving rendering (suppressed where the reader
        # normalized to None: quant off, router snapshot, pre-v9 stream) —
        # the HBM split KV-vs-weights an operator sizes a chip against
        kvq = section.get("kv_quant")
        if kvq:
            rate = kvq.get("agreement_rate")
            print("kv quant: "
                  f"mode={kvq.get('mode')}, "
                  f"{kvq.get('bytes_per_token')}/{kvq.get('bytes_per_token_fp')} "
                  f"KV bytes/token (quant/fp), greedy agreement "
                  f"{'unsampled' if rate is None else format(rate, '.2%')} "
                  f"({kvq.get('agreement_matched')}/{kvq.get('agreement_tokens')} tokens)")
        ws = section.get("weight_serving")
        if ws:
            fp_b = ws.get("param_bytes_fp") or 0
            served = ws.get("param_bytes") or 0
            ratio = f"{served / fp_b:.2f}x fp" if fp_b else "n/a"
            print("weight serving: "
                  f"dtype={ws.get('dtype')}, params {served} bytes ({ratio})")
        # v11 unified-ragged-tick rendering (suppressed where the reader
        # normalized to None: dense engine, router, pre-v11 stream) — the
        # programs-per-tick headline an operator checks before trusting the
        # one-launch steady state, plus the tick's mixed-batch composition
        rt = section.get("ragged_tick")
        if rt:
            ppt = rt.get("programs_per_tick") or {}
            build = rt.get("descriptor_build_s") or {}
            print("ragged tick: "
                  f"{'ragged' if rt.get('enabled') else 'composed (kill-switch)'}, "
                  f"{rt.get('ticks')} dispatching ticks, "
                  f"programs/tick p50={ppt.get('p50')} p95={ppt.get('p95')}, "
                  f"descriptor build p95={build.get('p95')}s")
            for key in ("chunk_items", "finish_items", "decode_items"):
                stats = rt.get(key) or {}
                print(f"  {key}: p50={stats.get('p50')} p95={stats.get('p95')}")
        # v10 fleet-operations rendering (suppressed where the reader
        # normalized to None: plain engine or pre-v10 stream) — the
        # migration/recycle/rollout/autoscale story an operator audits
        # after a deploy or a capacity change
        fo = section.get("fleet_ops")
        if fo:
            print("fleet ops: "
                  f"{fo.get('migrations')} migrations, "
                  f"{fo.get('recycles')} recycles, "
                  f"scale +{fo.get('scale_ups')}/-{fo.get('scale_downs')}, "
                  f"{fo.get('replicas_active')} replicas active"
                  + (", restart in progress"
                     if fo.get("restart_in_progress") else ""))
            rollout = fo.get("rollout")
            if rollout:
                print("  rollout: "
                      f"primary v{rollout.get('primary_version')}, "
                      f"v{rollout.get('rollout_version')} at "
                      f"{rollout.get('fraction')}")
                for v, row in sorted((rollout.get("versions") or {}).items(),
                                     key=lambda kv: int(kv[0])):
                    print(f"    v{v}: {row.get('submitted')} submitted, "
                          f"{row.get('finished')} finished, "
                          f"{row.get('tokens_generated')} tokens")
            for key in ("migrate_events", "recycle_events", "autoscale_events"):
                if section.get(key):
                    print(f"  {key}:", json.dumps(section[key]))
        # v12 out-of-process transport rendering (suppressed where the
        # reader normalized to None: in-process fleet or pre-v12 stream) —
        # the RPC tax and the supervisor's respawn ledger
        tp = section.get("transport")
        if tp:
            print("transport: "
                  f"{tp.get('rpcs')} rpcs "
                  f"(p50={tp.get('rpc_p50_ms')}ms p95={tp.get('rpc_p95_ms')}ms), "
                  f"{tp.get('retries')} retries, {tp.get('timeouts')} timeouts, "
                  f"{tp.get('worker_respawns')} worker respawns, "
                  f"{tp.get('workers_alive')} workers alive, "
                  f"{tp.get('bytes_sent')}B out / {tp.get('bytes_recv')}B in")
            for key in ("respawn_events", "rpc_retry_events"):
                if section.get(key):
                    print(f"  {key}:", json.dumps(section[key]))
        # v7 journal health + recovery rendering (suppressed on journal-less
        # engines and pre-v7 streams, where the reader normalized to None)
        jstats = section.get("journal")
        if jstats:
            print("journal: "
                  f"{jstats.get('bytes_written')} bytes / "
                  f"{jstats.get('records_appended')} records appended, "
                  f"{jstats.get('fsyncs')} fsyncs ({jstats.get('fsync')} policy), "
                  f"{jstats.get('compactions')} compactions, "
                  f"generation {jstats.get('generation')}, "
                  f"{jstats.get('live_sessions')} live sessions")
        # v8 prefix-cache / chunked-prefill rendering (suppressed where the
        # reader normalized to None: feature off, router, pre-v8 stream)
        pc = section.get("prefix_cache")
        if pc:
            rate = pc.get("hit_rate")
            print("prefix cache: "
                  f"{pc.get('hits')} hits / {pc.get('misses')} misses "
                  f"(hit rate {'n/a' if rate is None else format(rate, '.1%')}), "
                  f"{pc.get('cached_pages')} cached pages, "
                  f"{pc.get('shared_pages_in_use')} shared pages in use, "
                  f"{pc.get('evictions')} evictions "
                  f"({pc.get('evicted_pages')} pages evicted)")
        ph = section.get("prefix_hit_events")
        if ph:
            print(f"  prefix hits: {ph['count']} admissions reused "
                  f"{ph['shared_pages']} pages / {ph['shared_tokens']} tokens")
        pe = section.get("prefix_evict_events")
        if pe:
            print(f"  prefix evictions: {pe['count']} episodes freed "
                  f"{pe['pages_freed']} pages under pool pressure")
        cp = section.get("chunked_prefill")
        if cp:
            print("chunked prefill: "
                  f"{cp.get('chunks_dispatched')} chunks dispatched over "
                  f"{cp.get('chunked_admissions')} chunked admissions "
                  f"(chunk_tokens={cp.get('chunk_tokens')})")
        rec = section.get("recoveries")
        if rec:
            print(f"recoveries: {rec['count']} "
                  f"(sessions recovered: {rec['sessions_recovered']}, "
                  f"replayed tokens: {rec['replayed_tokens']}, "
                  f"torn tails: {rec['torn_tails']}, "
                  f"dropped records: {rec['dropped_records']})")
        # v6 priority/preemption rendering (suppressed on pre-v6 streams,
        # where the reader normalized the fields to None)
        if section.get("preemptions") is not None:
            print(f"preemptions: {section['preemptions']} "
                  f"(resumed as replay: {section.get('preempted_replays')})")
        waits = section.get("queue_wait_by_priority")
        if waits:
            for prio, stats in sorted(waits.items()):
                print(f"  queue wait [class {prio}]: "
                      f"p50={stats.get('p50')}s p95={stats.get('p95')}s")
        for prio, stats in (section.get("request_lifetimes_by_priority") or {}).items():
            print(f"  lifetime [class {prio}]: {stats['count']} requests, "
                  f"p50={stats['p50_s']}s p95={stats['p95_s']}s max={stats['max_s']}s")
    for section in report["train_metrics"]:
        print(f"\ntrain metrics — {section['source']}:")
        print(json.dumps({k: v for k, v in section.items() if k != "source"}, indent=1))
    return report


if __name__ == "__main__":
    main()
