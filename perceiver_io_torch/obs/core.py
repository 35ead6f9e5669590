"""Telemetry core: counters, gauges and span timers.

Port of ``perceiver_io_tpu/obs/core.py``, the port's own copy (it imports
nothing of the JAX package). The serving engine, the router and the fit
loop time their host-side phases with it (admit, prefill, decode dispatch,
the sample sync, fetch wait, the log sync, ...), and it exports them as a
Chrome ``trace_event`` JSON (obs/trace.py) and as a per-phase summary
(``summary()``) that ``python -m perceiver_io_torch.obs.report`` renders.

Telemetry is off by default. A disabled surface holds the shared
``NULL_RECORDER``, whose every method returns a constant: an instrumented
hot path pays an attribute lookup and an empty call, never an allocation, a
lock or a device sync. Spans time host calls only; they never read a
tensor.

Clocks are injectable (``clock=`` takes any () -> float seconds callable),
so span arithmetic is exact under a fake clock in tests. Recording from
other threads (the prefetcher, the checkpoint writer) is safe: one lock, no
reentrancy.

Enablement:
  * explicit: ``ServingEngine(telemetry=...)``, ``ServingRouter(telemetry=...)``,
    ``TrainerConfig.telemetry``: ``True`` (an in-memory recorder), a path
    string (a recorder that writes its Chrome trace there on close), or a
    ``TelemetryRecorder`` the caller owns;
  * ambient: the ``PERCEIVER_IO_TORCH_TELEMETRY`` environment variable with
    the same encoding ("1"/"true" in memory, any other non-empty value a
    trace path), read only when the knob is ``None``;
  * ``False`` always wins over the environment.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

TELEMETRY_ENV = "PERCEIVER_IO_TORCH_TELEMETRY"

# Bounded event history: a long-lived engine records several events a
# generated token. Counters and histograms stay lifetime; only the raw trace
# events are windowed, and the drop count is reported.
MAX_TRACE_EVENTS = 200_000

# each phase's duration histogram keeps this many recent samples for its
# percentiles
HISTOGRAM_WINDOW = 4096


class _NullSpan:
    """The one reusable no-op context manager of the disabled recorder."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The disabled telemetry surface: every method is an inert no-op.

    One shared instance (``NULL_RECORDER``) stands wherever telemetry is
    off. ``enabled`` is the one flag instrumented code may branch on, to
    skip building arguments."""

    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def span_begin(self, name: str, **args) -> None:
        return None

    def span_end(self, name: str, **args) -> None:
        return None

    def async_begin(self, name: str, span_id, **args) -> None:
        return None

    def async_instant(self, name: str, span_id, phase_name: str, **args) -> None:
        return None

    def async_end(self, name: str, span_id, **args) -> None:
        return None

    def instant(self, name: str, **args) -> None:
        return None

    def counter_inc(self, name: str, n=1) -> None:
        return None

    def gauge_set(self, name: str, value) -> None:
        return None

    def observe(self, name: str, seconds: float) -> None:
        return None

    def summary(self) -> Dict:
        return {}

    def chrome_trace(self) -> Dict:
        return {"traceEvents": []}

    def write_chrome_trace(self, path: str) -> None:
        return None

    def close(self) -> None:
        return None


NULL_RECORDER = NullRecorder()


class _Span:
    """Context manager recording one complete ("X") span on exit."""

    __slots__ = ("_rec", "_name", "_args", "_t0")

    def __init__(self, rec: "TelemetryRecorder", name: str, args: Dict):
        self._rec = rec
        self._name = name
        self._args = args
        self._t0 = rec._clock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        rec = self._rec
        t1 = rec._clock()
        rec._record_complete(self._name, self._t0, t1 - self._t0, self._args)
        return False


class TelemetryRecorder:
    """Thread-safe in-process telemetry: counters, gauges, span timers.

    ``clock`` is any monotonic () -> float seconds callable (default
    ``time.monotonic``). Event timestamps are offsets from the recorder's
    construction, so traces of different processes align at zero.

    With ``trace_path`` set, ``close()`` writes the final Chrome trace
    there; a positive ``flush_interval_s`` also starts a daemon thread
    (``perceiver-telemetry-flush``) that rewrites the file periodically, so
    a run that dies still leaves a readable trace. ``close()`` stops and
    joins it."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic, trace_path: Optional[str] = None,
                 flush_interval_s: Optional[float] = None, max_events: int = MAX_TRACE_EVENTS):
        self._clock = clock
        self._origin = clock()
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._dropped = 0
        self._max_events = max_events
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # name -> [count, total, max, recent window]
        self._hist: Dict[str, list] = {}
        # (thread ident, name) -> start times of span_begin/span_end pairs
        self._open_spans: Dict[tuple, List[float]] = {}
        self.trace_path = trace_path
        self._closed = False
        self._flush_stop = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None
        if trace_path and flush_interval_s and flush_interval_s > 0:
            # a daemon: an owner that dies without close() must not hang the
            # interpreter's exit on a join (the thread's bound target keeps
            # this recorder alive, so __del__ could never run it down)
            self._flush_thread = threading.Thread(target=self._flush_loop, args=(float(flush_interval_s),),
                                                  name="perceiver-telemetry-flush", daemon=True)
            self._flush_thread.start()

    # ---------------------------------------------------------------- recording
    def _now(self) -> float:
        return self._clock() - self._origin

    def _append_event(self, event: Dict) -> None:
        # the caller holds the lock; the deque's maxlen evicts
        if len(self._events) >= self._max_events:
            self._dropped += 1
        self._events.append(event)

    def _record_complete(self, name: str, t0: float, dur: float, args: Dict) -> None:
        start = t0 - self._origin
        with self._lock:
            self._observe_locked(name, dur)
            self._append_event({"ph": "X", "name": name, "ts": start, "dur": dur, "tid": threading.get_ident(),
                                **({"args": args} if args else {})})

    def span(self, name: str, **args) -> _Span:
        """Time a with-block as one complete span (it also feeds the histogram)."""
        return _Span(self, name, args)

    def span_begin(self, name: str, **args) -> None:
        """Open a span that ``span_end`` closes later on the same thread
        (for phases that are not one with-block). Pairs nest per (thread,
        name)."""
        t0 = self._clock()
        with self._lock:
            self._open_spans.setdefault((threading.get_ident(), name), []).append(t0)

    def span_end(self, name: str, **args) -> None:
        t1 = self._clock()
        key = (threading.get_ident(), name)
        with self._lock:
            stack = self._open_spans.get(key)
            if not stack:
                return  # an unmatched end is ignored, not recorded
            t0 = stack.pop()
            if not stack:
                del self._open_spans[key]
            self._observe_locked(name, t1 - t0)
            self._append_event({"ph": "X", "name": name, "ts": t0 - self._origin, "dur": t1 - t0, "tid": key[0],
                                **({"args": args} if args else {})})

    def async_begin(self, name: str, span_id, **args) -> None:
        """Open an async span (Chrome "b"), keyed by id: a lifecycle that
        crosses ticks and threads (a request, keyed by the ``request_id`` of
        the serving-metrics events)."""
        with self._lock:
            self._append_event({"ph": "b", "cat": name, "name": name, "id": span_id, "ts": self._now(),
                                "tid": threading.get_ident(), **({"args": args} if args else {})})

    def async_instant(self, name: str, span_id, phase_name: str, **args) -> None:
        """A named milestone ("n") inside an open async span."""
        with self._lock:
            self._append_event({"ph": "n", "cat": name, "name": phase_name, "id": span_id, "ts": self._now(),
                                "tid": threading.get_ident(), **({"args": args} if args else {})})

    def async_end(self, name: str, span_id, **args) -> None:
        with self._lock:
            self._append_event({"ph": "e", "cat": name, "name": name, "id": span_id, "ts": self._now(),
                                "tid": threading.get_ident(), **({"args": args} if args else {})})

    def instant(self, name: str, **args) -> None:
        """One timestamped marker ("i"), e.g. an unexpected capture."""
        with self._lock:
            self._append_event({"ph": "i", "name": name, "ts": self._now(), "s": "t", "tid": threading.get_ident(),
                                **({"args": args} if args else {})})

    def counter_inc(self, name: str, n=1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge_set(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    def _observe_locked(self, name: str, seconds: float) -> None:
        h = self._hist.get(name)
        if h is None:
            h = self._hist[name] = [0, 0.0, 0.0, deque(maxlen=HISTOGRAM_WINDOW)]
        h[0] += 1
        h[1] += seconds
        h[2] = max(h[2], seconds)
        h[3].append(seconds)

    def observe(self, name: str, seconds: float) -> None:
        """Feed a measured duration into a phase histogram, with no trace event."""
        with self._lock:
            self._observe_locked(name, seconds)

    # ----------------------------------------------------------------- reading
    def summary(self) -> Dict:
        """Per-phase duration statistics, counters and gauges. Percentiles
        cover the recent ``HISTOGRAM_WINDOW``; count and total are lifetime."""
        with self._lock:
            phases = {}
            for name, (count, total, mx, window) in sorted(self._hist.items()):
                w = sorted(window)
                phases[name] = {
                    "count": count,
                    "total_s": round(total, 6),
                    "mean_s": round(total / count, 6) if count else 0.0,
                    "p50_s": round(_quantile(w, 0.50), 6),
                    "p95_s": round(_quantile(w, 0.95), 6),
                    "max_s": round(mx, 6),
                }
            out = {"phases": phases, "counters": dict(sorted(self.counters.items())),
                   "gauges": dict(sorted(self.gauges.items()))}
            if self._dropped:
                out["trace_events_dropped"] = self._dropped
            return out

    def chrome_trace(self) -> Dict:
        from perceiver_io_torch.obs.trace import to_chrome_trace

        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        return to_chrome_trace(events, summary=self.summary(), dropped=dropped)

    def write_chrome_trace(self, path: str) -> str:
        from perceiver_io_torch.obs.trace import write_chrome_trace

        return write_chrome_trace(path, self.chrome_trace())

    # ---------------------------------------------------------------- lifecycle
    def _flush_loop(self, interval: float) -> None:
        while not self._flush_stop.wait(interval):
            try:
                self.write_chrome_trace(self.trace_path)
            except Exception:
                pass  # a failed periodic flush keeps the thread; close() writes loudly

    def close(self) -> None:
        """Join the flush thread and write the final trace (with a
        ``trace_path``). Idempotent, and a no-op when racing interpreter
        shutdown."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        thread = self._flush_thread
        if thread is not None:
            self._flush_stop.set()
            thread.join()
            self._flush_thread = None
        if self.trace_path:
            try:
                self.write_chrome_trace(self.trace_path)
            except Exception:
                if sys.is_finalizing():
                    return  # the file machinery is already torn down
                raise

    def __del__(self):  # a backstop; close() is the contract
        try:
            self.close()
        except Exception:
            pass


def _quantile(sorted_xs: List[float], q: float) -> float:
    """Linearly interpolated quantile of a sorted list."""
    if not sorted_xs:
        return 0.0
    if len(sorted_xs) == 1:
        return sorted_xs[0]
    pos = q * (len(sorted_xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_xs) - 1)
    frac = pos - lo
    return sorted_xs[lo] * (1.0 - frac) + sorted_xs[hi] * frac


def telemetry_env_setting() -> Optional[str]:
    """``PERCEIVER_IO_TORCH_TELEMETRY``'s value, or None when it is unset
    or off ("", "0", "false")."""
    raw = os.environ.get(TELEMETRY_ENV, "").strip()
    if raw.lower() in ("", "0", "false"):
        return None
    return raw


def resolve_recorder(telemetry=None):
    """A telemetry knob as ``(recorder, owned)``. ``owned`` is True when
    this call made the recorder (from ``True``, a path or the environment):
    the surface that resolved it closes it (which writes the trace when it
    has a path). A recorder passed in stays the caller's.

      * ``None``   read ``PERCEIVER_IO_TORCH_TELEMETRY``; unset means off.
      * ``False``  off, whatever the environment says.
      * ``True``   on, in memory.
      * ``str``    on, the Chrome trace written to that path at close.
      * recorder   any object with the recorder surface, used as it is.
    """
    if telemetry is None:
        telemetry = telemetry_env_setting()
        if telemetry is not None and telemetry.lower() in ("1", "true"):
            telemetry = True
    if telemetry is None or telemetry is False:
        return NULL_RECORDER, False
    if telemetry is True:
        return TelemetryRecorder(), True
    if isinstance(telemetry, str):
        return TelemetryRecorder(trace_path=telemetry), True
    return telemetry, False
