"""Compile watchdog: unexpected graph captures and kernel loads at runtime.

Port of ``perceiver_io_tpu/obs/watchdog.py`` with its API (``watch(name,
fn, budget)``, ``compile_counts``, ``mark_steady``, ``check``, ``summary``,
``close``; it never raises). The port compiles no XLA programs, so it
counts what takes their place:

  * **Per-function counts** through the same probe, ``fn._cache_size()``.
    The serving engine registers an object whose ``_cache_size()`` is its
    decode step's CUDA graph captures, as ``{obs_ns}.decode_step`` with
    budget 1. A callable with no probe is a watchable no-op (the eager
    train step, as in the JAX package a plain function). ``check()`` polls
    the probes at tick and log boundaries; a count past its budget is a
    violation.
  * **Process-wide loads** of the hand-written kernels' libraries, the
    counterpart of XLA's backend compiles: ``ops/cuda_build.py``'s
    ``library()`` calls a listener at each first load of a library in the
    process (with its build when nvcc ran). One module-level dispatcher,
    installed at the first watchdog, fans the load out to the live
    watchdogs (a weak set, so it pins none), which count it as
    ``compile.backend_total`` and feed its seconds into the phase
    ``cuda.kernel_load`` (the JAX package's ``jax.compile.backend``).
  * **Steady state**: ``mark_steady()`` freezes the current counts; any
    growth after it, budgeted or not, a capture or a kernel load, is a
    violation.

A violation is reported once (a count that jumped from 1 to 3 is one
report), counted on the recorder (``compile.unexpected``), put in the trace
as an instant event and kept on ``watchdog.violations``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional

from perceiver_io_torch.obs.core import NULL_RECORDER

# one process-wide load listener, installed at the first watchdog, over a
# WEAK set: a strong one would pin every watchdog (and the engine objects its
# probes reach) whose owner dropped it without close()
_DISPATCH_LOCK = threading.Lock()
_LIVE_WATCHDOGS: "weakref.WeakSet[CompileWatchdog]" = weakref.WeakSet()
_LISTENER_INSTALLED = False

# the phase the kernel libraries' build-and-load seconds feed
KERNEL_LOAD_PHASE = "cuda.kernel_load"


def _dispatch_kernel_load(name: str, seconds: float, built: bool) -> None:
    with _DISPATCH_LOCK:
        targets = list(_LIVE_WATCHDOGS)
    for wd in targets:
        wd._on_backend_compile(seconds, name)


def _install_listener() -> None:
    global _LISTENER_INSTALLED
    with _DISPATCH_LOCK:
        if _LISTENER_INSTALLED:
            return
        from perceiver_io_torch.ops import cuda_build

        cuda_build.add_load_listener(_dispatch_kernel_load)
        _LISTENER_INSTALLED = True


def _cache_size(fn) -> Optional[int]:
    """The count behind a watched object's ``_cache_size()`` probe (the
    captures of a decode graph), or None when it has no probe."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


class CompileWatchdog:
    """Tracks capture and kernel-load activity for one surface (an engine,
    a trainer run)."""

    def __init__(self, recorder=NULL_RECORDER, on_violation: Optional[Callable[[Dict], None]] = None):
        self._recorder = recorder
        self._on_violation = on_violation
        self._lock = threading.Lock()
        self._watched: Dict[str, Dict] = {}  # name -> {fn, budget, reported}
        self.backend_compiles = 0  # kernel libraries first loaded in the process while live
        self._loaded: List[str] = []  # their names, in order
        self._steady: Optional[Dict[str, int]] = None
        self._steady_backend: Optional[int] = None
        self.violations: List[Dict] = []
        self._closed = False
        _install_listener()
        with _DISPATCH_LOCK:
            _LIVE_WATCHDOGS.add(self)

    # ----------------------------------------------------------------- wiring
    def _on_backend_compile(self, duration: float, name: str = "") -> None:
        with self._lock:
            self.backend_compiles += 1
            self._loaded.append(name)
        self._recorder.counter_inc("compile.backend_total")
        self._recorder.observe(KERNEL_LOAD_PHASE, duration)

    def watch(self, name: str, fn, budget: Optional[int] = None) -> None:
        """Register an object with a ``_cache_size()`` probe. ``budget`` is
        its largest legitimate count (1 for the decode graph); None leaves it
        policed only after ``mark_steady()``."""
        with self._lock:
            self._watched[name] = {"fn": fn, "budget": budget, "reported": _cache_size(fn) or 0}

    def compile_counts(self) -> Dict[str, int]:
        """Each watch's current count (0 for one with no probe)."""
        with self._lock:
            return {name: _cache_size(w["fn"]) or 0 for name, w in self._watched.items()}

    def mark_steady(self) -> None:
        """Freeze the current counts as the plateau: every capture or kernel
        load after this, anywhere in the process, is flagged."""
        with self._lock:
            self._steady = {name: _cache_size(w["fn"]) or 0 for name, w in self._watched.items()}
            self._steady_backend = self.backend_compiles

    # ------------------------------------------------------------------ checks
    def check(self) -> List[Dict]:
        """Poll the probes; return (and record) the violations new since the
        last check. One int read a watch."""
        fresh: List[Dict] = []
        with self._lock:
            for name, w in self._watched.items():
                count = _cache_size(w["fn"])
                if count is None:
                    continue
                budget = w["budget"]
                if budget is not None and count > budget and count > w["reported"]:
                    fresh.append({"kind": "budget_exceeded", "function": name, "compilations": count,
                                  "budget": budget})
                    w["reported"] = count
                if self._steady is not None and count > self._steady.get(name, 0) and count > w["reported"]:
                    fresh.append({"kind": "recompile_after_steady", "function": name, "compilations": count,
                                  "steady": self._steady.get(name, 0)})
                    w["reported"] = count
            if self._steady_backend is not None and self.backend_compiles > self._steady_backend:
                fresh.append({"kind": "backend_compile_after_steady", "function": "process",
                              "compilations": self.backend_compiles, "steady": self._steady_backend,
                              "libraries": self._loaded[self._steady_backend:]})
                self._steady_backend = self.backend_compiles  # the jump is reported once
            self.violations.extend(fresh)
        for v in fresh:
            self._recorder.counter_inc("compile.unexpected")
            self._recorder.instant("compile.unexpected", **v)
            if self._on_violation is not None:
                self._on_violation(v)
        return fresh

    def summary(self) -> Dict:
        """Per-watch counts and budgets, the process's kernel loads and the
        violations."""
        counts = self.compile_counts()
        with self._lock:
            return {
                "per_function": {name: {"compilations": counts[name], "budget": w["budget"]}
                                 for name, w in self._watched.items()},
                "backend_compiles": self.backend_compiles,
                "unexpected": list(self.violations),
            }

    def close(self) -> None:
        """Leave the load dispatcher. Idempotent, and safe at interpreter
        shutdown."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        with _DISPATCH_LOCK:
            _LIVE_WATCHDOGS.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
