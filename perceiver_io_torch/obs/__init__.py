"""Telemetry of the port: a recorder of counters, gauges and span timers
(off by default, a shared no-op recorder when off), Chrome traces, the
compile watchdog over CUDA graph captures and kernel-library loads, and run
manifests. Port of ``perceiver_io_tpu/obs/``; ``python -m
perceiver_io_torch.obs.report`` renders the artifacts."""

from perceiver_io_torch.obs.core import (NULL_RECORDER, TELEMETRY_ENV, NullRecorder, TelemetryRecorder,
                                         resolve_recorder, telemetry_env_setting)
from perceiver_io_torch.obs.manifest import (ARTIFACT_SCHEMAS, build_run_manifest, manifest_path_for,
                                             write_run_manifest)
from perceiver_io_torch.obs.trace import (load_chrome_trace, to_chrome_trace, validate_chrome_trace,
                                          write_chrome_trace)
from perceiver_io_torch.obs.watchdog import CompileWatchdog

__all__ = [
    "ARTIFACT_SCHEMAS",
    "CompileWatchdog",
    "NULL_RECORDER",
    "NullRecorder",
    "TELEMETRY_ENV",
    "TelemetryRecorder",
    "build_run_manifest",
    "load_chrome_trace",
    "manifest_path_for",
    "resolve_recorder",
    "telemetry_env_setting",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_run_manifest",
]
