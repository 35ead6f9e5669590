"""Training driver: the fit loop on one device.

Port of ``perceiver_io_tpu/training/fit.py`` (``TrainerConfig`` with the JAX
field names, ``Trainer.fit`` and the count-weighted ``Trainer.evaluate``):
the step loop over epochs, ``log_every`` window lines (the window's mean
loss, latent tokens/s and MFU, from one host read of the window's device
sums), ``eval_every`` validation, and the best value of ``monitor``.

``mesh_axes`` builds ``make_mesh(mesh_axes)`` over the model's device type
(one position per visible card, or the CPU) and runs every train and eval
step under it as the ambient mesh, so a model with
``sequence_parallel_axis`` runs its ring attention there. Only meshes whose
axes above size 1 are all ``seq`` are taken: batch, parameter, tensor and
pipeline sharding (parallel/sharding.py, api.py, pipeline.py) are not
ported, and such a mesh raises.

Resilience (the JAX loop's, ported): ``checkpoint_dir`` with
``checkpoint_every`` saves ``<checkpoint_dir>/last`` every N steps as a
lineage save (the previous generation rotated to ``last.prev``, a manifest
after the state) with the loader's position in ``last_iterator.json``,
through the async writer (``async_checkpoint``; its snapshot costs the step
thread no host sync on a card) or inline; an eval that improves ``monitor``
saves ``best`` with ``best_metric.json`` and ``best_iterator.json``; the
loop ends in a synchronous save of ``last``. ``prefetch_depth`` > 0 moves
collation and placement to a ``DevicePrefetcher`` thread (0: on the step
thread). ``handle_preemption`` installs a once-only SIGTERM/SIGINT handler
(main thread only): the loop stops after a completed step, before the next
batch is pulled, the writer drains, the prefetcher joins, a ``preempted``
event is written and the final save is the exact resume point.
``metrics_jsonl`` streams every log record as ``train-metrics/v1``. Every
batch passes ``faults.poison_batch`` (``batch.nan``). The JAX loop's
environment kill switches (``PERCEIVER_IO_TPU_DISABLE_PREFETCH``,
``..._ASYNC_CHECKPOINT``) are TPU rollback levers and are not ported: the
fields are the switches.

Telemetry (``obs/``): ``telemetry`` (the engine's encoding) records the
JAX loop's phases: ``train.fetch_wait`` (the step thread blocked on the
input, observed without a trace event), ``train.step_dispatch``,
``train.log_sync`` around the window's one host read, ``train.eval``,
``train.ckpt_submit`` (``mode`` "async", "sync" or "final") and
``train.ckpt_drain``, the ``train.fetch_wait_frac`` gauge a log window,
and a compile watchdog (the eager steps are watchable no-ops; kernel
libraries loaded after the first log boundary, or after the first eval
when one is configured, are flagged). A recorder the fit made from its
knob is closed once, also when fit unwinds; ``Trainer.telemetry`` and
``Trainer.telemetry_summary`` hold the last fit's. ``profile_dir``: a
``torch.profiler`` trace (CPU activity, and CUDA on a card) of steps
``profile_start_step`` + 1 to ``profile_start_step + profile_steps``,
bracketed by a device synchronize each side as JAX's ``block_until_ready``,
exported as a Chrome trace into ``profile_dir`` (``profile_steps_<a>-<b>.json``)
and announced by a ``profile`` event.

``pipeline_axis`` (parallel/pipeline.py) is not ported yet and raises when
set.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from perceiver_io_torch.data.prefetch import DevicePrefetcher, make_put
from perceiver_io_torch.obs.core import resolve_recorder
from perceiver_io_torch.obs.watchdog import CompileWatchdog
from perceiver_io_torch.parallel.mesh import make_mesh, set_mesh
from perceiver_io_torch.reliability import faults
from perceiver_io_torch.reliability.preemption import install_preemption_handler, restore_preemption_handler
from perceiver_io_torch.reliability.retry import RetryPolicy, retry_call
from perceiver_io_torch.training.checkpoint import (AsyncCheckpointWriter, restore_checkpoint, restore_latest_valid,
                                                    save_checkpoint_lineage)
from perceiver_io_torch.training.metrics import make_writer
from perceiver_io_torch.training.trainer import TrainState


@dataclass
class TrainerConfig:
    max_steps: int = 1000
    eval_every: int = 200
    log_every: int = 50
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    monitor: str = "loss"  # validation metric whose best value is kept
    monitor_mode: str = "min"
    mesh_axes: Optional[Dict[str, int]] = None
    parallel_mode: str = "fsdp"
    pipeline_axis: Optional[str] = None
    tokens_per_batch: Optional[int] = None  # enables tokens/s in the log lines
    flops_per_step: Optional[float] = None  # with peak_flops, enables MFU (see training.flops)
    peak_flops: Optional[float] = None
    prefetch_depth: int = 2
    async_checkpoint: bool = True
    profile_dir: Optional[str] = None
    profile_start_step: int = 3
    profile_steps: int = 5
    handle_preemption: bool = True
    telemetry: object = None
    metrics_jsonl: Optional[str] = None


# field -> the JAX module it needs, for the fields that raise when set
_UNPORTED = {
    "pipeline_axis": "parallel/pipeline.py",
}


def _print_flush(line: str) -> None:
    """The default log sink, flushed a line at a time, so that a preemption
    leaves the log whole up to the last step boundary."""
    print(line, flush=True)


def _under_mesh(fn: Callable, mesh) -> Callable:
    """``fn`` run with ``mesh`` as the ambient mesh."""

    def wrapped(*args, **kwargs):
        with set_mesh(mesh):
            return fn(*args, **kwargs)

    return wrapped


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the profiler's brackets)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _host(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host read of a dict of scalars."""
    keys = list(values)
    got = torch.stack([torch.as_tensor(values[k], dtype=torch.float64) for k in keys]).tolist()
    return dict(zip(keys, got))


class Trainer:
    def __init__(self, config: TrainerConfig, log_fn: Callable[[str], None] = _print_flush):
        unported = [f"{name} ({where})" for name, where in _UNPORTED.items() if getattr(config, name)]
        if unported:
            raise NotImplementedError(f"TrainerConfig fields not ported yet: {', '.join(unported)}")
        sharded = [a for a, n in (config.mesh_axes or {}).items() if a != "seq" and n != 1]
        if sharded:
            raise NotImplementedError(f"mesh axes {sharded} of {config.mesh_axes}: only the 'seq' axis (ring "
                                      "attention) runs on the port; batch, parameter, tensor and pipeline sharding "
                                      "(parallel/sharding.py, api.py, pipeline.py) are not ported yet")
        self.config = config
        self.log = log_fn
        self.history: list = []
        self.best: Optional[float] = None  # the best ``monitor`` value seen by evaluate
        self.preempted = False  # True after a fit() stopped on SIGTERM/SIGINT
        self.writer: Optional[AsyncCheckpointWriter] = None  # the last fit's writer (its timings)
        self.final_save: Optional[Dict] = None  # the last fit's final save's timings
        self.telemetry = None  # the recorder of the last fit with telemetry on
        self.telemetry_summary: Optional[Dict] = None  # its final summary, with the compile block
        self._preempt_requested = False
        self._train_source = None
        # the metric stream is shared by this trainer's fits (a resume appends); close() releases it
        self._metrics_writer = make_writer(config.metrics_jsonl)

    def _emit(self, kind: str, line: Dict) -> None:
        """One log record to both sinks: the train-metrics/v1 stream and ``log_fn``."""
        if self._metrics_writer is not None:
            self._metrics_writer.write(kind, line)
        self.log(json.dumps(line))

    def close(self) -> None:
        """Release the metric stream's file (idempotent)."""
        if self._metrics_writer is not None:
            self._metrics_writer.close()

    def _install_preemption_handler(self) -> Tuple[Optional[Callable], dict]:
        """The once-only SIGTERM/SIGINT handler that asks the loop to stop at
        its next step boundary (a no-op off the main thread, or with
        ``handle_preemption`` off). Returns (handler, previous handlers)."""
        if not self.config.handle_preemption:
            return None, {}

        def _flag():
            self._preempt_requested = True

        return install_preemption_handler(_flag)

    def fit(
        self,
        state,  # TrainState, or a zero-argument factory of one
        train_step: Callable,
        train_loader_fn: Callable[[], Iterable],
        eval_step: Optional[Callable] = None,
        eval_loader_fn: Optional[Callable[[], Iterable]] = None,
        on_eval: Optional[Callable[[TrainState, Dict], None]] = None,
        initial_best: Optional[float] = None,
    ) -> TrainState:
        """Run ``train_step(state, batch)`` until ``max_steps`` (or a
        preemption); numpy batches from the loaders are put on the model's
        device, by the prefetcher's thread with ``prefetch_depth`` > 0.
        ``initial_best`` carries an earlier run's best ``monitor`` value
        across a resume, so that a worse first eval does not replace
        ``best``."""
        cfg = self.config
        if callable(state):
            state = state()
        device = next(state.model.parameters()).device
        put = make_put(device)
        if cfg.mesh_axes:
            mesh = make_mesh(cfg.mesh_axes, device_type=device.type)
            train_step = _under_mesh(train_step, mesh)
            eval_step = None if eval_step is None else _under_mesh(eval_step, mesh)

        retry = RetryPolicy()
        if cfg.prefetch_depth > 0:
            wrap = lambda src: DevicePrefetcher(src, depth=cfg.prefetch_depth, device=device, retry_policy=retry)
            loop_put = lambda batch: batch  # placed by the prefetcher's thread
        else:
            wrap = lambda src: src

            def fetch_and_place(batch):
                faults.fire_loader_fetch()  # the fetch's fault points fire on the step thread here
                return put(batch)

            loop_put = lambda batch: retry_call(fetch_and_place, batch, policy=retry)
        writer = AsyncCheckpointWriter() if (cfg.async_checkpoint and cfg.checkpoint_dir and cfg.checkpoint_every) \
            else None
        self.writer, self.final_save = writer, None

        # telemetry, resolved per fit: a recorder made here from the knob is
        # closed when this fit ends (its trace written), one passed in stays
        # open. The watchdog marks steady at the first log boundary (after the
        # first eval when one is configured) and checks at each later one
        obs, owns_obs = resolve_recorder(cfg.telemetry)
        obs_on = obs.enabled
        watchdog = CompileWatchdog(recorder=obs) if obs_on else None
        if watchdog is not None:
            watchdog.watch("train.step", train_step)
            if eval_step is not None:
                watchdog.watch("train.eval", eval_step)
        self.telemetry = obs if obs_on else None
        self.telemetry_summary = None
        steady_marked = False
        evaled_once = False
        obs_closed = False

        def close_obs():
            # once: on the success path after the final save (the trace holds
            # it), or from the finally when fit unwinds
            nonlocal obs_closed
            if obs_closed:
                return
            obs_closed = True
            if watchdog is not None:
                watchdog.check()
                self.telemetry_summary = {**obs.summary(), "compile": watchdog.summary()}
                watchdog.close()
            if owns_obs:
                obs.close()

        self.best = initial_best
        step_count = state.step
        window_t0, window_steps = time.perf_counter(), 0
        fetch_wait_window = 0.0  # seconds the step thread waited on input in this log window
        acc, acc_steps = None, 0  # the log window's metric sums, kept on the device
        # a stateful (resumable) loader is obtained once and re-iterated each
        # epoch, so that its position survives and can be saved; stateless
        # sources are built anew per epoch, as in the JAX loop
        raw_first = train_loader_fn()
        stateful = hasattr(raw_first, "state_dict")
        first_source = wrap(raw_first)
        self._train_source = first_source if stateful else None
        epoch_source = None
        profiler = None
        self._preempt_requested = False
        self.preempted = False
        fit_ok = False  # an explicit flag: sys.exc_info() also reports a caller's exception being handled
        on_preempt, prev_handlers = self._install_preemption_handler()
        try:
            while step_count < cfg.max_steps and not self._preempt_requested:
                epoch_source = first_source if stateful else wrap(train_loader_fn())
                self._train_source = epoch_source if stateful else None
                epoch_iter = iter(epoch_source)
                while True:
                    # fetch wait: the step thread blocked on the input pipeline
                    # (near zero while the prefetcher keeps up)
                    t_fetch = time.perf_counter() if obs_on else 0.0
                    try:
                        batch = next(epoch_iter)
                    except StopIteration:
                        break
                    if obs_on:
                        wait_s = time.perf_counter() - t_fetch
                        fetch_wait_window += wait_s
                        obs.observe("train.fetch_wait", wait_s)
                    if cfg.profile_dir and step_count == cfg.profile_start_step and profiler is None:
                        _sync(device)  # the trace holds this fit's steps only
                        profiler = _start_profiler(device)
                        profile_from = step_count + 1
                    with obs.span("train.step_dispatch"):
                        state, metrics = train_step(state, faults.poison_batch(loop_put(batch)))
                    step_count += 1
                    window_steps += 1
                    acc = dict(metrics) if acc is None else {k: acc[k] + metrics[k] for k in acc}
                    acc_steps += 1

                    if profiler is not None and step_count >= cfg.profile_start_step + cfg.profile_steps:
                        _sync(device)
                        self._export_profile(profiler, profile_from, step_count)
                        profiler = None
                        self._emit("profile", {"step": step_count, "profile_trace": cfg.profile_dir})
                        # the export's time stays out of the window's throughput
                        window_t0, window_steps, fetch_wait_window = time.perf_counter(), 0, 0.0

                    if step_count % cfg.log_every == 0:
                        with obs.span("train.log_sync"):
                            sums = _host(acc)  # the window's one sync
                        means = {k: v / acc_steps for k, v in sums.items()}
                        acc, acc_steps = None, 0
                        dt = time.perf_counter() - window_t0
                        line = {"step": step_count, **{k: round(v, 5) for k, v in means.items()}}
                        if cfg.tokens_per_batch:
                            line["tokens_per_sec"] = round(cfg.tokens_per_batch * window_steps / dt, 1)
                            if cfg.flops_per_step and cfg.peak_flops:
                                line["mfu"] = round(cfg.flops_per_step * window_steps / dt / cfg.peak_flops, 4)
                        if obs_on:
                            # the window's share of wall time waiting on input
                            obs.gauge_set("train.fetch_wait_frac", round(fetch_wait_window / dt, 4) if dt > 0 else 0.0)
                            fetch_wait_window = 0.0
                            if watchdog is not None:
                                if steady_marked:
                                    watchdog.check()
                                elif eval_step is None or evaled_once:
                                    # what loaded before is warm-up; with eval
                                    # configured, the first eval's too
                                    watchdog.mark_steady()
                                    steady_marked = True
                        self.history.append(line)
                        self._emit("train_log", line)
                        window_t0, window_steps = time.perf_counter(), 0

                    if cfg.checkpoint_dir and cfg.checkpoint_every and step_count % cfg.checkpoint_every == 0:
                        last = os.path.join(cfg.checkpoint_dir, "last")
                        with obs.span("train.ckpt_submit", step=step_count,
                                      mode="async" if writer is not None else "sync"):
                            aux = self._iterator_aux("last_iterator.json")
                            if writer is not None:  # a snapshot only: the writer thread serialises
                                writer.submit(last, state, aux_files=aux, lineage=True, step=step_count)
                            else:
                                save_checkpoint_lineage(last, state, aux_files=aux, step=step_count)
                        # the save's time must not count in the next window's throughput
                        window_t0, window_steps, fetch_wait_window = time.perf_counter(), 0, 0.0

                    if eval_step is not None and step_count % cfg.eval_every == 0:
                        with obs.span("train.eval", step=step_count):
                            val = self.evaluate(eval_step, eval_loader_fn(), put)
                        evaled_once = True
                        line = {"step": step_count, **{f"val_{k}": round(v, 5) for k, v in val.items()}}
                        self.history.append(line)
                        self._emit("val", line)
                        if on_eval is not None:
                            on_eval(state, val)
                        self._maybe_checkpoint(state, val, writer)
                        window_t0, window_steps, fetch_wait_window = time.perf_counter(), 0, 0.0

                    if step_count >= cfg.max_steps or self._preempt_requested:
                        # stop after the completed step and before the loop pulls
                        # another batch, which would move the loader's position
                        # past a batch that was never trained on
                        break
            fit_ok = True
        finally:
            restore_preemption_handler(on_preempt, prev_handlers)
            for src in (epoch_source, first_source):  # threads join on every way out
                if isinstance(src, DevicePrefetcher):
                    src.shutdown()
            if profiler is not None and not fit_ok:
                profiler.stop()  # an unwinding fit exports nothing
            if writer is not None:
                try:
                    with obs.span("train.ckpt_drain"):
                        writer.close()  # drains: the final save below must not race a background write
                except Exception:
                    if fit_ok:  # an unwinding fit keeps its own exception
                        close_obs()
                        raise
            if not fit_ok:
                close_obs()

        try:
            if profiler is not None:  # max_steps inside the profile window
                _sync(device)
                self._export_profile(profiler, profile_from, step_count)
            self.preempted = self._preempt_requested
            if self.preempted:
                self._emit("preempted", {"step": step_count, "preempted": True})
            if cfg.checkpoint_dir:
                # the final synchronous save: after a preemption, the exact resume point
                with obs.span("train.ckpt_submit", step=step_count, mode="final"):
                    self.final_save = save_checkpoint_lineage(os.path.join(cfg.checkpoint_dir, "last"), state,
                                                              aux_files=self._iterator_aux("last_iterator.json"),
                                                              step=step_count)
        finally:
            close_obs()  # also when the tail raises: that run's trace is the one wanted
        return state

    def _export_profile(self, profiler, first: int, last: int) -> str:
        """Stop ``profiler`` and write its Chrome trace of steps
        ``first``..``last`` into ``profile_dir``; returns the file's path."""
        profiler.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir, f"profile_steps_{first}-{last}.json")
        profiler.export_chrome_trace(path)
        return path

    def _iterator_aux(self, filename: str) -> Optional[Dict]:
        """The loader-position sidecar of a lineage save, taken now, in step
        with the state's snapshot (under prefetch, the position of the last
        batch the step loop took, not the worker's read-ahead)."""
        src = self._train_source
        if not self.config.checkpoint_dir or src is None or not hasattr(src, "state_dict"):
            return None
        return {os.path.join(self.config.checkpoint_dir, filename): src.state_dict()}

    @staticmethod
    def restore_iterator(path: str, loader) -> None:
        """Load an iterator-state JSON (written beside a checkpoint) into a
        loader with ``load_state_dict``."""
        with open(path) as f:
            loader.load_state_dict(json.load(f))

    def evaluate(self, eval_fn: Callable, loader: Iterable, put: Callable = lambda b: b) -> Dict[str, float]:
        """Each batch's metric means weighted by its ``count`` (real tokens;
        the batch size when the step reports none), summed on the device,
        read once at the end."""
        totals, weight = None, None
        for batch in loader:
            metrics = dict(eval_fn(put(batch)))
            w = metrics.pop("count", None)
            dev = next(iter(metrics.values())).device
            w = torch.as_tensor(len(next(iter(batch.values()))) if w is None else w, dtype=torch.float64, device=dev)
            scaled = {k: v.to(torch.float64) * w for k, v in metrics.items()}
            if totals is None:
                totals, weight = scaled, w
            else:
                totals = {k: totals[k] + scaled[k] for k in totals}
                weight = weight + w
        if totals is None:
            return {}
        sums = _host({**totals, "_weight": weight})
        denom = max(sums.pop("_weight"), 1e-9)
        return {k: v / denom for k, v in sums.items()}

    def _maybe_checkpoint(self, state: TrainState, val: Dict[str, float],
                          writer: Optional[AsyncCheckpointWriter] = None) -> None:
        """Track the best ``monitor`` value; with a checkpoint directory, save
        an improvement as ``best`` (after the writer's write in flight: one
        writer of a directory at a time) with its iterator and its value."""
        cfg = self.config
        if cfg.monitor not in val:
            return
        value = val[cfg.monitor]
        if self.best is not None and not (value < self.best if cfg.monitor_mode == "min" else value > self.best):
            return
        self.best = value
        if not cfg.checkpoint_dir:
            return
        if writer is not None:
            writer.wait()
        save_checkpoint_lineage(
            os.path.join(cfg.checkpoint_dir, "best"), state,
            aux_files={**(self._iterator_aux("best_iterator.json") or {}),
                       os.path.join(cfg.checkpoint_dir, "best_metric.json"): {"monitor": cfg.monitor,
                                                                               "value": float(value)}},
            step=int(state.step))
        self._emit("checkpoint", {"checkpoint": "best", cfg.monitor: round(value, 5)})

    @staticmethod
    def restore(path: str, state_template: TrainState) -> TrainState:
        """Restore the checkpoint at ``path`` into the template in place."""
        return restore_checkpoint(path, state_template)

    @staticmethod
    def restore_latest_valid(directory: str, state_template: TrainState):
        """Restore the newest checkpoint in ``directory`` that passes its
        checks, falling back past torn or partial ones (a ``last`` torn by a
        kill mid-write falls back to ``last.prev`` or ``best``). Returns
        ``(state, info)``; see training/checkpoint.py."""
        return restore_latest_valid(directory, state_template)
