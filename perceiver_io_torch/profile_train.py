"""Where a training step's time goes, on the card, as chip_smoke.py's train
phases run it: bf16 compute over float32 parameters, random ids from a
seed, AdamW with clipping and the config's activation checkpointing.
Workloads: ``flagship`` (the 455M flagship at full width, 20 layers, batch
16; the default) and ``clm_8k_sp`` (clm_8k at full width and depth, batch 4,
sequence-parallel under ``{"seq": 4}`` with the one card at every position).

    python3 -m perceiver_io_torch.profile_train [flagship|clm_8k_sp]

After WARMUP steps, REPEATS windows of STEPS steps run without the profiler
(wall ms per step on the host clock, each window ending in one host read of
the loss: median, min, max); one more window runs under ``torch.profiler``,
which gives the device kernel time per step, the launches per step, the
device's idle share of that window (1 - device / wall) and the share of the
flash kernels (B1a ``flash_fwd_*``; B1b by pass: its delta, dK/dV and dQ
kernels ``flash_bwd_{delta,dkdv,dq}_*``; on the sequence-parallel path
``flash_fwd_*`` is B5, the ring's fully visible blocks, and B1 is never
launched) and of the matrix products in the device time. Prints one JSON
object, with the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from perceiver_io_torch.models.core.config import clm_8k_config, flagship_455m_config
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.parallel.mesh import make_mesh, set_mesh
from perceiver_io_torch.training.trainer import TrainState, build_optimizer, make_causal_lm_train_step

WORKLOADS = {  # name: (config, batch, seq mesh size or None)
    "flagship": (flagship_455m_config, 16, None),
    "clm_8k_sp": (lambda: dataclasses.replace(clm_8k_config(), sequence_parallel_axis="seq"), 4, 4),
}
WARMUP, STEPS, REPEATS = 2, 4, 3
SEED = 0


def _kind(name: str, ring: bool) -> str:
    if "flash_fwd" in name:
        return "B5 ring block" if ring else "B1a flash forward"
    for part, kind in (("flash_bwd_delta", "B1b delta"), ("flash_bwd_dkdv", "B1b dK/dV"), ("flash_bwd_dq", "B1b dQ")):
        if part in name:
            return kind
    if any(s in name.lower() for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "matrix products"
    return "other"


def main(workload: str = "flagship") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    if workload not in WORKLOADS:
        raise SystemExit(f"unknown workload {workload!r}; expected one of {sorted(WORKLOADS)}")
    make_cfg, batch_size, n_seq = WORKLOADS[workload]
    cfg = make_cfg()
    model = CausalSequenceModel(cfg, dtype=torch.bfloat16, seed=SEED)
    g = torch.Generator("cuda").manual_seed(SEED)
    x = torch.randint(0, cfg.vocab_size, (batch_size, cfg.max_seq_len), generator=g, device="cuda")
    batch = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)

    def window(prof=None):
        nonlocal state
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, metrics = step(state, batch)
        float(metrics["loss"])
        wall = (time.perf_counter() - t0) * 1e3 / STEPS
        if prof is not None:
            prof.stop()
        return wall

    mesh = None if n_seq is None else make_mesh({"seq": n_seq}, devices=[torch.device("cuda")] * n_seq)
    with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for _ in range(WARMUP):
            state, _ = step(state, batch)
        walls = [window() for _ in range(REPEATS)]
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        profiled_wall = window(prof)

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    not_measured = "not measured"
    by_kind = {}
    for e in kernels:
        k = by_kind.setdefault(_kind(e.key, mesh is not None), {"ms_per_step": 0.0, "launches_per_step": 0.0})
        k["ms_per_step"] += e.self_device_time_total / 1e3 / STEPS
        k["launches_per_step"] += e.count / STEPS
    device_ms = device_us / 1e3 / STEPS if device_us else None
    for k in by_kind.values():
        k["share_of_device_time"] = k["ms_per_step"] / device_ms if device_ms else not_measured
    wall = statistics.median(walls)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card,
        "workload": workload, "batch": batch_size, "layers": cfg.num_self_attention_layers, "steps": STEPS,
        "repeats": REPEATS,
        "wall_ms_per_step": {"median": wall, "min": min(walls), "max": max(walls), "all": walls},
        "profiled_wall_ms_per_step": profiled_wall,
        "device_kernel_ms_per_step": device_ms if device_ms is not None else not_measured,
        "device_idle_share_profiled": 1 - device_ms / profiled_wall if device_ms is not None else not_measured,
        "idle_share_unprofiled_estimate": 1 - device_ms / wall if device_ms is not None else not_measured,
        "kernel_launches_per_step": sum(e.count for e in kernels) / STEPS,
        "by_kind": by_kind,
        "top_kernels": [{"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / STEPS,
                         "calls_per_step": e.count / STEPS} for e in top],
    }))


if __name__ == "__main__":
    main(*sys.argv[1:2])
