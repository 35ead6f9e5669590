"""Where a decode step's time goes: the 455M flagship in bf16 at batch 8 on
the card, greedy decode steps after a 768-token prompt with 256 latents.

    python3 -m perceiver_io_torch.profile_decode

Each window starts from a fresh prefill, takes WARMUP steps, then times STEPS
steps. REPEATS windows run without the profiler (wall ms per step on the host
clock, synchronised: median, min, max); one more runs under
``torch.profiler``, which gives the device kernel time, the kernel launches
and the device's idle share of that window (1 - device / wall, both from the
profiled window). ``idle_share_unprofiled_estimate`` sets the profiled device
time against the unprofiled median wall time: an estimate, since the two come
from different windows. ``by_kernel`` gives the device ms and launches a step
of the decode-attention kernel B2 (``decode_attention_kernel``), of the
matrix products and of the rest. Prints one JSON object, with the card's name
and power limit. Weights are random, from a seed. Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from perceiver_io_torch.models.core.config import flagship_455m_config
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel

BATCH, PROMPT, LATENTS = 8, 768, 256
WARMUP, STEPS, REPEATS = 4, 16, 3
SEED = 0


def kernel_kind(name: str, paged: str = "B3") -> str:
    """The kernel a profiler event belongs to: B2 (``decode_attention_kernel``),
    ``paged`` for the paged kernel (``paged_attention_kernel``, B3 or B4 by the
    pool the caller runs), the matrix products, or the rest."""
    if "decode_attention_kernel" in name:
        return "B2"
    if "paged_attention_kernel" in name:
        return paged
    if any(s in name.lower() for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "matrix products"
    return "other"


def by_kernel(kernels, steps: int, paged: str = "B3") -> dict:
    """Device ms and launches per step (or tick) of each kernel kind."""
    out = {}
    for e in kernels:
        k = out.setdefault(kernel_kind(e.key, paged), {"ms": 0.0, "launches": 0.0})
        k["ms"] += e.self_device_time_total / 1e3 / steps
        k["launches"] += e.count / steps
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA card")
    cfg = flagship_455m_config()
    model = CausalSequenceModel(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    g = torch.Generator("cuda").manual_seed(SEED + 1)
    ids = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT), generator=g, device="cuda")

    def decode(n, cache, logits):
        for _ in range(n):
            logits, cache = model.decode_step(logits[:, -1].argmax(-1, keepdim=True), cache)
        return cache, logits

    def window(prof=None):
        """Wall ms per step of STEPS decode steps from a fresh prefill."""
        logits, cache = model.prefill(ids, PROMPT - LATENTS, model.init_cache(BATCH))
        cache, logits = decode(WARMUP, cache, logits)
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        decode(STEPS, cache, logits)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / STEPS
        if prof is not None:
            prof.stop()
        return wall

    with torch.no_grad():
        walls = [window() for _ in range(REPEATS)]
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        profiled_wall = window(prof)

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    device_ms = device_us / 1e3 / STEPS if device_us else None
    wall = statistics.median(walls)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    not_measured = "not measured"
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card_line(),
        "batch": BATCH, "prompt": PROMPT, "latents": LATENTS, "steps": STEPS, "repeats": REPEATS,
        "wall_ms_per_step": {"median": wall, "min": min(walls), "max": max(walls), "all": walls},
        "profiled_wall_ms_per_step": profiled_wall,
        "device_kernel_ms_per_step": device_ms if device_ms is not None else not_measured,
        "device_idle_share_profiled": 1 - device_ms / profiled_wall if device_ms is not None else not_measured,
        "idle_share_unprofiled_estimate": 1 - device_ms / wall if device_ms is not None else not_measured,
        "kernel_launches_per_step": sum(e.count for e in kernels) / STEPS,
        "by_kernel_per_step": by_kernel(kernels, STEPS),
        "top_kernels": [{"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / STEPS,
                         "calls_per_step": e.count / STEPS} for e in top],
    }))


if __name__ == "__main__":
    main()
