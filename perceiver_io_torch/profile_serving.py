"""Where a serving tick's time goes: the 455M flagship engine in bf16 with 8
busy slots on the card, in each pool mode (dense, paged fp, int8 and int4
pages of 128 rows), with the tick's decode step as one CUDA graph (the
engine's default) and eagerly (``cuda_graph=False``), the two in turns
within one process.

    python3 -m perceiver_io_torch.profile_serving

For each mode and each of the two decodes a fresh engine admits 8 requests
(768-token prompts, the split admission path; even slots greedy, odd ones
sampled at temperature 0.8 and top-k 50), takes WARMUP decode ticks, times
STEPS ticks on the host clock (the tick ends in the engine's own device
sync), then runs STEPS more under ``torch.profiler``, which gives:
  * the device kernel time a tick and the device's idle share of that
    window (1 - device / wall, both from the profiled window);
  * the host's dispatches a tick: the CUDA runtime's launch calls the host
    made (``cudaGraphLaunch``, kernel launches, and the copies and fills it
    enqueued), by name;
  * the device ms and launches a tick of the decode-attention kernels: B2
    (``decode_attention_kernel``: every self-attention layer, and the
    cross-attention of the dense mode), B3 (``paged_attention_kernel`` in
    paged fp and int8 pools) and B4 (the same kernel in int4 pools), whether
    a graph or the host launched them.
Prints one JSON object per mode and decode, with the card's name and power
limit. Weights are random, from a seed. Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.models.core.config import flagship_455m_config
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.profile_decode import by_kernel, card_line
from perceiver_io_torch.serving import ServingEngine

SLOTS, PROMPT = 8, 768
WARMUP, STEPS = 4, 16
SEED = 0
MODES = {"dense": {}, "paged_fp": dict(kv_page_size=128), "paged_int8": dict(kv_page_size=128, kv_quant="int8"),
         "paged_int4": dict(kv_page_size=128, kv_quant="int4")}
# the CUDA API calls (runtime cuda*, low-level cu*) by which the host puts work on the card
DISPATCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                  "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_mode(model, prompts, configs, kw, graph: bool) -> dict:
    engine = ServingEngine(model, num_slots=SLOTS, cuda_graph=graph, **kw)
    for i, (p, c) in enumerate(zip(prompts, configs)):
        engine.submit(p, config=c, seed=i)
    t0 = time.perf_counter()
    engine.step()  # admits all 8, then the first decode tick
    admit_s = time.perf_counter() - t0
    for _ in range(WARMUP):
        engine.step()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        engine.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        engine.step()
    torch.cuda.synchronize()
    profiled_wall = (time.perf_counter() - t0) * 1e3 / STEPS
    prof.stop()
    replays = engine.graph_replays
    engine.run_until_drained()

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    device_ms = device_us / 1e3 / STEPS if device_us else None
    dispatches = {e.key: e.count / STEPS for e in events if e.key in DISPATCH_CALLS}
    not_measured = "not measured"
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return {
        "decode": "cuda_graph" if graph else "eager", "captures": engine.total_compilations,
        "graph_replays_total": replays,
        "first_tick_with_admissions_ms": admit_s * 1e3,
        "wall_ms_per_tick": {"median": statistics.median(walls), "min": min(walls), "max": max(walls)},
        "profiled_wall_ms_per_tick": profiled_wall,
        "device_kernel_ms_per_tick": device_ms if device_ms is not None else not_measured,
        "device_idle_share_profiled": 1 - device_ms / profiled_wall if device_ms is not None else not_measured,
        "host_dispatches_per_tick": sum(dispatches.values()) if dispatches else not_measured,
        "host_dispatches_per_tick_by_call": dispatches,
        "kernel_launches_per_tick": sum(e.count for e in kernels) / STEPS,
        "by_kernel_per_tick": by_kernel(kernels, STEPS, "B4" if kw.get("kv_quant") == "int4" else "B3"),
        "top_kernels": [{"name": e.key[:90], "ms_per_tick": e.self_device_time_total / 1e3 / STEPS,
                         "calls_per_tick": e.count / STEPS} for e in top],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    cfg = flagship_455m_config()
    model = CausalSequenceModel(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(1, cfg.vocab_size, PROMPT).tolist() for _ in range(SLOTS)]
    max_new = 1 + WARMUP + 2 * STEPS + 1  # nobody finishes inside the windows
    configs = [GenerationConfig(max_new_tokens=max_new, do_sample=bool(i % 2), temperature=0.8 if i % 2 else 1.0,
                                top_k=50 if i % 2 else None) for i in range(SLOTS)]
    for mode, kw in MODES.items():
        for graph in (True, False, False, True):  # in turns: graph, eager, eager, graph
            print(json.dumps({"mode": mode, "device": torch.cuda.get_device_name(0), "nvidia_smi": card_line(),
                              "slots": SLOTS, "prompt": PROMPT, "steps": STEPS,
                              **profile_mode(model, prompts, configs, kw, graph)}), flush=True)


if __name__ == "__main__":
    main()
