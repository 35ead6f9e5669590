"""Where a fresh serving worker's time goes: its start by part (the
warm-up of its admission paths included) and its first requests' RPCs.

    python3 -m perceiver_io_torch.profile_worker

The 455M flagship in bf16 behind a two-replica ``ServingRouter`` of worker
processes (paged pool, pages of 128, 8 slots each), built ROUNDS times.
Each fleet serves the first WARM requests of a seeded stream (the
fleet's first work), then the next REQUESTS. Prints, per fleet, each
worker's start by part (interpreter, recipe, model, engine, warm-up), the
slowest RPCs of the first WARM requests with their ops (the init's
excluded), and the RPC p50/p95/max of the requests after them; then the
card's name and power limit. Weights are random, from a seed. Needs a CUDA
card.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.models.core.config import flagship_455m_config
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.serving import ServingRouter

SEED = 0
WARM, REQUESTS = 3, 16
ROUNDS = 2


def stream(vocab: int, n: int):
    """Prompts of 64-1024 tokens, 16-128 new tokens, odd ones sampled."""
    rs = np.random.RandomState(SEED + 4)
    out = []
    for i in range(n):
        prompt = rs.randint(1, vocab, rs.randint(64, 1025)).tolist()
        config = GenerationConfig(max_new_tokens=int(rs.randint(16, 129)), do_sample=bool(i % 2),
                                  temperature=0.8 if i % 2 else 1.0, top_k=50 if i % 2 else None)
        out.append((prompt, config, SEED + i))
    return out


def fleet(model, requests) -> dict:
    t0 = time.perf_counter()
    router = ServingRouter(model, num_replicas=2, num_slots=8, replica_mode="process", kv_page_size=128,
                           transport=dict(rpc_timeout_s=60.0, init_timeout_s=300.0))
    spawn_s = time.perf_counter() - t0
    try:
        clients = [r.engine for r in router.replicas]
        for p, c, seed in requests[:WARM]:
            router.submit(p, config=c, seed=seed)
        router.run_until_drained()
        first = [sorted(((round(ms, 1), op) for op, ms in zip(c.rpc_ops, c.rpc_ms) if op != "init"),
                        reverse=True)[:4] for c in clients]
        mark = [len(c.rpc_ms) for c in clients]
        for p, c, seed in requests[WARM:]:
            router.submit(p, config=c, seed=seed)
        router.run_until_drained()
        later = [ms for c, n in zip(clients, mark) for ms in list(c.rpc_ms)[n:]]
        return {"spawn_s": spawn_s, "startup": [c.startup for c in clients],
                "first_requests_slowest_rpcs": first, "retries": sum(c.retries for c in clients),
                "later_rpc_ms": {"p50": float(np.percentile(later, 50)), "p95": float(np.percentile(later, 95)),
                                 "max": max(later)}}
    finally:
        router.close()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_worker needs a CUDA card")
    cfg = flagship_455m_config()
    model = CausalSequenceModel(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    requests = stream(cfg.vocab_size, WARM + REQUESTS)
    for _ in range(ROUNDS):
        print(json.dumps(fleet(model, requests)), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": card}))


if __name__ == "__main__":
    main()
