"""Where B1b wide's time goes on the card: ``csrc/flash_backward_wide.cu`` at
the optical-flow decoder's train-step shape (2 patches of 182,528 queries
over 2,048 keys, one 512-channel head, full mask), as it is and in variants
built from the same source with parts switched off (its ``B1B_OFF`` bits):
the streamed tiles' loads, the S and dP products, P and dS (the exp, the
mask, dS = P (dP - delta)), their stores (to shared memory, and dS's to the
scratch the dQ pass reads), and the products with P and dS (dV, dK, and
the dQ pass's dQ = dS K). Each variant's four kernels (delta, dK/dV, the
split reduce, dQ) are timed apart by ``torch.profiler`` (device time, median of 5
calls), all variants in turns, twice. A variant computes wrong values and
exists only to be timed: the kernel's time less a variant's is what the
part costs on the pass's critical path, not the part's own time.

    python3 -m perceiver_io_torch.profile_wide_backward [variant ...]

Needs a CUDA card and nvcc; the variants build into
``perceiver_io_torch/_build/ablate_backward/``. Prints one JSON object with
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from perceiver_io_torch.ops import cuda_build
from perceiver_io_torch.ops import flash as fl

SEED = 0
SHAPE = (2, 1, 182_528, 2048, 512)  # batch (patches), heads, queries, keys, head dim
CALLS = 5
# the source's switches (its kOff* bits)
LOADS, SCORES, PDS, STORES, PHASE2, TRANSPOSE = 1, 2, 4, 8, 16, 32
# name: parts switched off
VARIANTS = {
    "kernel": 0,
    "no_loads": LOADS,
    "no_scores": SCORES,
    "no_pds": PDS,
    "no_stores": STORES,
    "no_phase2": PHASE2,
    "loads_only": SCORES | PDS | STORES | PHASE2,
    "scores_only_no_loads": LOADS | PDS | STORES | PHASE2,
    "phase2_only_no_loads": LOADS | SCORES | PDS | STORES,
    "no_loads_no_phase2": LOADS | PHASE2,
    "phase2_only_untransposed_no_loads": LOADS | SCORES | PDS | STORES | TRANSPOSE,
}
# kernel name fragment: pass
PASSES = {"flash_bwd_delta_kernel": "delta", "flash_bwd_wide_dkdv_kernel": "dkdv",
          "flash_bwd_wide_reduce_kernel": "reduce", "flash_bwd_wide_dq_kernel": "dq"}


def _build(names):
    out = cuda_build.BUILD_DIR / "ablate_backward"
    out.mkdir(parents=True, exist_ok=True)
    source = cuda_build.CSRC / "flash_backward_wide.cu"
    procs = {name: subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DB1B_OFF={VARIANTS[name]}",
                                     "-o", str(out / f"lib{name}.so"), str(source)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in names}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).flash_backward_wide
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        fns[name] = fn
    return fns


def _pass_ms(call) -> dict:
    """Device ms of each pass's kernel, median over CALLS calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    per_call = {p: [] for p in PASSES.values()}
    for _ in range(CALLS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for frag, name in PASSES.items():
                if frag in e.key:
                    per_call[name].append(e.self_device_time_total / 1e3)
    return {name: statistics.median(ts) for name, ts in per_call.items() if ts}


def main(names=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_wide_backward needs a CUDA card")
    names = list(VARIANTS) if not names else names
    fns = _build(names)
    b, h, nq, nk, d = SHAPE
    g = torch.Generator("cuda").manual_seed(SEED)
    q = (torch.randn(b, h, nq, d, generator=g, device="cuda") * d**-0.5).bfloat16()
    k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").bfloat16() for n in (nk, nk, nq))
    o, lse = fl._launch_forward(q, k, v, None, False)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = fl.wide_backward_splits(b * h, nq, nk, d, sms)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, nq, device="cuda")
    ws = torch.empty(2 * b * h * splits * nk * d, device="cuda")
    ds = torch.empty(2 * b * h * nk * fl._wide_query_rows(nq), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = {name: [] for name in names}
    for _ in range(2):
        for name in names:
            def call(fn=fns[name], name=name):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                         delta.data_ptr(), ws.data_ptr(), ds.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         b, h, nq, nk, d, 0, splits, stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")
            ms[name].append(_pass_ms(call))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": card, "shape": SHAPE, "splits": splits,
                      "switched_off": {name: VARIANTS[name] for name in names}, "pass_ms": ms}))


if __name__ == "__main__":
    main(sys.argv[1:])
