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

Its float32 mode does the same for ``csrc/flash_backward_f32.cu`` (B1b in
float32: each product as three TF32 products) at the decoder's patch as the
default-dtype train step calls it (1 x 1 x 182,528 x 2,048 x 512, full mask)
and at the flagship's causal cross-attention (16 x 10 x 512 x 1,024 x 128),
with the source's ``B1B_F32_OFF`` bits: the streamed boxes' loads past the
ring's first fill, the S and dP products, the dV, dK and dQ products, the
split into three TF32 products (one, hi hi, instead), the dK/dV pass's
loads of its A fragments from shared memory; each pass's kernel
(delta, the pre-pass that splits K and V, dK/dV, the split reduce, dQ)
timed apart, the same way:

    python3 -m perceiver_io_torch.profile_wide_backward f32 [variant ...]

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
F32_SHAPES = {  # name: (batch, heads, queries, keys, head dim, causal)
    "flow_decoder": (1, 1, 182_528, 2048, 512, False),
    "flagship_cross": (16, 10, 512, 1024, 128, True),
}
# flash_backward_f32.cu's switches (its kOff* bits)
F32_LOADS, F32_SCORES, F32_PRODUCTS, F32_SPLIT, F32_A_LOADS = 1, 2, 4, 8, 16
F32_VARIANTS = {
    "kernel": 0,
    "no_loads": F32_LOADS,
    "no_scores": F32_SCORES,
    "no_products": F32_PRODUCTS,
    "no_split": F32_SPLIT,
    "no_a_loads": F32_A_LOADS,
    "loads_only": F32_SCORES | F32_PRODUCTS,
    "protocol_only": F32_LOADS | F32_SCORES | F32_PRODUCTS,
}
F32_PASSES = {"flash_bwd_f32_delta_kernel": "delta", "flash_bwd_f32_split_kernel": "split",
              "flash_bwd_f32_dkdv_kernel": "dkdv", "flash_bwd_f32_reduce_kernel": "reduce",
              "flash_bwd_f32_dq_kernel": "dq"}


def _build(names, f32=False):
    """The variants' entry points, each built from the source with its parts
    switched off (one nvcc a variant, all started together)."""
    out = cuda_build.BUILD_DIR / "ablate_backward"
    out.mkdir(parents=True, exist_ok=True)
    source, flag, variants = (("flash_backward_f32", "B1B_F32_OFF", F32_VARIANTS) if f32
                              else ("flash_backward_wide", "B1B_OFF", VARIANTS))
    procs = {name: subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-D{flag}={variants[name]}",
                                     "-o", str(out / f"lib{source}_{name}.so"), str(cuda_build.CSRC / f"{source}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in names}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{source}_{name}.so")), source)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 7 + [p] if f32 else [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        fns[name] = fn
    return fns


def _pass_ms(call, passes=PASSES) -> dict:
    """Device ms of each pass's kernel, median over CALLS calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    per_call = {p: [] for p in passes.values()}
    for _ in range(CALLS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for frag, name in passes.items():
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


def main_f32(names=None) -> None:
    """The float32 backward's variants at F32_SHAPES: ms by pass, in turns, twice."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_wide_backward needs a CUDA card")
    names = list(F32_VARIANTS) if not names else names
    fns = _build(names, f32=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for shape, (b, h, nq, nk, d, causal) in F32_SHAPES.items():
        g = torch.Generator("cuda").manual_seed(SEED)
        q = torch.randn(b, h, nq, d, generator=g, device="cuda") * d**-0.5
        k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda") for n in (nk, nk, nq))
        o, lse = fl._launch_forward(q, k, v, None, causal)
        splits = fl.f32_backward_splits(b * h, nq, nk, d, sms)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(b, h, nq, device="cuda")
        scratch = torch.empty(fl.f32_backward_scratch_floats(b * h, nk, d), device="cuda")
        ds = torch.empty(b * h * nq * fl._f32_ds_keys(nk), device="cuda")
        ws = torch.empty(2 * b * h * splits * nk * d if splits > 1 else 4, device="cuda")
        ms[shape] = {name: [] for name in names}
        for _ in range(2):
            for name in names:
                def call(fn=fns[name], name=name):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), lse.data_ptr(),
                             do.data_ptr(), delta.data_ptr(), scratch.data_ptr(), ds.data_ptr(), ws.data_ptr(),
                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, d, int(causal), splits, stream)
                    if err:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")
                ms[shape][name].append(_pass_ms(call, F32_PASSES))
        del q, k, v, do, o, lse, dq, dk, dv, scratch, ds, ws
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": card, "shapes": F32_SHAPES,
                      "switched_off": {name: F32_VARIANTS[name] for name in names}, "pass_ms": ms}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["f32"]:
        main_f32(sys.argv[2:])
    else:
        main(sys.argv[1:])
