"""Where B1a wide's time goes on the card: ``csrc/flash_forward_wide.cu`` at
the optical-flow decoder's shape (6 patches of 182,528 queries over 2,048
keys, one 512-channel head, full mask, P in one bf16 term, as the flow
forward calls it), as it is and in variants built from a copy of its source
with parts switched off: the K/V loads, S = Q K^T, the S exchange, the
softmax, O's rescale, P V. Each variant is timed like chip_smoke.py's
kernels (CUDA events, the L2 flushed before each run, median of 10), all of
them in turns, twice. A variant computes wrong values and exists only to be
timed: the kernel's time less a variant's is what the part costs on the
kernel's critical path, not the part's own time.

    python3 -m perceiver_io_torch.profile_wide_forward [variant ...]

Its float32 mode does the same for ``csrc/flash_forward_f32.cu`` (B1a in
float32: three TF32 products) at the decoder's patch as the default-dtype
pipeline calls it (1 x 1 x 182,528 x 2,048 x 512, full mask) and at the
flagship's causal cross-attention (16 x 10 x 512 x 1,024 x 128), with the
source's ``B1A_F32_OFF`` bits: the K/V loads past the ring's first fill, S =
Q K^T, the split into three TF32 products (one, hi hi, instead), O += P V,
also at the flow self-attention (6 x 8 x 2,048 x 2,048 x 64); each call's
time includes the pre-pass that splits K and V:

    python3 -m perceiver_io_torch.profile_wide_forward f32 [variant ...]

Needs a CUDA card and nvcc; the variants build into
``perceiver_io_torch/_build/ablate/``. Prints one JSON object with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys

import torch

from perceiver_io_torch.ops import cuda_build

SEED = 0
SHAPE = (6, 1, 182_528, 2048, 512)  # batch (patches), heads, queries, keys, head dim
REPS = 10
# name: parts switched off
VARIANTS = {
    "kernel": (),
    "no_loads": ("NO_LOADS",),
    "loads_only": ("NO_S", "NO_PV", "NO_SOFTMAX", "NO_EXCHANGE", "NO_RESCALE"),
    "no_s": ("NO_S",),
    "no_pv": ("NO_PV",),
    "no_exchange": ("NO_EXCHANGE",),
    "no_softmax": ("NO_SOFTMAX",),
    "no_rescale": ("NO_RESCALE",),
    "s_only_no_loads": ("NO_LOADS", "NO_PV", "NO_SOFTMAX", "NO_EXCHANGE", "NO_RESCALE"),
    "s_exchange_no_loads": ("NO_LOADS", "NO_PV", "NO_SOFTMAX", "NO_RESCALE"),
    "s_exchange_of_constants_no_loads": ("NO_LOADS", "NO_PV", "NO_SOFTMAX", "NO_RESCALE", "EXCHANGE_CONSTANTS"),
}
F32_SHAPES = {  # name: (batch, heads, queries, keys, head dim, causal)
    "flow_decoder": (1, 1, 182_528, 2048, 512, False),
    "flagship_cross": (16, 10, 512, 1024, 128, True),
    "flow_self_attention": (6, 8, 2048, 2048, 64, False),
}
# flash_forward_f32.cu's switches (its kOff* bits)
F32_LOADS, F32_SCORES, F32_SPLIT, F32_PV = 1, 2, 4, 8
# name: parts switched off
F32_VARIANTS = {
    "kernel": 0,
    "no_loads": F32_LOADS,
    "no_scores": F32_SCORES,
    "no_split": F32_SPLIT,
    "no_pv": F32_PV,
    "loads_only": F32_SCORES | F32_PV,
    "protocol_only": F32_LOADS | F32_SCORES | F32_PV,
    "no_loads_no_split": F32_LOADS | F32_SPLIT,
    "scores_only_no_loads": F32_LOADS | F32_PV,
    "pv_only_no_loads": F32_LOADS | F32_SCORES,
}
# the exchange's store of a consumer's partial S
_EXCHANGE_STORE = ("    *reinterpret_cast<float4*>(mine + (i * 128 + tid) * 4) = make_float4(s[4 * i], s[4 * i + 1], "
                   "s[4 * i + 2],\n" + " " * 73 + "s[4 * i + 3]);\n")
# (anchor in the source, its replacement): each anchor must occur exactly once
_GUARDS = (
    ('#include "hopper.cuh"', f'#include "{cuda_build.CSRC / "hopper.cuh"}"'),
    ("  float* mine = sm.exchange", "#ifndef NO_EXCHANGE\n  float* mine = sm.exchange"),
    (_EXCHANGE_STORE,
     "#ifdef EXCHANGE_CONSTANTS  // the same stores, of values that wait for no wgmma\n"
     "    *reinterpret_cast<float4*>(mine + (i * 128 + tid) * 4) = make_float4(1.f, 2.f, 3.f, (float)t);\n"
     f"#else\n{_EXCHANGE_STORE}#endif\n"),
    ("    s[4 * i + 3] += x.w;\n  }\n", "    s[4 * i + 3] += x.w;\n  }\n#endif\n#ifndef NO_SOFTMAX\n"),
    ("  for (int r = 0; r < 2; ++r) rows.l[r] = rows.l[r] * rows.alpha[r] + rs[r];\n}",
     "  for (int r = 0; r < 2; ++r) rows.l[r] = rows.l[r] * rows.alpha[r] + rs[r];\n#endif\n}"),
    ("#pragma unroll\n  for (int b = kSB0; b < kSB0 + kSB; ++b) {",
     "#ifndef NO_S\n#pragma unroll\n  for (int b = kSB0; b < kSB0 + kSB; ++b) {"),
    ("16, 1024));\n  }\n  wgmma_commit();", "16, 1024));\n  }\n#endif\n  wgmma_commit();"),
    ("    // O[:, own columns] += P V[:, own columns]\n",
     "    // O[:, own columns] += P V[:, own columns]\n#ifndef NO_PV\n"),
    ("      if constexpr (kSplitP) Wgmma<kON>::rs(acc, p.lo[kk], dv);\n    }\n",
     "      if constexpr (kSplitP) Wgmma<kON>::rs(acc, p.lo[kk], dv);\n    }\n#endif\n"),
    ("    if (__any_sync(0xffffffffu, rows.alpha[0] != 1.f || rows.alpha[1] != 1.f)) {",
     "#ifdef NO_RESCALE\n    if (false) {\n#else\n"
     "    if (__any_sync(0xffffffffu, rows.alpha[0] != 1.f || rows.alpha[1] != 1.f)) {\n#endif"),
    ("    mbar_arrive_expect_tx(full + st, sizeof(bf16) * kBK * D);",
     "#ifdef NO_LOADS\n    if (t >= kStages) {  // the first stages only, so that every tile reads stale tiles\n"
     "      mbar_arrive_expect_tx(full + st, 0);\n      return;\n    }\n#endif\n"
     "    mbar_arrive_expect_tx(full + st, sizeof(bf16) * kBK * D);"),
)


def ablation_source() -> str:
    """flash_forward_wide.cu with each part under its switch, instantiated
    at D = 512 only."""
    src = (cuda_build.CSRC / "flash_forward_wide.cu").read_text()
    for anchor, replacement in _GUARDS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_wide_forward: the kernel source no longer has one {anchor[:60]!r}")
        src = src.replace(anchor, replacement)
    return re.sub(r"    case (192|256|320|384|448): return forward_width<\d+>\([^;]*;\n", "", src)


def _build(names):
    out = cuda_build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    source = out / "flash_forward_wide_ablate.cu"
    source.write_text(ablation_source())
    procs = {name: subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *(f"-D{f}" for f in VARIANTS[name]),
                                     "-o", str(out / f"lib{name}.so"), str(source)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in names}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).flash_forward_wide
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        fns[name] = fn
    return fns


def _time_ms(fn, flush) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _build_f32(names):
    out = cuda_build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    source = cuda_build.CSRC / "flash_forward_f32.cu"
    procs = {name: subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DB1A_F32_OFF={F32_VARIANTS[name]}",
                                     "-o", str(out / f"libf32_{name}.so"), str(source)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in names}
    fns, notes, spills = {}, {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        notes[name] = len([line for line in log.splitlines() if "serialized" in line])
        spills[name] = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
        fn = ctypes.CDLL(str(out / f"libf32_{name}.so")).flash_forward_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        fns[name] = fn
    return fns, notes, spills


def main_f32(names=None) -> None:
    """The float32 mode: each variant of csrc/flash_forward_f32.cu at each
    of F32_SHAPES, in turns, twice, with the count of ptxas's notes that it
    serialised wgmma in each variant's build."""
    from perceiver_io_torch.ops import flash as fl

    names = list(F32_VARIANTS) if not names else names
    fns, notes, spills = _build_f32(names)
    flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB, past the 50 MB L2
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator("cuda").manual_seed(SEED)
    ms = {}
    for shape, (b, h, nq, nk, d, causal) in F32_SHAPES.items():
        q = torch.randn(b, h, nq, d, generator=g, device="cuda") * d**-0.5
        k, v = (torch.randn(b, h, nk, d, generator=g, device="cuda") for _ in range(2))
        o = torch.empty(q.shape, device="cuda")
        lse = torch.empty(b, h, nq, device="cuda")
        scratch = torch.empty(fl.f32_scratch_floats(b * h, nk, d), device="cuda")
        ms[shape] = {name: [] for name in names}
        for _ in range(2):
            for name in names:
                def call(fn=fns[name], name=name):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, scratch.data_ptr(), o.data_ptr(),
                             lse.data_ptr(), b, h, nq, nk, d, int(causal), stream)
                    if err:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")
                ms[shape][name].append(_time_ms(call, flush))
        del q, k, v, o, lse, scratch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": card, "shapes": F32_SHAPES,
                      "source": "perceiver_io_torch/csrc/flash_forward_f32.cu",
                      "variants": {name: {"off": F32_VARIANTS[name],
                                          "wgmma_serialised_notes": notes[name],
                                          "spill_bytes": spills[name]} for name in names}, "ms": ms}))


def main(names=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_wide_forward needs a CUDA card")
    if names and names[0] == "f32":
        main_f32(names[1:])
        return
    names = list(VARIANTS) if not names else names
    fns = _build(names)
    b, h, nq, nk, d = SHAPE
    g = torch.Generator("cuda").manual_seed(SEED)
    q = (torch.randn(b, h, nq, d, generator=g, device="cuda") * d**-0.5).bfloat16()
    k, v = (torch.randn(b, h, nk, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    o = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")
    lse = torch.empty(b, h, nq, device="cuda")
    flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB, past the 50 MB L2
    stream = torch.cuda.current_stream().cuda_stream
    ms = {name: [] for name in names}
    for _ in range(2):
        for name in names:
            def call(fn=fns[name], name=name):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), lse.data_ptr(), b, h, nq, nk,
                         d, 0, 0, stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")
            ms[name].append(_time_ms(call, flush))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": card, "shape": SHAPE,
                      "switched_off": {name: list(VARIANTS[name]) for name in names}, "ms": ms}))


if __name__ == "__main__":
    main(sys.argv[1:])
