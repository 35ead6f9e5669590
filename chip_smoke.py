"""Smoke test of the PyTorch port on one NVIDIA H100: build the hand-written
kernels, hold each against its plain PyTorch version, drive Perceiver AR
generation, the serving engine and training at the 455M flagship's full
width, train the 30M recipe through the fit loop, train clm_8k sequence-
parallel (ring attention over a {"seq": 4} mesh of the one card), run
Perceiver IO optical-flow inference (the 41M model on a Sintel-sized frame
pair) and training (the 41M model on two Sintel-sized patches, and the
convergence probe through the fit loop), and check the card against the
port's CPU run and the ring against the plain path.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the exit code is not 0):
  1. device         CUDA with compute capability (9, 0); the card's name and power limit
  2. build          one nvcc per perceiver_io_torch/csrc/*.cu, all started together:
                    seconds and ptxas lines per source; B1a and B1b wide's
                    and B1a float32's registers and spills by instantiation
                    (a spill fails the run) and the count of ptxas notes
                    that each source's wgmma were serialised
  3. kernel_check   each kernel vs its plain version at the main paths'
                    shapes: f32 max error 1e-4; bf16 and quantized pools 0.03 x
                    the RMS of the plain output; times, the least time the
                    card could take (bytes or operations) and a library call
                    as a yardstick. B2, B3 and B4 (split-K) also print each
                    call's split count and blocks (launched, and working:
                    the rest return at once) and must give the same bits
                    twice. B2 (decode attention) at the flagship's
                    and the 30M recipe's shapes; B3 (paged decode) in f32,
                    bf16 and int8 pools and B4 (ragged paged) in int4, bf16
                    and int8 pools, at the flagship cross-attention shape (8
                    slots, page 128, 65-page pool), the 30M decode shape and a
                    page size that does not divide the window, with wrapping
                    ring offsets, dead pages, latent-finish causal bounds and
                    live = 0 lanes (which must be exact zeros); B1a/B1b (flash
                    attention forward and backward, against the plain
                    version's autograd gradients; bf16 also gets one bf16
                    step of the element, see flash_limit; in bf16 the
                    forward runs csrc/flash_forward_mma.cu and B1b
                    csrc/flash_backward_mma.cu on the tensor cores, with P
                    in two bf16 terms where B1b reads the forward's output
                    and in one without gradients (held and timed too); in
                    float32 B1a runs csrc/flash_forward_f32.cu and B1b
                    csrc/flash_backward_f32.cu, each product as three TF32
                    products on the tensor cores) at the
                    flagship cross- and self-attention and the 30M
                    cross-attention (left-padded) shapes, pad keys' gradients
                    exact zeros, two backward runs bit-identical (in float32
                    the forward too), and at the flagship cross-attention
                    the float32 output's error against the float64 plain
                    version within F32_CLASS_FACTOR (4) x the plain float32
                    version's; B5
                    (ring_block_forward, ring attention's fully visible
                    blocks: B1a's entry, in bf16 with P in two terms) at
                    clm_8k's cross- and
                    self-attention blocks at {"seq": 4}, the flagship's
                    cross-attention block at {"seq": 2} and a block with
                    256-channel heads (csrc/flash_forward_wide.cu), the float32 output
                    and log-sum-exp within 1e-4 in both input types, an
                    all-padding row exact zeros and -inf; then
                    decode_host: B2, B3 and B4 at their head cases, the
                    host's microseconds a wrapper call takes beside the
                    card's ms a call, with and without the host's enqueue
                    time (decode_host_times); then B1a at the optical-flow
                    model's shapes, full mask (check_flow_flash_kernel): the
                    decoder's one 512-channel head, 182,528 pixel queries
                    over 2,048 latents (csrc/flash_forward_wide.cu in bf16,
                    which writes a bf16 output here), checked at 1 patch
                    and at 6 (patch by patch), each twice for the same
                    bits, and timed at 6 and at 1 (in float32, one patch a
                    call is the default-dtype pipeline's; there also the
                    float32-class check against float64), and the 24
                    self-attention layers' 8 x 64 over 2,048 x 2,048 at 6
                    patches; bf16 within 0.03 x the plain output's RMS plus
                    one bf16 step, f32 within 1e-4; the library call's
                    CUDA kernels named (its backend at D = 512); then the
                    wide bf16 forward beyond inference
                    (check_wide_forward_kernel): the flow train step's call
                    (2 patches, P in two terms, the float32 output and lse
                    within 1e-4 patch by patch) and D = 192 and 256 at a
                    left-padded causal shape with an odd query-tile count
                    (a spare block in the last cluster), one-term P within
                    flash_limit and two-term P within 1e-4, every launch
                    twice for the same bits; then B1b
                    at heads of 192-512 (check_wide_backward_kernel): the
                    flow decoder's 512-channel head, full mask, in bf16
                    (csrc/flash_backward_wide.cu) checked at 1 patch and
                    at the train step's 2 (patch by patch), timed at 2 with
                    each pass's device ms (delta, dK/dV, reduce, dQ), D =
                    192 and 256 in bf16 and f32 at a left-padded causal
                    shape (in f32 the forward too: o and lse within 1e-4,
                    two runs the same bits, timed), and D = 320 in bf16 at one whose query and key
                    tiles both leave a spare block in their last cluster;
                    dq, dk and dv against the plain backward within
                    flash_limit, pad keys' dk and dv exact zeros, two runs
                    the same bits;
                    the library call F.scaled_dot_product_attention forward
                    and backward timed with its kernels named, or its error;
                    every float32 forward's bound at 165 TFLOP/s (three
                    TF32 products) has its bound at the CUDA cores' 67
                    beside it; then B1b in float32 (check_f32_backward_kernel,
                    csrc/flash_backward_f32.cu) at every float32 backward
                    shape of the main paths (the flagship cross- and
                    self-attention, the 30M cross-attention, D 192 and 256
                    padded causal, the flow decoder's patch and the flow
                    self-attention): dq, dk and dv within 1e-4 of the plain
                    backward, pad keys' exact zeros, two runs the same bits,
                    at the flagship cross-attention and the flow decoder's
                    patch the gradients' error from float64 within
                    F32_CLASS_FACTOR x the plain float32 version's; the
                    kernel, the plain backward and the library's backward
                    timed (its kernels named), the bound at both float32
                    rates, ms by pass at those two shapes
  4. main_path      flagship generation in bf16 at batch 8 through generate():
                    greedy, rolling window, chunked, left-padded, each REPEATS
                    times; prefill and the decode loop are timed apart inside
                    each call; the B2 counter must equal (1 + layers) x decode
                    iterations
  5. serving        the flagship engine in bf16, 8 slots, a seeded stream of 32
                    requests (prompts 64-1024, 16-128 new tokens, half
                    sampled) in four pool modes (dense, paged fp, int8, int4),
                    and paged_chunked_prefix: page 128, chunks of 256, the
                    prefix cache, 2 prompts in flight, over chat_stream (32
                    requests on four shared 256-token system prefixes,
                    768-896 tokens in all), REPEATS runs each: decode
                    tokens/s, ms per tick, TTFT and peak pages, ticks, graph
                    replays and captures, and for the chunked mode prefix
                    hits, shared pages in use and chunks (both > 0); each
                    tick's decode is one CUDA graph, captured once per
                    engine, whose every replay launches B2 once per layer
                    plus one cross-attention kernel (B2, B3 or B4); greedy
                    tokens identical across repeats and to an eager engine
                    (cuda_graph=False) over the same stream, whose first
                    decoding tick's logits lie within 0.03 x their RMS
  6. train          the flagship train step (20 layers, bf16 over f32
                    parameters, batch 16, AdamW with clipping, activation
                    checkpointing with the dots policy): REPEATS windows of
                    TRAIN_STEPS steps, ms/step, latent tokens/s, MFU, peak
                    memory; B1b = 21 x steps, B1a = 21 x steps + 20 x steps
                    (the checkpointed layers' recomputes); the loss must fall
     train_30m      the 30M recipe through run_fit / Trainer.fit on the
                    Markov data (gather prefix dropout 0.5): 10 steps and one
                    eval, whose loss must be finite; exact B1 counts
     train_sp       clm_8k (sequence 8192, 1024 latents, 8 layers, gather
                    prefix dropout 0.5, dots checkpointing) at batch 4 with
                    sequence_parallel_axis="seq" under {"seq": 4} on the one
                    card: REPEATS windows of TRAIN_STEPS steps; B5 = (12 +
                    8 x 2 x 6) x steps (see ring_schedule), B1 never; the
                    loss must fall
     sp_lr_check    the same model, batch and state through the ring and
                    through the plain B1 path, SP_CHECK_STEPS steps each at
                    bench.py's learning rate and at SP_LR: losses step by
                    step within 2e-2 relative, and both falling at SP_LR
     optical_flow   OpticalFlowPipeline over official_41m_config() in bf16 on a
                    seeded 436 x 1024 synthetic frame pair (make_flow_pair:
                    6 patches, micro_batch_size=6): REPEATS model forwards
                    (ms, synced) and REPEATS pipeline calls (frame pairs/s),
                    medians and spreads, and the peak memory; B1a exactly 24
                    launches a forward at D = 64 and 1 at D = 512; the flow
                    finite, of shape (436, 1024, 2); then the same model at
                    its default dtype (float32) one patch a call, as the
                    pipeline's default micro-batch: ms a pair and a patch,
                    B1a in float32 only (csrc/flash_forward_f32.cu), 24
                    launches a patch at D = 64 and 1 at D = 512
     train_flow     the same model with activation checkpointing, AdamW at
                    1e-3 with clipping at 1.0, through scripts/convergence.py's
                    flow train step on a micro-batch of 2 seeded 368 x 496
                    patches: 3 warm-up and 5 timed steps (ms a step, patches/s,
                    peak memory); B1a and B1b by head width exact (D 512 once
                    a step each, D 64 twice a self-attention layer for B1a
                    and once for B1b); the loss finite and falling; then the
                    same in the model's default dtype (float32) on one
                    patch: B1a and B1b in float32 only, by width and dtype
                    exact
  7. card_vs_cpu    flagship at batch 1 in f32: logits within 1e-3 of the CPU
                    run, greedy tokens identical; then the engine at flagship
                    width with 2 layers in f32 (TF32 off) in paged fp, int8
                    and int4 pools: identical tokens, a tick's logits from
                    the same state within 1e-3, and the first tick's within
                    1e-3 in fp and int8 pools (see card_vs_cpu_serving);
                    the chunked and prefix path (paged_chunked_prefix's
                    options, 4 slots, 8 requests): identical tokens, equal
                    prefix hits and chunks, every tick's logits within 1e-3;
                    then training at flagship width with 2 layers in f32:
                    loss within 1e-5 relative, gradients within 1e-3 x their
                    RMS, 3 AdamW steps' losses within 1e-4 relative; the
                    same for the clm_8k ring with 2 layers (card vs CPU,
                    both under {"seq": 4}), and card vs card: the ring
                    against the same model without the seq axis (B1);
                    then OpticalFlow at full width with 2 self-attention
                    layers on a 64 x 96 image in f32 (TF32 off): the flow
                    within 1e-3 x its RMS of the CPU's, B1a launched at D =
                    64 and D = 512 on the card; and its training at full
                    width with 2 layers and 128 latents on 16 x 16 patches
                    in f32: loss 1e-5 relative, gradients 1e-3 x RMS, 3
                    AdamW steps 1e-4, B1b launched at D = 64 and 512
  8. flow_convergence  scripts/convergence.py's run_optical_flow_epe on the
                    card, FLOW_CONVERGENCE_STEPS steps through Trainer.fit:
                    the pipeline's endpoint error on unseen pairs, the
                    zero-flow baseline and the wall seconds; it must be
                    ``met`` (EPE under half the baseline)
Each main path runs with every launch counter set to 0 just before it and
read just after; a kernel of the path that was never launched fails the run.
The last three lines are the card (nvidia-smi), the kernel table and
{"ok": true, "device": ...}. Weights are random, from a seed.
"""

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

import numpy as np

import perceiver_io_torch.models.core.perceiver_ar as tpar
import perceiver_io_torch.ops.decode_kernel as dk
import perceiver_io_torch.ops.flash as fl
import perceiver_io_torch.ops.paged_decode_kernel as pk
import perceiver_io_torch.ops.ragged_paged_kernel as rk
from perceiver_io_torch.data.text.synthetic import SyntheticTextDataModule
from perceiver_io_torch.data.vision.synthetic import flow_patches, make_flow_pair
from perceiver_io_torch.generation.generate import GenerationConfig, generate
from perceiver_io_torch.models.core.config import CausalSequenceModelConfig, clm_8k_config, flagship_455m_config
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.models.vision.optical_flow import OpticalFlow, official_41m_config
from perceiver_io_torch.ops import cuda_build
from perceiver_io_torch.ops.position import apply_rope, frequency_position_encoding
from perceiver_io_torch.parallel.mesh import make_mesh, set_mesh
from perceiver_io_torch.pipelines import OpticalFlowPipeline
from perceiver_io_torch.scripts.common import OptimizerFlags, build_tx, run_fit
from perceiver_io_torch.scripts.convergence import make_flow_train_step, run_optical_flow_epe
from perceiver_io_torch.serving import ServingEngine
from perceiver_io_torch.training.fit import TrainerConfig
from perceiver_io_torch.training.flops import PerceiverARFlops, detect_peak_flops
from perceiver_io_torch.training.losses import cross_entropy
from perceiver_io_torch.training.trainer import (TrainState, build_optimizer, make_causal_lm_eval_step,
                                                 make_causal_lm_train_step, trainable)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# H100 SXM: float32-class products on the tensor cores, three TF32 products
# each (495 TFLOP/s TF32 / 3); beside it float32 outside the tensor cores
F32_FLOP_PER_S = 495e12 / 3
F32_CUDA_CORE_FLOP_PER_S = 67e12
SEED = 0
DEVICE = "cuda"
REPEATS = 3  # generate() calls per main-path run, and engine runs per pool mode; medians and spreads are printed
# Kernel vs plain: float32 within an absolute 1e-4. In bfloat16 both sides sum
# in float32 and round the output to bfloat16 apart, so they may differ by one
# bfloat16 step (up to 2**-7 of a value); the limit is that fraction of the
# output's RMS, which these inputs (unit keys and values, softmax over hundreds
# of slots) put far below 1.
F32_ATOL = 1e-4
BF16_RMS_FRACTION = 0.03
T_START = time.perf_counter()


def emit(**record):
    record["t"] = round(time.perf_counter() - T_START, 3)
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
_FLUSH = None


SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock


def time_ms(fn, reps=25, warmup=3, spin=False) -> float:
    """Median device time of ``fn`` in ms (CUDA events), with the 50 MB L2
    flushed before each run, as a decode step finds the caches. When the host
    takes longer to enqueue ``fn`` than the flush takes to run, the reading
    holds that difference too; with ``spin``, a spin kernel
    (``torch.cuda._sleep``) between the flush and the start event keeps the
    card busy meanwhile, so the reading is the card's alone."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------- phase 3: kernels
def decode_case(b, h, d, r, cap, n_q, dtype, pads, g):
    """Inputs of one decode-attention call as the model makes them: a full
    window, rows left-padded by ``pads``, slot angles from the shifted
    positions, queries pre-scaled."""
    dev = DEVICE
    shift = torch.tensor(pads, dtype=torch.int32, device=dev)[:, None]
    q = (torch.randn(b, h, n_q, d, generator=g, device=dev) * d**-0.5).to(dtype)
    k = torch.randn(b, cap, h * d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, cap, h * d, generator=g, device=dev).to(dtype)
    ang = frequency_position_encoding((torch.arange(cap, device=dev)[None, :] - shift).clamp_min(0), r).contiguous()
    pad = torch.arange(cap, device=dev)[None, :] < shift
    q_pos = cap - 1
    live = (q_pos + 1 - shift[:, 0]).to(torch.int32)
    return q, k, v, ang, q_pos, pad, live


def byte_bound(b, h, d, r, cap, n_q, esize, pads):
    """Least bytes and operations the function needs for these inputs: the
    live slots' key and value rows, their angles and pad flags, the queries
    and the output, each moved once; per live slot and head, the rotation (3
    flops a rotated channel) and 4 * n_q * D flops of scores and value sum."""
    live_slots = sum(cap - p for p in pads)
    nbytes = live_slots * (2 * h * d * esize + r * 4 + 1) + 2 * b * h * n_q * d * esize + 2 * b * 4
    flops = live_slots * h * (3 * r + 4 * n_q * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_CUDA_CORE_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, k, v, ang, q_pos, pad, live):
    """``F.scaled_dot_product_attention`` over pre-rotated keys with the same
    visibility: a yardstick for the kernel, used nowhere in the port."""
    b, h, n_q, d = q.shape
    cap = k.shape[1]
    split = lambda t: t.view(b, cap, h, d).transpose(1, 2)
    kr = apply_rope(split(k).float(), ang).to(q.dtype).contiguous()
    vv = split(v).contiguous()
    slot = torch.arange(cap, device=q.device)
    at = q_pos - (n_q - 1) + torch.arange(n_q, device=q.device)
    lo = q_pos + 1 - live
    mask = (slot[None, None, :] <= at[None, :, None]) & (slot[None, None, :] >= lo[:, None, None]) & ~pad[:, None, :]
    mask = mask[:, None].contiguous()
    return lambda: F.scaled_dot_product_attention(q, kr, vv, attn_mask=mask, scale=1.0)


DECODE_SHAPES = {  # name: (batch, heads, head dim, rotary width, capacity)
    "flagship_cross_attention": (8, 10, 128, 128, 1024),
    "flagship_self_attention": (8, 10, 128, 128, 512),
    "clm_30m_decode": (8, 8, 64, 32, 4096),
}
PADS8 = [0, 0, 3, 17, 100, 250, 0, 1]  # left pads of the 8 rows


def check_decode_kernel():
    g = torch.Generator(DEVICE).manual_seed(SEED)
    results = {}
    for name, (b, h, d, r, cap) in DECODE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for n_q in (1, 8):
                args = decode_case(b, h, d, r, cap, n_q, dtype, PADS8, g)
                got = dk.fused_decode_attention(*args)
                again = dk.fused_decode_attention(*args)
                want = dk.fused_decode_attention_reference(*args).float()
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                rms = want.pow(2).mean().sqrt().item()
                atol = F32_ATOL if dtype == torch.float32 else BF16_RMS_FRACTION * rms
                if not err <= atol:
                    raise AssertionError(f"{name} {dtype} n_q={n_q}: kernel vs plain max error {err} > {atol}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {dtype} n_q={n_q}: two runs differ")
                bound, bound_by = byte_bound(b, h, d, r, cap, n_q, torch.finfo(dtype).bits // 8, PADS8)
                splits = dk.decode_splits(b, h, cap, dk.num_sms(args[0].device))  # q_pos is an int, live a tensor
                _, _, _, _, q_pos, pad, live = args
                working = h * sum(len(dk.decode_split_rows(q_pos, lv, cap, pad_row, splits))
                                  for lv, pad_row in zip(live.tolist(), pad.tolist()))
                rec = dict(
                    shape=name, dtype=str(dtype).removeprefix("torch."), n_q=n_q, max_abs_err=err, atol=atol,
                    output_rms=rms, bit_identical=True, splits=splits, blocks_launched=b * h * splits,
                    blocks_working=working,
                    ms=time_ms(lambda: dk.fused_decode_attention(*args)),
                    plain_ms=time_ms(lambda: dk.fused_decode_attention_reference(*args)),
                    library_ms=time_ms(library_call(*args)), bound_ms=bound, bound_by=bound_by,
                )
                emit(phase="kernel_check", kernel="fused_decode_attention", **rec)
                results[(name, rec["dtype"], n_q)] = rec
    return results


# ------------------------------------------------ phase 3: paged kernels
POOL_BYTES = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}
PAGED_SHAPES = {  # name: (slots, heads, head dim, rotary width, window, page size)
    "flagship_cross_attention": (8, 10, 128, 128, 1024, 128),
    "clm_30m_decode": (8, 8, 64, 32, 4096, 128),
    "flagship_page_100": (8, 10, 128, 128, 1024, 100),  # the page size does not divide the window
}


def paged_case(w, h, d, r, window, ps, pool, q_dtype, g):
    """A pool of w * P + 1 pages (each row its own shuffled pages, page 0 the
    trash page), float32 angles of the ring's logical positions, scaled
    queries; quantized pools are written through ``write_pages``."""
    dev = g.device
    p = -(-window // ps)
    n_pages = w * p + 1
    q = (torch.randn(w, h, 1, d, generator=g, device=dev) * d**-0.5).to(q_dtype)
    kf, vf = (torch.randn(n_pages, ps, h * d, generator=g, device=dev) for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=g, device=dev)[: w * p] + 1).reshape(w, p).to(torch.int32)
    ang = frequency_position_encoding(torch.arange(p * ps, device=dev)[None, :].expand(w, -1) % window, r)
    if pool in ("f32", "bf16"):
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        return q, kf.to(dt), vf.to(dt), table, ang, {}, 8
    qbits = 4 if pool == "int4" else 8
    cache = pk.PagedKVCache(*[torch.zeros(n_pages, ps, h * d // (8 // qbits), device=dev,
                                          dtype=torch.uint8 if qbits == 4 else torch.int8) for _ in range(2)],
                            table, torch.zeros(w, dtype=torch.int32, device=dev), window,
                            torch.zeros(n_pages, h, device=dev), torch.zeros(n_pages, h, device=dev), num_heads=h,
                            qbits=qbits)
    cache.write_pages(torch.arange(n_pages, device=dev), kf, vf)
    return q, cache.kp, cache.vp, table, ang, dict(k_scale=cache.k_scale, v_scale=cache.v_scale), qbits


def paged_bound(h, d, r, ps, window, pool, q, start, live):
    """Least time for these inputs: bytes (each live row's key and value codes
    and its angles, each live page's two per-head scales on quantized pools,
    q and out, each read or written once) over 3.35 TB/s, or operations (per
    live row and head: dequantize, 3 flops a rotated channel, a dot and an
    axpy of D) over 67 TFLOP/s float32, whichever is larger."""
    start, live = start.tolist(), live.tolist()
    rows = sum(live)
    pages = 0
    for s0, lv in zip(start, live):
        live_pages = {((s0 - lv + j) % window) // ps for j in range(lv)}
        pages += len(live_pages)
    esize = torch.finfo(q.dtype).bits // 8
    nbytes = rows * (2 * h * d * POOL_BYTES[pool] + 4 * r) + 2 * q.numel() * esize
    if pool in ("int8", "int4"):
        nbytes += pages * 2 * h * 4
    flops = rows * h * (3 * r + 6 * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_CUDA_CORE_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_library_call(q, kp, vp, table, start, live, ang, window, scales, qbits):
    """``F.scaled_dot_product_attention`` over keys already gathered,
    dequantized and rotated, with the same visibility: a yardstick for the
    kernel that excludes the gather, used nowhere in the port."""
    w, h, _, d = q.shape
    cache = pk.PagedKVCache(kp, vp, table, start, window, scales.get("k_scale"), scales.get("v_scale"),
                            num_heads=h, qbits=qbits)
    k, v = cache.gather_dense()
    n = k.shape[1]
    split = lambda t: t.reshape(w, n, h, d).transpose(1, 2)
    kr = apply_rope(split(k).float(), ang).to(q.dtype).contiguous()
    vv = split(v).to(q.dtype).contiguous()
    mask = pk.paged_visibility(start, live, window, n)[:, None, None, :].contiguous()
    return lambda: F.scaled_dot_product_attention(q, kr, vv, attn_mask=mask, scale=1.0)


def paged_rows(window):
    """The 8 rows of a paged kernel check: B3's (start, live), full windows
    at ring offsets that wrap and partial lives that leave dead pages; B4's
    (start, live, causal bound), decode rows, the finish of a 900-token
    prompt over 512 latents (bounds window - 512 + j) and two live = 0
    lanes."""
    t = lambda xs: torch.tensor(xs, dtype=torch.int32, device=DEVICE)
    n, latents = 900, 512
    return (t([0, 517, window - 1, 333, 129, 64, 1000 % window, 5]),
            t([window, window, 700, 300, 129, 1, window - 24, 512]),
            t([77, window - 3, n, n, n, n, 0, 9]), t([window, 600, n, n, n, n, 0, 0]),
            t([window - 1, window - 1] + [window - latents + j for j in (0, 1, 255, 511)] + [window - 1, window - 1]))


def check_paged_kernels():
    """B3 and B4 against their plain versions; returns the records."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 3)
    records = []
    for name, (w, h, d, r, window, ps) in PAGED_SHAPES.items():
        b3_start, b3_live, b4_start, b4_live, b4_cb = paged_rows(window)
        cases = [("fused_paged_decode_attention", pool, q_dtype) for pool, q_dtype in
                 (("f32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.bfloat16))]
        cases += [("fused_ragged_paged_attention", pool, torch.bfloat16) for pool in ("int4", "bf16", "int8")]
        for kernel, pool, q_dtype in cases:
            q, kp, vp, table, ang, scales, qbits = paged_case(w, h, d, r, window, ps, pool, q_dtype, g)
            if kernel == "fused_paged_decode_attention":
                args = (q, kp, vp, table, b3_start, b3_live, ang, window)
                launch = lambda: pk.fused_paged_decode_attention(*args, **scales)
                plain = lambda: pk.fused_paged_decode_attention_reference(*args, **scales)
                eff_start, eff_live = b3_start, b3_live
            else:
                args = (q, kp, vp, table, b4_start, b4_live, b4_cb, ang, window)
                launch = lambda: rk.fused_ragged_paged_attention(*args, qbits=qbits, **scales)
                plain = lambda: rk.fused_ragged_paged_attention_reference(*args, qbits=qbits, **scales)
                eff_start, eff_live = rk.fold_causal_bound(b4_start, b4_live, b4_cb, window)
            got = launch()
            again = launch()
            want = plain().float()
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            rms = want.pow(2).mean().sqrt().item()
            atol = F32_ATOL if pool == "f32" else BF16_RMS_FRACTION * rms
            if not err <= atol:
                raise AssertionError(f"{kernel} {name} {pool}: kernel vs plain max error {err} > {atol}")
            zero_lanes = eff_live == 0
            if zero_lanes.any() and not (got[zero_lanes] == 0).all():
                raise AssertionError(f"{kernel} {name} {pool}: live = 0 lanes are not exact zeros")
            if not torch.equal(got, again):
                raise AssertionError(f"{kernel} {name} {pool}: two runs differ")
            bound, bound_by = paged_bound(h, d, r, ps, window, pool, q, eff_start, eff_live)
            splits = pk.paged_splits(w, h, window, ps, dk.num_sms(q.device))
            working = h * sum(len(pk.paged_split_rows(s0, lv, window, ps, splits))
                              for s0, lv in zip(eff_start.tolist(), eff_live.tolist()))
            rec = dict(kernel=kernel, shape=name, pool=pool, q_dtype=str(q_dtype).removeprefix("torch."),
                       page_size=ps, window=window, max_abs_err=err, atol=atol, output_rms=rms,
                       zero_lanes=int(zero_lanes.sum()), bit_identical=True, splits=splits,
                       blocks_launched=w * h * splits, blocks_working=working,
                       ms=time_ms(launch), plain_ms=time_ms(plain),
                       library_ms=time_ms(paged_library_call(q, kp, vp, table, eff_start, eff_live, ang, window,
                                                             scales, qbits)),
                       bound_ms=bound, bound_by=bound_by)
            emit(phase="kernel_check", **rec)
            records.append(rec)
    return records


def host_us(fn, calls=100, repeats=10) -> float:
    """Host microseconds one call of ``fn`` takes (the wrapper's Python, the
    ctypes call, the launch): ``calls`` calls queued back to back with no
    sync between them, on the host clock; the least of ``repeats``, since
    the host's cores are shared."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(times)


def decode_host_times():
    """B2, B3 and B4 at their head cases (B2 at its three shapes in bf16,
    n_q 1 and 8; B3 over a bf16 pool and B4 over an int4 pool at the flagship
    cross-attention shape): the host's microseconds a wrapper call takes
    (``host_us``) beside the card's ms a call and the library call's, timed
    as kernel_check times them (``ms``, ``library_ms``) and with the host's
    enqueue time kept out (``spin_ms``, ``library_spin_ms``); one JSON line a
    case. It calls only the wrappers' public
    functions, so it times another checkout's package the same way: from that
    checkout's root, load this file by its path
    (``importlib.util.spec_from_file_location``) and call this function."""
    g = torch.Generator(DEVICE).manual_seed(SEED)
    cases = {}
    for name, (b, h, d, r, cap) in DECODE_SHAPES.items():
        for n_q in (1, 8):
            args = decode_case(b, h, d, r, cap, n_q, torch.bfloat16, PADS8, g)
            cases[f"B2 {name} n_q={n_q}"] = (lambda a=args: dk.fused_decode_attention(*a), library_call(*args))
    w, h, d, r, window, ps = PAGED_SHAPES["flagship_cross_attention"]
    b3_start, b3_live, b4_start, b4_live, b4_cb = paged_rows(window)
    for kernel, pool in (("B3", "bf16"), ("B4", "int4")):
        q, kp, vp, table, ang, scales, qbits = paged_case(w, h, d, r, window, ps, pool, torch.bfloat16, g)
        if kernel == "B3":
            a = (q, kp, vp, table, b3_start, b3_live, ang, window)
            run = lambda a=a, s=scales: pk.fused_paged_decode_attention(*a, **s)
            st, lv = b3_start, b3_live
        else:
            a = (q, kp, vp, table, b4_start, b4_live, b4_cb, ang, window)
            run = lambda a=a, s=scales: rk.fused_ragged_paged_attention(*a, qbits=4, **s)
            st, lv = rk.fold_causal_bound(b4_start, b4_live, b4_cb, window)
        cases[f"{kernel} {pool} flagship_cross_attention"] = (
            run, paged_library_call(q, kp, vp, table, st, lv, ang, window, scales, qbits))
    card = card_line()
    for name, (run, library) in cases.items():
        emit(phase="decode_host", case=name, host_us=host_us(run), ms=time_ms(run), spin_ms=time_ms(run, spin=True),
             library_ms=time_ms(library), library_spin_ms=time_ms(library, spin=True), card=card)

# ------------------------------------------------ phase 3: flash kernels
FLASH_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None)
    "flagship_cross_attention": (16, 10, 512, 1024, 128, None),
    "flagship_self_attention": (16, 10, 512, 512, 128, None),
    # the 30M recipe after the gather (3,584 prefix tokens halved, then 512
    # latents), its rows left-padded inside the prefix
    "clm_30m_cross_attention": (8, 8, 512, 2304, 64, [0, 0, 7, 100, 300, 511, 1024, 1790]),
}
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores


def flash_limit(want, dtype):
    """Kernel vs plain: float32 within 1e-4 absolute. bfloat16 within 0.03 x
    the RMS of the plain tensor, as B2-B4 are held, plus one bfloat16 step of
    the element itself (2**-7 of it): the two sides round a float32 result
    to bfloat16 apart, and here the largest elements sit far above the RMS
    (a gradient's at 10-20x; a causal self-attention's first rows average
    one or a few values), so one step there alone can exceed 0.03 x the RMS.
    (The backward's delta = rowsum(dO * O) uses the float32 O, as autograd of
    the plain version does; taken from the bf16-rounded O, as the TPU kernel
    takes it, the flagship self-attention's dq moved by up to 4 bf16 steps.)
    Returns (atol, rtol)."""
    if dtype == torch.float32:
        return F32_ATOL, 0.0
    return BF16_RMS_FRACTION * want.float().pow(2).mean().sqrt().item(), 2.0**-7


def flash_case(b, h, nq, nk, d, pads, dtype, g):
    q = (torch.randn(b, h, nq, d, generator=g, device=DEVICE) * d**-0.5).to(dtype)
    k, v, do = (torch.randn(b, h, n, d, generator=g, device=DEVICE).to(dtype) for n in (nk, nk, nq))
    pad = None if pads is None else torch.arange(nk, device=DEVICE)[None, :] < torch.tensor(pads, device=DEVICE)[:, None]
    return q, k, v, pad, do


def flash_bounds(q, k, pad, esize):
    """Least times (ms, bound_by) of the forward and the backward for these
    inputs: 4 D flops a visible (query, key) pair forward and 10 D backward
    over the dense peak of the input type (bf16 tensor cores, or float32
    outside them), against the bytes each must move once: forward q, k, v
    in and o, lse out; backward q, k, v, o, dO, lse in and dq, dk, dv out."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    visible = fl._visibility(nq, nk, pad, True, q.device).expand(b, 1, nq, nk)
    pairs = int(visible.sum().item()) * h
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    rows_q, rows_k = b * h * nq, b * h * nk
    pad_bytes = 0 if pad is None else b * nk
    out = {}
    for name, flops, nbytes in (
            ("forward", 4 * d * pairs, (2 * rows_q + 2 * rows_k) * d * esize + rows_q * 4 + pad_bytes),
            ("backward", 10 * d * pairs, (4 * rows_q + 4 * rows_k) * d * esize + rows_q * 4 + pad_bytes)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out, pairs


def check_flash_kernel():
    """B1a (forward) and B1b (backward) against the plain version and its
    autograd gradients at the training path's shapes, causal, in float32 and
    bfloat16; pad keys' dK and dV must be exact zeros, and two backward runs
    on the same inputs the same bits (no atomics; in float32 the forward
    too), and at the flagship cross-attention the float32 output
    float32-class (f32_class_check). Times per call: the
    forward, the backward alone (from a saved forward) and both, for the
    kernel, the plain version and F.scaled_dot_product_attention with the
    same boolean mask (a yardstick, used nowhere in the port)."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 6)
    records = []
    for name, (b, h, nq, nk, d, pads) in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pad, do = flash_case(b, h, nq, nk, d, pads, dtype, g)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            got = fl.splash_mha(*leaves, pad_mask=pad, causal=True)
            got_grads = torch.autograd.grad(got, leaves, do)
            ref_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            want = fl.flash_attention_reference(*ref_leaves, pad_mask=pad, causal=True)
            want_grads = torch.autograd.grad(want, ref_leaves, do, retain_graph=True)
            torch.cuda.synchronize()
            errs, limits = {}, {}
            for key, x, y in zip(("o", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
                atol, rtol = flash_limit(y, dtype)
                diff = (x.float() - y.float()).abs()
                errs[key] = diff.max().item()
                limits[key] = (atol, rtol)
                if not (diff <= atol + rtol * y.float().abs()).all():
                    raise AssertionError(f"flash {name} {dtype} {key}: kernel vs plain max error {errs[key]} "
                                         f"(atol {atol}, rtol {rtol})")
            f32_class = (f32_class_check(name, got.detach(), want.detach(), q, k, v, pad, True)
                         if dtype == torch.float32 and name == "flagship_cross_attention" else {})
            if dtype == torch.bfloat16:  # a forward without gradients: P in one bf16 term
                with torch.no_grad():
                    one = fl.splash_mha(q, k, v, pad_mask=pad, causal=True).float()
                atol, rtol = flash_limit(want, dtype)
                diff = (one - want.float()).abs()
                errs["o_one_term_p"], limits["o_one_term_p"] = diff.max().item(), (atol, rtol)
                if not (diff <= atol + rtol * want.float().abs()).all():
                    raise AssertionError(f"flash {name} {dtype} o (one-term P): kernel vs plain max error "
                                         f"{errs['o_one_term_p']} (atol {atol}, rtol {rtol})")
                del one, diff
            # the same gradients from the kernels' own arithmetic in plain PyTorch
            fa2 = fl._backward_plain(q, k, v, pad, True, *fl._forward_plain(q, k, v, pad, True), do)
            errs_fa2 = {key: (x.float() - y.float()).abs().max().item()
                        for key, x, y in zip(("dq", "dk", "dv"), got_grads, fa2)}
            del fa2
            if pad is not None:
                at = pad[:, None, :, None].expand_as(got_grads[1])
                if not ((got_grads[1][at] == 0).all() and (got_grads[2][at] == 0).all()):
                    raise AssertionError(f"flash {name} {dtype}: pad keys' dK or dV are not exact zeros")

            # saved forward for the backward-alone timings
            o, lse = fl._launch_forward(q, k, v, pad, True)
            if dtype == torch.float32 and not all(map(torch.equal, (o, lse), fl._launch_forward(q, k, v, pad, True))):
                raise AssertionError(f"flash {name} {dtype}: two forward runs on the same inputs differ")
            first, second = (fl._launch_backward(q, k, v, pad, True, o, lse, do) for _ in range(2))
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError(f"flash {name} {dtype}: two backward runs on the same inputs differ")
            del first, second
            mask = fl._visibility(nq, nk, pad, True, q.device).contiguous()
            lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask, scale=1.0)

            def both(fn, ls):
                return lambda: torch.autograd.grad(fn(*ls), ls, do)

            def library(*ts):
                return F.scaled_dot_product_attention(*ts, attn_mask=mask, scale=1.0)

            times = dict(
                ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, True)),  # bf16: P in two terms, as in training
                backward_ms=time_ms(lambda: fl._launch_backward(q, k, v, pad, True, o, lse, do)),
                forward_backward_ms=time_ms(both(lambda *ts: fl.splash_mha(*ts, pad_mask=pad, causal=True), leaves)),
                plain_ms=time_ms(lambda: fl.flash_attention_reference(q, k, v, pad, True)),
                plain_backward_ms=time_ms(lambda: torch.autograd.grad(want, ref_leaves, do, retain_graph=True)),
                plain_forward_backward_ms=time_ms(both(
                    lambda *ts: fl.flash_attention_reference(*ts, pad_mask=pad, causal=True), ref_leaves)),
                library_ms=time_ms(lambda: library(q, k, v)),
                library_backward_ms=time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)),
                library_forward_backward_ms=time_ms(both(library, lib_leaves)),
            )
            if dtype == torch.bfloat16:
                times["one_term_p_ms"] = time_ms(lambda: fl._launch_forward(q, k, v, pad, True, split_p=False))
            bounds, pairs = flash_bounds(q, k, pad, torch.finfo(dtype).bits // 8)
            rec = dict(kernel="splash_mha", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b, heads=h,
                       queries=nq, keys=nk, head_dim=d, visible_pairs=pairs, max_abs_err=errs, limits=limits,
                       grad_err_vs_plain_fa2_arithmetic=errs_fa2, backward_bit_identical=True,
                       bound_ms=bounds["forward"][0], bound_by=bounds["forward"][1],
                       backward_bound_ms=bounds["backward"][0], backward_bound_by=bounds["backward"][1], **times,
                       **f32_class)
            if dtype == torch.float32:
                rec["bound_ms_cuda_cores"] = cuda_core_bound_ms(bounds["forward"][0], 4 * d * pairs)
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del leaves, ref_leaves, lib_leaves, got_grads, want_grads, want, lib_out
            torch.cuda.empty_cache()
    return records


# ------------------------------------- phase 3: B1a at the optical-flow shapes
FLOW_FLASH_SHAPES = {  # name: (batch, heads, queries, keys, head dim); full mask, no padding
    # official_41m_config's decoder at bench.py's six patches: the 182,528
    # pixels of a 368 x 496 patch over the 2,048 latents, one head of 512
    "flow_decoder_cross_attention": (6, 1, 182_528, 2048, 512),
    "flow_self_attention": (6, 8, 2048, 2048, 64),  # each of its 24 self-attention layers
}


def full_mask_bound(b, h, nq, nk, d, esize, backward=False):
    """Least time (ms, bound_by) of one full-mask forward (or backward): 4 D
    (10 D) flops a (query, key) pair over the dense peak of the input type,
    against the bytes moved once: q, k and v in, the float32 output and
    log-sum-exp out (backward: q, k, v and dO in, the float32 output and
    log-sum-exp in, dq, dk and dv out)."""
    flops = (10 if backward else 4) * d * b * h * nq * nk
    rows = (3 * b * h * nq + 4 * b * h * nk) if backward else (b * h * nq + 2 * b * h * nk)
    nbytes = rows * d * esize + b * h * nq * (d + 1) * 4
    peak = BF16_FLOP_PER_S if esize == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_kernel_names(fn, top=4):
    """The names of the CUDA kernels one call of ``fn`` spends most time in
    (torch.profiler): which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.key[:120] for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]]


def check_flow_flash_kernel():
    """B1a at the optical-flow model's attention shapes, full mask, as the
    inference path calls it (no gradients: in bf16 P in one bf16 term),
    against its plain version: bf16 within 0.03 x the plain output's RMS
    plus one bf16 step of the element (flash_limit), f32 within 1e-4. The
    decoder's shape is checked at 1 patch and at the main path's 6 patches:
    the six-patch launch is held patch by patch against the plain version of
    each patch (its float32 scores of six patches at once are 9 GB a copy);
    in float32 its patch is also held to float32-class accuracy
    (f32_class_check). It is timed at 6 and at 1 (in float32 the
    default-dtype pipeline's call): the kernel and the library call at 6
    patches and at 1, the plain version at 1 and over the 6 patches one
    patch a call. F.scaled_dot_product_attention is the library yardstick,
    used nowhere in the port; the kernels it launched are named (PyTorch's
    flash backend takes heads up to 256 channels). Float32 bounds have their
    CUDA-core bound beside them."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 10)
    records = []
    for name, (b, h, nq, nk, d) in FLOW_FLASH_SHAPES.items():
        decoder = name == "flow_decoder_cross_attention"
        for dtype in (torch.float32, torch.bfloat16):
            nb = 1 if decoder else b
            q, k, v, _, _ = flash_case(nb, h, nq, nk, d, None, dtype, g)
            with torch.no_grad():
                got, again = fl.splash_mha(q, k, v), fl.splash_mha(q, k, v)
            want = fl.flash_attention_reference(q, k, v)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash {name} {dtype}: two runs on the same inputs differ")
            if got.dtype != dtype:
                raise AssertionError(f"flash {name} {dtype}: the forward without gradients returned {got.dtype}")
            del again
            atol, rtol = flash_limit(want, dtype)
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            if not (diff <= atol + rtol * want.float().abs()).all():
                raise AssertionError(f"flash {name} {dtype}: kernel vs plain max error {err} (atol {atol}, "
                                     f"rtol {rtol})")
            del diff
            f32_class = (f32_class_check(name, got, want, q, k, v, None, False)
                         if decoder and dtype == torch.float32 else {})
            del got, want
            esize = torch.finfo(dtype).bits // 8
            rec = dict(kernel="splash_mha", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b,
                       checked_batch=nb, heads=h, queries=nq, keys=nk, head_dim=d, mask="full",
                       max_abs_err=err, limits=(atol, rtol), bit_identical=True,
                       ms_checked_batch=time_ms(lambda: fl._launch_forward(q, k, v, None, False, split_p=False)),
                       plain_ms_checked_batch=time_ms(lambda: fl.flash_attention_reference(q, k, v), reps=5),
                       library_ms_checked_batch=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)),
                       **f32_class)
            if decoder:  # six patches
                patches = [flash_case(1, h, nq, nk, d, None, dtype, g)[:3] for _ in range(b)]
                q6, k6, v6 = (torch.cat(ts) for ts in zip(*patches))
                o6 = fl._launch_forward(q6, k6, v6, None, False, split_p=False)[0]
                if o6.dtype != dtype or not torch.equal(
                        o6, fl._launch_forward(q6, k6, v6, None, False, split_p=False)[0]):
                    raise AssertionError(f"flash {name} {dtype} at {b} patches: not a {dtype} output, or two runs "
                                         "differ")
                errs6 = []
                for i, patch in enumerate(patches):
                    want = fl.flash_attention_reference(*patch)
                    atol6, rtol6 = flash_limit(want, dtype)
                    diff = (o6[i:i + 1].float() - want.float()).abs()
                    errs6.append(diff.max().item())
                    if not (diff <= atol6 + rtol6 * want.float().abs()).all():
                        raise AssertionError(f"flash {name} {dtype} at {b} patches: patch {i} kernel vs plain "
                                             f"max error {errs6[-1]} (atol {atol6}, rtol {rtol6})")
                    del want, diff
                del o6
                rec.update(max_abs_err=max(err, *errs6), max_abs_err_checked_batch=err, max_abs_err_by_patch=errs6)
                rec.update(
                    ms=time_ms(lambda: fl._launch_forward(q6, k6, v6, None, False, split_p=False), reps=10),
                    plain_ms=time_ms(lambda: [fl.flash_attention_reference(*t) for t in patches], reps=3),
                    plain_ms_note="the six patches one patch a call",
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(q6, k6, v6, scale=1.0), reps=10),
                    library_kernels=cuda_kernel_names(lambda: F.scaled_dot_product_attention(q6, k6, v6,
                                                                                             scale=1.0)))
                del patches, q6, k6, v6
            else:
                rec.update(ms=rec["ms_checked_batch"], plain_ms=rec["plain_ms_checked_batch"],
                           library_ms=rec["library_ms_checked_batch"],
                           library_kernels=cuda_kernel_names(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                                                    scale=1.0)))
            rec["bound_ms"], rec["bound_by"] = full_mask_bound(b, h, nq, nk, d, esize)
            rec["bound_ms_checked_batch"], rec["bound_by_checked_batch"] = full_mask_bound(nb, h, nq, nk, d, esize)
            if dtype == torch.float32:
                for key, batch in (("bound_ms", b), ("bound_ms_checked_batch", nb)):
                    rec[f"{key}_cuda_cores"] = cuda_core_bound_ms(rec[key], 4 * d * batch * h * nq * nk)
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del q, k, v
            torch.cuda.empty_cache()
    return records


# ------------------------- phase 3: B1a wide (csrc/flash_forward_wide.cu) beyond inference
WIDE_FORWARD_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None, causal)
    # official_41m_config's decoder in the train step: B1a with two-term P
    # (B1b reads its float32 output) at 2 patches, full mask
    "flow_decoder_train_step": (2, 1, 182_528, 2048, 512, None, False),
    # 1,050 queries: 16 full 64-query tiles and a partial one, so the last
    # two-block cluster holds a spare block; left-padded keys, causal
    "wide_192_padded_causal": (2, 2, 1050, 768, 192, [0, 300], True),
    "wide_256_padded_causal": (2, 2, 1050, 768, 256, [0, 300], True),
}


def check_wide_forward_kernel():
    """B1a's wide bf16 kernel (csrc/flash_forward_wide.cu) where the flow
    inference check does not reach: the flow train step's call (2 patches,
    P in two terms, float32 o), held patch by patch, and D 192 and 256,
    padded and causal, at an odd query-tile count, with P in one term (the
    bf16 output within flash_limit) and in two (the float32 output and lse
    within F32_ATOL); every launch run twice for the same bits. Times per
    call (L2 flushed), the bound, the plain version and the library call
    F.scaled_dot_product_attention (with the same mask, returning the output
    only)."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 12)
    records = []
    for name, (b, h, nq, nk, d, pads, causal) in WIDE_FORWARD_SHAPES.items():
        decoder = name == "flow_decoder_train_step"
        q, k, v, pad, _ = flash_case(b, h, nq, nk, d, pads, torch.bfloat16, g)
        mask = None if pad is None and not causal else fl._visibility(nq, nk, pad, causal, q.device).contiguous()
        rec = dict(kernel="splash_mha", shape=name, dtype="bfloat16", batch=b, heads=h, queries=nq, keys=nk,
                   head_dim=d, causal=causal, query_tiles=-(-nq // 64), bit_identical=True, launches_per_call=1)
        errs = {}
        for split_p in ((True,) if decoder else (False, True)):
            key = "two_term_p" if split_p else "one_term_p"
            first, second = (fl._launch_forward(q, k, v, pad, causal, split_p=split_p) for _ in range(2))
            torch.cuda.synchronize()
            if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
                raise AssertionError(f"wide forward {name} ({key}): two runs on the same inputs differ")
            want_dtype = torch.float32 if split_p else torch.bfloat16
            if first[0].dtype != want_dtype:
                raise AssertionError(f"wide forward {name} ({key}): o is {first[0].dtype}, not {want_dtype}")
            del second
            for i in range(b if decoder else 1):  # the decoder patch by patch, as the plain version's scores are large
                at = slice(i, i + 1) if decoder else slice(None)
                want_o, want_lse = fl._forward_plain(q[at], k[at], v[at], None if pad is None else pad[at], causal)
                pairs = [("lse", first[1][at], want_lse)]
                pairs.append(("o", first[0][at], want_o) if split_p else ("o", first[0][at], want_o.bfloat16()))
                for part, x, y in pairs:
                    atol, rtol = (F32_ATOL, 0.0) if split_p else flash_limit(y, torch.bfloat16)
                    finite = torch.isfinite(y)
                    if not torch.equal(torch.isfinite(x), finite):
                        raise AssertionError(f"wide forward {name} ({key}) {part}: finite entries differ")
                    diff = (x[finite].float() - y[finite].float()).abs()
                    err = diff.max().item() if diff.numel() else 0.0
                    errs[f"{part}_{key}"] = max(errs.get(f"{part}_{key}", 0.0), err)
                    if not (diff <= atol + rtol * y[finite].float().abs()).all():
                        raise AssertionError(f"wide forward {name} ({key}) {part}: kernel vs plain max error {err} "
                                             f"(atol {atol}, rtol {rtol})")
                del want_o, want_lse, pairs
            del first
        rec["max_abs_err"] = errs
        if decoder:
            rec.update(ms=time_ms(lambda: fl._launch_forward(q, k, v, None, False, split_p=True), reps=10),
                       plain_ms=time_ms(lambda: [fl._forward_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], None, False)
                                                 for i in range(b)], reps=3),
                       plain_ms_note="the two patches one patch a call",
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), reps=10))
            rec["bound_ms"], rec["bound_by"] = full_mask_bound(b, h, nq, nk, d, 2)
        else:
            (bounds, pairs) = flash_bounds(q, k, pad, 2)
            rec.update(ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, causal, split_p=False)),
                       two_term_p_ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, causal, split_p=True)),
                       plain_ms=time_ms(lambda: fl._forward_plain(q, k, v, pad, causal)),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)),
                       visible_pairs=pairs, bound_ms=bounds["forward"][0], bound_by=bounds["forward"][1])
        emit(phase="kernel_check", **rec)
        records.append(rec)
        del q, k, v, pad, mask
        torch.cuda.empty_cache()
    return records


# ------------------------- phase 3: B1a in float32 (csrc/flash_forward_f32.cu)
# The float32-class limit: the float32 forward's error against the float64
# plain version at most this many times the plain float32 version's (TF32
# off). On an H100 the kernel read 0.44-0.93 x, its first build (one chain of
# the tensor cores' truncating sums over D and every key) 6.13-8.69 x, one
# TF32 term 250-2,000 x.
F32_CLASS_FACTOR = 4


def f32_class_check(name, got, want, q, k, v, pad, causal):
    """The float32-class check of a float32 forward's output ``got`` (the
    plain float32 version's is ``want``): its error against the float64
    plain version within F32_CLASS_FACTOR x the plain float32 version's.
    Returns the record's fields."""
    ref = fl._forward_plain(q.double(), k.double(), v.double(), pad, causal)[0]
    err_kernel = (got.double() - ref).abs().max().item()
    err_plain = (want.double() - ref).abs().max().item()
    del ref
    if not err_kernel <= F32_CLASS_FACTOR * err_plain:
        raise AssertionError(f"f32 forward {name}: error vs float64 {err_kernel} is more than {F32_CLASS_FACTOR} x "
                             f"the plain float32 version's {err_plain}")
    return dict(err_vs_float64=err_kernel, plain_f32_err_vs_float64=err_plain,
                err_ratio=err_kernel / max(err_plain, 1e-30), err_ratio_limit=F32_CLASS_FACTOR)


def cuda_core_bound_ms(bound_ms, flops):
    """A float32 bound at the CUDA cores' rate, printed beside the tensor
    cores' ``bound_ms``: the larger of its bytes time and ``flops`` over
    F32_CUDA_CORE_FLOP_PER_S."""
    return max(bound_ms, flops / F32_CUDA_CORE_FLOP_PER_S * 1e3)


# ------------------------------- phase 3: B1b at the optical-flow decoder's head
WIDE_BACKWARD_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None, causal)
    # official_41m_config's decoder in the train step: 182,528 pixels over
    # 2,048 latents, one head of 512, full mask; checked at 1 patch, timed at 2
    "flow_decoder_cross_attention": (2, 1, 182_528, 2048, 512, None, False),
    "wide_192_padded_causal": (2, 2, 1024, 768, 192, [0, 300], True),
    "wide_256_padded_causal": (2, 2, 1024, 768, 256, [0, 300], True),
    # 1,050 queries: 17 of the dQ pass's 64-query tiles, so its last cluster
    # holds a spare block; 720 keys: 23 of the dK/dV pass's 32-key blocks, the
    # last ragged, and a spare block there too; bf16 only
    "wide_320_padded_causal_ragged": (2, 2, 1050, 720, 320, [0, 300], True),
}
# the wide backward's passes, by a fragment of each kernel's name
WIDE_BACKWARD_PASSES = {"flash_bwd_delta_kernel": "delta", "flash_bwd_wide_dkdv_kernel": "dkdv",
                        "flash_bwd_wide_reduce_kernel": "reduce", "flash_bwd_wide_dq_kernel": "dq"}


def wide_backward_pass_ms(fn, calls=3, passes=None):
    """Device ms of each pass of one backward call (torch.profiler, median
    over ``calls`` calls), by ``passes`` (a fragment of each kernel's name:
    the pass; default the wide bf16 backward's delta, dK/dV, the split
    reduce, dQ)."""
    passes = WIDE_BACKWARD_PASSES if passes is None else passes
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = {name: [] for name in passes.values()}
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for fragment, name in passes.items():
                    if fragment in e.key:
                        times[name].append(e.self_device_time_total / 1e3)
    return {name: statistics.median(ts) for name, ts in times.items() if ts}


def check_wide_backward_kernel():
    """B1b at heads of 192-512 channels (bf16: csrc/flash_backward_wide.cu;
    f32: csrc/flash_backward_f32.cu) against its plain version
    (the same (o, lse) from B1a's plain version into both): dq, dk and dv
    within flash_limit, pad keys' dk and dv exact zeros, two runs the same
    bits. The flow decoder's shape in bf16, full mask: checked at 1 patch
    and at the train step's 2 patches (that launch held patch by patch
    against the plain version of each patch, and run twice for the same
    bits), timed at 2 (kernel, the plain backward as two one-patch calls,
    and the library yardstick F.scaled_dot_product_attention: its backward
    from a saved forward, and forward + backward, with the CUDA kernels it
    ran named, or the error it raised, and each pass's device ms); D 192 and
    256 in bf16 and f32 at a left-padded causal shape (in f32 B1a's forward
    too: o and lse within F32_ATOL of the plain version, rows that see no
    key exact zeros, two runs the same bits, timed beside the plain version,
    the library call and its bound at both float32 rates); D 320 in bf16 at
    a left-padded causal shape whose query and key tiles both leave a spare
    block in their last cluster. Times per call, L2 flushed."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 11)
    records = []
    for name, (b, h, nq, nk, d, pads, causal) in WIDE_BACKWARD_SHAPES.items():
        decoder = name == "flow_decoder_cross_attention"
        bf16_only = decoder or name.endswith("_ragged")
        for dtype in (torch.bfloat16,) if bf16_only else (torch.float32, torch.bfloat16):
            nb = 1 if decoder else b
            q, k, v, pad, do = flash_case(nb, h, nq, nk, d, pads, dtype, g)
            o, lse = fl._forward_plain(q, k, v, pad, causal)
            want = fl._backward_plain(q, k, v, pad, causal, o, lse, do)
            first = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
            second = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
            torch.cuda.synchronize()
            errs, limits = {}, {}
            for key, x, y in zip(("dq", "dk", "dv"), first, want):
                atol, rtol = flash_limit(y, dtype)
                diff = (x.float() - y.float()).abs()
                errs[key], limits[key] = diff.max().item(), (atol, rtol)
                if not (diff <= atol + rtol * y.float().abs()).all():
                    raise AssertionError(f"wide backward {name} {dtype} {key}: kernel vs plain max error "
                                         f"{errs[key]} (atol {atol}, rtol {rtol})")
            if pad is not None:
                at = pad[:, None, :, None].expand_as(first[1])
                if not ((first[1][at] == 0).all() and (first[2][at] == 0).all()):
                    raise AssertionError(f"wide backward {name} {dtype}: pad keys' dK or dV are not exact zeros")
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError(f"wide backward {name} {dtype}: two runs on the same inputs differ")
            del want, first, second
            esize = torch.finfo(dtype).bits // 8
            rec = dict(kernel="splash_mha_backward", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b,
                       checked_batch=nb, heads=h, queries=nq, keys=nk, head_dim=d, causal=causal,
                       max_abs_err=errs, limits=limits, backward_bit_identical=True)
            if decoder:  # the train step's two patches, held patch by patch against the plain version
                patches = [(q, k, v, do)]
                for _ in range(b - 1):
                    pq, pk, pv, _, pdo = flash_case(1, h, nq, nk, d, None, dtype, g)
                    patches.append((pq, pk, pv, pdo))
                q2, k2, v2, do2 = (torch.cat(ts) for ts in zip(*patches))
                o2, lse2 = fl._launch_forward(q2, k2, v2, None, False)
                per_patch = [(pq, pk, pv, o2[i:i + 1], lse2[i:i + 1], pdo)
                             for i, (pq, pk, pv, pdo) in enumerate(patches)]
                first = fl._launch_backward(q2, k2, v2, None, False, o2, lse2, do2)
                second = fl._launch_backward(q2, k2, v2, None, False, o2, lse2, do2)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(first, second)):
                    raise AssertionError(f"wide backward {name} {dtype} at {b} patches: two runs differ")
                del second
                errs2 = []
                for i, args in enumerate(per_patch):
                    want = fl._backward_plain(*args[:3], None, False, *args[3:])
                    errs2.append({})
                    for key, x, y in zip(("dq", "dk", "dv"), first, want):
                        atol2, rtol2 = flash_limit(y, dtype)
                        diff = (x[i:i + 1].float() - y.float()).abs()
                        errs2[-1][key] = diff.max().item()
                        if not (diff <= atol2 + rtol2 * y.float().abs()).all():
                            raise AssertionError(f"wide backward {name} {dtype} at {b} patches: patch {i} {key} "
                                                 f"kernel vs plain max error {errs2[-1][key]} (atol {atol2}, "
                                                 f"rtol {rtol2})")
                        del diff
                    del want
                del first
                rec.update(max_abs_err={key: max(errs[key], *(e[key] for e in errs2)) for key in errs},
                           max_abs_err_checked_batch=errs, max_abs_err_by_patch=errs2)
                rec.update(
                    splits=fl.wide_backward_splits(b * h, nq, nk, d,
                                                   torch.cuda.get_device_properties(0).multi_processor_count),
                    ms=time_ms(lambda: fl._launch_backward(q2, k2, v2, None, False, o2, lse2, do2), reps=10),
                    ms_by_pass=wide_backward_pass_ms(lambda: fl._launch_backward(q2, k2, v2, None, False, o2, lse2,
                                                                                 do2)),
                    ms_checked_batch=time_ms(lambda: fl._launch_backward(q, k, v, None, False, o, lse, do), reps=10),
                    plain_ms=time_ms(lambda: [fl._backward_plain(pq, pk, pv, None, False, po, pl, pdo)
                                              for pq, pk, pv, po, pl, pdo in per_patch], reps=3),
                    plain_ms_note="the two patches one patch a call")
                leaves = [t.detach().clone().requires_grad_() for t in (q2, k2, v2)]
                fb = lambda: torch.autograd.grad(fl.splash_mha(*leaves), leaves, do2)
                rec["forward_backward_ms"] = time_ms(fb, reps=5)
                try:
                    lib_leaves = [t.detach().clone().requires_grad_() for t in (q2, k2, v2)]
                    lib_out = F.scaled_dot_product_attention(*lib_leaves, scale=1.0)
                    lib_fb = lambda: torch.autograd.grad(F.scaled_dot_product_attention(*lib_leaves, scale=1.0),
                                                         lib_leaves, do2)
                    rec.update(
                        library_ms=time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do2, retain_graph=True),
                                           reps=5),
                        library_forward_backward_ms=time_ms(lib_fb, reps=5),
                        library_kernels=cuda_kernel_names(lib_fb, top=6))
                    del lib_out, lib_leaves
                except RuntimeError as err:  # no backend of F.scaled_dot_product_attention takes this shape
                    rec.update(library_ms=None, library_error=str(err)[:300])
                del patches, per_patch, q2, k2, v2, do2, o2, lse2, leaves
                rec["bound_ms"], rec["bound_by"] = full_mask_bound(b, h, nq, nk, d, esize, backward=True)
                rec["bound_ms_checked_batch"] = full_mask_bound(nb, h, nq, nk, d, esize, backward=True)[0]
            else:  # causal: flash_bounds counts the visible pairs
                bounds, pairs = flash_bounds(q, k, pad, esize)
                mask = fl._visibility(nq, nk, pad, causal, q.device).contiguous()
                lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask, scale=1.0)
                rec.update(ms=time_ms(lambda: fl._launch_backward(q, k, v, pad, causal, o, lse, do)),
                           plain_ms=time_ms(lambda: fl._backward_plain(q, k, v, pad, causal, o, lse, do)),
                           library_ms=time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)),
                           library_note="backward from a saved forward",
                           visible_pairs=pairs, bound_ms=bounds["backward"][0], bound_by=bounds["backward"][1],
                           ops_ms_cuda_cores=10 * d * pairs / F32_CUDA_CORE_FLOP_PER_S * 1e3
                           if dtype == torch.float32 else None)
                if dtype == torch.float32:  # B1a's float32 forward on the same inputs
                    fo, flse = fl._launch_forward(q, k, v, pad, causal)
                    again = fl._launch_forward(q, k, v, pad, causal)
                    finite = torch.isfinite(lse)
                    if not (torch.equal(fo, again[0]) and torch.equal(flse, again[1])
                            and torch.equal(torch.isfinite(flse), finite) and (fo[~finite] == 0).all()):
                        raise AssertionError(f"f32 forward {name}: two runs differ, or its rows that see no key are "
                                             "not zeros and -inf")
                    ferrs = {"o": (fo - o).abs().max().item(),
                             "lse": (flse[finite] - lse[finite]).abs().max().item()}
                    if not max(ferrs.values()) <= F32_ATOL:
                        raise AssertionError(f"f32 forward {name}: kernel vs plain max error {ferrs} (atol {F32_ATOL})")
                    del fo, flse, again
                    rec.update(forward_max_abs_err=ferrs, forward_bit_identical=True,
                               forward_ms=time_ms(lambda: fl._launch_forward(q, k, v, pad, causal)),
                               forward_plain_ms=time_ms(lambda: fl._forward_plain(q, k, v, pad, causal)),
                               forward_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                                   q, k, v, attn_mask=mask, scale=1.0)),
                               forward_bound_ms=bounds["forward"][0], forward_bound_by=bounds["forward"][1],
                               forward_bound_ms_cuda_cores=cuda_core_bound_ms(bounds["forward"][0], 4 * d * pairs))
                del mask, lib_leaves, lib_out
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return records


# -------------------------------- phase 3: B1b in float32 (csrc/flash_backward_f32.cu)
F32_BACKWARD_SHAPES = {  # name: (batch, heads, queries, keys, head dim, left pads of the keys per row or None, causal)
    "flagship_cross_attention": (16, 10, 512, 1024, 128, None, True),
    "flagship_self_attention": (16, 10, 512, 512, 128, None, True),
    "clm_30m_cross_attention": (8, 8, 512, 2304, 64, [0, 0, 7, 100, 300, 511, 1024, 1790], True),
    "wide_192_padded_causal": (2, 2, 1024, 768, 192, [0, 300], True),
    "wide_256_padded_causal": (2, 2, 1024, 768, 256, [0, 300], True),
    # the default-dtype (float32) flow train step's decoder call: one patch
    # of 182,528 pixel queries over 2,048 latents, one head of 512, full mask
    "flow_decoder_cross_attention": (1, 1, 182_528, 2048, 512, None, False),
    "flow_self_attention": (6, 8, 2048, 2048, 64, None, False),  # each of its 24 self-attention layers
}
F32_GRAD_CLASS_SHAPES = ("flagship_cross_attention", "flow_decoder_cross_attention")
# the float32 backward's passes, by a fragment of each kernel's name
F32_BACKWARD_PASSES = {"flash_bwd_f32_delta_kernel": "delta", "flash_bwd_f32_split_kernel": "split",
                       "flash_bwd_f32_dkdv_kernel": "dkdv", "flash_bwd_f32_reduce_kernel": "reduce",
                       "flash_bwd_f32_dq_kernel": "dq"}


def f32_grad_class_check(name, got, want, q, k, v, pad, causal, do):
    """The float32-class check of a float32 backward's gradients ``got``
    (the plain float32 backward's are ``want``): each of dq, dk and dv within
    F32_CLASS_FACTOR x the plain float32 version's error against the plain
    backward in float64 (from its own float64 forward). Returns the record's
    fields."""
    o64, lse64 = fl._forward_plain(q.double(), k.double(), v.double(), pad, causal)
    ref = fl._backward_plain(q.double(), k.double(), v.double(), pad, causal, o64, lse64, do.double())
    del o64, lse64
    out = {}
    for key, x, y, r in zip(("dq", "dk", "dv"), got, want, ref):
        e_kernel, e_plain = (x.double() - r).abs().max().item(), (y.double() - r).abs().max().item()
        out[key] = dict(err_vs_float64=e_kernel, plain_f32_err_vs_float64=e_plain,
                        err_ratio=e_kernel / max(e_plain, 1e-30))
    del ref
    torch.cuda.empty_cache()
    if not all(r["err_ratio"] <= F32_CLASS_FACTOR for r in out.values()):
        raise AssertionError(f"f32 backward {name}: error vs float64 more than {F32_CLASS_FACTOR} x the plain float32 "
                             f"version's: {out}")
    return dict(grad_err_vs_float64=out, err_ratio_limit=F32_CLASS_FACTOR)


def check_f32_backward_kernel():
    """B1b in float32 (csrc/flash_backward_f32.cu: five products, each as
    three TF32 products on wgmma fed by TMA) at every float32 backward shape
    of the main paths: the flagship cross- and self-attention, the 30M
    cross-attention (left-padded), D 192 and 256 padded causal, the
    default-dtype flow train step's decoder call (one patch, full mask) and
    its self-attention. From the plain forward's (o, lse): dq, dk and dv
    within F32_ATOL of the plain backward, pad keys' dk and dv exact zeros,
    two runs the same bits; at F32_GRAD_CLASS_SHAPES the gradients'
    error from the float64 plain backward within F32_CLASS_FACTOR x the
    plain float32 version's. Times per call, L2 flushed: the kernel, the
    plain backward, the library's backward from a saved forward
    (F.scaled_dot_product_attention with the same boolean mask, a yardstick
    used nowhere in the port; its CUDA kernels named, or its error), the
    bound at 165 TFLOP/s (three TF32 products) and at the CUDA cores' 67,
    and at the flow decoder and the flagship cross-attention each pass's
    device ms. Only ops/flash.py's _launch_backward, _forward_plain and
    _backward_plain are called, so a checkout of another tree's package can
    be read by the same checks."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 15)
    records = []
    for name, (b, h, nq, nk, d, pads, causal) in F32_BACKWARD_SHAPES.items():
        q, k, v, pad, do = flash_case(b, h, nq, nk, d, pads, torch.float32, g)
        o, lse = fl._forward_plain(q, k, v, pad, causal)
        want = fl._backward_plain(q, k, v, pad, causal, o, lse, do)
        first = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
        second = fl._launch_backward(q, k, v, pad, causal, o, lse, do)
        torch.cuda.synchronize()
        errs = {key: (x - y).abs().max().item() for key, x, y in zip(("dq", "dk", "dv"), first, want)}
        if not max(errs.values()) <= F32_ATOL:
            raise AssertionError(f"f32 backward {name}: kernel vs plain max error {errs} (atol {F32_ATOL})")
        if pad is not None:
            at = pad[:, None, :, None].expand_as(first[1])
            if not ((first[1][at] == 0).all() and (first[2][at] == 0).all()):
                raise AssertionError(f"f32 backward {name}: pad keys' dK or dV are not exact zeros")
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"f32 backward {name}: two runs on the same inputs differ")
        rec = dict(kernel="splash_mha_backward", shape=name, dtype="float32", batch=b, heads=h, queries=nq, keys=nk,
                   head_dim=d, causal=causal, max_abs_err=errs, limit=F32_ATOL, backward_bit_identical=True,
                   pad_grads_exact_zero=pad is not None)
        if name in F32_GRAD_CLASS_SHAPES:
            rec.update(f32_grad_class_check(name, first, want, q, k, v, pad, causal, do))
        del first, second, want
        torch.cuda.empty_cache()
        if causal or pad is not None:
            bounds, pairs = flash_bounds(q, k, pad, 4)
            bound, bound_by = bounds["backward"]
        else:
            pairs = b * h * nq * nk
            bound, bound_by = full_mask_bound(b, h, nq, nk, d, 4, backward=True)
        flow = nq > 100_000
        call = lambda: fl._launch_backward(q, k, v, pad, causal, o, lse, do)
        rec.update(visible_pairs=pairs, bound_ms=bound, bound_by=bound_by,
                   bound_ms_cuda_cores=cuda_core_bound_ms(bound, 10 * d * pairs),
                   ms=time_ms(call, reps=10 if flow else 25),
                   plain_ms=time_ms(lambda: fl._backward_plain(q, k, v, pad, causal, o, lse, do), reps=3 if flow else 10))
        if name in F32_GRAD_CLASS_SHAPES:
            rec["ms_by_pass"] = wide_backward_pass_ms(call, passes=F32_BACKWARD_PASSES)
        mask = fl._visibility(nq, nk, pad, causal, q.device).contiguous() if causal or pad is not None else None
        try:
            lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask, scale=1.0)
            lib_backward = lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)
            rec.update(library_ms=time_ms(lib_backward, reps=5 if flow else 25),
                       library_note="backward from a saved forward",
                       library_kernels=cuda_kernel_names(lib_backward, top=4))
            del lib_out, lib_leaves
        except RuntimeError as err:  # no backend of F.scaled_dot_product_attention takes this shape
            rec.update(library_ms=None, library_error=str(err)[:300])
        emit(phase="kernel_check", **rec)
        records.append(rec)
        del q, k, v, do, o, lse, mask
        torch.cuda.empty_cache()
    return records


# --------------------------------------------- phase 3: ring-block kernel
RING_BLOCK_SHAPES = {  # name: (batch, heads, queries, keys, head dim, leading padding keys per row or None)
    # clm_8k's cross-attention at {"seq": 4}: 256 latents over 1,152 of the
    # 4,608 keys the gather keeps; row 2's block is all padding
    "clm_8k_cross_block": (4, 8, 256, 1152, 64, [0, 300, 1152, 17]),
    "clm_8k_self_block": (4, 8, 256, 256, 64, None),  # its self-attention at {"seq": 4}
    "flagship_seq2_block": (16, 10, 256, 512, 128, None),  # the 455M flagship's cross-attention at {"seq": 2}
    # a ring block at a wide head (csrc/flash_forward_wide.cu, two-term P):
    # clm_8k's cross-attention block with 256-channel heads; row 2 all padding
    "wide_256_block": (4, 4, 256, 1152, 256, [0, 300, 1152, 17]),
}


def ring_block_bound(q, k, pad, esize):
    """Least time (ms, bound_by) of one ring block for these inputs: 4 D
    flops a visible (query, key) pair (every non-padding key of the row)
    over the dense peak of the input type, against the bytes moved once: q,
    the k and v of the non-padding keys (a padding key's are never needed)
    and the pad flags in, the float32 output and log-sum-exp out."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    keys = b * nk - (0 if pad is None else int(pad.sum().item()))
    pairs = keys * nq * h
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    nbytes = (b * h * nq * d + 2 * h * keys * d) * esize + (0 if pad is None else b * nk) + b * h * nq * (d + 1) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 4 * d * pairs / peak * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), pairs


def check_ring_block_kernel():
    """B5 (``ring_block_forward``: B1a's entry with no causal mask) against
    its plain version at the ring's block shapes, float32 and bfloat16: the
    float32 output and log-sum-exp within F32_ATOL for both input types (both
    sides sum in float32 from the same inputs and round nothing to
    bfloat16, so no bfloat16 allowance applies); a row whose keys are
    all padding must give exact zeros and lse = -inf. Times per launch; the
    library yardstick is F.scaled_dot_product_attention with the same key
    mask, which returns the output only (no log-sum-exp) and NaN for an
    all-padding row."""
    g = torch.Generator(DEVICE).manual_seed(SEED + 9)
    records = []
    for name, (b, h, nq, nk, d, pads) in RING_BLOCK_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn(b, h, nq, d, generator=g, device=DEVICE) * d**-0.5).to(dtype)
            k, v = (torch.randn(b, h, nk, d, generator=g, device=DEVICE).to(dtype) for _ in range(2))
            pad = None if pads is None else (torch.arange(nk, device=DEVICE)[None, :]
                                             < torch.tensor(pads, device=DEVICE)[:, None])
            o, lse = fl.ring_block_forward(q, k, v, pad)
            want_o, want_lse = fl._forward_plain(q, k, v, pad, False)
            torch.cuda.synchronize()
            errs, limits = {}, {}
            for key, x, y in (("o", o, want_o), ("lse", lse, want_lse)):
                finite = torch.isfinite(y)
                if not torch.equal(torch.isfinite(x), finite):
                    raise AssertionError(f"ring block {name} {dtype} {key}: finite entries differ from the plain "
                                         "version")
                atol, rtol = F32_ATOL, 0.0
                diff = (x[finite] - y[finite]).abs()
                errs[key], limits[key] = diff.max().item(), (atol, rtol)
                if not (diff <= atol + rtol * y[finite].abs()).all():
                    raise AssertionError(f"ring block {name} {dtype} {key}: kernel vs plain max error {errs[key]} "
                                         f"(atol {atol}, rtol {rtol})")
            blind = torch.zeros(b, dtype=torch.bool, device=DEVICE) if pad is None else pad.all(1)
            if not ((o[blind] == 0).all() and torch.isneginf(lse[blind]).all()):
                raise AssertionError(f"ring block {name} {dtype}: an all-padding row is not exact zeros and -inf")
            mask = None if pad is None else ~pad[:, None, None, :]
            (bound, bound_by), pairs = ring_block_bound(q, k, pad, torch.finfo(dtype).bits // 8)
            rec = dict(kernel="ring_block_forward", shape=name, dtype=str(dtype).removeprefix("torch."), batch=b,
                       heads=h, queries=nq, keys=nk, head_dim=d, all_padding_rows=int(blind.sum()),
                       visible_pairs=pairs, max_abs_err=errs, limits=limits,
                       ms=time_ms(lambda: fl.ring_block_forward(q, k, v, pad)),
                       plain_ms=time_ms(lambda: fl._forward_plain(q, k, v, pad, False)),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)),
                       library_returns="output only, no log-sum-exp", bound_ms=bound, bound_by=bound_by)
            if dtype == torch.float32:
                rec["bound_ms_cuda_cores"] = cuda_core_bound_ms(bound, 4 * d * pairs)
            emit(phase="kernel_check", **rec)
            records.append(rec)
            del q, k, v, o, lse, want_o, want_lse
            torch.cuda.empty_cache()
    return records


# ----------------------------------------------------- phase 4: main path
def stamp_after(fn, stamps):
    """``fn``, made to synchronise the card and append the host clock when it
    returns: wrapped around the model's prefill, it splits a generate() call
    into its prefill and its decode loop."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    return wrapped


def drive(model, stamps, ids, num_latents, max_new, pad_mask=None, **cfg):
    """One generate() call with the launch counter read around it; returns
    the tokens, the stats, the counted launches, the decode iterations it must
    have made, and the seconds of its prefill and of its decode loop."""
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    t0 = time.perf_counter()
    tokens, stats = generate(model, ids, num_latents=num_latents, pad_mask=pad_mask, max_new_tokens=max_new,
                             return_stats=True, **cfg)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dk.launches
    if cfg.get("decode_chunk", 1) > 1:
        iterations = stats["chunk_iterations"] + max(stats["tail_steps"] - 1, 0)
    else:
        iterations = max_new - 1  # the step after the last token is never run
    return tokens, stats, launches, iterations, stamps[-1] - t0, t_end - stamps[-1]


def spread(values):
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def main_path():
    cfg = flagship_455m_config()
    layers = cfg.num_self_attention_layers
    model = CausalSequenceModel(cfg, device="cuda", dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    stamps = []
    model.prefill_with_hidden = stamp_after(model.prefill_with_hidden, stamps)
    g = torch.Generator("cuda").manual_seed(SEED + 1)
    batch = 8
    prompt = lambda n: torch.randint(1, cfg.vocab_size, (batch, n), generator=g, device="cuda")
    generate(model, prompt(64), num_latents=8, max_new_tokens=4)  # warm-up: cuBLAS handles, the kernel library

    ids768, ids1024 = prompt(768), prompt(1024)
    pads = torch.tensor([0, 17, 100, 300, 511, 0, 5, 64], device="cuda")
    pad_mask = torch.arange(768, device="cuda")[None, :] < pads[:, None]
    padded = ids768.masked_fill(pad_mask, 0)
    runs = [
        ("greedy", ids768, 256, 128, None, {}),
        ("rolling_window", ids1024, 512, 32, None, {}),
        ("chunked", ids768, 256, 128, None, {"decode_chunk": 8}),
        ("left_padded", padded, 256, 32, pad_mask, {}),
    ]
    total_launches, outputs = 0, {}
    for name, ids, num_latents, max_new, pm, extra in runs:
        prefill_ms, ms_per_iteration, tokens_per_s, news = [], [], [], []
        for _ in range(REPEATS):
            tokens, stats, launches, iterations, prefill_s, decode_s = drive(
                model, stamps, ids, num_latents, max_new, pm, **extra)
            expected = (1 + layers) * iterations
            if launches != expected:
                raise AssertionError(f"{name}: {launches} decode-kernel launches, expected (1 + {layers}) x {iterations}")
            new = tokens[:, ids.shape[1]:]
            if tokens.shape != (batch, ids.shape[1] + max_new) or not torch.equal(tokens[:, : ids.shape[1]], ids):
                raise AssertionError(f"{name}: output shape {tuple(tokens.shape)} or prompt not preserved")
            if not ((new >= 0) & (new < cfg.vocab_size)).all():
                raise AssertionError(f"{name}: token ids outside the vocabulary")
            total_launches += launches
            news.append(new)
            prefill_ms.append(prefill_s * 1e3)
            ms_per_iteration.append(decode_s * 1e3 / iterations)
            tokens_per_s.append(batch * (max_new - 1) / decode_s)
        emit(phase="main_path", run=name, batch=batch, prompt=ids.shape[1], num_latents=num_latents,
             new_tokens=max_new, decode_iterations=iterations, launches_per_call=launches,
             expected_launches=expected, stats=stats, repeats=REPEATS,
             tokens_identical_across_repeats=all(torch.equal(n, news[0]) for n in news),
             prefill_ms=spread(prefill_ms), ms_per_decode_iteration=spread(ms_per_iteration),
             decode_tokens_per_s=spread(tokens_per_s))
        outputs[name] = news[0]
    agree = (outputs["chunked"] == outputs["greedy"]).float().mean().item()
    emit(phase="main_path", check="chunked_vs_greedy_token_agreement_bf16", agreement=agree)
    del model
    torch.cuda.empty_cache()
    return total_launches


# -------------------------------------------------------- phase 5: serving
CHAT = dict(kv_page_size=128, prefill_chunk_tokens=256, prefix_cache=True, max_prefill_slots=2)
SERVING_MODES = {  # name: (the engine's options, the cross-attention kernel's module)
    "dense": ({}, dk),
    "paged_fp": (dict(kv_page_size=128), pk),
    "paged_int8": (dict(kv_page_size=128, kv_quant="int8"), pk),
    "paged_int4": (dict(kv_page_size=128, kv_quant="int4"), rk),
    "paged_chunked_prefix": (CHAT, pk),
}


def _sampling(i):
    """Even requests greedy, odd ones sampled at temperature 0.8 and top-k 50."""
    return dict(do_sample=bool(i % 2), temperature=0.8 if i % 2 else 1.0, top_k=50 if i % 2 else None)


def request_stream(cfg, n=32):
    """The fixed, seeded stream: prompts of 64-1024 tokens (so both admission
    paths run: shorter than 512 latents, the bucket prefill; longer, the
    split path), 16-128 new tokens, half of them sampled with their own
    seeds."""
    rs = np.random.RandomState(SEED + 4)
    stream = []
    for i in range(n):
        prompt = rs.randint(1, cfg.vocab_size, rs.randint(64, 1025)).tolist()
        config = GenerationConfig(max_new_tokens=int(rs.randint(16, 129)), **_sampling(i))
        stream.append((prompt, config, SEED + i))
    return stream


def chat_stream(cfg, n=32):
    """Chat serving with shared system prompts: four 256-token system
    prefixes (two pages each), each request one of them and its own turn,
    768-896 tokens in all (so the shared pages lie below the latent
    boundary), 16-128 new tokens (prompt and budget within the window: no
    request wraps, so every one may share), half of them sampled."""
    rs = np.random.RandomState(SEED + 6)
    systems = [rs.randint(1, cfg.vocab_size, 256).tolist() for _ in range(4)]
    stream = []
    for i in range(n):
        turn = rs.randint(1, cfg.vocab_size, int(rs.randint(768, 897)) - 256).tolist()
        config = GenerationConfig(max_new_tokens=int(rs.randint(16, 129)), **_sampling(i))
        stream.append((systems[i % 4] + turn, config, SEED + i))
    return stream


def serve(model, mode, stream, num_slots=8, cuda_graph=True):
    """One engine run over ``stream``; returns the engine, the handles and the
    counters of the three kernels, zeroed just before the run."""
    engine = ServingEngine(model, num_slots=num_slots, cuda_graph=cuda_graph, **SERVING_MODES[mode][0])
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    handles = [engine.submit(p, config=c, seed=seed) for p, c, seed in stream]
    engine.run_until_drained()
    torch.cuda.synchronize()
    return engine, handles, {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches}


def graph_vs_eager(model, mode, stream):
    """The same stream through a graph engine and an eager one, ticked in
    turns: the first decoding tick's next logits (bf16: within 0.03 x the
    eager tensor's RMS, over the slots that decode) and every greedy token
    (identical). Returns the error and its limit, the greedy tokens, and
    each engine's mean ms a decoding tick."""
    engines = [ServingEngine(model, num_slots=8, cuda_graph=graph, **SERVING_MODES[mode][0]) for graph in (True, False)]
    handles = [[e.submit(p, config=c, seed=seed) for p, c, seed in stream] for e in engines]
    first = None
    work = [True, True]
    while any(work):
        work = [e.step() if w else False for e, w in zip(engines, work)]
        if first is None and engines[1].metrics.decode_steps:
            active = engines[1]._state.active
            got, want = (e._state.next_logits[active].float() for e in engines)
            first = ((got - want).abs().max().item(), BF16_RMS_FRACTION * want.pow(2).mean().sqrt().item())
    if engines[0].metrics.decode_steps != engines[1].metrics.decode_steps:
        raise AssertionError(f"serving {mode}: graph and eager engines ticked apart")
    greedy = [[h.result().tolist() for h in hs if not h.config.do_sample] for hs in handles]
    return first, greedy, [1e3 * e.metrics.snapshot()["decode_step_s"]["mean"] for e in engines]


def serving():
    cfg = flagship_455m_config()
    layers = cfg.num_self_attention_layers
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, param_dtype=torch.bfloat16, seed=SEED)
    totals = {"B2": 0, "B3": 0, "B4": 0}
    for mode, (options, ca_kernel) in SERVING_MODES.items():
        stream = chat_stream(cfg) if mode == "paged_chunked_prefix" else request_stream(cfg)
        serve(model, mode, stream[:3])  # warm-up: cuBLAS handles, the kernel libraries, the allocator
        runs, greedy = [], []
        for _ in range(REPEATS):
            engine, handles, counts = serve(model, mode, stream)
            snap = engine.metrics.snapshot()
            ticks = snap["decode_steps"]
            if engine.decode_compilations != 1 or engine.total_compilations != 1 or engine.graph_replays != ticks:
                raise AssertionError(f"serving {mode}: {engine.total_compilations} captures, {engine.graph_replays} "
                                     f"replays for {ticks} decode ticks (one capture, one replay a tick)")
            expected = {"B2": ticks * (layers + (ca_kernel is dk)), "B3": ticks * (ca_kernel is pk),
                        "B4": ticks * (ca_kernel is rk)}
            if counts != expected:
                raise AssertionError(f"serving {mode}: launches {counts}, expected {expected} for {ticks} ticks")
            if not all(h.ok and len(h.output_ids) == h.config.max_new_tokens for h in handles):
                raise AssertionError(f"serving {mode}: a request did not finish with its max_new_tokens")
            if not all(0 <= t < cfg.vocab_size for h in handles for t in h.output_ids):
                raise AssertionError(f"serving {mode}: token ids outside the vocabulary")
            for k in totals:
                totals[k] += counts[k]
            greedy.append([h.result().tolist() for h in handles if not h.config.do_sample])
            pool, cache, chunks = snap["page_pool"], snap["prefix_cache"], snap["chunked_prefill"]
            runs.append(dict(tokens_per_s=snap["decode_tokens_per_s"], ms_per_tick=1e3 * snap["decode_step_s"]["mean"],
                             ttft_p50_ms=1e3 * snap["ttft_s"]["p50"], ttft_p95_ms=1e3 * snap["ttft_s"]["p95"],
                             peak_pages=None if pool is None else pool["peak_pages_in_use"], ticks=ticks,
                             tokens=snap["tokens_generated"], replays=engine.graph_replays,
                             captures=engine.total_compilations,
                             dispatching_ticks=None if snap["ragged_tick"] is None else snap["ragged_tick"]["ticks"],
                             prefix_hits=None if cache is None else cache["hits"],
                             peak_shared_pages_in_use=None if cache is None else cache["peak_shared_pages_in_use"],
                             chunks=None if chunks is None else chunks["chunks_dispatched"]))
        identical = all(g == greedy[0] for g in greedy)
        (first_err, first_limit), (graph_greedy, eager_greedy), tick_ms = graph_vs_eager(model, mode, stream)
        emit(phase="serving", mode=mode, options=options, slots=8, requests=len(stream), repeats=REPEATS,
             launches_per_run=counts, launches_per_tick={k: v / runs[-1]["ticks"] for k, v in counts.items()},
             greedy_tokens_identical_across_repeats=identical,
             graph_vs_eager={"greedy_tokens_identical": graph_greedy == eager_greedy == greedy[0],
                             "first_tick_max_logit_err": first_err, "limit": first_limit,
                             "ms_per_tick_in_turns": {"graph": tick_ms[0], "eager": tick_ms[1]}},
             **{k: spread([r[k] for r in runs]) if runs[0][k] is not None else None
                for k in ("tokens_per_s", "ms_per_tick", "ttft_p50_ms", "ttft_p95_ms", "peak_pages", "ticks",
                          "replays", "captures", "dispatching_ticks", "prefix_hits", "peak_shared_pages_in_use",
                          "chunks")},
             tokens=runs[-1]["tokens"])
        if not identical:
            raise AssertionError(f"serving {mode}: greedy tokens differ between repeats")
        if not graph_greedy == eager_greedy == greedy[0] or not first_err <= first_limit:
            raise AssertionError(f"serving {mode}: the graph and eager engines disagree: greedy tokens identical "
                                 f"{graph_greedy == eager_greedy == greedy[0]}, first decoding tick's logits "
                                 f"{first_err} (limit {first_limit})")
        if mode == "paged_chunked_prefix" and not all(r["prefix_hits"] > 0 and r["chunks"] > 0 for r in runs):
            raise AssertionError(f"serving {mode}: no prefix hit or no chunk: {runs}")
    del model
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------- phase 6: optical-flow inference
FLOW_IMAGE = (436, 1024)  # a Sintel frame pair: a 2 x 3 grid of 368 x 496 patches


def optical_flow():
    """Perceiver IO inference at full width through OpticalFlowPipeline:
    official_41m_config() in bf16 over float32 parameters (random, from
    SEED) on a seeded synthetic 436 x 1024 frame pair, its six patches in one
    micro-batch, as bench.py:bench_optical_flow runs the JAX model. One
    warm-up, then REPEATS model forwards on the preprocessed patches (ms,
    synced) and REPEATS pipeline calls (preprocessing, forward, blending:
    frame pairs/s). Every count is zeroed just before and read just after;
    B1a must launch 24 times a forward at D = 64 and once at D = 512, and
    nothing else. Returns the B1a launches by width."""
    cfg = official_41m_config()
    layers = cfg.encoder.num_self_attention_layers_per_block
    model = OpticalFlow(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    frame1, frame2, _ = make_flow_pair(np.random.default_rng(SEED), FLOW_IMAGE)
    pipe = OpticalFlowPipeline(model, micro_batch_size=6)
    patches = len(pipe.processor.compute_patch_grid_indices(FLOW_IMAGE))
    x = torch.from_numpy(pipe.processor.preprocess((frame1, frame2))).to(DEVICE)
    pipe([(frame1, frame2)])  # warm-up: cuBLAS handles, the kernel libraries, the Fourier table's cast
    torch.cuda.synchronize()
    zero_counts()
    fl.forward_launches_by_width.clear()
    torch.cuda.reset_peak_memory_stats()
    forward_ms, pipeline_s = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        flow = pipe([(frame1, frame2)])
        pipeline_s.append(time.perf_counter() - t0)
    counts = dict(fl.forward_launches_by_width)
    others = {"B1b": fl.backward_launches, "B5": fl.block_launches, "B2-B4": dk.launches + pk.launches + rk.launches}
    forwards = 2 * REPEATS
    expected = {64: layers * forwards, 512: forwards}
    emit(phase="optical_flow", model="official_41m_config", dtype="bfloat16 compute, float32 params",
         image=FLOW_IMAGE, patches=patches, micro_batch_size=6, forwards=forwards,
         forward_ms=spread(forward_ms), frame_pairs_per_s=spread([1 / t for t in pipeline_s]),
         pipeline_s=spread(pipeline_s), max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
         b1a_launches_by_head_dim=counts, expected_b1a_launches_by_head_dim=expected, other_launches=others,
         flow_shape=list(flow.shape[1:]), flow_finite=bool(np.isfinite(flow).all()),
         flow_rms=float(np.sqrt(np.mean(flow**2))))
    if counts != expected or any(others.values()):
        raise AssertionError(f"optical flow: B1a launches {counts}, expected {expected}; others {others}")
    if flow.shape != (1, *FLOW_IMAGE, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"optical flow: flow of shape {flow.shape}, finite: {np.isfinite(flow).all()}")
    del model, pipe
    torch.cuda.empty_cache()
    return counts, optical_flow_default_dtype(cfg, x)


def optical_flow_default_dtype(cfg, x):
    """The same model at its default dtype (its parameters', float32; TF32
    off), one patch a call as OpticalFlowPipeline's default micro-batch of
    1: REPEATS passes over the pair's six preprocessed patches, each patch
    a synced forward (ms a pair, ms a patch). Every count is zeroed just
    before and read just after: B1a must run in float32 only, 24 times a
    patch at D = 64 and once at D = 512 (csrc/flash_forward_f32.cu), and
    nothing else launch; the flows finite. Returns B1a's float32
    launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers = cfg.encoder.num_self_attention_layers_per_block
    model = OpticalFlow(cfg, device=DEVICE, seed=SEED)
    patches = x.float()
    with torch.inference_mode():
        model(patches[:1])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    fl.forward_launches_by_width.clear()
    torch.cuda.reset_peak_memory_stats()
    pair_ms, finite = [], True
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for i in range(len(patches)):
            with torch.inference_mode():
                out = model(patches[i:i + 1])
            torch.cuda.synchronize()
            finite = finite and bool(torch.isfinite(out).all())
        pair_ms.append((time.perf_counter() - t0) * 1e3)
    calls = REPEATS * len(patches)
    counts = dict(fl.forward_launches_by_width)
    by_dtype = dict(fl.forward_launches_by_dtype)
    others = {"B1b": fl.backward_launches, "B5": fl.block_launches, "B2-B4": dk.launches + pk.launches + rk.launches}
    expected = {64: layers * calls, 512: calls}
    emit(phase="optical_flow", model="official_41m_config", dtype="float32 (the parameters' dtype, the default)",
         micro_batch_size=1, patches_per_pair=len(patches), forwards=calls, pair_ms=spread(pair_ms),
         patch_ms=spread([t / len(patches) for t in pair_ms]),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, b1a_launches_by_head_dim=counts,
         b1a_launches_by_dtype=by_dtype, expected_b1a_launches_by_head_dim=expected, other_launches=others,
         flow_finite=finite)
    if counts != expected or by_dtype != {"float32": sum(expected.values())} or any(others.values()) or not finite:
        raise AssertionError(f"optical flow in float32: B1a launches {counts} ({by_dtype}), expected {expected}; "
                             f"others {others}; finite {finite}")
    del model, patches
    torch.cuda.empty_cache()
    return by_dtype["float32"]


# ------------------------------------------------ phase 6: optical-flow training
FLOW_TRAIN_PATCHES = 2  # a micro-batch of two Sintel-sized 368 x 496 patches
FLOW_TRAIN_WARMUP, FLOW_TRAIN_STEPS = 3, 5
FLOW_SCALE = 20  # OpticalFlowProcessor's flow_scale_factor: the model learns flow / 20


def flow_train_batch(cfg, patches, seed):
    """``patches`` seeded make_flow_pair frame pairs of one patch each,
    preprocessed to 27-channel patches, and their flow (flow_patches)."""
    x, flow = flow_patches(np.random.default_rng(seed), cfg.encoder.image_shape, patches)
    return {"x": torch.from_numpy(x), "flow": torch.from_numpy(flow)}


def train_flow(dtype=torch.bfloat16, patches=FLOW_TRAIN_PATCHES):
    """The Perceiver IO optical-flow train step at full width and depth:
    official_41m_config() with activation checkpointing, float32 parameters
    (random, from SEED) in ``dtype`` compute (bf16, or float32: the model's
    default dtype, which runs B1a and B1b in float32), AdamW at 1e-3 with
    clipping at 1.0, on a micro-batch of ``patches`` 368 x 496 patches from
    make_flow_pair and the processor, through scripts/convergence.py's flow
    train step (the loss of the probe task, MSE against flow / 20).
    FLOW_TRAIN_WARMUP steps, then FLOW_TRAIN_STEPS timed steps on the same
    batch (each synced: ms a step, patches/s), the counts zeroed just before
    them and read just after: B1a and B1b by head width must be exact (the
    decoder's one head at D 512 once a step each; the self-attention layers
    at D 64, B1a twice a layer with checkpointing, B1b once), all in
    ``dtype``, and nothing else launched; the loss finite and lower after
    the timed steps than at the first. Returns the launches by kernel and
    width."""
    cfg = dataclasses.replace(official_41m_config(), activation_checkpointing=True)
    layers = cfg.encoder.num_self_attention_layers_per_block * cfg.encoder.num_self_attention_blocks
    model = OpticalFlow(cfg, device=DEVICE, dtype=None if dtype == torch.float32 else dtype, seed=SEED)
    batch = {k: v.to(DEVICE) for k, v in flow_train_batch(cfg, patches, SEED + 12).items()}
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_flow_train_step(model, tx, FLOW_SCALE)
    losses = []
    for _ in range(FLOW_TRAIN_WARMUP):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    fl.forward_launches_by_width.clear()
    fl.backward_launches_by_width.clear()
    ms = []
    for _ in range(FLOW_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # the step's one host read, which syncs it
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {"B1a": dict(fl.forward_launches_by_width), "B1b": dict(fl.backward_launches_by_width)}
    by_dtype = {"B1a": dict(fl.forward_launches_by_dtype), "B1b": dict(fl.backward_launches_by_dtype)}
    others = {"B5": fl.block_launches, "B2-B4": dk.launches + pk.launches + rk.launches}
    remat = 2 if cfg.activation_checkpointing else 1  # a checkpointed layer's forward runs again in the backward
    expected = {"B1a": {64: remat * layers * FLOW_TRAIN_STEPS, 512: FLOW_TRAIN_STEPS},
                "B1b": {64: layers * FLOW_TRAIN_STEPS, 512: FLOW_TRAIN_STEPS}}
    name = str(dtype).removeprefix("torch.")
    expected_by_dtype = {key: {name: sum(widths.values())} for key, widths in expected.items()}
    emit(phase="train_flow", model="official_41m_config", dtype=f"{name} compute, float32 params",
         activation_checkpointing=cfg.activation_checkpointing, patches=patches,
         image=list(cfg.encoder.image_shape), steps=FLOW_TRAIN_STEPS, ms_per_step=spread(ms),
         patches_per_s=spread([patches / (t / 1e3) for t in ms]),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, losses=losses,
         launches_by_head_dim=counts, expected_launches_by_head_dim=expected, launches_by_dtype=by_dtype,
         other_launches=others)
    if counts != expected or any(others.values()):
        raise AssertionError(f"flow train: launches {counts}, expected {expected}; others {others}")
    if dtype == torch.float32 and by_dtype != expected_by_dtype:
        raise AssertionError(f"flow train: launches by dtype {by_dtype}, expected {expected_by_dtype}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"flow train: the loss did not fall from {losses[0]}: {losses}")
    del model, state, step, batch
    torch.cuda.empty_cache()
    return counts


def card_vs_cpu_flow_train():
    """Optical-flow training in float32 (TF32 off) at official_41m_config's
    width with 2 self-attention layers and 128 latents on 16 x 16 patches,
    whose decoder head (512 channels, 256 pixel queries over 128 latents)
    and self-attention heads (64) pass the flash gate: the card's loss
    within 1e-5 relative of the port's CPU run, every gradient within 1e-3
    x its RMS, 3 AdamW steps' losses within 1e-4 relative; on the card B1b
    launched at D 64 and at D 512 (csrc/flash_backward_f32.cu).
    The key projections' biases, whose gradient the softmax cancels, are
    held to 1e-6 x the whole gradient's RMS on both sides instead."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = official_41m_config()
    shape = (16, 16)
    cfg = dataclasses.replace(
        full, num_latents=128,
        encoder=dataclasses.replace(full.encoder, image_shape=shape, num_self_attention_layers_per_block=2),
        decoder=dataclasses.replace(full.decoder, image_shape=shape))
    cpu = OpticalFlow(cfg, device="cpu", seed=SEED)
    gpu = OpticalFlow(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    batch = flow_train_batch(cfg, 2, SEED + 13)
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}

    def loss_and_grads(model, b):
        model.train()
        loss = torch.mean((model(b["x"]) - b["flow"] / FLOW_SCALE) ** 2)
        return loss, torch.autograd.grad(loss, trainable(model))

    l_cpu, g_cpu = loss_and_grads(cpu, batch)
    fl.backward_launches_by_width.clear()
    l_gpu, g_gpu = loss_and_grads(gpu, on(DEVICE))
    launches = dict(fl.backward_launches_by_width)
    loss_rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
    names = [n for n, p in cpu.named_parameters() if p.requires_grad]
    # a key projection's bias moves all of a query's scores by one amount,
    # which the softmax cancels: its gradient is zero in exact arithmetic
    # and float32 rounding noise on both sides, with no scale of its own;
    # it is held to 1e-6 x the RMS of the whole gradient on both sides
    scale = torch.cat([t.flatten() for t in g_cpu]).pow(2).mean().sqrt().item()
    cancelled = {n: max(a.abs().max().item(), b.abs().max().item()) / scale
                 for n, a, b in zip(names, g_gpu, g_cpu) if n.endswith("attention.k_proj.bias")}
    grad_ratio = {n: ((a.cpu() - b).abs().max() / b.pow(2).mean().sqrt().clamp_min(1e-30)).item()
                  for n, a, b in zip(names, g_gpu, g_cpu) if n not in cancelled}
    worst = max(grad_ratio, key=grad_ratio.get)
    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, DEVICE)):
        tx = build_optimizer(1e-3, max_grad_norm=1.0)
        state = TrainState.create(model, tx, seed=SEED)
        step = make_flow_train_step(model, tx, FLOW_SCALE)
        runs[name] = [float(step(state, on(dev))[1]["loss"]) for _ in range(3)]
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    emit(phase="card_vs_cpu", path="flow_train", layers=2, image=shape, latents=128, loss_rel_err=loss_rel,
         loss_rtol=1e-5, max_grad_err_over_rms=grad_ratio[worst], worst_grad=worst, grad_limit=1e-3,
         worst_grads=dict(sorted(grad_ratio.items(), key=lambda kv: -kv[1])[:4]),
         cancelled_grads_over_gradient_rms=cancelled, cancelled_limit=1e-6,
         step_losses=runs, step_loss_rel_err=step_rel, step_rtol=1e-4, b1b_launches_by_head_dim=launches)
    if not (loss_rel <= 1e-5 and grad_ratio[worst] <= 1e-3 and step_rel <= 1e-4
            and max(cancelled.values()) <= 1e-6):
        raise AssertionError(f"flow train card vs CPU: loss {loss_rel} (1e-5), gradient {worst} {grad_ratio[worst]} "
                             f"x RMS (1e-3), steps {step_rel} (1e-4), cancelled gradients {cancelled} (1e-6)")
    if launches != {64: 2, 512: 1}:
        raise AssertionError(f"flow train card vs CPU: B1b launches {launches}, expected {{64: 2, 512: 1}}")


FLOW_CONVERGENCE_STEPS = 600


def flow_convergence():
    """scripts/convergence.py's run_optical_flow_epe on the card, float32, at
    FLOW_CONVERGENCE_STEPS steps through Trainer.fit (the probe model: 32 x
    48 pairs, 128 latents of 64 channels, one 64-channel decoder head, so B1a
    and B1b at D 64), then the endpoint error through the whole pipeline on
    unseen 48 x 72 pairs: raises unless ``met`` (EPE < 0.5 x the zero-flow
    baseline). Returns the B1 launches of the run."""
    zero_counts()
    t0 = time.perf_counter()
    result = run_optical_flow_epe(FLOW_CONVERGENCE_STEPS, device=DEVICE, log_fn=lambda line: None)
    torch.cuda.synchronize()
    counts = flash_counts()
    by_dtype = {"B1a": dict(fl.forward_launches_by_dtype), "B1b": dict(fl.backward_launches_by_dtype)}
    emit(phase="flow_convergence", steps=FLOW_CONVERGENCE_STEPS, wall_s=time.perf_counter() - t0,
         **{k: v for k, v in result.items() if k != "history"}, val_epe_curve=[h["val_epe"] for h in result["history"]
                                                                             if "val_epe" in h], launches=counts,
         launches_by_dtype=by_dtype)
    if by_dtype != {"B1a": {"float32": counts["B1a"]}, "B1b": {"float32": counts["B1b"]}}:
        raise AssertionError(f"flow convergence: B1 ran other than float32: {by_dtype}")
    if not result["met"]:
        raise AssertionError(f"flow convergence: pipeline EPE {result['full_pipeline_epe_px']} is not under half the "
                             f"zero-flow baseline {result['zero_flow_baseline_epe_px']}")
    if not (counts["B1a"] and counts["B1b"]):
        raise AssertionError(f"flow convergence: B1 launches {counts}")
    return counts


# --------------------------------------------------- phase 6: card vs cpu
def card_vs_cpu():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_455m_config()
    cpu = CausalSequenceModel(cfg, device="cpu", param_dtype=torch.float32, seed=SEED)
    gpu = CausalSequenceModel(cfg, device="cuda", param_dtype=torch.float32, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(1, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(SEED + 2))
    max_err = 0.0
    with torch.no_grad():  # prefill (8 latents: decode attention) then 8 decode steps on the same tokens
        c_cpu, c_gpu = cpu.init_cache(1), gpu.init_cache(1)
        l_cpu, c_cpu = cpu.prefill(ids, 56, c_cpu)
        l_gpu, c_gpu = gpu.prefill(ids.cuda(), 56, c_gpu)
        for step in range(8):
            max_err = max(max_err, (l_gpu.cpu() - l_cpu).abs().max().item())
            tok = l_cpu[:, -1].argmax(-1, keepdim=True)
            l_cpu, c_cpu = cpu.decode_step(tok, c_cpu)
            l_gpu, c_gpu = gpu.decode_step(tok.cuda(), c_gpu)
        max_err = max(max_err, (l_gpu.cpu() - l_cpu).abs().max().item())
    t_cpu = generate(cpu, ids, num_latents=8, max_new_tokens=8)
    t_gpu = generate(gpu, ids.cuda(), num_latents=8, max_new_tokens=8).cpu()
    same = torch.equal(t_cpu, t_gpu)
    emit(phase="card_vs_cpu", max_logit_err=max_err, atol=1e-3, greedy_tokens_identical=same)
    if not max_err <= 1e-3 or not same:
        raise AssertionError(f"card vs CPU: logit error {max_err} (atol 1e-3), tokens identical: {same}")


def card_vs_cpu_flow():
    """OpticalFlow at official_41m_config's full width with 2 self-attention
    layers on a 64 x 96 image (6,144 pixel queries, which a splash tile
    divides, so the decoder's 512-channel head still takes B1a), in f32
    with TF32 off: the card's flow within 1e-3 x its RMS of the CPU's, and
    B1a launched on the card at D = 64 (twice) and D = 512 (once)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = official_41m_config()
    shape = (64, 96)
    cfg = dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, image_shape=shape, num_self_attention_layers_per_block=2),
        decoder=dataclasses.replace(full.decoder, image_shape=shape))
    cpu = OpticalFlow(cfg, device="cpu", seed=SEED)
    gpu = OpticalFlow(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(SEED + 3).standard_normal((1, 2, 27, *shape), dtype=np.float32))
    fl.forward_launches_by_width.clear()
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(DEVICE)).cpu()
    counts = dict(fl.forward_launches_by_width)
    rms = want.pow(2).mean().sqrt().item()
    err = (got - want).abs().max().item()
    emit(phase="card_vs_cpu", path="optical_flow", layers=2, image=shape, max_flow_err=err, flow_rms=rms,
         limit=1e-3 * rms, b1a_launches_by_head_dim=counts)
    if not err <= 1e-3 * rms or counts != {64: 2, 512: 1}:
        raise AssertionError(f"optical flow card vs CPU: error {err} (limit {1e-3 * rms}), B1a launches {counts}")


def _copy_device_state(src: ServingEngine, dst: ServingEngine) -> None:
    """Overwrite ``dst``'s pool, caches and next logits with ``src``'s (the
    two engines hold the same requests in the same slots)."""
    ca, dca = src._cache.ca, dst._cache.ca
    for name in ("kp", "vp", "page_table", "start", "k_scale", "v_scale"):
        if getattr(ca, name) is not None:
            getattr(dca, name).copy_(getattr(ca, name))
    for a, b in ((src._cache.sa.k, dst._cache.sa.k), (src._cache.sa.v, dst._cache.sa.v),
                 (src._cache.shift, dst._cache.shift), (src._cache.live, dst._cache.live),
                 (src._state.next_logits, dst._state.next_logits)):
        b.copy_(a)


def card_vs_cpu_serving():
    """The engine at flagship width with 2 layers in float32 (TF32 off), 4
    slots, page 128, the same 6 greedy requests on the card and on the CPU,
    in paged fp, int8 and int4 pools:
    - the two runs give identical tokens;
    - a decode tick from the same state (the card's pools, caches and logits
      after its first tick copied into a CPU engine) gives logits within
      1e-3 of the card's;
    - the first tick's logits of the two independent runs agree within 1e-3
      in fp and int8 pools. In int4 pools that number is printed, not held:
      the card and the CPU compute the keys and values in a different order,
      a few codes round the other way, and one int4 step is 1/7 of a head's
      largest value in the page."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", param_dtype=torch.float32, seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, param_dtype=torch.float32, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(SEED + 5)
    requests = [(rs.randint(1, cfg.vocab_size, n).tolist(), m)
                for n, m in ((100, 8), (600, 12), (1024, 6), (300, 10), (512, 9), (777, 7))]

    def engine(model, quant):
        e = ServingEngine(model, num_slots=4, kv_page_size=128, kv_quant=quant)
        return e, [e.submit(p, max_new_tokens=m) for p, m in requests]

    logits = lambda e: e._state.next_logits.float().cpu()
    for quant in (None, "int8", "int4"):
        (e_cpu, h_cpu), (e_gpu, h_gpu), (e_same, _) = engine(cpu, quant), engine(gpu, quant), engine(cpu, quant)
        for e in (e_cpu, e_gpu, e_same):
            e.step()
        first_err = (logits(e_gpu) - logits(e_cpu)).abs().max().item()
        _copy_device_state(e_gpu, e_same)
        e_gpu.step()
        e_same.step()
        same_state_err = (logits(e_gpu) - logits(e_same)).abs().max().item()
        e_cpu.run_until_drained()
        e_gpu.run_until_drained()
        tokens = [h.result().tolist() for h in h_gpu]
        same = tokens == [h.result().tolist() for h in h_cpu]
        held = quant != "int4"
        emit(phase="card_vs_cpu", path="serving", kv_quant=quant, first_tick_max_logit_err=first_err,
             first_tick_held=held, same_state_tick_max_logit_err=same_state_err, atol=1e-3, tokens_identical=same,
             tokens=sum(map(len, tokens)))
        if not same or not same_state_err <= 1e-3 or (held and not first_err <= 1e-3):
            raise AssertionError(f"serving card vs CPU ({quant}): tokens identical: {same}, logit error from the "
                                 f"same state {same_state_err}, first tick {first_err} (atol 1e-3)")


def card_vs_cpu_chunked():
    """The chunked and prefix path at flagship width with 2 layers in float32
    (TF32 off): one engine on the card (decode on its CUDA graph) and one on
    the CPU, 4 slots, page 128, chunks of 256, the prefix cache, 2 prompts
    in flight, ticked in turns over the same 8 greedy requests (two 256-token
    system prefixes, 768-896 tokens in all): identical tokens, the same
    prefix hits and chunks (both > 0), and after every tick the next logits
    of the slots that decode within 1e-3 of the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", param_dtype=torch.float32, seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, param_dtype=torch.float32, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(SEED + 7)
    systems = [rs.randint(1, cfg.vocab_size, 256).tolist() for _ in range(2)]
    requests = [(systems[i % 2] + rs.randint(1, cfg.vocab_size, int(rs.randint(768, 897)) - 256).tolist(),
                 int(rs.randint(6, 13))) for i in range(8)]
    engines = [ServingEngine(m, num_slots=4, **CHAT) for m in (gpu, cpu)]
    handles = [[e.submit(p, max_new_tokens=m) for p, m in requests] for e in engines]
    max_err, ticks, work = 0.0, 0, [True, True]
    while any(work):
        work = [e.step() for e in engines]
        if work[0] != work[1]:
            raise AssertionError("chunked card vs CPU: the engines ticked apart")
        active = engines[1]._state.active
        if active.any():
            err = (engines[0]._state.next_logits.cpu()[active] - engines[1]._state.next_logits[active]).abs().max()
            max_err = max(max_err, err.item())
        ticks += 1
    tokens = [[h.result().tolist() for h in hs] for hs in handles]
    snaps = [e.metrics.snapshot() for e in engines]
    hits = [s["prefix_cache"]["hits"] for s in snaps]
    chunks = [s["chunked_prefill"]["chunks_dispatched"] for s in snaps]
    same = tokens[0] == tokens[1]
    emit(phase="card_vs_cpu", path="serving_chunked_prefix", ticks=ticks, max_logit_err=max_err, atol=1e-3,
         tokens_identical=same, tokens=sum(map(len, tokens[0])), prefix_hits=hits, chunks=chunks,
         graph_replays=engines[0].graph_replays)
    if not same or not max_err <= 1e-3 or hits[0] != hits[1] or chunks[0] != chunks[1] or not (hits[0] and chunks[0]):
        raise AssertionError(f"chunked card vs CPU: tokens identical {same}, logit error {max_err} (atol 1e-3), "
                             f"prefix hits {hits}, chunks {chunks}")


# -------------------------------------------------------- phase 7: training
TRAIN_STEPS = 5  # steps per timed window; REPEATS windows, each ending in one host read of the loss


def flash_counts():
    return {"B1a": fl.forward_launches, "B1b": fl.backward_launches}


def train_flagship():
    """The 455M flagship at full width (20 layers, 1280 channels, sequence
    1024, 512 latents), bf16 compute over f32 parameters, batch 16, random
    ids from SEED with labels rolled by one; make_causal_lm_train_step with
    build_optimizer(1e-3, max_grad_norm=1.0) and the config's activation
    checkpointing (dots policy). 2 warm-up steps, then REPEATS windows of
    TRAIN_STEPS steps. The batch is fixed, so the loss must fall."""
    cfg = flagship_455m_config()
    layers = cfg.num_self_attention_layers
    batch = 16
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    g = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g, device=DEVICE)
    data = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
    first = None
    for _ in range(2):
        state, metrics = step(state, data)
        first = float(metrics["loss"]) if first is None else first

    flops = PerceiverARFlops(cfg, cfg.max_seq_len, cfg.cross_attention_dropout)
    peak = detect_peak_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fl.forward_launches = fl.backward_launches = dk.launches = pk.launches = rk.launches = 0
    ms_per_step, losses = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, metrics = step(state, data)
        losses.append(float(metrics["loss"]))  # the window's one host read; steps depend on each other
        ms_per_step.append((time.perf_counter() - t0) * 1e3 / TRAIN_STEPS)
    counts = flash_counts()
    steps = REPEATS * TRAIN_STEPS
    expected = {"B1a": (1 + layers) * steps + layers * steps, "B1b": (1 + layers) * steps}
    tokens_per_s = [flops.tokens_per_step(batch) / (ms / 1e3) for ms in ms_per_step]
    emit(phase="train", model="flagship_455m", layers=layers, batch=batch, dtype="bfloat16 compute, float32 params",
         remat_policy=cfg.remat_policy, steps=steps, launches=counts, expected_launches=expected,
         decode_kernel_launches=dk.launches + pk.launches + rk.launches,
         ms_per_step=spread(ms_per_step), latent_tokens_per_s=spread(tokens_per_s),
         mfu=None if peak is None else spread([flops.train_flops_per_step(batch) / (ms / 1e3) / peak
                                               for ms in ms_per_step]),
         peak_flops=peak, train_flops_per_step=flops.train_flops_per_step(batch),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, first_loss=first,
         window_losses=losses)
    if counts != expected:
        raise AssertionError(f"flagship train: launches {counts}, expected {expected} for {steps} steps")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < first:
        raise AssertionError(f"flagship train: the loss did not fall from {first}: {losses}")
    del model, state, step
    torch.cuda.empty_cache()
    return counts


def train_30m():
    """The 30M recipe (bench.py's clm_30m and the CLM script's defaults:
    sequence 4096, 512 latents, 512 channels, 8 heads of 64, 8 layers,
    cross-attention dropout 0.5 in gather mode, batch 8, bf16 compute; AdamW
    at 2e-4, cosine schedule with 200 warm-up updates, clipping at 0.5)
    through run_fit / Trainer.fit on the Markov data module: 10 steps and
    one eval. Returns the B1 launches of the run."""
    cfg = CausalSequenceModelConfig(vocab_size=262, max_seq_len=4096, max_latents=512, num_channels=512,
                                    num_heads=8, num_self_attention_layers=8, cross_attention_dropout=0.5,
                                    fused_qkv=True)
    data = SyntheticTextDataModule(seq_len=cfg.max_seq_len, batch_size=8, seed=SEED)
    data.setup()
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    max_steps = 10
    tx = build_tx(OptimizerFlags(lr=2e-4, warmup_steps=200, schedule="cosine", max_grad_norm=0.5), max_steps)
    flops = PerceiverARFlops(cfg, cfg.max_seq_len, cfg.cross_attention_dropout)
    trainer_cfg = TrainerConfig(max_steps=max_steps, log_every=5, eval_every=max_steps,
                                tokens_per_batch=flops.tokens_per_step(data.batch_size),
                                flops_per_step=flops.train_flops_per_step(data.batch_size),
                                peak_flops=detect_peak_flops())
    lines = []
    torch.cuda.synchronize()
    fl.forward_launches = fl.backward_launches = 0
    t0 = time.perf_counter()
    run_fit(trainer_cfg, TrainState.create(model, tx, seed=SEED),
            make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents), data,
            eval_step=make_causal_lm_eval_step(model, max_latents=cfg.max_latents),
            log_fn=lambda line: (lines.append(json.loads(line)), emit(phase="train_30m", **json.loads(line))))
    torch.cuda.synchronize()
    counts = flash_counts()
    layers = cfg.num_self_attention_layers
    eval_batches = len(data.val_dataloader())
    expected = {"B1a": (1 + layers) * (max_steps + eval_batches), "B1b": (1 + layers) * max_steps}
    val = [ln["val_loss"] for ln in lines if "val_loss" in ln]
    emit(phase="train_30m", steps=max_steps, seconds=time.perf_counter() - t0, launches=counts,
         expected_launches=expected, eval_batches=eval_batches, val_loss=val, entropy_floor=data.entropy_floor)
    if counts != expected:
        raise AssertionError(f"30M fit: launches {counts}, expected {expected}")
    if len(val) != 1 or not math.isfinite(val[0]):
        raise AssertionError(f"30M fit: eval loss {val}")
    del model
    torch.cuda.empty_cache()
    return counts


def card_vs_cpu_train():
    """The flagship at full width with 2 layers, float32 parameters and
    compute (TF32 off), batch 2, no dropout: the card's loss within 1e-5
    relative of the port's CPU run, every gradient within 1e-3 x its RMS,
    then 3 AdamW steps (1e-3, clipping at 1.0) whose losses agree to 1e-4
    relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=torch.Generator().manual_seed(SEED + 7))
    batch = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}
    prefix = cfg.max_seq_len - cfg.max_latents

    def loss_and_grads(model, b):
        model.train()
        loss = cross_entropy(model(b["input_ids"], prefix), b["labels"][:, prefix:])
        return loss, torch.autograd.grad(loss, trainable(model))

    l_cpu, g_cpu = loss_and_grads(cpu, batch)
    l_gpu, g_gpu = loss_and_grads(gpu, on(DEVICE))
    loss_rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
    names = [n for n, p in cpu.named_parameters() if p.requires_grad]
    grad_ratio = {n: ((a.cpu() - b).abs().max() / b.pow(2).mean().sqrt().clamp_min(1e-30)).item()
                  for n, a, b in zip(names, g_gpu, g_cpu)}
    worst = max(grad_ratio, key=grad_ratio.get)
    del g_cpu, g_gpu

    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, DEVICE)):
        tx = build_optimizer(1e-3, max_grad_norm=1.0)
        state = TrainState.create(model, tx, seed=SEED)
        step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
        runs[name] = [float(step(state, on(dev))[1]["loss"]) for _ in range(3)]
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    emit(phase="card_vs_cpu", path="train", layers=2, batch=2, loss_rel_err=loss_rel, loss_rtol=1e-5,
         max_grad_err_over_rms=grad_ratio[worst], worst_grad=worst, grad_limit=1e-3, step_losses=runs,
         step_loss_rel_err=step_rel, step_rtol=1e-4)
    if not (loss_rel <= 1e-5 and grad_ratio[worst] <= 1e-3 and step_rel <= 1e-4):
        raise AssertionError(f"train card vs CPU: loss {loss_rel} (1e-5), gradient {worst} {grad_ratio[worst]} "
                             f"x RMS (1e-3), steps {step_rel} (1e-4)")


# ------------------------------------- phase 6b: sequence-parallel training
SP_AXES = {"seq": 4}
BENCH_LR = 1e-3  # bench.py's learning rate for clm_8k
# at BENCH_LR the loss on this fixed batch rises after the third step, through
# the ring and through the plain path alike (sp_lr_check shows both), so the
# phase that must see the loss fall takes 3e-4
SP_LR = 3e-4
SP_CHECK_STEPS = 6
SP_CHECK_RTOL = 2e-2


def clm_8k_sp_config(layers: int = 8) -> CausalSequenceModelConfig:
    """clm_8k (bench.py's clm_8k_bench_config: the Perceiver AR paper's 8k
    regime on the 30M-class architecture) with ``sequence_parallel_axis="seq"``
    and ``layers`` self-attention layers."""
    return dataclasses.replace(clm_8k_config(), num_self_attention_layers=layers, sequence_parallel_axis="seq")


def card_mesh(device=None):
    """``SP_AXES`` with one device (the card) standing at every position."""
    return make_mesh(SP_AXES, devices=[torch.device(device or DEVICE)] * math.prod(SP_AXES.values()))


def ring_schedule(cfg: CausalSequenceModelConfig, batch_seq_len: int):
    """Per train step of ``cfg`` under ``SP_AXES``: the fully visible,
    diagonal and hidden (query position, key block) pairs of the
    cross-attention ring (latents over the kept prefix and the latents) and
    of one self-attention ring, and the B5 launches and forward einsum blocks
    a step makes: each visible pair is one launch, once for the
    cross-attention and twice for each self-attention layer (the dots policy
    recomputes it). Counted from the full right-aligned causal mask (query i
    of Nq sees keys 0..Nk - Nq + i), cut into the mesh's blocks, not from the
    ring's own classifier."""
    n_seq = SP_AXES["seq"]
    prefix = batch_seq_len - cfg.max_latents
    keys = prefix - int(prefix * cfg.cross_attention_dropout) + cfg.max_latents

    def kinds(nq, nk):
        seen = torch.arange(nk)[None, :] <= (nk - nq + torch.arange(nq))[:, None]
        blocks = seen.reshape(n_seq, nq // n_seq, n_seq, nk // n_seq).transpose(1, 2).flatten(2)
        whole, some = blocks.all(-1), blocks.any(-1)
        return dict(visible=int(whole.sum()), diagonal=int((some & ~whole).sum()), hidden=int((~some).sum()))

    cross, self_ = kinds(cfg.max_latents, keys), kinds(cfg.max_latents, cfg.max_latents)
    runs = 1 + (cfg.activation_checkpointing and cfg.remat_policy is not None)
    layers = cfg.num_self_attention_layers
    return dict(
        cross_keys=keys, cross_visible=cross["visible"], cross_diagonal=cross["diagonal"],
        self_visible=self_["visible"], self_diagonal=self_["diagonal"], self_hidden=self_["hidden"],
        self_attention_runs_per_layer=runs,
        b5_per_step=cross["visible"] + layers * runs * self_["visible"],
        diagonal_blocks_per_step=cross["diagonal"] + layers * runs * self_["diagonal"],
    )


def sp_counts():
    return {"B5": fl.block_launches, "B1a": fl.forward_launches, "B1b": fl.backward_launches}


def zero_counts():
    fl.forward_launches = fl.backward_launches = fl.block_launches = 0
    fl.forward_launches_by_dtype.clear()
    fl.backward_launches_by_dtype.clear()
    dk.launches = pk.launches = rk.launches = 0


def train_sp():
    """clm_8k at full width and depth with sequence_parallel_axis="seq"
    under a {"seq": 4} mesh of the one card: bf16 compute over f32
    parameters, batch 4 (bench.py's clm_8k batch), random ids from SEED with
    labels rolled by one, AdamW at SP_LR with clipping at 1.0. 2 warm-up steps,
    then REPEATS windows of TRAIN_STEPS steps; every attention runs as ring
    attention (B5 for the fully visible blocks, einsum for the diagonal
    ones, the backward ring in plain PyTorch), so B1 is never launched. The
    batch is fixed, so the loss must fall."""
    cfg = clm_8k_sp_config()
    batch = 4
    sched = ring_schedule(cfg, cfg.max_seq_len)
    model = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED)
    g = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g, device=DEVICE)
    data = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    tx = build_optimizer(SP_LR, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=SEED)
    step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
    flops = PerceiverARFlops(cfg, cfg.max_seq_len, cfg.cross_attention_dropout)
    peak = detect_peak_flops()
    with set_mesh(card_mesh()):
        first = None
        for _ in range(2):
            state, metrics = step(state, data)
            first = float(metrics["loss"]) if first is None else first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        ms_per_step, step_losses = [], []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                state, metrics = step(state, data)
                step_losses.append(metrics["loss"])
            float(metrics["loss"])  # the window's one host read; steps depend on each other
            ms_per_step.append((time.perf_counter() - t0) * 1e3 / TRAIN_STEPS)
        counts = sp_counts()
    steps = REPEATS * TRAIN_STEPS
    losses = [float(v) for v in step_losses]
    expected = {"B5": sched["b5_per_step"] * steps, "B1a": 0, "B1b": 0}
    tokens_per_s = [flops.tokens_per_step(batch) / (ms / 1e3) for ms in ms_per_step]
    emit(phase="train_sp", model="clm_8k", mesh=SP_AXES, devices="one card at every position", batch=batch,
         layers=cfg.num_self_attention_layers, dtype="bfloat16 compute, float32 params", remat_policy=cfg.remat_policy,
         lr=SP_LR, steps=steps, launches=counts, expected_launches=expected, schedule=sched,
         b5_launch_is="one (query position, fully visible key block) pair of one ring forward: per step "
                      f"{sched['cross_visible']} cross-attention + {cfg.num_self_attention_layers} layers x "
                      f"{sched['self_attention_runs_per_layer']} runs (forward and checkpoint recompute) x "
                      f"{sched['self_visible']} self-attention",
         ms_per_step=spread(ms_per_step), latent_tokens_per_s=spread(tokens_per_s),
         mfu=None if peak is None else spread([flops.train_flops_per_step(batch) / (ms / 1e3) / peak
                                               for ms in ms_per_step]),
         peak_flops=peak, train_flops_per_step=flops.train_flops_per_step(batch),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, first_loss=first, step_losses=losses)
    if counts != expected:
        raise AssertionError(f"clm_8k SP train: launches {counts}, expected {expected} for {steps} steps")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < first:
        raise AssertionError(f"clm_8k SP train: the loss did not fall from {first}: {losses}")
    del model, state, step
    torch.cuda.empty_cache()
    return counts


def sp_lr_check():
    """train_sp's model, batch and generator seed at full width and depth
    (bf16 compute over f32 parameters, batch 4), SP_CHECK_STEPS steps from
    the same weights and optimizer state through the ring under {"seq": 4}
    (B5 and einsum blocks) and through the same model without the seq axis
    (B1), at BENCH_LR and at SP_LR: the two paths' losses within
    SP_CHECK_RTOL relative at every step (bf16 rounds the two paths'
    attention apart, and Adam's steps carry that on), and both falling at
    SP_LR. All four trajectories are printed, so whether the loss rises at
    BENCH_LR is read for both paths."""
    cfg = clm_8k_sp_config()
    batch = 4
    g = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g, device=DEVICE)
    data = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    init = CausalSequenceModel(cfg, device=DEVICE, dtype=torch.bfloat16, seed=SEED).state_dict()
    runs, counts = {}, {}
    for lr in (BENCH_LR, SP_LR):
        for path, axis in (("ring", "seq"), ("plain", None)):
            model = CausalSequenceModel(dataclasses.replace(cfg, sequence_parallel_axis=axis), device=DEVICE,
                                        dtype=torch.bfloat16, seed=SEED + 99)
            model.load_state_dict(init)
            tx = build_optimizer(lr, max_grad_norm=1.0)
            state = TrainState.create(model, tx, seed=SEED)
            step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
            zero_counts()
            losses = []
            with set_mesh(card_mesh()) if axis else contextlib.nullcontext():
                for _ in range(SP_CHECK_STEPS):
                    state, metrics = step(state, data)
                    losses.append(metrics["loss"])
            runs[f"{path}@{lr:g}"] = [float(v) for v in losses]
            counts[f"{path}@{lr:g}"] = sp_counts()
            del model, state, step
    rel = {f"{lr:g}": max(abs(a - b) / abs(b) for a, b in zip(runs[f"ring@{lr:g}"], runs[f"plain@{lr:g}"]))
           for lr in (BENCH_LR, SP_LR)}
    emit(phase="sp_lr_check", model="clm_8k", mesh=SP_AXES, batch=batch, layers=cfg.num_self_attention_layers,
         dtype="bfloat16 compute, float32 params", steps=SP_CHECK_STEPS, step_losses=runs, launches=counts,
         max_step_loss_rel_err=rel, rtol=SP_CHECK_RTOL,
         rises_at_bench_lr={p: max(runs[f"{p}@{BENCH_LR:g}"][1:]) > runs[f"{p}@{BENCH_LR:g}"][0]
                            for p in ("ring", "plain")})
    torch.cuda.empty_cache()
    for key, c in counts.items():
        took_own = (c["B5"] and not c["B1a"]) if key.startswith("ring") else (c["B1a"] and not c["B5"])
        if not took_own:
            raise AssertionError(f"sp_lr_check: {key} took {c}")
    if not all(math.isfinite(v) for r in runs.values() for v in r) or max(rel.values()) > SP_CHECK_RTOL:
        raise AssertionError(f"sp_lr_check: ring vs plain losses differ by {rel} (rtol {SP_CHECK_RTOL}): {runs}")
    for p in ("ring", "plain"):
        r = runs[f"{p}@{SP_LR:g}"]
        if not r[-1] < r[0]:
            raise AssertionError(f"sp_lr_check: the {p} path's loss did not fall at {SP_LR}: {r}")


def _grad_ratios(model, got, want):
    """max |got - want| / RMS(want) per trainable parameter (name -> ratio)."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return {n: ((a.cpu() - b.cpu()).abs().max() / b.cpu().pow(2).mean().sqrt().clamp_min(1e-30)).item()
            for n, a, b in zip(names, got, want)}


def card_vs_card_sp():
    """clm_8k at full width and sequence with 2 layers, f32 (TF32 off),
    batch 2, training mode: the ring under {"seq": 4} (B5 and einsum blocks)
    against the same weights without the seq axis (B1), with the same
    generator seed (so the same prefix-dropout draws on the card): loss
    within 1e-5 relative, every gradient within 1e-3 x its RMS."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = clm_8k_sp_config(layers=2)
    sp = CausalSequenceModel(cfg, device=DEVICE, seed=SEED)
    plain = CausalSequenceModel(dataclasses.replace(cfg, sequence_parallel_axis=None), device=DEVICE, seed=SEED + 99)
    plain.load_state_dict(sp.state_dict())
    x = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=torch.Generator().manual_seed(SEED + 8))
    x, labels = x.to(DEVICE), torch.roll(x, -1, dims=1).to(DEVICE)
    prefix = cfg.max_seq_len - cfg.max_latents

    def loss_and_grads(model):
        model.train()
        zero_counts()
        loss = cross_entropy(model(x, prefix, generator=torch.Generator().manual_seed(SEED)), labels[:, prefix:])
        grads = torch.autograd.grad(loss, trainable(model))
        torch.cuda.synchronize()
        return loss.item(), grads, sp_counts()

    with set_mesh(card_mesh()):
        l_ring, g_ring, ring_counts = loss_and_grads(sp)
    l_plain, g_plain, plain_counts = loss_and_grads(plain)
    loss_rel = abs(l_ring - l_plain) / abs(l_plain)
    ratio = _grad_ratios(sp, g_ring, g_plain)
    worst = max(ratio, key=ratio.get)
    emit(phase="card_vs_card", path="train_sp", model="clm_8k", layers=2, batch=2, mesh=SP_AXES,
         ring_loss=l_ring, plain_loss=l_plain, loss_rel_err=loss_rel, loss_rtol=1e-5,
         max_grad_err_over_rms=ratio[worst], worst_grad=worst, grad_limit=1e-3, ring_launches=ring_counts,
         plain_launches=plain_counts)
    if not (ring_counts["B5"] and not ring_counts["B1a"] and plain_counts["B1a"] and not plain_counts["B5"]):
        raise AssertionError(f"card vs card: the ring took {ring_counts}, the plain model {plain_counts}")
    if not (loss_rel <= 1e-5 and ratio[worst] <= 1e-3):
        raise AssertionError(f"ring vs plain on the card: loss {loss_rel} (1e-5), gradient {worst} {ratio[worst]} "
                             "x RMS (1e-3)")


def card_vs_cpu_sp():
    """The clm_8k ring at full width and sequence with 2 layers, f32 (TF32
    off), batch 1, under {"seq": 4} on the card (the card at every position)
    and on the CPU (the CPU at every position): loss within 1e-5 relative,
    every gradient within 1e-3 x its RMS, 3 AdamW steps' losses within 1e-4
    relative (the limits of card_vs_cpu_train). Both sides take the prefix
    dropout's uniforms from a CPU generator with the seed of the model's
    (the card's generator draws other numbers from the same seed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = clm_8k_sp_config(layers=2)
    cpu = CausalSequenceModel(cfg, device="cpu", seed=SEED)
    gpu = CausalSequenceModel(cfg, device=DEVICE, seed=SEED + 99)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len), generator=torch.Generator().manual_seed(SEED + 10))
    batch = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}
    prefix = cfg.max_seq_len - cfg.max_latents
    meshes = {"cpu": make_mesh(SP_AXES, devices=["cpu"] * math.prod(SP_AXES.values())), "card": card_mesh()}
    real_draws = tpar.prefix_dropout_draws

    def cpu_draws(mode, rate, shape, generator, device):
        return real_draws(mode, rate, shape, torch.Generator().manual_seed(generator.initial_seed()), "cpu").to(device)

    def loss_and_grads(model, b):
        model.train()
        loss = cross_entropy(model(b["input_ids"], prefix, generator=torch.Generator().manual_seed(SEED)),
                             b["labels"][:, prefix:])
        return loss.item(), torch.autograd.grad(loss, trainable(model))

    tpar.prefix_dropout_draws = cpu_draws
    try:
        with set_mesh(meshes["cpu"]):
            l_cpu, g_cpu = loss_and_grads(cpu, batch)
        with set_mesh(meshes["card"]):
            l_gpu, g_gpu = loss_and_grads(gpu, on(DEVICE))
        ratio = _grad_ratios(cpu, g_gpu, g_cpu)
        del g_cpu, g_gpu
        runs = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, DEVICE)):
            tx = build_optimizer(1e-3, max_grad_norm=1.0)
            state = TrainState.create(model, tx, seed=SEED)
            step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
            with set_mesh(meshes[name]):
                runs[name] = [float(step(state, on(dev))[1]["loss"]) for _ in range(3)]
    finally:
        tpar.prefix_dropout_draws = real_draws
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = max(ratio, key=ratio.get)
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"]))
    emit(phase="card_vs_cpu", path="train_sp", model="clm_8k", layers=2, batch=1, mesh=SP_AXES,
         loss_rel_err=loss_rel, loss_rtol=1e-5, max_grad_err_over_rms=ratio[worst], worst_grad=worst,
         grad_limit=1e-3, step_losses=runs, step_loss_rel_err=step_rel, step_rtol=1e-4)
    if not (loss_rel <= 1e-5 and ratio[worst] <= 1e-3 and step_rel <= 1e-4):
        raise AssertionError(f"ring card vs CPU: loss {loss_rel} (1e-5), gradient {worst} {ratio[worst]} x RMS "
                             f"(1e-3), steps {step_rel} (1e-4)")


def wide_ptxas(source, lines):
    """The ptxas report of a wide flash source (flash_forward_wide or
    flash_backward_wide): registers and spill bytes of each kernel
    instantiation (its name, head width and, in the forward, P's terms), and
    the count of ptxas notes that it serialised wgmma (C7513/C7518/C7520),
    emitted as one line; a spill fails the run (an empty report: the library
    was already built, nothing to read)."""
    kernels, current = [], None
    for line in lines:
        found = re.search(r"(flash_(?:fwd|bwd)_[a-z0-9_]*kernel)(?:ILi(\d+)E)?(?:Lb([01])E)?", line)
        if "Compiling entry function" in line and found:
            current = dict(kernel=found.group(1))
            if found.group(2):
                current["head_dim"] = int(found.group(2))
            if found.group(3):
                current["split_p"] = found.group(3) == "1"
            kernels.append(current)
        elif current is not None and "spill stores" in line:
            current["spill_bytes"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif current is not None and "Used" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    serialised = [line for line in lines if "serialized" in line]
    emit(phase="build", source=f"perceiver_io_torch/csrc/{source}.cu", instantiations=kernels,
         wgmma_serialised=len(serialised))
    if any(k.get("spill_bytes", 0) for k in kernels):
        raise AssertionError(f"{source}.cu spills registers: {kernels}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    card = card_line()
    emit(phase="device", name=torch.cuda.get_device_name(0), capability=list(cap), count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card has compute capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain float32 versions stay float32 throughout
    torch.backends.cudnn.allow_tf32 = False

    built = cuda_build.build()
    for source, rec in built.items():
        emit(phase="build", source=f"perceiver_io_torch/csrc/{source}.cu", **rec)
    for source in ("flash_forward_wide", "flash_backward_wide", "flash_forward_f32", "flash_backward_f32"):
        wide_ptxas(source, built[source]["ptxas"])

    decode_results = check_decode_kernel()
    paged_results = check_paged_kernels()
    decode_host_times()
    flash_results = check_flash_kernel()
    ring_results = check_ring_block_kernel()
    flow_flash_results = check_flow_flash_kernel()
    wide_forward_results = check_wide_forward_kernel()
    wide_backward_results = check_wide_backward_kernel()
    f32_backward_results = check_f32_backward_kernel()
    launches = {"B2": main_path()}
    if launches["B2"] == 0:
        raise AssertionError("the generation path never launched B2")
    for k, v in serving().items():
        launches[k] = launches.get(k, 0) + v
    if not all(launches[k] for k in ("B2", "B3", "B4")):
        raise AssertionError(f"a kernel of the serving path was never launched: {launches}")
    for run in (train_flagship, train_30m):
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
    if not (launches["B1a"] and launches["B1b"]):
        raise AssertionError(f"a kernel of the training path was never launched: {launches}")
    launches["B5"] = train_sp()["B5"]
    if not launches["B5"]:
        raise AssertionError("the sequence-parallel training path never launched B5")
    flow_launches, flow_f32_launches = optical_flow()
    if not (flow_launches.get(64) and flow_launches.get(512)):
        raise AssertionError(f"the optical-flow path did not launch B1a at D = 64 and D = 512: {flow_launches}")
    flow_train_launches = train_flow()
    if not all(flow_train_launches[k].get(d) for k in ("B1a", "B1b") for d in (64, 512)):
        raise AssertionError(f"the flow training path did not launch B1a and B1b at D = 64 and 512: "
                             f"{flow_train_launches}")
    for key in ("B1a", "B1b"):
        launches[key] += flow_train_launches[key][64]
    flow_train_f32_launches = train_flow(torch.float32, patches=1)  # the model's default dtype, one patch
    if not all(flow_train_f32_launches[k].get(d) for k in ("B1a", "B1b") for d in (64, 512)):
        raise AssertionError(f"the float32 flow training path did not launch B1a and B1b at D = 64 and 512: "
                             f"{flow_train_f32_launches}")
    card_vs_cpu()
    card_vs_cpu_serving()
    card_vs_cpu_chunked()
    card_vs_cpu_train()
    sp_lr_check()
    card_vs_card_sp()
    card_vs_cpu_sp()
    card_vs_cpu_flow()
    card_vs_cpu_flow_train()
    convergence_launches = flow_convergence()

    head = decode_results[("flagship_cross_attention", "bfloat16", 1)]
    kernels = [dict(
        name="fused_decode_attention", route="cuda", source="perceiver_io_torch/csrc/decode_attention.cu",
        replaces="perceiver_io_tpu/ops/decode_kernel.py:251", launches=launches["B2"],
        max_abs_err=max(r["max_abs_err"] for r in decode_results.values()), ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
    )]
    for key, kernel, pool, replaces in (
            ("B3", "fused_paged_decode_attention", "bf16", "perceiver_io_tpu/ops/paged_decode_kernel.py:608"),
            ("B4", "fused_ragged_paged_attention", "int4", "perceiver_io_tpu/ops/ragged_paged_kernel.py:231")):
        mine = [r for r in paged_results if r["kernel"] == kernel]
        head = next(r for r in mine if r["shape"] == "flagship_cross_attention" and r["pool"] == pool)
        kernels.append(dict(
            name=kernel, route="cuda", source="perceiver_io_torch/csrc/paged_attention.cu", replaces=replaces,
            launches=launches[key], max_abs_err=max(r["max_abs_err"] for r in mine), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
        ))
    head = next(r for r in flash_results if r["shape"] == "flagship_cross_attention" and r["dtype"] == "bfloat16")
    for key, name, err_keys, prefix, source in (
            ("B1a", "splash_mha_forward", ("o",), "", "flash_forward_mma.cu"),
            ("B1b", "splash_mha_backward", ("dq", "dk", "dv"), "backward_", "flash_backward_mma.cu")):
        kernels.append(dict(
            name=name, route="cuda", source=f"perceiver_io_torch/csrc/{source}",
            replaces="perceiver_io_tpu/ops/flash.py:164", launches=launches[key],
            max_abs_err=max(r["max_abs_err"][e] for r in flash_results for e in err_keys),
            ms=head["ms" if not prefix else "backward_ms"], plain_ms=head[f"plain_{prefix}ms"],
            bound_ms=head[f"{prefix}bound_ms"], bound_by=head[f"{prefix}bound_by"],
            library_ms=head[f"library_{prefix}ms"],
        ))
    head = next(r for r in ring_results if r["shape"] == "clm_8k_cross_block" and r["dtype"] == "bfloat16")
    kernels.append(dict(
        name="ring_block_forward", route="cuda", source="perceiver_io_torch/csrc/flash_forward_mma.cu",
        replaces="perceiver_io_tpu/parallel/ring_attention.py:102", launches=launches["B5"],
        max_abs_err=max(e for r in ring_results for e in r["max_abs_err"].values()), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
    ))
    for shape, d, name, source in (
            ("flow_decoder_cross_attention", 512, "splash_mha_forward_wide_flow_decoder", "flash_forward_wide.cu"),
            ("flow_self_attention", 64, "splash_mha_forward_flow_self_attention", "flash_forward_mma.cu")):
        mine = [r for r in flow_flash_results if r["shape"] == shape]
        head = next(r for r in mine if r["dtype"] == "bfloat16")
        errs = [r["max_abs_err"] for r in mine]
        if d == 512:  # the wide kernel's other checks: the train step's call, D 192 and 256
            errs += [e for r in wide_forward_results for e in r["max_abs_err"].values()]
        kernels.append(dict(
            name=name, route="cuda", source=f"perceiver_io_torch/csrc/{source}",
            replaces="perceiver_io_tpu/ops/flash.py:164", launches=flow_launches[d],
            max_abs_err=max(errs), ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
        ))
    head = next(r for r in wide_backward_results if r["shape"] == "flow_decoder_cross_attention")
    kernels.append(dict(
        name="splash_mha_backward_wide_flow_decoder", route="cuda",
        source="perceiver_io_torch/csrc/flash_backward_wide.cu",
        replaces="perceiver_io_tpu/ops/flash.py:164", launches=flow_train_launches["B1b"][512],
        max_abs_err=max(e for r in wide_backward_results for e in r["max_abs_err"].values()), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
    ))
    # float32: the forward (B1a and B5) on the default-dtype flow path and the
    # float32 epe task, the backward on the epe task; times at the flow
    # decoder's patch and (backward) the flagship cross-attention
    head = next(r for r in flow_flash_results
                if r["shape"] == "flow_decoder_cross_attention" and r["dtype"] == "float32")
    f32_forward_errs = [r["max_abs_err"]["o"] for r in flash_results if r["dtype"] == "float32"]
    f32_forward_errs += [r["max_abs_err"] for r in flow_flash_results if r["dtype"] == "float32"]
    f32_forward_errs += [e for r in ring_results if r["dtype"] == "float32" for e in r["max_abs_err"].values()]
    f32_forward_errs += [e for r in wide_backward_results for e in r.get("forward_max_abs_err", {}).values()]
    kernels.append(dict(
        name="splash_mha_forward_f32", route="cuda", source="perceiver_io_torch/csrc/flash_forward_f32.cu",
        replaces="perceiver_io_tpu/ops/flash.py:164", launches=flow_f32_launches + convergence_launches["B1a"],
        max_abs_err=max(f32_forward_errs), ms=head["ms_checked_batch"], plain_ms=head["plain_ms_checked_batch"],
        bound_ms=head["bound_ms_checked_batch"], bound_by=head["bound_by_checked_batch"],
        library_ms=head["library_ms_checked_batch"],
    ))
    # the float32 backward on the float32 flow train step and the epe task;
    # times at the flagship cross-attention
    head = next(r for r in f32_backward_results if r["shape"] == "flagship_cross_attention")
    f32_backward = [r for r in flash_results + wide_backward_results + f32_backward_results
                    if r["dtype"] == "float32"]
    kernels.append(dict(
        name="splash_mha_backward_f32", route="cuda", source="perceiver_io_torch/csrc/flash_backward_f32.cu",
        replaces="perceiver_io_tpu/ops/flash.py:164",
        launches=convergence_launches["B1b"] + sum(flow_train_f32_launches["B1b"].values()),
        max_abs_err=max(r["max_abs_err"][e] for r in f32_backward for e in ("dq", "dk", "dv")),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"],
    ))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
