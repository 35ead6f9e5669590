"""Cached-decode attention: n_q <= 8 queries over a dense, left-aligned,
unrotated KV cache, with RoPE applied to the keys in-stream.

Port of ``perceiver_io_tpu/ops/decode_kernel.py:fused_decode_attention``. On a
CUDA tensor the wrapper launches the hand-written Hopper kernel
(``perceiver_io_torch/csrc/decode_attention.cu``, whose header says what
bounds it and how it is built) or raises; on a CPU tensor it computes the
plain PyTorch version, ``fused_decode_attention_reference``, which is also
what the kernel is held against on the card. There is no other fallback.

The TPU kernel's block-diagonal query matrix, rotate-half matmul and head
expander worked around Mosaic lowering limits and are not part of the
function; neither is its capacity tiling gate (the CUDA kernel masks its own
ragged edge).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from perceiver_io_torch.ops.position import apply_rope

MAX_QUERIES = 8
MAX_HEAD_DIM = 256

# Split-K schedule of the decode-attention kernels (B2 here, B3/B4 in
# paged_decode_kernel.py): each (row, head) is cut into up to S splits, one
# block each. B2's S asks for about SPLIT_BLOCKS_PER_SM blocks on every SM
# (more ran slower on the H100 at the flagship shapes), for at least one split
# per MAX_SPLIT_SLOTS slots, and gives each split at least MIN_SPLIT_SLOTS
# slots where the row has them.
SPLIT_BLOCKS_PER_SM = 2
MIN_SPLIT_SLOTS = 64
MAX_SPLIT_SLOTS = 512

# Kernel launches since import (or since the caller last reset it to 0). Only
# ``_launch`` adds to it, once per launch.
launches = 0

Index = Union[int, torch.Tensor]


def decode_kernel_supported(n_q: int, num_qk: int, num_v: int, num_heads: int) -> bool:
    """The dispatch rule of the cached attention path, the same on every
    device: short query blocks with equal qk/v widths take decode attention."""
    return 1 <= n_q <= MAX_QUERIES and num_qk == num_v and num_qk // num_heads <= MAX_HEAD_DIM


def _rows(x: Index, b: int, device) -> torch.Tensor:
    """Scalar or (B,) int -> (B,) int32 on ``device``."""
    return torch.as_tensor(x, device=device).to(torch.int32).reshape(-1).expand(b)


def _check(q, k_cache, v_cache, rope_k, pad_slots):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, n_q, D), got shape {tuple(q.shape)}")
    b, h, n_q, d = q.shape
    if not 1 <= n_q <= MAX_QUERIES:
        raise ValueError(f"decode attention takes 1..{MAX_QUERIES} queries, got n_q={n_q}")
    if k_cache.dim() != 3 or k_cache.shape[0] != b or k_cache.shape[2] != h * d:
        raise ValueError(f"k_cache must be (B, cap, H*D) = ({b}, cap, {h * d}), got {tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache shape {tuple(v_cache.shape)} != k_cache shape {tuple(k_cache.shape)}")
    cap = k_cache.shape[1]
    if rope_k.dim() != 3 or tuple(rope_k.shape[:2]) != (b, cap):
        raise ValueError(f"rope_k must be (B, cap, r) = ({b}, {cap}, r), got {tuple(rope_k.shape)}")
    r = rope_k.shape[2]
    if r % 2 or r > d:
        raise ValueError(f"rotary width r={r} must be even and at most the head dim {d}")
    if tuple(pad_slots.shape) != (b, cap):
        raise ValueError(f"pad_slots must be (B, cap) = ({b}, {cap}), got {tuple(pad_slots.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q, k_cache and v_cache must share a dtype, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")


def fused_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    rope_k: torch.Tensor,
    q_pos: Index,
    pad_slots: torch.Tensor,
    live: Optional[Index] = None,
) -> torch.Tensor:
    """q (B, H, n_q, D) scaled (and rotated) queries, n_q <= 8; k/v_cache
    (B, cap, H*D) unrotated; rope_k (B, cap, r) angles; q_pos () or (B,):
    absolute position of the LAST query (query qi sits at q_pos-(n_q-1-qi));
    pad_slots (B, cap) bool; live () or (B,): the live region is the tail
    [q_pos+1-live, q_pos+1), None = fully live. Returns (B, H, n_q, D) in q's
    dtype, accumulated in float32 (or wider, for float64 inputs)."""
    _check(q, k_cache, v_cache, rope_k, pad_slots)
    if q.device.type == "cpu":
        return fused_decode_attention_reference(q, k_cache, v_cache, rope_k, q_pos, pad_slots, live)
    return _launch(q, k_cache, v_cache, rope_k, q_pos, pad_slots, live)


def fused_decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    rope_k: torch.Tensor,
    q_pos: Index,
    pad_slots: torch.Tensor,
    live: Optional[Index] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: the same
    visibility, -inf masking, float32 (or wider) accumulation through the
    value sum, and zeros for a query that sees no slot."""
    b, h, n_q, d = q.shape
    cap = k_cache.shape[1]
    wide = torch.promote_types(q.dtype, torch.float32)
    split = lambda t: t.reshape(b, cap, h, d).transpose(1, 2).to(wide)
    k = apply_rope(split(k_cache), rope_k.to(torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wide), k)

    q_last = _rows(q_pos, b, q.device)
    slot = torch.arange(cap, device=q.device)
    q_at = q_last[:, None] - (n_q - 1) + torch.arange(n_q, device=q.device)  # (B, n_q)
    visible = (slot[None, None, :] <= q_at[:, :, None]) & ~pad_slots.to(torch.bool)[:, None, :]
    if live is not None:
        lo = q_last + 1 - _rows(live, b, q.device)
        visible = visible & (slot[None, None, :] >= lo[:, None, None])
    s = s.masked_fill(~visible[:, None], float("-inf"))

    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, split(v_cache)) / l
    return o.to(q.dtype)


def decode_splits(batch: int, heads: int, span: int, num_sms: int) -> int:
    """Splits S per (row, head) of a B2 launch over rows whose visible slot
    range holds at most ``span`` slots, on a card with ``num_sms`` SMs."""
    want = max(-(-SPLIT_BLOCKS_PER_SM * num_sms // (batch * heads)), -(-span // MAX_SPLIT_SLOTS))
    return max(1, min(want, span // MIN_SPLIT_SLOTS))


def decode_split_rows(q_last: int, live: Optional[int], cap: int, pad_row: Sequence[bool], num_splits: int,
                      min_slots: int = MIN_SPLIT_SLOTS) -> List[List[int]]:
    """The slots each split block of one batch row reads, by the kernel's own
    arithmetic (``csrc/decode_attention.cu``): the n slots [lo, hi] cut into
    n_k = max(1, min(S, n // min_slots)) contiguous runs, pad slots
    skipped. Each query then keeps the slots up to its causal bound."""
    lo = 0 if live is None else max(q_last + 1 - live, 0)
    hi = min(q_last, cap - 1)
    n = max(hi - lo + 1, 0)
    n_k = max(1, min(num_splits, n // min_slots))
    return [[j for j in range(lo + k * n // n_k, lo + (k + 1) * n // n_k) if not pad_row[j]] for k in range(n_k)]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_num_sms: Dict[int, int] = {}
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _num_sms:
        _num_sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _num_sms[index]


def split_workspace(stream: torch.cuda.Stream, floats: int, counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-K workspace (float32) and counters (int32) of a CUDA stream:
    kept per (device, stream), so launches on one stream reuse them in order,
    and grown on demand. The counters are zeroed once; every launch leaves
    them at zero (the last block of each (row, head) resets its own)."""
    key = (stream.device.index, stream.cuda_stream)
    ws, cnt = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=stream.device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(counters, dtype=torch.int32, device=stream.device)
    _workspaces[key] = (ws, cnt)
    return ws, cnt


def claim_split_workspace(stream: torch.cuda.Stream) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Take a stream's workspace and counters out of the per-stream table;
    the caller keeps them alive. A CUDA graph captured on the stream points
    at them: a later call on that stream then gets a workspace of its own
    instead of growing (and so freeing) the graph's."""
    return _workspaces.pop((stream.device.index, stream.cuda_stream), None)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_fn = None


def _entry():
    """The C entry point, built and loaded at first use (never at import)."""
    global _fn
    if _fn is None:
        from perceiver_io_torch.ops.cuda_build import library

        fn = library("decode_attention").decode_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v ang pad qpos qpos_scalar live live_scalar has_live out B H n_q D cap r dtype
        # splits min_slots ws counters stream
        fn.argtypes = [p, p, p, p, p, p, i, p, i, i, p, i, i, i, i, i, i, i, i, i, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def _launch(q, k_cache, v_cache, rope_k, q_pos, pad_slots, live) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, or raise."""
    global launches
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache, "rope_k": rope_k, "pad_slots": pad_slots}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode attention on a non-CPU device needs CUDA tensors on one card; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode attention needs contiguous tensors; {name} is not")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA decode kernel takes float32 or bfloat16, got {q.dtype}")
    if rope_k.dtype != torch.float32:
        raise ValueError(f"rope_k must be float32 on the card, got {rope_k.dtype}")
    if pad_slots.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"pad_slots must be bool or uint8, got {pad_slots.dtype}")
    b, h, n_q, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA decode kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("rope_k", rope_k)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned for the kernel's paired loads")

    qpos_t = None if isinstance(q_pos, int) else _rows(q_pos, b, q.device).contiguous()
    live_t = None if live is None or isinstance(live, int) else _rows(live, b, q.device).contiguous()
    cap = k_cache.shape[1]
    span = cap  # the most slots a row can see; exact when q_pos and live are host ints
    if qpos_t is None and live_t is None:
        lo = 0 if live is None else max(q_pos + 1 - live, 0)
        span = max(min(q_pos, cap - 1) - lo + 1, 0)
    splits = decode_splits(b, h, span, num_sms(q.device))
    stream = torch.cuda.current_stream(q.device)
    ws = cnt = None
    if splits > 1:
        ws, cnt = split_workspace(stream, b * h * splits * n_q * (d + 2), b * h)
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), rope_k.data_ptr(), pad_slots.data_ptr(),
        _ptr(qpos_t), q_pos if qpos_t is None else 0,
        _ptr(live_t), live if isinstance(live, int) else 0, int(live is not None),
        out.data_ptr(), b, h, n_q, d, cap, rope_k.shape[2], _DTYPES[q.dtype],
        splits, MIN_SPLIT_SLOTS, _ptr(ws), _ptr(cnt), stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
