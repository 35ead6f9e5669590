"""Flash attention over split heads: the uncached forward's attention with no
materialised score matrix, forward and backward.

Port of ``perceiver_io_tpu/ops/flash.py`` (``flash_supported`` and
``splash_mha``). On a CUDA tensor ``splash_mha`` launches the hand-written
Hopper kernels through a ``torch.autograd.Function``, or raises: B1a, the
forward, is ``perceiver_io_torch/csrc/flash_forward_mma.cu`` for bfloat16
heads of 64 and 128 channels (tensor-core ``mma.sync`` tiles),
``csrc/flash_forward_wide.cu`` for bfloat16 heads of 192 to 512 channels
(``wgmma`` fed by TMA, warp-specialised, K and V multicast over a cluster
of two blocks; a bf16 output when no float32 reader needs it), and
``csrc/flash_forward_f32.cu`` for float32 at every width (``wgmma`` fed by
TMA: float32-class products as three TF32 products, each operand split
into a TF32 high part and a TF32 low part); B1b, the backward, is
``csrc/flash_backward_mma.cu`` for bfloat16 heads of 64 and 128 channels
(two deterministic passes on ``mma.sync`` tiles, dK/dV and dQ, as the TPU's
splash runs them), ``csrc/flash_backward_wide.cu`` for bfloat16 heads of 192
to 512 channels (two passes on ``wgmma`` fed by TMA, warp-specialised,
the streamed tiles multicast over a cluster of two blocks: dK/dV, its query
range split over blocks whose float32 partial sums a reduce adds in split
order, writes dS to a scratch; dQ multiplies that dS by K) and
``csrc/flash_backward_f32.cu`` for float32 at every width (the same two
passes on ``wgmma`` fed by TMA, each of the five products as three TF32
products; each file's header says what bounds its kernels). On a CPU tensor the same Function computes
the kernels' arithmetic in plain PyTorch (``_forward_plain``,
``_backward_plain``). ``flash_attention_reference`` is the plain version
written with autograd-native ops: the CUDA kernels and the CPU route are held
against it and its autograd gradients. There is no other fallback.

``ring_block_forward`` is kernel B5, the port of
``perceiver_io_tpu/parallel/ring_attention.py:_splash_fwd_block``: one fully
visible block of ring attention, which the TPU runs as the same splash kernel
with ``save_residuals=True`` (its log-sum-exp) and no causal mask. Its CUDA
counterpart is therefore B1a's own entry with no causal mask, which writes
the float32 output and log-sum-exp; in bfloat16 it asks that kernel for P
as two bf16 terms (``split_p``), so the float32 output holds 1e-4, where
one term would move it by up to ~8e-4. B1a asks for two terms too whenever
its output will be differentiated (B1b reads the float32 output), and for
one when it is only cast to bf16 (a forward without gradients). It has no
autograd, as JAX's AD never sees the TPU kernel:
the ring's custom backward recomputes the block. It counts its launches in
``block_launches``, apart from the training path's B1a.

The JAX gate's backend, mesh and environment-switch conditions (a TPU
rollback lever) are not carried over: the gate is structural, the same on
every device. The kernels, forward and backward, take every head width that
is a multiple of 64 up to ``MAX_HEAD_DIM`` = 512 (the JAX gate has no upper
limit; the widest head in the package is the optical-flow decoder's 512), so
the one condition added is that a head wider than 512 takes the masked
softmax.

Rows with no visible key (a pad token among the queries) get exact zeros and
zero gradients, as the port's decode kernels do; the masked softmax averages
such rows uniformly instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# candidate tile sizes of the JAX gate (its splash tiling), largest first;
# the CUDA kernels tile by 64 and mask their own ragged edge, so these only
# keep the gate's shapes the JAX package's
_BLOCKS_WIDE = (512, 256, 128)  # head_dim >= 128 or min seq >= 1024
_BLOCKS_NARROW = (256, 128)
MAX_HEAD_DIM = 512
_HEAD_DIMS = tuple(range(64, MAX_HEAD_DIM + 1, 64))  # the forward kernels' widths
# the bf16 kernels of flash_forward_mma.cu and flash_backward_mma.cu; wider
# heads take flash_forward_wide.cu and flash_backward_wide.cu
_NARROW_HEAD_DIMS = (64, 128)
# flash_backward_wide.cu's dK/dV pass: key rows a block (its kDkdvKeys),
# query rows of a tile (its kDkdvCols), blocks in a cluster, and the waves of
# one-block-an-SM that its grid should make. The tests hold the first three
# to the source.
_WIDE_KEY_ROWS = 32
_WIDE_QUERY_ROWS = 64
_WIDE_CLUSTER = 2
_WIDE_WAVES = 8
# flash_backward_f32.cu's dK/dV pass: query rows a tile (its kQTile), and the
# waves of one-block-an-SM that its grid should make
_F32_QUERY_TILE = 128
_F32_WAVES = 4

# Launches since import (or since the caller last reset them to 0): one per
# forward kernel call (B1a; also counted by head width in
# ``forward_launches_by_width`` and by input type, "float32" or "bfloat16",
# in ``forward_launches_by_dtype``), one per backward call (B1b: its delta,
# dK/dV and dQ kernels, and at wide heads the dK/dV reduce; also counted by
# head width and input type in ``backward_launches_by_width`` and
# ``backward_launches_by_dtype``) and one per ring block (B5). Only
# ``_launch_forward``, ``_launch_backward`` and ``ring_block_forward`` add
# to them.
forward_launches = 0
forward_launches_by_width = {}
forward_launches_by_dtype = {}
backward_launches = 0
backward_launches_by_width = {}
backward_launches_by_dtype = {}
block_launches = 0


def _pick_block(n_q: int, n_k: int, head_dim: int) -> Optional[int]:
    """Largest candidate tile dividing both sequence lengths (None = no fit)."""
    wide = head_dim >= 128 or min(n_q, n_k) >= 1024
    for block in _BLOCKS_WIDE if wide else _BLOCKS_NARROW:
        if n_q % block == 0 and n_k % block == 0:
            return block
    return None


def flash_supported(
    num_qk_channels_per_head: int,
    num_v_channels_per_head: int,
    n_q: int,
    n_k: int,
    has_dropout: bool,
    has_cache: bool,
) -> bool:
    """Static predicate: does this attention call take the flash kernels?
    (The JAX gate's batch and head counts only matter on a mesh.) The same
    whether or not the call records gradients: B1b takes every width B1a
    does."""
    if has_dropout or has_cache:
        return False
    if num_qk_channels_per_head != num_v_channels_per_head:
        return False  # one head width for q, k and v
    if num_qk_channels_per_head % 64 != 0 or num_qk_channels_per_head > MAX_HEAD_DIM:
        return False
    return _pick_block(n_q, n_k, num_qk_channels_per_head) is not None and n_q >= 128 and n_k >= 128


def _check(q, k, v, pad_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be (B, H, N, D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, H, Nk, D) = ({b}, {h}, Nk, {d}); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, k.shape[2]):
        raise ValueError(f"pad_mask must be (B, Nk) = ({b}, {k.shape[2]}), got {tuple(pad_mask.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def splash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
               causal: bool = False) -> torch.Tensor:
    """q (B, H, Nq, D) [pre-scaled, pre-rotated], k/v (B, H, Nk, D), pad_mask
    (B, Nk) True = padding. Returns (B, H, Nq, D) in q's dtype; differentiable
    in q, k and v."""
    _check(q, k, v, pad_mask)
    return _FlashAttention.apply(q, k, v, pad_mask, causal)


def _visibility(n_q: int, n_k: int, pad_mask: Optional[torch.Tensor], causal: bool, device) -> torch.Tensor:
    """(B or 1, 1, Nq, Nk) bool: query i sees key j (right-aligned causal:
    j <= Nk - Nq + i; pad keys never)."""
    visible = torch.ones(1, 1, n_q, n_k, dtype=torch.bool, device=device)
    if causal:
        visible = ~torch.ones(n_q, n_k, dtype=torch.bool, device=device).triu(n_k - n_q + 1)[None, None]
    if pad_mask is not None:
        visible = visible & ~pad_mask.to(torch.bool)[:, None, None, :]
    return visible


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              pad_mask: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernels, on any device and
    differentiable by autograd: scores and softmax in float32 (or wider for
    float64 inputs), -inf masking, zeros for a query that sees no key, the
    output in q's dtype."""
    return _forward_plain(q, k, v, pad_mask, causal)[0].to(q.dtype)


def _forward_plain(q, k, v, pad_mask, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1a's arithmetic: (o, lse) in float32 (or float64 for float64
    inputs), the output before its cast to q's dtype and the (B, H, Nq)
    log-sum-exp of each query's visible scores (-inf for a query that sees
    no key)."""
    wide = torch.promote_types(q.dtype, torch.float32)
    visible = _visibility(q.shape[2], k.shape[2], pad_mask, causal, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wide), k.to(wide)).masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m)).detach()  # the shift does not change the value
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(wide)) / torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))[..., 0]
    return o, lse


def _backward_plain(q, k, v, pad_mask, causal, o, lse, do) -> Tuple[torch.Tensor, ...]:
    """B1b's arithmetic on the CPU, FlashAttention-2's backward: P recomputed
    from q, k and lse; delta = rowsum(dO * O) with the forward's unrounded
    (float32 or wider) O; dS = P * (dO V^T - delta);
    dQ = dS K, dK = dS^T Q, dV = P^T dO. Hidden pairs (and every pair of a
    row with lse = -inf) have P = 0, so pad keys get exact-zero dK and dV."""
    wide = torch.promote_types(q.dtype, torch.float32)
    qw, kw, vw, ow, dow = (t.to(wide) for t in (q, k, v, o, do))
    visible = _visibility(q.shape[2], k.shape[2], pad_mask, causal, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qw, kw)
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse)).to(wide)[..., None]
    p = torch.where(visible, torch.exp(s - lse_safe), torch.zeros_like(s))
    delta = (dow * ow).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dow, vw) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kw)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qw)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dow)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """B1a forward, B1b backward (CPU tensors: their plain arithmetic). On a
    CUDA tensor bfloat16 runs ``flash_forward_mma.cu`` and
    ``flash_backward_mma.cu`` (heads of 64 and 128 channels) or
    ``flash_forward_wide.cu`` and ``flash_backward_wide.cu`` (192 to 512),
    float32 ``flash_forward_f32.cu`` and ``flash_backward_f32.cu``. Saves (q, k, v, o, lse) and
    the pad mask, with o the float32 (or wider) output before its cast to
    q's dtype; a wide bfloat16 forward without gradients writes o in
    bfloat16 already, and returns it uncast."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal):
        if q.device.type == "cpu":
            o, lse = _forward_plain(q, k, v, pad_mask, causal)
        else:
            # the backward's delta = rowsum(dO * O) reads the float32 O, and
            # with P rounded to bf16 once it moves bf16 dq past B1's limit
            o, lse = _launch_forward(q, k, v, pad_mask, causal, split_p=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, o, lse, pad_mask)
        ctx.causal = causal
        return o.to(q.dtype)  # no copy when the kernel wrote q's dtype

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, pad_mask = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = _backward_plain(q, k, v, pad_mask, ctx.causal, o, lse, do)
        else:
            dq, dk, dv = _launch_backward(q, k, v, pad_mask, ctx.causal, o, lse, do.contiguous())
        return dq, dk, dv, None, None


# ------------------------------------------------------------------ CUDA
_DTYPES = (torch.float32, torch.bfloat16)
_f32_bwd_fn = None
_f32_fn = None
_mma_fn = None
_wide_fn = None
_mma_bwd_fn = None
_wide_bwd_fn = None


def _f32_backward_entry():
    """The float32 backward's C entry point (``csrc/flash_backward_f32.cu``),
    built and loaded at first use (never at import)."""
    global _f32_bwd_fn
    if _f32_bwd_fn is None:
        from perceiver_io_torch.ops.cuda_build import library

        fn = library("flash_backward_f32").flash_backward_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v pad o lse dout delta scratch ds ws dq dk dv B H Nq Nk D causal splits stream
        fn.argtypes = [p] * 14 + [i] * 7 + [p]
        fn.restype = i
        _f32_bwd_fn = fn
    return _f32_bwd_fn


def _f32_entry():
    """The float32 forward's C entry point (``csrc/flash_forward_f32.cu``),
    built and loaded at first use (never at import)."""
    global _f32_fn
    if _f32_fn is None:
        from perceiver_io_torch.ops.cuda_build import library

        fn = library("flash_forward_f32").flash_forward_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v pad scratch o lse B H Nq Nk D causal stream
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        _f32_fn = fn
    return _f32_fn


def f32_scratch_floats(batch_heads: int, n_k: int, head_dim: int) -> int:
    """Float32 words of ``flash_forward_f32.cu``'s scratch: K as TF32 high and
    low terms (2 x B*H x Nk x D) and V transposed, as the same two terms, with
    its keys padded with zeros to a multiple of 8 (2 x B*H x D x Nk8): a row
    of V^T is then a multiple of 32 bytes, as TMA needs 16, and every 8-group
    of keys that the kernel reorders is whole."""
    n_k8 = -(-n_k // 8) * 8
    return 2 * batch_heads * head_dim * (n_k + n_k8)


def _mma_entry():
    """The bfloat16 forward's C entry point (``csrc/flash_forward_mma.cu``),
    built and loaded at first use (never at import)."""
    global _mma_fn
    if _mma_fn is None:
        from perceiver_io_torch.ops.cuda_build import library

        fn = library("flash_forward_mma").flash_forward_mma
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v pad o lse B H Nq Nk D causal split_p stream
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        _mma_fn = fn
    return _mma_fn


def _wide_entry():
    """The bfloat16 forward's C entry point for heads of 192 to 512 channels
    (``csrc/flash_forward_wide.cu``), built and loaded at first use (never at
    import)."""
    global _wide_fn
    if _wide_fn is None:
        from perceiver_io_torch.ops.cuda_build import library

        fn = library("flash_forward_wide").flash_forward_wide
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v pad o lse B H Nq Nk D causal split_p stream (o: bf16 without split_p, else float32)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        _wide_fn = fn
    return _wide_fn


def _mma_backward_entry():
    """The bfloat16 backward's C entry point (``csrc/flash_backward_mma.cu``),
    built and loaded at first use (never at import)."""
    global _mma_bwd_fn
    if _mma_bwd_fn is None:
        from perceiver_io_torch.ops.cuda_build import library

        fn = library("flash_backward_mma").flash_backward_mma
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v pad o lse dout delta dq dk dv B H Nq Nk D causal stream
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        _mma_bwd_fn = fn
    return _mma_bwd_fn


def _wide_backward_entry():
    """The bfloat16 backward's C entry point for heads of 192 to 512
    channels (``csrc/flash_backward_wide.cu``), built and loaded at first use
    (never at import)."""
    global _wide_bwd_fn
    if _wide_bwd_fn is None:
        from perceiver_io_torch.ops.cuda_build import library

        fn = library("flash_backward_wide").flash_backward_wide
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v pad o lse dout delta ws ds dq dk dv B H Nq Nk D causal splits stream
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        _wide_bwd_fn = fn
    return _wide_bwd_fn


def wide_backward_splits(batch_heads: int, n_q: int, n_k: int, head_dim: int, sms: int) -> int:
    """How many blocks ``flash_backward_wide.cu``'s dK/dV pass splits each
    key tile's query range over: enough for ``_WIDE_WAVES`` waves of one
    block an SM (the kernel's shared memory allows one) over the (batch*head,
    key tile) pairs, the key tiles padded to whole clusters of two, and no
    more than one split per 4 query tiles. The flow decoder at 2 patches (2 x
    64 key tiles of 32 rows) gets 9 on 132 SMs, 1,152 blocks. ``head_dim``
    does not change it: every width keeps 32 keys a block."""
    key_tiles = -(-n_k // _WIDE_KEY_ROWS)
    key_tiles = -(-key_tiles // _WIDE_CLUSTER) * _WIDE_CLUSTER
    q_tiles = -(-n_q // _WIDE_QUERY_ROWS)
    want = -(-_WIDE_WAVES * sms // (batch_heads * key_tiles))
    return max(1, min(want, -(-q_tiles // 4), 65535))


def f32_backward_splits(batch_heads: int, n_q: int, n_k: int, head_dim: int, sms: int) -> int:
    """How many blocks ``flash_backward_f32.cu``'s dK/dV pass splits each key
    block's query range over: enough for ``_F32_WAVES`` waves of one block an
    SM (its shared memory allows one) over the (batch*head, key block) pairs,
    and no more than one split per 4 of its 128-query tiles. Key blocks are
    64 keys up to D 128 and 32 above: the flow decoder's patch (64 key blocks
    of 32) gets 9 on 132 SMs, the flagship's 160 heads none."""
    key_blocks = -(-n_k // (64 if head_dim <= 128 else 32))
    q_tiles = -(-n_q // _F32_QUERY_TILE)
    want = -(-_F32_WAVES * sms // (batch_heads * key_blocks))
    return max(1, min(want, -(-q_tiles // 4), 65535))


def f32_backward_scratch_floats(batch_heads: int, n_k: int, head_dim: int) -> int:
    """Float32 words of ``flash_backward_f32.cu``'s scratch: K and V as TF32
    high and low terms (4 x B*H x Nk x D) and K transposed, as the same two
    terms, its keys padded with zeros to a multiple of 8 (2 x B*H x D x
    Nk8)."""
    n_k8 = -(-n_k // 8) * 8
    return 2 * batch_heads * head_dim * (2 * n_k + n_k8)


def _f32_ds_keys(n_k: int) -> int:
    """The keys of a row of ``flash_backward_f32.cu``'s dS scratch: n_k
    rounded up to 4, so that every row is 16-byte aligned for TMA."""
    return -(-n_k // 4) * 4


def _wide_query_rows(n_q: int) -> int:
    """The query rows of ``flash_backward_wide.cu``'s dS^T scratch: n_q
    rounded up to whole query tiles, so that every row is 128-byte aligned
    for TMA."""
    return -(-n_q // _WIDE_QUERY_ROWS) * _WIDE_QUERY_ROWS


def _check_aligned(tensors: dict, what: str) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:  # cp.async copies rows in 16-byte pieces; a TMA tensor map needs a 16-byte base
            raise ValueError(f"the flash {what} needs 16-byte aligned tensors; {name} is not")


def _check_cuda(tensors: dict, q: torch.Tensor, head_dims=_HEAD_DIMS) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash attention on a non-CPU device needs CUDA tensors on one card; {name} is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash attention needs contiguous tensors; {name} is not")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"the CUDA flash kernels take head dims {head_dims}, got {q.shape[-1]}")


def _pad_bytes(pad_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if pad_mask is None:
        return None
    if pad_mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"pad_mask must be bool or uint8, got {pad_mask.dtype}")
    return pad_mask.contiguous().view(torch.uint8)


def _forward_entry(q, k, v, pad_mask, causal, split_p) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream, or raise: (o, lse).
    bfloat16 inputs take ``flash_forward_mma`` (heads of 64 and 128
    channels) or ``flash_forward_wide`` (192 to 512; ``split_p``: P as two
    bf16 terms), float32 ones ``flash_forward_f32`` (its K and V^T terms in
    a scratch of ``f32_scratch_floats`` words); every one reads q, k and v
    16-byte aligned. lse is float32; o is float32, except from
    ``flash_forward_wide`` without ``split_p`` (a forward whose output is
    only cast), which writes it in bfloat16. Counts nothing: its callers
    do."""
    pad = _pad_bytes(pad_mask)
    _check_cuda({"q": q, "k": k, "v": v, "pad_mask": pad}, q)
    _check_aligned({"q": q, "k": k, "v": v}, "forward")
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    wide = q.dtype == torch.bfloat16 and d not in _NARROW_HEAD_DIMS
    o = torch.empty(q.shape, dtype=torch.bfloat16 if wide and not split_p else torch.float32, device=q.device)
    lse = torch.empty(b, h, n_q, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pad_ptr = None if pad is None else pad.data_ptr()
    if q.dtype == torch.bfloat16:
        name, entry = ("flash_forward_wide", _wide_entry) if wide else ("flash_forward_mma", _mma_entry)
        err = entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, o.data_ptr(), lse.data_ptr(), b, h, n_q,
                      n_k, d, int(causal), int(split_p), stream)
    else:
        name = "flash_forward_f32"
        scratch = torch.empty(f32_scratch_floats(b * h, n_k, d), dtype=torch.float32, device=q.device)
        err = _f32_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, scratch.data_ptr(), o.data_ptr(),
                           lse.data_ptr(), b, h, n_q, n_k, d, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return o, lse


def _launch_forward(q, k, v, pad_mask, causal, split_p=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B1a on the current stream, or raise: (o, lse), lse float32
    and o float32 (bfloat16 from the wide kernel without ``split_p``; see
    ``_forward_entry``). ``split_p``: in bfloat16, P as two bf16 terms
    (needed when B1b will read o); one term is enough for an output that is
    only cast to bf16."""
    global forward_launches
    out = _forward_entry(q, k, v, pad_mask, causal, split_p)
    forward_launches += 1
    d, dtype = q.shape[-1], str(q.dtype).removeprefix("torch.")
    forward_launches_by_width[d] = forward_launches_by_width.get(d, 0) + 1
    forward_launches_by_dtype[dtype] = forward_launches_by_dtype.get(dtype, 0) + 1
    return out


def ring_block_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pad_mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5: attention of ``q`` (B, H, Nq, D) over one fully visible key block
    ``k``/``v`` (B, H, Nk, D), keys masked only by ``pad_mask`` (B, Nk), True =
    padding. Returns (o, lse): the normalised output (B, H, Nq, D) and the
    log-sum-exp (B, H, Nq), float32 (float64 for float64 inputs), with
    exact zeros and -inf for a query whose keys are all padding. CUDA
    tensors launch B1a's entry with no causal mask and, in bfloat16, P as
    two bf16 terms (contiguous inputs, or it raises); CPU tensors take its
    plain version."""
    global block_launches
    _check(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return _forward_plain(q, k, v, pad_mask, False)
    out = _forward_entry(q, k, v, pad_mask, False, split_p=True)
    block_launches += 1
    return out


def _launch_backward(q, k, v, pad_mask, causal, o, lse, do) -> Tuple[torch.Tensor, ...]:
    """Launch B1b (its delta, dK/dV and dQ kernels) on the current stream, or
    raise: bfloat16 takes ``flash_backward_mma`` for heads of 64 and 128
    channels and ``flash_backward_wide`` for 192 to 512, whose dK/dV pass
    splits each key tile's queries over ``wide_backward_splits`` blocks and
    writes dS, as two bf16 terms, to a scratch of 4 x B x H x Nk x Nq bytes
    that its dQ pass multiplies by K; float32 takes ``flash_backward_f32``
    (every product as three TF32 products on the tensor cores), whose dK/dV
    pass splits each key block's queries over ``f32_backward_splits`` blocks
    and writes dS in float32 to a scratch of 4 x B x H x Nq x Nk4 bytes that
    its dQ pass multiplies by K."""
    global backward_launches
    pad = _pad_bytes(pad_mask)
    _check_cuda({"q": q, "k": k, "v": v, "pad_mask": pad, "o": o, "lse": lse, "do": do}, q)
    if do.dtype != q.dtype or o.dtype != torch.float32 or lse.dtype != torch.float32:
        raise ValueError(f"do must be in q's dtype, o and lse float32; got {do.dtype}, {o.dtype}, {lse.dtype}")
    _check_aligned({"q": q, "k": k, "v": v, "do": do}, "backward")
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, n_q, dtype=torch.float32, device=q.device)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if pad is None else pad.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), delta.data_ptr())
    sizes = (b, h, n_q, n_k, d, int(causal))
    outputs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if q.dtype == torch.bfloat16 and d in _NARROW_HEAD_DIMS:
        name = "flash_backward_mma"
        err = _mma_backward_entry()(*pointers, *outputs, *sizes, stream)
    elif q.dtype == torch.bfloat16:
        splits = wide_backward_splits(b * h, n_q, n_k, d, sms)
        ws = torch.empty(2 * b * h * splits * n_k * d, dtype=torch.float32, device=q.device)
        ds = torch.empty(2 * b * h * n_k * _wide_query_rows(n_q), dtype=torch.bfloat16, device=q.device)
        name = "flash_backward_wide"
        err = _wide_backward_entry()(*pointers, ws.data_ptr(), ds.data_ptr(), *outputs, *sizes, splits, stream)
    else:
        splits = f32_backward_splits(b * h, n_q, n_k, d, sms)
        scratch = torch.empty(f32_backward_scratch_floats(b * h, n_k, d), dtype=torch.float32, device=q.device)
        ds = torch.empty(b * h * n_q * _f32_ds_keys(n_k), dtype=torch.float32, device=q.device)
        ws = torch.empty(2 * b * h * splits * n_k * d if splits > 1 else 4, dtype=torch.float32, device=q.device)
        name = "flash_backward_f32"
        err = _f32_backward_entry()(*pointers, scratch.data_ptr(), ds.data_ptr(), ws.data_ptr(), *outputs, *sizes,
                                    splits, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    backward_launches += 1
    dtype = str(q.dtype).removeprefix("torch.")
    backward_launches_by_width[d] = backward_launches_by_width.get(d, 0) + 1
    backward_launches_by_dtype[dtype] = backward_launches_by_dtype.get(dtype, 0) + 1
    return dq, dk, dv
