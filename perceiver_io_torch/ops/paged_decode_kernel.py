"""Paged KV cache and single-query paged decode attention.

Port of ``perceiver_io_tpu/ops/paged_decode_kernel.py``: the page layout and
quantizers (``PagedKVCache``, ``_pack_codes``/``_unpack_codes`` and the
per-page-per-head scale helpers), the ring visibility (``paged_visibility``,
``_page_has_live``) and the kernel wrapper ``fused_paged_decode_attention``.

Layout: one physical page pool ``kp``/``vp`` (num_pages, page_size, C)
shared by every slot (page 0 is the trash page free slots read and write), a
page table (B, P) per slot, and a ring offset ``start``: physical position r
holds logical window position ``(r - start) mod window``. With ``live`` live
entries, logical positions ``[window - live, window)`` are visible.

Quantized pools store int8 codes (``kv_quant="int8"``) or offset-8 nibbles
packed two per byte, the even channel in the low nibble (``"int4"``, last dim
C // 2 uint8), with one float32 scale per (page, head). Every quantizer works
in float32 with round-half-to-even, as the JAX package does, so the stored
bytes and scales are bit for bit the JAX package's for the same writes.

The cache is updated IN PLACE (the JAX package returns a new one): every
write method mutates the pool tensors and returns ``self``.

On a CUDA tensor ``fused_paged_decode_attention`` launches kernel B3 of
``perceiver_io_torch/csrc/paged_attention.cu`` (whose header says what bounds
it) or raises; on a CPU tensor it computes the plain PyTorch version,
``fused_paged_decode_attention_reference``, which is also what the kernel is
held against on the card. The TPU kernel's block-diagonal query, rotate-half
matmul, head expander and page-size tiling gates (``paged_decode_supported``)
worked around Mosaic limits and are not part of the function.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from perceiver_io_torch.ops.decode_kernel import (_DTYPES, MAX_HEAD_DIM, MAX_SPLIT_SLOTS, _ptr, _rows, num_sms,
                                                  split_workspace)
from perceiver_io_torch.ops.position import apply_rope

# supported quantized-page modes (the serving engine's ``kv_quant``)
KV_QUANT_MODES = ("int8", "int4")
# int8: q = clip(round(x / s), -127, 127), s = amax / 127
_QMAX = 127.0
# int4: q = clip(round(x / s), -7, 7), s = amax / 7, stored as q + 8 nibbles
_QMAX4 = 7.0

# Kernel launches since import (or since the caller last reset it to 0). Only
# ``fused_paged_decode_attention`` adds to it, once per launch.
launches = 0


def _qmax_for(qbits: int) -> float:
    return _QMAX4 if qbits == 4 else _QMAX


def quant_mode_qbits(kv_quant: Optional[str]) -> int:
    """Code width of a ``kv_quant`` mode (8 for fp and int8 pools)."""
    return 4 if kv_quant == "int4" else 8


def _pack_codes(vals: torch.Tensor, qbits: int) -> torch.Tensor:
    """Clipped integer code values (float32) -> stored pool bytes: int8, or
    offset nibbles packed two per uint8 (even channel in the low nibble)."""
    if qbits == 8:
        return vals.to(torch.int8)
    n = (vals.to(torch.int32) + 8).to(torch.uint8)
    return n[..., ::2] | (n[..., 1::2] << 4)


def _unpack_codes(blocks: torch.Tensor, qbits: int) -> torch.Tensor:
    """Stored pool bytes -> float32 code values at the logical channel width
    (inverse of ``_pack_codes``)."""
    if qbits == 8:
        return blocks.to(torch.float32)
    lo = (blocks & 0xF).to(torch.int32) - 8
    hi = (blocks >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2).to(torch.float32)


def _amax_per_head(rows: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-head abs-max of ``rows`` (..., n, H*d) over rows and channels ->
    (..., H): one scale covers what a head owns in one page."""
    r = rows.unflatten(-1, (num_heads, -1))
    return r.abs().amax(dim=(-3, -1))


def _expand_scale(scale: torch.Tensor, d: int) -> torch.Tensor:
    """(..., H) per-head scales -> (..., H*d) per channel."""
    return scale.repeat_interleave(d, dim=-1)


def _quantize_values(rows_f32: torch.Tensor, scale: torch.Tensor, d: int, qmax: float) -> torch.Tensor:
    """Code values (float32, not yet stored) of ``rows_f32`` (..., n, H*d)
    under per-head ``scale`` (..., H); a zero scale gives zero codes."""
    sc = _expand_scale(scale, d)[..., None, :]
    safe = torch.where(sc > 0, sc, torch.ones_like(sc))
    q = torch.where(sc > 0, torch.round(rows_f32 / safe), torch.zeros_like(rows_f32))
    return q.clamp(-qmax, qmax)


def _quantize_blocks(rows_f32: torch.Tensor, scale: torch.Tensor, d: int, qbits: int = 8) -> torch.Tensor:
    return _pack_codes(_quantize_values(rows_f32, scale, d, _qmax_for(qbits)), qbits)


@dataclass
class PagedKVCache:
    """Paged cross-attention KV state of one batched decode pool.

    ``kp``/``vp``: (num_pages, page_size, C) pool (C // 2 uint8 for int4),
    ``page_table``: (B, P) int32, ``start``: (B,) int32 ring offset (the next
    append writes at physical position ``start``), ``window``: the logical
    window (<= P * page_size). Quantized pools carry ``k_scale``/``v_scale``
    (num_pages, H) float32, ``num_heads`` and ``qbits``."""

    kp: torch.Tensor
    vp: torch.Tensor
    page_table: torch.Tensor
    start: torch.Tensor
    window: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    num_heads: int = 1
    qbits: int = 8

    @property
    def page_size(self) -> int:
        return self.kp.shape[1]

    @property
    def num_pages(self) -> int:
        return self.kp.shape[0]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_channels(self) -> int:
        c = self.kp.shape[-1]
        return c * 2 if (self.quantized and self.qbits == 4) else c

    @property
    def head_dim(self) -> int:
        return self.num_channels // self.num_heads

    def append_token(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "PagedKVCache":
        """Write one token's (B, 1, C) keys/values at each row's ring
        position ``start`` through the page table and advance ``start``.
        Quantized pools ratchet the write page's per-head scale up to cover
        the new row and requantize the page's codes by the exact old/new
        ratio; a fresh page (scale 0) has its stale bytes zeroed. Free slots
        all write the trash page, with differing payloads: that scatter is
        nondeterministic on CUDA, harmless because page 0 is never read into
        a harvested output."""
        b = k_new.shape[0]
        ps = self.page_size
        rows = torch.arange(b, device=self.start.device)
        page_ids = self.page_table[rows, torch.div(self.start, ps, rounding_mode="floor")].long()
        offs = (self.start % ps).long()
        if not self.quantized:
            self.kp[page_ids, offs] = k_new[:, 0].to(self.kp.dtype)
            self.vp[page_ids, offs] = v_new[:, 0].to(self.vp.dtype)
        else:
            h, d = self.num_heads, self.head_dim
            qmax = _qmax_for(self.qbits)
            for pool, scales, new_rows in ((self.kp, self.k_scale, k_new), (self.vp, self.v_scale, v_new)):
                row = new_rows[:, 0].to(torch.float32)  # (B, C)
                rmax = row.unflatten(-1, (h, d)).abs().amax(dim=-1)  # (B, H)
                old = scales[page_ids]
                new = torch.maximum(old, rmax / qmax)
                ratio = torch.where(new > 0, old / torch.where(new > 0, new, torch.ones_like(new)),
                                    torch.zeros_like(new))
                pages = _unpack_codes(pool[page_ids], self.qbits)  # (B, ps, C)
                pages = torch.round(pages * _expand_scale(ratio, d)[:, None, :])
                pages[rows, offs] = _quantize_values(row[:, None, :], new, d, qmax)[:, 0]
                pool[page_ids] = _pack_codes(pages, self.qbits)
                scales[page_ids] = new
        self.start.copy_((self.start + 1) % self.window)  # in place: a captured graph replays this buffer
        return self

    def write_rows(self, table_row: torch.Tensor, offset: int, count: int, k_rows: torch.Tensor,
                   v_rows: torch.Tensor) -> "PagedKVCache":
        """Write ``count`` consecutive rows of ONE slot's ring, physical
        positions ``[offset, offset + count)``, through ``table_row`` (P,).
        ``k_rows``/``v_rows`` are (C_max, channels); rows past ``count`` go to
        the trash page with a zero payload. Quantized pools write whole pages
        (``offset`` page-aligned): each page with a real row gets a fresh
        per-head scale over exactly its rows, the rest of the page zeros;
        blocks with no real row write zeros and zero scales to the trash
        page."""
        cmax = k_rows.shape[0]
        ps = self.page_size
        p = self.page_table.shape[1]
        dev = self.kp.device
        if not self.quantized:
            j = torch.arange(cmax, device=dev)
            phys = offset + j
            real = j < count
            pidx = torch.div(phys, ps, rounding_mode="floor").clamp(0, p - 1)
            page_ids = torch.where(real, table_row.to(dev)[pidx], torch.zeros_like(pidx)).long()
            offs = torch.where(real, phys % ps, torch.zeros_like(phys)).long()
            self.kp[page_ids, offs] = torch.where(real[:, None], k_rows, torch.zeros_like(k_rows)).to(self.kp.dtype)
            self.vp[page_ids, offs] = torch.where(real[:, None], v_rows, torch.zeros_like(v_rows)).to(self.vp.dtype)
            return self
        if offset % ps:
            raise ValueError(f"quantized write_rows needs a page-aligned offset, got {offset} (page size {ps})")
        h, d = self.num_heads, self.head_dim
        lp = -(-cmax // ps)
        real = (torch.arange(lp * ps, device=dev) < count)[:, None]
        block_real = torch.arange(lp, device=dev) * ps < count
        pidx = (offset // ps + torch.arange(lp, device=dev)).clamp(0, p - 1)
        page_ids = torch.where(block_real, table_row.to(dev)[pidx], torch.zeros_like(pidx)).long()
        for pool, scales, rows in ((self.kp, self.k_scale, k_rows), (self.vp, self.v_scale, v_rows)):
            rz = torch.zeros(lp * ps, rows.shape[-1], dtype=torch.float32, device=dev)
            rz[:cmax] = rows.to(torch.float32)
            blocks = torch.where(real, rz, torch.zeros_like(rz)).reshape(lp, ps, h * d)
            scale = _amax_per_head(blocks, h) / _qmax_for(self.qbits)  # (lp, H)
            pool[page_ids] = _quantize_blocks(blocks, scale, d, self.qbits)
            scales[page_ids] = torch.where(block_real[:, None], scale, torch.zeros_like(scale))
        return self

    def write_pages(self, ids: torch.Tensor, k_blocks: torch.Tensor, v_blocks: torch.Tensor) -> "PagedKVCache":
        """Overwrite whole pages ``ids`` (nb,) with (nb, ps, C) blocks;
        quantized pools stamp a fresh per-head scale per page."""
        ids = ids.long()
        if not self.quantized:
            self.kp[ids] = k_blocks.to(self.kp.dtype)
            self.vp[ids] = v_blocks.to(self.vp.dtype)
            return self
        h, d = self.num_heads, self.head_dim
        for pool, scales, blocks in ((self.kp, self.k_scale, k_blocks), (self.vp, self.v_scale, v_blocks)):
            bf = blocks.to(torch.float32)
            scale = _amax_per_head(bf, h) / _qmax_for(self.qbits)
            pool[ids] = _quantize_blocks(bf, scale, d, self.qbits)
            scales[ids] = scale
        return self

    def reset_page_scales(self, ids: torch.Tensor) -> "PagedKVCache":
        """Zero the scales of pages ``ids`` (a later ratcheted append then
        zeroes stale bytes). No-op on fp pools; duplicate trash ids are
        harmless (the same zero payload)."""
        if self.quantized:
            ids = ids.long()
            self.k_scale[ids] = 0.0
            self.v_scale[ids] = 0.0
        return self

    def _dequant(self, pool: torch.Tensor, scales: Optional[torch.Tensor], table: torch.Tensor) -> torch.Tensor:
        """Pages ``table`` (..., P) -> (..., P, ps, C) values (float32 on
        quantized pools: codes times the page's per-head scale)."""
        blocks = pool[table.long()]
        if not self.quantized:
            return blocks
        return _unpack_codes(blocks, self.qbits) * _expand_scale(scales[table.long()], self.head_dim)[..., None, :]

    def gather_dense(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, P * page_size, C) rows through the page table, dequantized."""
        b = self.page_table.shape[0]
        c = self.num_channels
        k = self._dequant(self.kp, self.k_scale, self.page_table)
        v = self._dequant(self.vp, self.v_scale, self.page_table)
        return k.reshape(b, -1, c), v.reshape(b, -1, c)

    def gather_slot(self, table_row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ONE slot's rows in physical ring order, (1, P * page_size, C),
        dequantized: the prefill finish reads exactly what decode will."""
        c = self.num_channels
        k = self._dequant(self.kp, self.k_scale, table_row)
        v = self._dequant(self.vp, self.v_scale, table_row)
        return k.reshape(1, -1, c), v.reshape(1, -1, c)


def paged_visibility(start: torch.Tensor, live: torch.Tensor, window: int, n_phys: int) -> torch.Tensor:
    """(B, n_phys) bool: physical position r is visible iff its logical
    position ``(r - start) mod window`` lies in ``[window - live, window)``
    and ``r < window`` (a partial last page's tail is never visible)."""
    r = torch.arange(n_phys, device=start.device)[None, :]
    lp = (r - start[:, None]) % window
    return (lp >= (window - live)[:, None]) & (r < window)


def _page_has_live(i, start, live, window: int, page_size: int):
    """Does physical page ``i`` hold any live position? The live region is
    the ring interval [start - live, start) mod window."""
    p0 = i * page_size
    p1 = min(p0 + page_size, window) - 1
    s0 = (start - live) % window
    return (live > 0) & (((s0 >= p0) & (s0 <= p1)) | ((p0 - s0) % window < live))


# Pages one split block may take (``kMaxPages`` in csrc/paged_attention.cu).
MAX_SPLIT_PAGES = 64
# Blocks a B3/B4 launch asks for on each SM. More than B2's: on the H100 at
# the flagship shapes, one page a split ran faster than two.
PAGED_SPLIT_BLOCKS_PER_SM = 8


def paged_splits(rows: int, heads: int, window: int, page_size: int, num_sms: int) -> int:
    """Splits S per (row, head) of a B3/B4 launch on a card with ``num_sms``
    SMs: about ``PAGED_SPLIT_BLOCKS_PER_SM`` blocks an SM, one split per
    ``MAX_SPLIT_SLOTS`` window positions, never more splits than the
    window's pages and never more than ``MAX_SPLIT_PAGES`` pages a split."""
    pages = -(-window // page_size)
    want = max(-(-PAGED_SPLIT_BLOCKS_PER_SM * num_sms // (rows * heads)), -(-window // MAX_SPLIT_SLOTS))
    return max(1, min(want, pages), -(-pages // MAX_SPLIT_PAGES))


def paged_split_rows(start: int, live: int, window: int, page_size: int,
                     num_splits: int) -> List[Tuple[List[int], List[int]]]:
    """What each split block of one row (B4: after ``fold_causal_bound``)
    reads, by the kernel's own arithmetic (``csrc/paged_attention.cu``):
    ``(pages, positions)`` per split, the ring walk's pages (as indices into
    the row's page table) and the physical positions whose key and value rows
    it loads. The live ring interval touches ``count`` pages, walked in ring
    order from the page of the oldest live position; split k of
    n_k = max(1, min(S, count)) takes walk pages [k count / n_k,
    (k + 1) count / n_k)."""
    ps = page_size
    live = min(max(live, 0), window)
    pw = -(-window // ps)
    a0 = count = 0
    if live > 0:
        s0 = (start - live) % window
        e = s0 + live
        a0 = s0 // ps
        count = (e - 1) // ps - a0 + 1 if e <= window else min(pw, (pw - a0) + (e - window - 1) // ps + 1)
    n_k = max(1, min(num_splits, count))
    splits = []
    for k in range(n_k):
        j0, npg = k * count // n_k, (k + 1) * count // n_k - k * count // n_k
        pages = [(a0 + j0 + j) % pw for j in range(npg)]
        rows = [pi * ps + o for pi in pages for o in range(ps)]
        splits.append((pages, [rr for rr in rows if rr < window and (rr - start) % window >= window - live]))
    return splits


def check_paged_args(q, kp, vp, page_table, start, live, rope_k, window, k_scale, v_scale, qbits):
    """Shapes and types both paged-attention wrappers take; raises on others."""
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (B, H, 1, D), got shape {tuple(q.shape)}")
    w, h, _, d = q.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both scales or neither")
    quantized = k_scale is not None
    c_phys = h * d // 2 if quantized and qbits == 4 else h * d
    if kp.dim() != 3 or kp.shape[2] != c_phys or vp.shape != kp.shape:
        raise ValueError(f"kp/vp must be (N, page_size, {c_phys}), got {tuple(kp.shape)} and {tuple(vp.shape)}")
    want = {None: None, 8: torch.int8, 4: torch.uint8}[qbits if quantized else None]
    if quantized and kp.dtype != want:
        raise ValueError(f"a {qbits}-bit pool must be {want}, got {kp.dtype}")
    if quantized and (tuple(k_scale.shape) != (kp.shape[0], h) or k_scale.shape != v_scale.shape):
        raise ValueError(f"k_scale/v_scale must be (N, H) = ({kp.shape[0]}, {h}), got {tuple(k_scale.shape)}")
    if not quantized and kp.dtype != q.dtype:
        raise ValueError(f"an fp pool must share q's dtype, got {kp.dtype} and {q.dtype}")
    ps = kp.shape[1]
    p = page_table.shape[1]
    if page_table.dim() != 2 or page_table.shape[0] != w or not 1 <= window <= p * ps:
        raise ValueError(f"page_table must be (B, P) with window <= P * page_size, got {tuple(page_table.shape)},"
                         f" window {window}, page size {ps}")
    if rope_k.dim() != 3 or tuple(rope_k.shape[:2]) != (w, p * ps):
        raise ValueError(f"rope_k must be (B, P * page_size, r) = ({w}, {p * ps}, r), got {tuple(rope_k.shape)}")
    r = rope_k.shape[2]
    if r % 2 or r > d or d % 2:
        raise ValueError(f"rotary width r={r} must be even and at most the (even) head dim {d}")


def paged_attention_plain(q, kp, vp, page_table, start, live, rope_k, window, k_scale=None, v_scale=None,
                          qbits=8) -> torch.Tensor:
    """The plain PyTorch version of kernels B3 and B4 on any device: gather
    the pages, dequantize (float32 codes x scale) before rotating, mask with
    ``paged_visibility``, -inf scores, sums in float32 (or wider) and zeros
    for a row that sees nothing (l clamped at 1e-30)."""
    w, h, _, d = q.shape
    wide = torch.promote_types(q.dtype, torch.float32)
    cache = PagedKVCache(kp, vp, page_table, start, window, k_scale, v_scale, num_heads=h, qbits=qbits)
    k, v = cache.gather_dense()
    n_phys = k.shape[1]
    split = lambda t: t.reshape(w, n_phys, h, d).transpose(1, 2).to(wide)
    kr = apply_rope(split(k), rope_k.to(torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wide), kr)
    visible = paged_visibility(_rows(start, w, q.device), _rows(live, w, q.device), window, n_phys)
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, split(v)) / l
    return o.to(q.dtype)


def fused_paged_decode_attention_reference(q, kp, vp, page_table, start, live, rope_k, window, k_scale=None,
                                           v_scale=None) -> torch.Tensor:
    """The plain version of kernel B3 (fp and int8 pools)."""
    return paged_attention_plain(q, kp, vp, page_table, start, live, rope_k, window, k_scale, v_scale, qbits=8)


def fused_paged_decode_attention(
    q: torch.Tensor,
    kp: torch.Tensor,
    vp: torch.Tensor,
    page_table: torch.Tensor,
    start: torch.Tensor,
    live: torch.Tensor,
    rope_k: torch.Tensor,
    window: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q (B, H, 1, D) scaled and rotated single queries; kp/vp (N, ps, H*D)
    unrotated fp pool of q's dtype, or int8 with ``k_scale``/``v_scale``
    (N, H); page_table (B, P); start (B,) post-append ring offsets; live (B,)
    live counts; rope_k (B, P*ps, r) float32 angles per physical position.
    Returns (B, H, 1, D) in q's dtype."""
    global launches
    check_paged_args(q, kp, vp, page_table, start, live, rope_k, window, k_scale, v_scale, qbits=8)
    if q.device.type == "cpu":
        return fused_paged_decode_attention_reference(q, kp, vp, page_table, start, live, rope_k, window,
                                                      k_scale, v_scale)
    out = launch(False, q, kp, vp, page_table, start, live, None, rope_k, window, k_scale, v_scale, qbits=8)
    launches += 1
    return out


# ------------------------------------------------------------------ the card
_POOL_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
_fns = {}


def _entry(name: str):
    """A C entry point of the paged-attention library, built and loaded at
    first use (never at import)."""
    if name not in _fns:
        from perceiver_io_torch.ops.cuda_build import library

        fn = getattr(library("paged_attention"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        # q kp vp table start live [cb] ang kscale vscale out W H D P ps window r pool_kind q_dtype splits
        # ws counters stream
        fn.argtypes = [p] * (6 + (name == "ragged_paged_attention")) + [p] * 4 + [i] * 10 + [p] * 3
        fn.restype = i
        _fns[name] = fn
    return _fns[name]


def launch(ragged: bool, q, kp, vp, page_table, start, live, causal_bound, rope_k, window, k_scale, v_scale,
           qbits) -> torch.Tensor:
    """Launch B3 (``ragged=False``) or B4 on the current stream, or raise.
    The callers count their own launches."""
    w, h, _, d = q.shape
    idx = [_rows(x, w, q.device).contiguous() for x in (start, live)]
    if ragged:
        idx.append(_rows(causal_bound, w, q.device).contiguous())
    tensors = {"q": q, "kp": kp, "vp": vp, "page_table": page_table, "rope_k": rope_k}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged attention on a non-CPU device needs CUDA tensors on one card; {name} is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged attention needs contiguous tensors; {name} is not")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA paged-attention kernel takes float32 or bfloat16 queries, got {q.dtype}")
    if page_table.dtype != torch.int32 or rope_k.dtype != torch.float32:
        raise ValueError(f"page_table must be int32 and rope_k float32, got {page_table.dtype} and {rope_k.dtype}")
    if k_scale is not None and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("k_scale and v_scale must be float32")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA paged-attention kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    splits = paged_splits(w, h, window, kp.shape[1], num_sms(q.device))
    stream = torch.cuda.current_stream(q.device)
    ws = cnt = None
    if splits > 1:
        ws, cnt = split_workspace(stream, w * h * splits * (d + 2), w * h)
    out = torch.empty_like(q)
    err = _entry("ragged_paged_attention" if ragged else "paged_decode_attention")(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), page_table.data_ptr(), *[t.data_ptr() for t in idx],
        rope_k.data_ptr(), _ptr(k_scale), _ptr(v_scale), out.data_ptr(),
        w, h, d, page_table.shape[1], kp.shape[1], window, rope_k.shape[2], _POOL_KINDS[kp.dtype], _DTYPES[q.dtype],
        splits, _ptr(ws), _ptr(cnt), stream.cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA error {err}")
    return out

