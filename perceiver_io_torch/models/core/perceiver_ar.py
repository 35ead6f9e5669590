"""Perceiver AR: long-context causal modelling through latent compression.

Port of ``perceiver_io_tpu/models/core/perceiver_ar.py`` (``PerceiverARCache``,
``PagedPerceiverARCache``, ``PerceiverAR`` and ``CausalSequenceModel``: the
uncached forward, cached prefill and decode, and the serving engine's paged
decode and split prefill).

The input is split at ``prefix_len`` into prefix and latents; the latents
attend causally to concat(prefix, latents) through one cross-attention, then
a causal self-attention stack runs over the latents. Decode keeps two
fixed-capacity caches: the cross-attention cache (capacity ``max_seq_len``)
and the stacked self-attention caches (capacity ``max_latents``). Cache slot
``j`` of the cross-attention cache holds sequence position ``max(j - shift,
0)`` where ``shift`` is the row's left-pad count, so every RoPE table is a
function of slot indices.

Sequence parallelism: with ``sequence_parallel_axis`` set, the uncached
forward's cross- and self-attention run as ring attention over that axis of
the ambient mesh (``parallel/ring_attention.py``); the cached entry points
ignore it, as in the JAX package. The parameters are the plain model's.

Training: ``model.train()`` and ``model.eval()`` stand in for the JAX
package's ``deterministic``. In training mode the uncached forward applies
prefix (cross-attention) dropout in "gather" or "mask" mode, attention
dropout and residual dropout, drawing every mask from the caller's CPU
``generator`` through seeds (``ops.layers.next_seed``); the self-attention
layers run under activation checkpointing when the config asks for it. The
cached (inference) entry points run under ``torch.no_grad``: they write the
caches in place, and a graph through those writes would keep old buffers
alive.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_torch.models.core.adapter import TiedTokenOutputAdapter, TokenInputAdapterWithRotarySupport
from perceiver_io_torch.models.core.config import CausalSequenceModelConfig
from perceiver_io_torch.models.core.modules import LN_EPS, CrossAttentionLayer, SelfAttentionBlock
from perceiver_io_torch.ops.attention import KVCache
from perceiver_io_torch.ops.paged_decode_kernel import KV_QUANT_MODES, PagedKVCache, quant_mode_qbits
from perceiver_io_torch.ops.layers import LayerNorm, next_seed, reset_parameters, seeded_generator
from perceiver_io_torch.ops.position import frequency_position_encoding, positions


@dataclass
class PerceiverARCache:
    """Decode state.

    ``ca``: cross-attention KV cache (capacity ``max_seq_len``).
    ``sa``: stacked self-attention KV caches (capacity ``max_latents``).
    ``pad_slots``: (B, max_seq_len) bool, True where a ``ca`` slot holds a
        padding token; rolled in lockstep with ``ca``.
    ``shift``: (B, 1) int32 left-pad count.
    ``live``: (B,) int32 live (non-pad) entries per row; the live region is the
        tail ``[ca.length - live, ca.length)`` of the valid slots.
    Methods update the state in place and return it; a decode step writes
    into the tensors the cache holds and never replaces one, so a CUDA graph
    captured over it replays against the same buffers.
    """

    ca: KVCache
    sa: KVCache
    pad_slots: torch.Tensor
    shift: torch.Tensor
    live: torch.Tensor

    @property
    def seq_len(self) -> int:
        return self.ca.length

    def rewind(self, k: int) -> "PerceiverARCache":
        """Drop the ``k`` most recently appended tokens by rewinding the
        lengths. Exact only when none of those appends rolled the buffers (the
        no-roll contract of ``decode_block``)."""
        self.ca.length = max(self.ca.length - k, 0)
        self.sa.length = [max(n - k, 0) for n in self.sa.length]
        self.live = (self.live - k).clamp_min(0)
        return self

    def write_slot(self, slot: int, src: "PerceiverARCache") -> "PerceiverARCache":
        """Install a batch-1 cache ``src`` into batch row ``slot``. Lengths are
        kept from ``self``. A ``src`` prefilled at a smaller cross-attention
        capacity is widened into the tail: the head becomes masked left-pad
        (zero keys, ``pad_slots`` True, ``shift`` grown by the offset)."""
        off = self.ca.capacity - src.ca.capacity
        if off:
            b = src.pad_slots.shape[0]
            widen = lambda t: torch.cat([t.new_zeros(b, off, t.shape[-1]), t], dim=1)
            src = PerceiverARCache(
                ca=KVCache(k=widen(src.ca.k), v=widen(src.ca.v), length=src.ca.length),
                sa=src.sa,
                pad_slots=torch.cat([src.pad_slots.new_ones(b, off), src.pad_slots], dim=1),
                shift=src.shift + off,
                live=src.live,
            )
        self.ca.write_batch_row(slot, src.ca)
        self.sa.write_batch_row(slot, src.sa)
        self.pad_slots[slot] = src.pad_slots[0]
        self.shift[slot] = src.shift[0]
        self.live[slot] = src.live[0]
        return self


def _make_ar_cache(batch_size: int, max_seq_len: int, max_latents: int, num_layers: int, num_channels: int,
                   dtype=torch.float32, device=None) -> PerceiverARCache:
    return PerceiverARCache(
        ca=KVCache.create(batch_size, max_seq_len, num_channels, num_channels, dtype, device),
        sa=KVCache.create_stacked(num_layers, batch_size, max_latents, num_channels, num_channels, dtype, device),
        pad_slots=torch.zeros(batch_size, max_seq_len, dtype=torch.bool, device=device),
        shift=torch.zeros(batch_size, 1, dtype=torch.int32, device=device),
        live=torch.zeros(batch_size, dtype=torch.int32, device=device),
    )


@dataclass
class PagedPerceiverARCache:
    """Paged decode state of a serving pool: the cross-attention KV lives in
    a shared page pool (``ca``, a ``PagedKVCache``) addressed through per-slot
    page tables; the small self-attention cache (``sa``, capacity
    ``max_latents``) stays dense. Every row sits at full window occupancy, so
    validity is ``live`` plus the ring offset ``ca.start``: there is no
    pad-slot buffer and no shared length. ``shift`` (B, 1) and ``live`` (B,)
    are as in ``PerceiverARCache``. Methods update the state in place."""

    ca: PagedKVCache
    sa: KVCache
    shift: torch.Tensor
    live: torch.Tensor

    def rewind(self, k: int) -> "PagedPerceiverARCache":
        """Un-append the ``k`` most recent tokens by stepping the ring offset
        back (their pages stay allocated and the next append overwrites)."""
        self.ca.start = (self.ca.start - k) % self.ca.window
        self.sa.length = [max(n - k, 0) for n in self.sa.length]
        self.live = (self.live - k).clamp_min(0)
        return self

    def install_slot(self, slot: int, table_row: torch.Tensor, src: PerceiverARCache) -> "PagedPerceiverARCache":
        """Install a bucket-prefilled request (``src``: a batch-1 dense cache
        at bucket capacity) into pool slot ``slot`` whose page-table row
        becomes ``table_row`` (P,). The bucket's left-pad is rolled out so
        prompt token i lands at physical ring position i, and the ring offset
        starts at ``n mod window`` (n the live prompt length): ring slot i
        holds logical position ``window - n + i``, so ``shift`` grows by
        ``window - bucket``. The rolled-out pad rows sit past position n,
        never visible; quantized pools zero them first (they would inflate
        their page's scale) and reset the whole reservation's scales."""
        ps, window = self.ca.page_size, self.ca.window
        bucket = src.ca.capacity
        nb = -(-bucket // ps)  # pages holding the prompt (and the inert tail)
        n = int(src.live[0])
        shift = bucket - n
        rows = lambda t: torch.cat([t[0].roll(-shift, dims=0), t.new_zeros(nb * ps - bucket, t.shape[-1])])
        kc, vc = rows(src.ca.k), rows(src.ca.v)
        table_row = table_row.to(self.ca.page_table.device)
        if self.ca.quantized:
            kc[n:] = 0
            vc[n:] = 0
            self.ca.reset_page_scales(table_row)
        self.ca.write_pages(table_row[:nb], kc.reshape(nb, ps, -1), vc.reshape(nb, ps, -1))
        self.ca.page_table[slot] = table_row
        self.ca.start[slot] = n % window
        self.sa.write_batch_row(slot, src.sa)
        self.shift[slot] = src.shift[0] + (window - bucket)
        self.live[slot] = src.live[0]
        return self

    def install_finish(self, slot: int, table_row: torch.Tensor, sa_src: KVCache,
                       live: int) -> "PagedPerceiverARCache":
        """Install a split-prefilled request whose KV rows already sit
        page-aligned in its pages: point the table at them, set the ring
        offset to ``live mod window``, write the finish's self-attention
        cache and pin shift/live as ``install_slot`` would for ``live``
        prompt tokens."""
        window = self.ca.window
        self.ca.page_table[slot] = table_row.to(self.ca.page_table.device)
        self.ca.start[slot] = live % window
        self.sa.write_batch_row(slot, sa_src)
        self.shift[slot] = window - live
        self.live[slot] = live
        return self

    def release_slot(self, slot: int) -> "PagedPerceiverARCache":
        """Reset slot ``slot`` to the free form: table all trash page, ring
        offset 0, live pinned at the window. A freed slot keeps decoding, so
        a stale table entry would write into a page since given to another
        request."""
        self.ca.page_table[slot] = 0
        self.ca.start[slot] = 0
        self.shift[slot] = 0
        self.live[slot] = self.ca.window
        return self


def _make_paged_ar_cache(batch_size: int, max_seq_len: int, max_latents: int, num_layers: int, num_channels: int,
                         num_pages: int, page_size: int, dtype=torch.float32, num_heads: int = 1,
                         kv_quant: Optional[str] = None, device=None) -> PagedPerceiverARCache:
    """A shared (num_pages, page_size, C) pool (page 0 the trash page),
    per-slot page tables over ceil(max_seq_len / page_size) pages, dense
    self-attention caches. ``kv_quant`` "int8" stores int8 codes, "int4"
    nibble pairs (C // 2 uint8), each with per-page-per-head float32 scales."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if page_size > max_seq_len:
        raise ValueError(f"page_size ({page_size}) exceeds the window ({max_seq_len})")
    if num_pages < 2:
        raise ValueError(f"num_pages must be >= 2 (page 0 is the reserved trash page), got {num_pages}")
    if kv_quant is not None and kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"kv_quant must be one of {KV_QUANT_MODES} or None, got {kv_quant!r}")
    if kv_quant is not None and num_channels % max(num_heads, 1) != 0:
        raise ValueError("num_channels must divide evenly over num_heads for per-head scales")
    qbits = quant_mode_qbits(kv_quant)
    if kv_quant is not None and qbits == 4 and num_channels % 2 != 0:
        raise ValueError(f"kv_quant='int4' nibble-packs channel pairs: num_channels must be even, got {num_channels}")
    pool_dtype = (torch.uint8 if qbits == 4 else torch.int8) if kv_quant else dtype
    pool_channels = num_channels // 2 if (kv_quant and qbits == 4) else num_channels
    pool = lambda: torch.zeros(num_pages, page_size, pool_channels, dtype=pool_dtype, device=device)
    scales = lambda: torch.zeros(num_pages, num_heads, dtype=torch.float32, device=device) if kv_quant else None
    return PagedPerceiverARCache(
        ca=PagedKVCache(
            kp=pool(), vp=pool(),
            page_table=torch.zeros(batch_size, -(-max_seq_len // page_size), dtype=torch.int32, device=device),
            start=torch.zeros(batch_size, dtype=torch.int32, device=device),
            window=max_seq_len, k_scale=scales(), v_scale=scales(),
            num_heads=num_heads if kv_quant else 1, qbits=qbits,
        ),
        sa=KVCache.create_stacked(num_layers, batch_size, max_latents, num_channels, num_channels, dtype, device),
        shift=torch.zeros(batch_size, 1, dtype=torch.int32, device=device),
        live=torch.full((batch_size,), max_seq_len, dtype=torch.int32, device=device),
    )


def prefix_dropout_draws(mode: str, rate: float, shape, generator: Optional[torch.Generator],
                         device) -> torch.Tensor:
    """The random draws of prefix dropout, made in this one place (tests
    replace it to hand both packages the same numbers): uniform [0, 1)
    numbers of ``shape`` for "gather" (the kept positions are the largest
    ``keep``), Bernoulli(``rate``) drops (bool, True = dropped) for "mask"."""
    u = torch.rand(shape, generator=generator, device=device)
    return u if mode == "gather" else u < rate


class PerceiverAR(nn.Module):
    """Perceiver AR over a token input adapter with rotary support."""

    def __init__(self, input_adapter: TokenInputAdapterWithRotarySupport, num_heads: int = 8,
                 num_self_attention_layers: int = 6, num_self_attention_rotary_layers: int = 1,
                 self_attention_widening_factor: int = 4, cross_attention_widening_factor: int = 4,
                 cross_attention_dropout: float = 0.5, cross_attention_dropout_mode: str = "gather",
                 post_attention_dropout: float = 0.0, residual_dropout: float = 0.0,
                 activation_checkpointing: bool = False, remat_policy: Optional[str] = None,
                 init_scale: float = 0.02, sequence_parallel_axis: Optional[str] = None, dtype=None,
                 param_dtype=torch.float32, device=None, activation_offloading: bool = False):
        super().__init__()
        c = input_adapter.num_input_channels
        kw = dict(init_scale=init_scale, seq_axis=sequence_parallel_axis, dtype=dtype, param_dtype=param_dtype,
                  device=device)
        self.input_adapter = input_adapter
        self.cross_attention_dropout = cross_attention_dropout
        self.cross_attention_dropout_mode = cross_attention_dropout_mode
        drop = dict(dropout=post_attention_dropout, residual_dropout=residual_dropout)
        self.cross_attention = CrossAttentionLayer(
            num_heads, c, causal_attention=True, widening_factor=cross_attention_widening_factor,
            qkv_bias=False, out_bias=True, mlp_bias=False, **drop, **kw,
        )
        self.self_attention = SelfAttentionBlock(
            num_self_attention_layers, num_heads, c, num_rotary_layers=num_self_attention_rotary_layers,
            causal_attention=True, widening_factor=self_attention_widening_factor,
            activation_checkpointing=activation_checkpointing, remat_policy=remat_policy,
            activation_offloading=activation_offloading, qkv_bias=False, out_bias=False, mlp_bias=False, **drop,
            **kw,
        )

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return self.input_adapter.attend(x)

    def _rotated_dim(self) -> int:
        return self.input_adapter.rotated_channels_per_head

    # ------------------------------------------------------------------ uncached
    def forward(self, x: torch.Tensor, prefix_len: int, pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Uncached forward over tokens ``x`` (B, N); returns the latents'
        hidden states (B, N - prefix_len, C). In training mode ``generator``
        (a CPU generator; None: PyTorch's default) seeds every dropout mask.
        With ``sequence_parallel_axis`` every attention runs as ring attention
        over the ambient mesh (``parallel.mesh.set_mesh``), and raises without
        one; the kept prefix plus the latents and the latents alone must then
        divide by the axis size.

        Prefix dropout, as the JAX package: "gather" keeps a fixed count
        ``prefix_len - int(prefix_len * p)`` of prefix positions per row (the
        top of uniform draws, in their original order) and gathers the
        embeddings, rotary angles and pad flags; "mask" ORs Bernoulli(p)
        drops into the prefix pad mask."""
        b, n = x.shape
        if not 0 <= prefix_len < n:
            raise ValueError(f"prefix_len ({prefix_len}) out of valid range [0..{n})")
        dev = x.device
        shift = None if pad_mask is None else pad_mask.sum(dim=1, keepdim=True)
        x_emb, frq = self.input_adapter(x, abs_pos=positions(b, n, shift=shift, device=dev))

        x_latent, x_prefix = x_emb[:, prefix_len:], x_emb[:, :prefix_len]
        frq_latent, frq_prefix = frq[:, prefix_len:], frq[:, :prefix_len]
        pad_latent = None if pad_mask is None else pad_mask[:, prefix_len:]
        pad_prefix = None if pad_mask is None else pad_mask[:, :prefix_len]

        rate, mode = self.cross_attention_dropout, self.cross_attention_dropout_mode
        if self.training and prefix_len > 0 and rate > 0.0:
            draw = functools.partial(prefix_dropout_draws, mode, rate, (b, prefix_len),
                                     seeded_generator(next_seed(generator), dev), dev)
            if mode == "mask":
                dropped = draw()
                pad_prefix = dropped if pad_prefix is None else pad_prefix | dropped
            elif mode == "gather":
                keep = prefix_len - int(prefix_len * rate)
                idx = draw().topk(keep, dim=1).indices.sort(dim=1).values
                take = lambda t: t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))
                x_prefix, frq_prefix = take(x_prefix), take(frq_prefix)
                if pad_prefix is not None:
                    pad_prefix = pad_prefix.gather(1, idx)
            else:
                raise ValueError(f"unknown cross_attention_dropout_mode '{mode}'")

        if pad_prefix is None and pad_latent is None:
            pad_full = None
        else:
            pp = pad_prefix if pad_prefix is not None else torch.zeros(b, x_prefix.shape[1], dtype=torch.bool,
                                                                       device=dev)
            pl = pad_latent if pad_latent is not None else torch.zeros(b, n - prefix_len, dtype=torch.bool,
                                                                       device=dev)
            pad_full = torch.cat([pp, pl], dim=1)
        ca_gen = seeded_generator(next_seed(generator), dev) if self.cross_attention.draws else None
        x_latent, _ = self.cross_attention(
            x_latent, x_kv_prefix=x_prefix, pad_mask=pad_full, rope_q=frq_latent,
            rope_k=torch.cat([frq_prefix, frq_latent], dim=1), generator=ca_gen,
        )
        x_latent, _ = self.self_attention(x_latent, rope_q=frq_latent, rope_k=frq_latent, generator=generator)
        return x_latent

    # ------------------------------------------------------------------- cached
    def init_cache(self, batch_size: int, max_seq_len: int, max_latents: int, dtype=torch.float32,
                   device=None) -> PerceiverARCache:
        return _make_ar_cache(batch_size, max_seq_len, max_latents, len(self.self_attention.layers),
                              self.input_adapter.num_input_channels, dtype, device)

    @torch.no_grad()
    def prefill(self, x: torch.Tensor, prefix_len: int, cache: PerceiverARCache,
                pad_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, PerceiverARCache]:
        """Process a prompt (B, N) into ``cache`` (reset first); N - prefix_len
        latents. Eval mode only (dropout has no cached form)."""
        if self.training:
            raise ValueError("cached prefill runs in eval mode (dropout is not supported with caching); "
                             "call model.eval()")
        b, n = x.shape
        ca_cap, sa_cap = cache.ca.capacity, cache.sa.capacity
        if not 0 <= prefix_len < n:
            raise ValueError(f"prefix_len ({prefix_len}) out of valid range [0..{n})")
        if n > ca_cap or (n - prefix_len) > sa_cap:
            raise ValueError("prompt does not fit cache capacities")
        cache.ca.reset()
        cache.sa.reset()
        dev = x.device
        rot = self._rotated_dim()

        if pad_mask is None:
            shift = torch.zeros(b, 1, dtype=torch.int32, device=dev)
        else:
            shift = pad_mask.sum(dim=1, keepdim=True).to(torch.int32)
        x_emb, frq = self.input_adapter(x, abs_pos=positions(b, n, shift=shift))
        x_latent, x_prefix = x_emb[:, prefix_len:], x_emb[:, :prefix_len]
        frq_latent = frq[:, prefix_len:]

        # RoPE over cross-attention cache slots: slot j is position j - shift
        slot_pos = (torch.arange(ca_cap, device=dev)[None, :] - shift).clamp_min(0)
        rope_k_ca = frequency_position_encoding(slot_pos, rot)
        pad_slots = torch.zeros(b, ca_cap, dtype=torch.bool, device=dev)
        if pad_mask is not None:
            pad_slots[:, :n] = pad_mask
        live = n - shift[:, 0]

        x_latent, ca_cache = self.cross_attention(
            x_latent, x_kv_prefix=x_prefix, pad_mask=pad_slots, rope_q=frq_latent, rope_k=rope_k_ca,
            kv_cache=cache.ca, kv_live=live,
        )
        # self-attention slot j will hold latent j, at position prefix_len + j
        sa_slot_pos = (prefix_len + torch.arange(sa_cap, device=dev)[None, :] - shift).clamp_min(0)
        rope_k_sa = frequency_position_encoding(sa_slot_pos, rot)
        x_latent, sa_cache = self.self_attention(x_latent, rope_q=frq_latent, rope_k=rope_k_sa, kv_cache=cache.sa)
        cache.ca, cache.sa, cache.pad_slots, cache.shift, cache.live = ca_cache, sa_cache, pad_slots, shift, live
        return x_latent, cache

    @torch.no_grad()
    def decode_block(self, x: torch.Tensor, cache: PerceiverARCache) -> Tuple[torch.Tensor, PerceiverARCache]:
        """Decode ``n`` tokens ``x`` (B, n) in one forward; each attends
        causally to the cache and its block predecessors.

        ``n == 1`` is the general sliding-window step: full caches roll their
        oldest entry out. ``n > 1`` carries a NO-ROLL CONTRACT: the caller
        guarantees ``length + n <= capacity`` for both caches, so the block
        sees what n single steps would and ``cache.rewind`` is exact."""
        b, n = x.shape
        ca_cap, sa_cap = cache.ca.capacity, cache.sa.capacity
        rot = self._rotated_dim()
        dev = x.device

        n_after = min(cache.ca.length + n, ca_cap)  # window length after the append
        q_pos = (n_after - n + torch.arange(n, device=dev)[None, :] - cache.shift).clamp_min(0)  # (B, n)
        x_emb, frq_q = self.input_adapter(x, abs_pos=q_pos)

        if n == 1:
            if cache.ca.length >= ca_cap:  # roll the pad-slot mask with the cache
                cache.pad_slots.copy_(cache.pad_slots.roll(-1, dims=1))
            write_pos = min(cache.ca.length, ca_cap - 1)
        else:
            write_pos = cache.ca.length
        cache.pad_slots[:, write_pos : write_pos + n] = False

        slot_pos = (torch.arange(ca_cap, device=dev)[None, :] - cache.shift).clamp_min(0)
        rope_k_ca = frequency_position_encoding(slot_pos, rot)
        # while the buffer is full every append rolls a left-pad (or, once none
        # remain, a live token) out of the head: live saturates at capacity
        live = (cache.live + n).clamp_max(ca_cap)

        x_latent, _ = self.cross_attention(
            x_emb, x_kv_prefix=x_emb[:, :0], pad_mask=cache.pad_slots, rope_q=frq_q, rope_k=rope_k_ca,
            kv_cache=cache.ca, kv_live=live,
        )
        # self-attention slot j holds the (j+1)-th oldest latent, at position
        # n_after - sa_len_after + j
        sa_len_after = min(cache.sa.length[0] + n, sa_cap)
        sa_slot_pos = (n_after - sa_len_after + torch.arange(sa_cap, device=dev)[None, :] - cache.shift).clamp_min(0)
        rope_k_sa = frequency_position_encoding(sa_slot_pos, rot)
        x_latent, _ = self.self_attention(x_latent, rope_q=frq_q, rope_k=rope_k_sa, kv_cache=cache.sa)
        cache.live.copy_(live)
        return x_latent, cache

    @torch.no_grad()
    def decode_step(self, x: torch.Tensor, cache: PerceiverARCache) -> Tuple[torch.Tensor, PerceiverARCache]:
        """One decode step with tokens ``x`` (B, 1); see ``decode_block``."""
        if x.shape[1] != 1:
            raise ValueError("decode_step processes one token at a time; use decode_block for chunks")
        return self.decode_block(x, cache)

    @torch.no_grad()
    def decode_step_paged(self, x: torch.Tensor, cache: PagedPerceiverARCache
                          ) -> Tuple[torch.Tensor, PagedPerceiverARCache]:
        """``decode_block`` with n = 1 against the paged pool: every row is
        at full window occupancy, so the append is the ring write
        ``PagedKVCache.append_token`` and the window's re-positioning is
        arithmetic. Ring slot r holds logical position
        ``(r - start_after) mod window``: the RoPE table and the visibility
        bound are per physical slot, from the post-append ring offset."""
        b, n = x.shape
        if n != 1:
            raise ValueError("paged decode processes one token at a time")
        window = cache.ca.window
        rot = self._rotated_dim()
        dev = x.device

        q_pos = (window - 1 - cache.shift).clamp_min(0)  # (B, 1)
        x_emb, frq_q = self.input_adapter(x, abs_pos=q_pos)
        start_after = (cache.ca.start + 1) % window
        live = (cache.live + 1).clamp_max(window)
        n_phys = cache.ca.pages_per_slot * cache.ca.page_size
        logical = (torch.arange(n_phys, device=dev)[None, :] - start_after[:, None]) % window
        rope_k_ca = frequency_position_encoding((logical - cache.shift).clamp_min(0), rot)

        x_latent, _ = self.cross_attention(
            x_emb, x_kv_prefix=x_emb[:, :0], rope_q=frq_q, rope_k=rope_k_ca, kv_cache=cache.ca, kv_live=live,
        )
        # dense self-attention over the latents, as decode_block n=1 with a full window
        sa_cap = cache.sa.capacity
        sa_len_after = min(cache.sa.length[0] + 1, sa_cap)
        sa_slot_pos = (window - sa_len_after + torch.arange(sa_cap, device=dev)[None, :] - cache.shift).clamp_min(0)
        rope_k_sa = frequency_position_encoding(sa_slot_pos, rot)
        x_latent, _ = self.self_attention(x_latent, rope_q=frq_q, rope_k=rope_k_sa, kv_cache=cache.sa)
        cache.live.copy_(live)
        return x_latent, cache

    # ---------------------------------------------------------- split prefill
    @torch.no_grad()
    def prefill_chunk_kv(self, x: torch.Tensor, abs_pos: torch.Tensor,
                         latent_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention KV rows for prompt tokens ``x`` (1, c) at absolute
        positions ``abs_pos``: embed, norm (``q_norm`` where ``latent_mask``
        marks the prompt's latent region, as the one-shot prefill's concat),
        project. No attention."""
        x_emb, _ = self.input_adapter(x, abs_pos=abs_pos)
        return self.cross_attention.prefill_chunk_kv(x_emb, latent_mask)

    @torch.no_grad()
    def prefill_latents_paged(self, x: torch.Tensor, n_live: int, ca: PagedKVCache,
                              table_row: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """The split prefill's finish: latents for a slot whose prompt KV
        already sits page-aligned in the pool. ``x`` (1, L = max_latents) are
        the prompt's last L tokens, ``n_live`` >= L the prompt length. Ring
        position r holds prompt position r, visible to latent j iff r < n and
        r <= n - L + j; then the self-attention stack fills a fresh batch-1
        cache, in the compute dtype (a quantized pool's rows arrive
        dequantized in float32)."""
        b, latents = x.shape
        window = ca.window
        rot = self._rotated_dim()
        n = int(n_live)
        dev = x.device
        q_pos = (n - latents + torch.arange(latents, device=dev)[None, :]).clamp_min(0)
        x_emb, frq_q = self.input_adapter(x, abs_pos=q_pos)

        k_rows, v_rows = ca.gather_slot(table_row.to(dev))
        n_phys = k_rows.shape[1]
        r = torch.arange(n_phys, device=dev)[None, :]
        logical = (r - n % window) % window
        rope_k = frequency_position_encoding((logical - (window - n)).clamp_min(0), rot)
        live_ok = (logical >= window - n) & (r < window)  # (1, n_phys)
        causal = logical[:, None, :] <= (window - latents + torch.arange(latents, device=dev))[None, :, None]
        visible = live_ok[:, None, :] & causal  # (1, L, n_phys)

        x_latent = self.cross_attention.prefill_latents_paged(x_emb, k_rows, v_rows, visible, rope_q=frq_q,
                                                              rope_k=rope_k)
        sa_fresh = KVCache.create_stacked(len(self.self_attention.layers), b, latents,
                                          self.input_adapter.num_input_channels,
                                          self.input_adapter.num_input_channels, x_latent.dtype, dev)
        rope_k_sa = frequency_position_encoding(q_pos, rot)
        return self.self_attention(x_latent, rope_q=frq_q, rope_k=rope_k_sa, kv_cache=sa_fresh)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; there is no silent fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class CausalSequenceModel(nn.Module):
    """Perceiver AR + token input adapter + optional final LayerNorm + tied
    token head.

    ``device`` defaults to the card (and raises if there is none); ``dtype``
    is the compute dtype (``None``: the parameter dtype), ``param_dtype``
    the storage dtype of the weights, which are initialised from ``seed``
    (load real weights with ``convert_jax.load_jax_params``)."""

    def __init__(self, config: CausalSequenceModelConfig, device=None, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.param_dtype = param_dtype
        device = resolve_device(device)
        num_rotated = config.num_channels // config.num_heads
        if config.abs_pos_emb:
            num_rotated //= 2  # rotary embedding only for the first half of each head's channels
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        adapter = TokenInputAdapterWithRotarySupport(
            num_rotated, config.vocab_size, config.max_seq_len, config.num_channels,
            abs_pos_emb=config.abs_pos_emb, init_scale=config.init_scale, **kw,
        )
        self.ar = PerceiverAR(
            adapter, config.num_heads, config.num_self_attention_layers, config.num_self_attention_rotary_layers,
            config.self_attention_widening_factor, config.cross_attention_widening_factor,
            cross_attention_dropout=config.cross_attention_dropout,
            cross_attention_dropout_mode=config.cross_attention_dropout_mode,
            post_attention_dropout=config.post_attention_dropout, residual_dropout=config.residual_dropout,
            activation_checkpointing=config.activation_checkpointing, remat_policy=config.remat_policy,
            activation_offloading=config.activation_offloading, init_scale=config.init_scale,
            sequence_parallel_axis=config.sequence_parallel_axis, **kw,
        )
        self.out_norm = LayerNorm(config.num_channels, LN_EPS, **kw) if config.output_norm else None
        self.output_adapter = TiedTokenOutputAdapter(config.vocab_size, config.output_bias, param_dtype, device)
        reset_parameters(self, torch.Generator(device).manual_seed(seed))
        self.eval()

    @property
    def device(self) -> torch.device:
        # the embedding's storage (its parameter, or its int8 codes when an
        # engine serves int8 weights), read without dequantizing it
        emb = self.ar.input_adapter.txt_embedding
        return next(iter(emb._parameters.values() or emb._buffers.values())).device

    @property
    def cache_dtype(self) -> torch.dtype:
        return self.dtype if self.dtype is not None else self.param_dtype

    @property
    def max_seq_len(self) -> int:
        return self.config.max_seq_len

    @property
    def max_latents(self) -> int:
        return self.config.max_latents

    @property
    def max_prefix_len(self) -> int:
        return self.config.max_seq_len - self.config.max_latents

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.out_norm is not None:
            hidden = self.out_norm(hidden)
        return self.output_adapter(self.ar.attend(hidden))

    def _check_prefix(self, prefix_len: int) -> None:
        if prefix_len > self.max_prefix_len:
            raise ValueError(f"prefix_len ({prefix_len}) exceeds max_prefix_len ({self.max_prefix_len})")

    def train(self, mode: bool = True) -> "CausalSequenceModel":
        """Training mode (dropout on; ``eval()`` turns it off). Raises for the
        config's pipeline knob, which the port does not run yet (ROADMAP A5),
        rather than training without it."""
        if mode and self.config.pipeline_axis is not None:
            raise NotImplementedError("training with pipeline_axis is not ported yet")
        return super().train(mode)

    def forward(self, x: torch.Tensor, prefix_len: int, pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits (B, N - prefix_len, vocab) over the latent positions;
        ``generator`` seeds the dropout masks in training mode (see
        ``PerceiverAR.forward``)."""
        self._check_prefix(prefix_len)
        return self._head(self.ar(x, prefix_len=prefix_len, pad_mask=pad_mask, generator=generator))

    def init_cache(self, batch_size: int, dtype: Optional[torch.dtype] = None,
                   max_seq_len: Optional[int] = None) -> PerceiverARCache:
        """Empty decode state on the model's device; ``max_seq_len`` overrides
        the cross-attention capacity (bucketed prefill, see ``write_slot``)."""
        return self.ar.init_cache(batch_size, max_seq_len or self.config.max_seq_len, self.config.max_latents,
                                  dtype or self.cache_dtype, self.device)

    @torch.no_grad()
    def prefill_with_hidden(self, x: torch.Tensor, prefix_len: int, cache: PerceiverARCache,
                            pad_mask: Optional[torch.Tensor] = None):
        """(logits, pre-head hidden, cache)."""
        self._check_prefix(prefix_len)
        hidden, cache = self.ar.prefill(x, prefix_len=prefix_len, cache=cache, pad_mask=pad_mask)
        return self._head(hidden), hidden, cache

    def prefill(self, x: torch.Tensor, prefix_len: int, cache: PerceiverARCache,
                pad_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, PerceiverARCache]:
        logits, _, cache = self.prefill_with_hidden(x, prefix_len, cache, pad_mask)
        return logits, cache

    @torch.no_grad()
    def decode_step_with_hidden(self, x: torch.Tensor, cache: PerceiverARCache):
        """(logits, pre-head hidden, cache)."""
        hidden, cache = self.ar.decode_step(x, cache)
        return self._head(hidden), hidden, cache

    @torch.no_grad()
    def decode_step(self, x: torch.Tensor, cache: PerceiverARCache) -> Tuple[torch.Tensor, PerceiverARCache]:
        logits, _, cache = self.decode_step_with_hidden(x, cache)
        return logits, cache

    @torch.no_grad()
    def decode_block(self, x: torch.Tensor, cache: PerceiverARCache) -> Tuple[torch.Tensor, PerceiverARCache]:
        """Decode ``n`` tokens at once (see ``PerceiverAR.decode_block``);
        logits (B, n, vocab)."""
        hidden, cache = self.ar.decode_block(x, cache)
        return self._head(hidden), cache

    def init_paged_cache(self, batch_size: int, num_pages: int, page_size: int, dtype: Optional[torch.dtype] = None,
                         kv_quant: Optional[str] = None) -> PagedPerceiverARCache:
        """Paged decode-pool state for the serving engine, on the model's
        device: a shared KV page pool and per-slot page tables in place of the
        dense per-slot cross-attention cache."""
        cfg = self.config
        return _make_paged_ar_cache(batch_size, cfg.max_seq_len, cfg.max_latents, cfg.num_self_attention_layers,
                                    cfg.num_channels, num_pages, page_size, dtype or self.cache_dtype,
                                    num_heads=cfg.num_heads, kv_quant=kv_quant, device=self.device)

    @torch.no_grad()
    def prefill_chunk_kv(self, x: torch.Tensor, abs_pos: torch.Tensor,
                         latent_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The split prefill's KV rows; see ``PerceiverAR.prefill_chunk_kv``."""
        return self.ar.prefill_chunk_kv(x, abs_pos, latent_mask)

    @torch.no_grad()
    def prefill_finish_paged(self, x: torch.Tensor, n_live: int, ca: PagedKVCache,
                             table_row: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """The split prefill's finish through the head: (last-position logits
        (1, V), the batch-1 self-attention cache to install); see
        ``PerceiverAR.prefill_latents_paged``."""
        hidden, sa_cache = self.ar.prefill_latents_paged(x, n_live, ca, table_row)
        return self._head(hidden)[:, -1], sa_cache

    @torch.no_grad()
    def decode_step_paged(self, x: torch.Tensor,
                          cache: PagedPerceiverARCache) -> Tuple[torch.Tensor, PagedPerceiverARCache]:
        """One decode token against the paged pool; see
        ``PerceiverAR.decode_step_paged``."""
        hidden, cache = self.ar.decode_step_paged(x, cache)
        return self._head(hidden), cache
