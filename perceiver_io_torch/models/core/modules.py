"""Perceiver attention building blocks, encoder and decoder.

Port of ``perceiver_io_tpu/models/core/modules.py``: ``MLP``,
``CrossAttention`` (keys/values are either ``kv_norm(x_kv)``, Perceiver IO,
or the concat of ``kv_norm(prefix)`` and ``q_norm(x_q)``, Perceiver AR; with
the serving engine's split prefill pass-throughs ``prefill_chunk_kv`` and
``prefill_latents_paged``), ``SelfAttention``, ``CrossAttentionLayer``,
``SelfAttentionLayer`` and ``SelfAttentionBlock``, with attention and
residual dropout, per-layer activation checkpointing under the JAX
package's remat policies and activation offloading (``remat_plan``,
``offload.py``) and ``seq_axis`` (the
mesh axis over which the uncached attention runs as ring attention; see
``ops/attention.py``); and Perceiver IO's ``PerceiverEncoder``,
``PerceiverDecoder`` and ``PerceiverIO``. The Perceiver IO
options of the layers (a key/value input width other than the queries',
separate qk/v widths, no attention residual) are keyword arguments after the
Perceiver AR constructors' own, so those keep their signatures and parameter
names. Self-attention pad masks wait (ROADMAP A3).

The JAX block scans one layer body over stacked parameters; here the layers
are an ``nn.ModuleList`` run in a Python loop, each with its own slice of a
stacked KV cache. Per-layer rotary gating is kept as in the JAX package: a
non-rotary layer receives zero angles (rotation by zero is the identity).

Dropout draws from explicit generators. A layer takes a ``generator`` on its
device for all of its masks (attention dropout, then the two residual
dropouts, in call order); the block draws one seed per layer from the
caller's CPU generator before the layer runs (the counterpart of the JAX
scan's ``split_rngs``), so a layer recomputed under activation checkpointing
(``torch.utils.checkpoint`` restores only the default generators) redraws
exactly the masks of its forward. The Perceiver IO encoder and decoder draw
one seed per cross-attention layer the same way and hand the generator on to
their self-attention blocks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from perceiver_io_torch.models.core.adapter import TrainableQueryProvider
from perceiver_io_torch.models.core.offload import NO_BATCH_DOTS, offload_context_fn
from perceiver_io_torch.ops.attention import KVCache, MultiHeadAttention
from perceiver_io_torch.ops.layers import Dense, Dropout, LayerNorm, next_seed, seeded_generator

LN_EPS = 1e-5

# the JAX package's argument-free jax.checkpoint_policies names
# (perceiver_io_tpu/models/core/modules.py:_REMAT_POLICIES)
REMAT_POLICIES = (
    "everything_saveable",
    "nothing_saveable",
    "dots_saveable",
    "checkpoint_dots",
    "dots_with_no_batch_dims_saveable",
    "checkpoint_dots_with_no_batch_dims",
)
# every matrix product, batched or not: what dots_saveable keeps (the masked
# softmax's batched products among them); the flash kernels launch through
# ctypes inside an autograd Function, are no dispatcher op, and are
# recomputed under every policy, as a pallas_call is no dot_general in JAX
_ALL_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.baddbmm.default]
# products without batch dimensions, the outputs dots_with_no_batch_dims
# keeps: the Dense layers' matrix products (F.linear reaches the dispatcher
# as mm or addmm); attention's batched products are recomputed
_SAVED_DOTS = list(NO_BATCH_DOTS)


@dataclass(frozen=True)
class RematPlan:
    """How a checkpointable layer runs when it records gradients: under
    ``torch.utils.checkpoint`` (non-reentrant, the masks from the layer's
    seed, so no RNG state is stashed) with ``context_fn``, or plainly."""

    checkpoint: bool
    context_fn: Optional[Callable] = None

    def run(self, fn, *args):
        if not (self.checkpoint and torch.is_grad_enabled()):
            return fn(*args)
        kw = {} if self.context_fn is None else {"context_fn": self.context_fn}
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def remat_plan(name: Optional[str], activation_checkpointing: bool = True,
               activation_offloading: bool = False) -> RematPlan:
    """The JAX package's ``_remat_policy`` (same checks, same messages) as a
    ``RematPlan``: None and "nothing_saveable" recompute everything;
    "everything_saveable" saves every residual, as no checkpoint does;
    "dots_saveable" / "checkpoint_dots" save every matrix product and
    "dots_with_no_batch_dims_saveable" /
    "checkpoint_dots_with_no_batch_dims" the unbatched ones (selective
    checkpointing); ``activation_offloading`` saves the unbatched ones in
    host memory (``offload.py``) and recomputes the rest."""
    if activation_offloading:
        if not activation_checkpointing:
            raise ValueError(
                "activation_offloading requires activation_checkpointing=True "
                "(offloading is a property of what the checkpoint saves)"
            )
        if name not in (None, "dots_with_no_batch_dims_saveable"):
            raise ValueError(
                f"activation_offloading composes with remat_policy=None or "
                f"'dots_with_no_batch_dims_saveable' (it offloads exactly that "
                f"policy's saveable set to host memory), got {name!r}"
            )
        return RematPlan(True, offload_context_fn)
    if name is None:
        return RematPlan(activation_checkpointing)
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; expected one of {REMAT_POLICIES}")
    if not activation_checkpointing:
        raise ValueError("remat_policy is set but activation_checkpointing is False; enable it (or clear the policy)")
    if name == "everything_saveable":
        return RematPlan(False)
    if name == "nothing_saveable":
        return RematPlan(True)
    dots = _ALL_DOTS if name in ("dots_saveable", "checkpoint_dots") else _SAVED_DOTS
    return RematPlan(True, functools.partial(create_selective_checkpoint_contexts, dots))


class MLP(nn.Module):
    """LayerNorm -> Dense (x widening) -> exact-erf GELU -> Dense."""

    def __init__(self, num_channels: int, widening_factor: int, bias: bool = True, init_scale: float = 0.02,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm = LayerNorm(num_channels, LN_EPS, **kw)
        self.dense_1 = Dense(num_channels, widening_factor * num_channels, bias, init_scale, **kw)
        self.dense_2 = Dense(widening_factor * num_channels, num_channels, bias, init_scale, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_2(F.gelu(self.dense_1(self.norm(x))))


class CrossAttention(nn.Module):
    """Pre-LN cross-attention. With ``x_kv`` the key/value input is
    ``kv_norm(x_kv)`` (Perceiver IO); otherwise it is concat(kv_norm(
    x_kv_prefix), q_norm(x_q)): the queries also attend to themselves at the
    end of the key/value sequence (Perceiver AR). ``num_channels`` is the
    query input's width; ``num_kv_input_channels`` (default: the same) the
    key/value input's."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False, dropout: float = 0.0,
                 qkv_bias: bool = True, out_bias: bool = True, init_scale: float = 0.02, seq_axis=None, dtype=None,
                 param_dtype=torch.float32, device=None, num_kv_input_channels: Optional[int] = None,
                 num_qk_channels: Optional[int] = None, num_v_channels: Optional[int] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        num_kv = num_channels if num_kv_input_channels is None else num_kv_input_channels
        self.q_norm = LayerNorm(num_channels, LN_EPS, **kw)
        self.kv_norm = LayerNorm(num_kv, LN_EPS, **kw)
        self.attention = MultiHeadAttention(
            num_heads, num_channels, num_kv, num_qk_channels, num_v_channels, causal_attention=causal_attention,
            dropout=dropout, qkv_bias=qkv_bias, out_bias=out_bias, init_scale=init_scale, seq_axis=seq_axis, **kw,
        )

    def forward(self, x_q, x_kv_prefix=None, pad_mask=None, rope_q=None, rope_k=None,
                kv_cache: Optional[KVCache] = None, kv_live=None, generator: Optional[torch.Generator] = None,
                x_kv=None) -> Tuple[torch.Tensor, Optional[KVCache]]:
        x_q = self.q_norm(x_q)
        if x_kv is None:
            x_kv = torch.cat([self.kv_norm(x_kv_prefix), x_q], dim=1)
        else:
            x_kv = self.kv_norm(x_kv)
        return self.attention(x_q, x_kv, pad_mask=pad_mask, rope_q=rope_q, rope_k=rope_k,
                              kv_cache=kv_cache, kv_live=kv_live, generator=generator)

    def prefill_chunk_kv(self, x_emb: torch.Tensor, latent_mask: torch.Tensor):
        """The split prefill's KV rows for prompt-token embeddings, with no
        attention: ``kv_norm`` rows for the prefix, ``q_norm`` rows where
        ``latent_mask`` is True (the latents reused as keys), as the one-shot
        prefill's concat has them."""
        x_kv = torch.where(latent_mask[..., None], self.q_norm(x_emb), self.kv_norm(x_emb))
        return self.attention.project_kv(x_kv)

    def prefill_latents_paged(self, x_q, k_rows, v_rows, visible, rope_q=None, rope_k=None) -> torch.Tensor:
        """The split prefill's finish: the latents (raw embeddings; q_norm
        applies here) against a slot's already-written rows."""
        return self.attention.paged_prefill_attention(self.q_norm(x_q), k_rows, v_rows, visible, rope_q=rope_q,
                                                      rope_k=rope_k)


class SelfAttention(nn.Module):
    """Pre-LN self-attention (q = k = v = norm(x))."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False, dropout: float = 0.0,
                 qkv_bias: bool = True, out_bias: bool = True, init_scale: float = 0.02, seq_axis=None, dtype=None,
                 param_dtype=torch.float32, device=None, num_qk_channels: Optional[int] = None,
                 num_v_channels: Optional[int] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm = LayerNorm(num_channels, LN_EPS, **kw)
        self.attention = MultiHeadAttention(
            num_heads, num_channels, num_channels, num_qk_channels, num_v_channels, causal_attention=causal_attention,
            dropout=dropout, qkv_bias=qkv_bias, out_bias=out_bias, init_scale=init_scale, seq_axis=seq_axis, **kw,
        )

    def forward(self, x, rope_q=None, rope_k=None, kv_cache: Optional[KVCache] = None,
                generator: Optional[torch.Generator] = None):
        x = self.norm(x)
        return self.attention(x, x, rope_q=rope_q, rope_k=rope_k, kv_cache=kv_cache, generator=generator)


class CrossAttentionLayer(nn.Module):
    """Cross-attention with a residual over the queries (unless
    ``attention_residual`` is False), then a residual MLP; residual dropout
    on the attention output and on the MLP output. ``num_channels`` is the
    query input's width (``num_q_input_channels`` in the JAX package)."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False, widening_factor: int = 1,
                 dropout: float = 0.0, residual_dropout: float = 0.0, qkv_bias: bool = True, out_bias: bool = True,
                 mlp_bias: bool = True, init_scale: float = 0.02, seq_axis=None, dtype=None,
                 param_dtype=torch.float32, device=None, num_kv_input_channels: Optional[int] = None,
                 num_qk_channels: Optional[int] = None, num_v_channels: Optional[int] = None,
                 attention_residual: bool = True):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.cross_attn = CrossAttention(num_heads, num_channels, causal_attention, dropout, qkv_bias, out_bias,
                                         init_scale, seq_axis=seq_axis, num_kv_input_channels=num_kv_input_channels,
                                         num_qk_channels=num_qk_channels, num_v_channels=num_v_channels, **kw)
        self.mlp = MLP(num_channels, widening_factor, mlp_bias, init_scale, **kw)
        self.res_dropout = Dropout(residual_dropout)
        self.attention_residual = attention_residual

    @property
    def draws(self) -> bool:
        """Whether a forward in the current mode draws random masks."""
        return self.res_dropout.active or self.cross_attn.attention.attn_dropout.active

    def forward(self, x_q, x_kv_prefix=None, pad_mask=None, rope_q=None, rope_k=None,
                kv_cache: Optional[KVCache] = None, kv_live=None, generator: Optional[torch.Generator] = None,
                x_kv=None):
        att, kv_cache = self.cross_attn(x_q, x_kv_prefix, pad_mask=pad_mask, rope_q=rope_q, rope_k=rope_k,
                                        kv_cache=kv_cache, kv_live=kv_live, generator=generator, x_kv=x_kv)
        x = self.res_dropout(att, generator)
        if self.attention_residual:
            x = x + x_q
        return x + self.res_dropout(self.mlp(x), generator), kv_cache

    def prefill_chunk_kv(self, x_emb: torch.Tensor, latent_mask: torch.Tensor):
        """Split-prefill KV rows (see ``CrossAttention.prefill_chunk_kv``)."""
        return self.cross_attn.prefill_chunk_kv(x_emb, latent_mask)

    def prefill_latents_paged(self, x_q, k_rows, v_rows, visible, rope_q=None, rope_k=None) -> torch.Tensor:
        """The split prefill's finish through the whole layer: paged attention,
        then the residual and MLP the one-shot prefill applies."""
        x = self.cross_attn.prefill_latents_paged(x_q, k_rows, v_rows, visible, rope_q=rope_q, rope_k=rope_k) + x_q
        return x + self.mlp(x)


class SelfAttentionLayer(nn.Module):
    """Self-attention with a residual, then a residual MLP; residual dropout
    on both branches."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False, widening_factor: int = 1,
                 dropout: float = 0.0, residual_dropout: float = 0.0, qkv_bias: bool = True, out_bias: bool = True,
                 mlp_bias: bool = True, init_scale: float = 0.02, seq_axis=None, dtype=None,
                 param_dtype=torch.float32, device=None, num_qk_channels: Optional[int] = None,
                 num_v_channels: Optional[int] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.self_attn = SelfAttention(num_heads, num_channels, causal_attention, dropout, qkv_bias, out_bias,
                                       init_scale, seq_axis=seq_axis, num_qk_channels=num_qk_channels,
                                       num_v_channels=num_v_channels, **kw)
        self.mlp = MLP(num_channels, widening_factor, mlp_bias, init_scale, **kw)
        self.res_dropout = Dropout(residual_dropout)

    @property
    def draws(self) -> bool:
        """Whether a forward in the current mode draws random masks."""
        return self.res_dropout.active or self.self_attn.attention.attn_dropout.active

    def forward(self, x, kv_cache: Optional[KVCache] = None, rope_q=None, rope_k=None,
                generator: Optional[torch.Generator] = None):
        att, kv_cache = self.self_attn(x, rope_q=rope_q, rope_k=rope_k, kv_cache=kv_cache, generator=generator)
        x = x + self.res_dropout(att, generator)
        return x + self.res_dropout(self.mlp(x), generator), kv_cache


def _seeded_layer(layer: SelfAttentionLayer, x, rope_q, rope_k, seed: Optional[int]) -> torch.Tensor:
    """One uncached layer whose masks come from ``seed``: the unit that
    activation checkpointing runs, and reruns with the same seed."""
    out, _ = layer(x, rope_q=rope_q, rope_k=rope_k, generator=seeded_generator(seed, x.device))
    return out


def _seeded_cross_layer(layer: CrossAttentionLayer, x_q, x_kv, pad_mask, seed: Optional[int]) -> torch.Tensor:
    """A Perceiver IO cross-attention layer whose masks come from ``seed``
    (the unit that activation checkpointing runs and reruns)."""
    out, _ = layer(x_q, x_kv=x_kv, pad_mask=pad_mask, generator=seeded_generator(seed, x_q.device))
    return out


class SelfAttentionBlock(nn.Module):
    """``num_layers`` self-attention layers; the first ``num_rotary_layers``
    apply RoPE (-1 = all), the others get zero angles. With
    ``activation_checkpointing`` each layer of an uncached forward that
    records gradients runs as ``remat_plan`` says for ``remat_policy`` and
    ``activation_offloading``."""

    def __init__(self, num_layers: int, num_heads: int, num_channels: int, num_rotary_layers: int = 1,
                 causal_attention: bool = False, widening_factor: int = 1, dropout: float = 0.0,
                 residual_dropout: float = 0.0, activation_checkpointing: bool = False,
                 remat_policy: Optional[str] = None, qkv_bias: bool = True, out_bias: bool = True,
                 mlp_bias: bool = True, init_scale: float = 0.02, seq_axis=None, dtype=None,
                 param_dtype=torch.float32, device=None, num_qk_channels: Optional[int] = None,
                 num_v_channels: Optional[int] = None, activation_offloading: bool = False):
        super().__init__()
        self.num_rotary_layers = num_rotary_layers
        self.remat = remat_plan(remat_policy, activation_checkpointing, activation_offloading)
        self.layers = nn.ModuleList(
            SelfAttentionLayer(num_heads, num_channels, causal_attention, widening_factor, dropout, residual_dropout,
                               qkv_bias, out_bias, mlp_bias, init_scale, seq_axis=seq_axis, dtype=dtype,
                               param_dtype=param_dtype, device=device, num_qk_channels=num_qk_channels,
                               num_v_channels=num_v_channels)
            for _ in range(num_layers)
        )

    def _rotary(self, i: int) -> bool:
        return self.num_rotary_layers == -1 or i < self.num_rotary_layers

    def forward(self, x, rope_q=None, rope_k=None, kv_cache: Optional[KVCache] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """``generator``: the caller's CPU generator, one seed drawn from it
        per layer that draws masks (training mode)."""
        still = None  # zero angles, made once if some layer is not rotary
        for i, layer in enumerate(self.layers):
            if self._rotary(i):
                rq, rk = rope_q, rope_k
            else:
                if still is None:
                    still = tuple(None if a is None else torch.zeros_like(a) for a in (rope_q, rope_k))
                rq, rk = still
            if kv_cache is not None:
                x, layer_cache = layer(x, kv_cache=kv_cache.layer(i), rope_q=rq, rope_k=rk)
                kv_cache.length[i] = layer_cache.length
                continue
            seed = next_seed(generator) if layer.draws else None
            x = self.remat.run(_seeded_layer, layer, x, rq, rk, seed)
        return x, kv_cache


class PerceiverEncoder(nn.Module):
    """Perceiver IO encoder: a trainable latent array cross-attends to the
    adapted input, then self-attention blocks run over the latents. With
    ``num_cross_attention_layers`` > 1 the cross-attention repeats before the
    first blocks (``cross_attn_n`` unless ``first_cross_attention_layer_shared``
    reuses ``cross_attn_1``), and with ``num_self_attention_blocks`` > 1 the
    blocks repeat (``self_attn_n`` unless ``first_self_attention_block_shared``,
    the default, reuses ``self_attn_1``). The dropout rates act in training
    mode, with masks from the ``generator`` a forward is given. With
    ``activation_checkpointing`` a forward that records gradients runs each
    cross-attention layer, and each self-attention layer, as ``remat_plan``
    says (``torch.utils.checkpoint``), as the JAX encoder ``nn.remat``s
    them."""

    def __init__(self, input_adapter: nn.Module, num_latents: int, num_latent_channels: int,
                 num_cross_attention_heads: int = 4, num_cross_attention_qk_channels: Optional[int] = None,
                 num_cross_attention_v_channels: Optional[int] = None, num_cross_attention_layers: int = 1,
                 first_cross_attention_layer_shared: bool = False, cross_attention_widening_factor: int = 1,
                 num_self_attention_heads: int = 4, num_self_attention_qk_channels: Optional[int] = None,
                 num_self_attention_v_channels: Optional[int] = None, num_self_attention_layers_per_block: int = 6,
                 num_self_attention_blocks: int = 1, first_self_attention_block_shared: bool = True,
                 self_attention_widening_factor: int = 1, dropout: float = 0.0, residual_dropout: float = 0.0,
                 init_scale: float = 0.02, activation_checkpointing: bool = False,
                 remat_policy: Optional[str] = None, dtype=None, param_dtype=torch.float32, device=None,
                 activation_offloading: bool = False):
        super().__init__()
        if num_cross_attention_layers <= 0:
            raise ValueError("num_cross_attention_layers must be > 0")
        if num_self_attention_blocks <= 0:
            raise ValueError("num_self_attention_blocks must be > 0")
        if num_cross_attention_layers > num_self_attention_blocks:
            raise ValueError("num_cross_attention_layers must be <= num_self_attention_blocks")
        # the JAX encoder resolves the cross-attention's policy only under
        # checkpointing, the blocks' always
        self.remat = (remat_plan(remat_policy, True, activation_offloading) if activation_checkpointing
                      else RematPlan(False))
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_latents, self.num_latent_channels = num_latents, num_latent_channels
        self.num_cross_attention_layers = num_cross_attention_layers
        self.num_self_attention_blocks = num_self_attention_blocks
        self.input_adapter = input_adapter
        self.latent_provider = TrainableQueryProvider(num_latents, num_latent_channels, init_scale, param_dtype,
                                                      device)

        def cross_attn():
            return CrossAttentionLayer(
                num_cross_attention_heads, num_latent_channels, widening_factor=cross_attention_widening_factor,
                dropout=dropout, residual_dropout=residual_dropout, init_scale=init_scale,
                num_kv_input_channels=input_adapter.num_input_channels,
                num_qk_channels=num_cross_attention_qk_channels, num_v_channels=num_cross_attention_v_channels, **kw)

        def self_attn():
            return SelfAttentionBlock(
                num_self_attention_layers_per_block, num_self_attention_heads, num_latent_channels,
                num_rotary_layers=0, widening_factor=self_attention_widening_factor, dropout=dropout,
                residual_dropout=residual_dropout, activation_checkpointing=activation_checkpointing,
                remat_policy=remat_policy, init_scale=init_scale, num_qk_channels=num_self_attention_qk_channels,
                num_v_channels=num_self_attention_v_channels, activation_offloading=activation_offloading, **kw)

        self.cross_attn_1 = cross_attn()
        self.self_attn_1 = self_attn()
        extra_cross = num_cross_attention_layers > 1 and not first_cross_attention_layer_shared
        extra_self = num_self_attention_blocks > 1 and not first_self_attention_block_shared
        self.cross_attn_n = cross_attn() if extra_cross else None
        self.self_attn_n = self_attn() if extra_self else None

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None, return_adapted_input: bool = False,
                generator: Optional[torch.Generator] = None):
        """Latents (B, num_latents, num_latent_channels) of the input ``x``
        (and the adapted input with ``return_adapted_input``); ``pad_mask``
        (B, N) True = padding, over the adapted input's positions;
        ``generator``: the caller's CPU generator, one seed drawn from it
        per layer that draws masks (training mode)."""
        x_adapted = self.input_adapter(x)
        x_latent = self.latent_provider().expand(x.shape[0], -1, -1).to(x_adapted.dtype)

        def cross(layer, x_latent):
            # one seed a layer that draws masks; under checkpointing (JAX's
            # ``nn.remat`` of the layer) the recompute redraws the same masks
            # from that seed
            seed = next_seed(generator) if layer.draws else None
            return self.remat.run(_seeded_cross_layer, layer, x_latent, x_adapted, pad_mask, seed)

        x_latent = cross(self.cross_attn_1, x_latent)
        x_latent, _ = self.self_attn_1(x_latent, generator=generator)
        cross_attn_n = self.cross_attn_1 if self.cross_attn_n is None else self.cross_attn_n
        self_attn_n = self.self_attn_1 if self.self_attn_n is None else self.self_attn_n
        for i in range(1, self.num_self_attention_blocks):
            if i < self.num_cross_attention_layers:
                x_latent = cross(cross_attn_n, x_latent)
            x_latent, _ = self_attn_n(x_latent, generator=generator)
        if return_adapted_input:
            return x_latent, x_adapted
        return x_latent


class PerceiverDecoder(nn.Module):
    """Perceiver IO decoder: the output query (from ``output_query_provider``,
    which may read the adapted input) cross-attends to the latents; the
    output adapter maps the result to the task's output. Its dropout masks
    come from the ``generator`` a forward is given (one seed a forward).
    With ``activation_checkpointing`` a forward that records gradients runs
    the cross-attention layer as ``remat_plan`` says, as the JAX decoder
    ``nn.remat``s it."""

    def __init__(self, output_adapter: nn.Module, output_query_provider: nn.Module, num_latent_channels: int,
                 num_cross_attention_heads: int = 4, num_cross_attention_qk_channels: Optional[int] = None,
                 num_cross_attention_v_channels: Optional[int] = None, cross_attention_widening_factor: int = 1,
                 cross_attention_residual: bool = True, dropout: float = 0.0, init_scale: float = 0.02,
                 dtype=None, param_dtype=torch.float32, device=None, activation_checkpointing: bool = False,
                 remat_policy: Optional[str] = None, activation_offloading: bool = False):
        super().__init__()
        self.remat = remat_plan(remat_policy, activation_checkpointing, activation_offloading)
        self.output_adapter = output_adapter
        self.output_query_provider = output_query_provider
        self.cross_attn = CrossAttentionLayer(
            num_cross_attention_heads, output_query_provider.num_query_channels,
            widening_factor=cross_attention_widening_factor, dropout=dropout, init_scale=init_scale,
            dtype=dtype, param_dtype=param_dtype, device=device, num_kv_input_channels=num_latent_channels,
            num_qk_channels=num_cross_attention_qk_channels, num_v_channels=num_cross_attention_v_channels,
            attention_residual=cross_attention_residual)

    def forward(self, x_latent: torch.Tensor, x_adapted: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, **kwargs):
        output_query = self.output_query_provider(x_adapted)
        if output_query.shape[0] == 1 and x_latent.shape[0] != 1:
            output_query = output_query.expand(x_latent.shape[0], *output_query.shape[1:])
        seed = next_seed(generator) if self.cross_attn.draws else None
        output = self.remat.run(_seeded_cross_layer, self.cross_attn, output_query.to(x_latent.dtype), x_latent,
                                None, seed)
        return self.output_adapter(output, **kwargs)


class PerceiverIO(nn.Module):
    def __init__(self, encoder: PerceiverEncoder, decoder: PerceiverDecoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, **kwargs):
        return self.decoder(self.encoder(x, pad_mask=pad_mask, generator=generator), generator=generator, **kwargs)
