"""Model configurations: the port's own copy of
``perceiver_io_tpu/models/core/config.py`` (EncoderConfig, DecoderConfig,
PerceiverIOConfig, PerceiverARConfig, CausalSequenceModelConfig,
flagship_455m_config), with the same field names and defaults so
configurations and converted weights line up.

Perceiver IO (``EncoderConfig``, ``DecoderConfig``, ``PerceiverIOConfig``):
``ClassificationDecoderConfig`` adds the classifier's output query and
class count. ``scan_unroll`` is accepted and ignored (the layers run in a Python loop;
``base_kwargs`` leaves it out); ``freeze`` is carried for the task scripts
and acts nothing here. The dropout rates act in training mode.
``activation_checkpointing``, ``remat_policy`` and ``activation_offloading``
reach the encoder's cross-attention layers and self-attention blocks and the
decoder's layer, where they act only in a forward that records gradients
(``modules.remat_plan``).

Perceiver AR, the fields that act in the port: the dropout rates and mode
(``cross_attention_dropout``, ``cross_attention_dropout_mode``,
``post_attention_dropout``, ``residual_dropout``; in training mode only),
``activation_checkpointing``, ``remat_policy`` (the JAX package's six policy
names) and ``activation_offloading`` (the unbatched products kept in host
memory, ``offload.py``), and ``sequence_parallel_axis`` (ring attention over
that axis of the ambient mesh in the uncached forward, which raises without
such a mesh; the cached entry points ignore it). ``pipeline_axis`` is not
ported: a model that has it set raises when it is put in training mode
(inference ignores it, as it changes no result).
``scan_unroll``, ``fused_qkv`` and ``pipeline_microbatches`` are execution
knobs with no effect here; ``max_heads_parallel`` has none in either package.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields
from typing import Generic, Optional, TypeVar


def _base_kwargs(config, base_class, exclude) -> dict:
    """The fields of ``config`` that ``base_class`` declares, less ``exclude``."""
    names = [f.name for f in fields(base_class) if f.name not in exclude]
    return {k: v for k, v in asdict(config).items() if k in names}


@dataclass(frozen=True)
class EncoderConfig:
    num_cross_attention_heads: int = 8
    num_cross_attention_qk_channels: Optional[int] = None
    num_cross_attention_v_channels: Optional[int] = None
    num_cross_attention_layers: int = 1
    first_cross_attention_layer_shared: bool = False
    cross_attention_widening_factor: int = 1
    num_self_attention_heads: int = 8
    num_self_attention_qk_channels: Optional[int] = None
    num_self_attention_v_channels: Optional[int] = None
    num_self_attention_layers_per_block: int = 8
    num_self_attention_blocks: int = 1
    first_self_attention_block_shared: bool = True
    self_attention_widening_factor: int = 1
    dropout: float = 0.0
    init_scale: float = 0.02
    freeze: bool = False
    scan_unroll: int = 1

    def base_kwargs(self, exclude=("freeze", "scan_unroll")):
        return _base_kwargs(self, EncoderConfig, exclude)


@dataclass(frozen=True)
class DecoderConfig:
    num_cross_attention_heads: int = 8
    num_cross_attention_qk_channels: Optional[int] = None
    num_cross_attention_v_channels: Optional[int] = None
    cross_attention_widening_factor: int = 1
    cross_attention_residual: bool = True
    dropout: float = 0.0
    init_scale: float = 0.02
    freeze: bool = False

    def base_kwargs(self, exclude=("freeze",)):
        return _base_kwargs(self, DecoderConfig, exclude)


@dataclass(frozen=True)
class ClassificationDecoderConfig(DecoderConfig):
    num_output_queries: int = 1
    num_output_query_channels: int = 256
    num_classes: int = 100

    def base_kwargs(self, exclude=("freeze", "num_output_queries", "num_output_query_channels", "num_classes")):
        return super().base_kwargs(exclude=exclude)


E = TypeVar("E", bound=EncoderConfig)
D = TypeVar("D", bound=DecoderConfig)


@dataclass(frozen=True)
class PerceiverIOConfig(Generic[E, D]):
    encoder: E
    decoder: D
    num_latents: int
    num_latent_channels: int
    activation_checkpointing: bool = False
    remat_policy: Optional[str] = None
    activation_offloading: bool = False


@dataclass(frozen=True)
class PerceiverARConfig:
    num_heads: int = 8
    max_heads_parallel: Optional[int] = None
    num_self_attention_layers: int = 8
    num_self_attention_rotary_layers: int = 1
    self_attention_widening_factor: int = 4
    cross_attention_widening_factor: int = 4
    cross_attention_dropout: float = 0.5
    cross_attention_dropout_mode: str = "gather"
    post_attention_dropout: float = 0.0
    residual_dropout: float = 0.0
    activation_checkpointing: bool = False
    remat_policy: Optional[str] = None
    activation_offloading: bool = False
    scan_unroll: int = 1
    fused_qkv: bool = False
    sequence_parallel_axis: Optional[str] = None
    pipeline_axis: Optional[str] = None
    pipeline_microbatches: Optional[int] = None


@dataclass(frozen=True)
class CausalSequenceModelConfig(PerceiverARConfig):
    vocab_size: int = 262
    max_seq_len: int = 4096
    max_latents: int = 512
    num_channels: int = 512
    output_norm: bool = False
    output_bias: bool = True
    abs_pos_emb: bool = True
    init_scale: float = 0.02


def flagship_455m_config() -> CausalSequenceModelConfig:
    """The reference's published 455M C4 Perceiver AR (examples/training/clm/
    train_fsdp.sh: 20 layers x 1280 channels, 10 heads, sequence 1024, 512
    latents, 32k vocabulary), with the same execution knobs as the JAX
    package's copy (activation checkpointing with the dots policy acts in
    the port; the unroll does not)."""
    return CausalSequenceModelConfig(
        vocab_size=32000,
        max_seq_len=1024,
        max_latents=512,
        num_channels=1280,
        num_heads=10,
        num_self_attention_layers=20,
        cross_attention_dropout=0.0,
        abs_pos_emb=False,
        output_norm=True,
        output_bias=False,
        activation_checkpointing=True,
        remat_policy="dots_with_no_batch_dims_saveable",
        scan_unroll=20,
    )


def clm_8k_config() -> CausalSequenceModelConfig:
    """The Perceiver AR paper's 8k long-context regime on the 30M-class
    architecture, as the JAX package's ``bench.py:clm_8k_bench_config``
    (sequence 8192, 1024 latents, 512 channels, 8 heads of 64, 8 layers,
    gather prefix dropout 0.5, dots checkpointing); run sequence-parallel
    with ``dataclasses.replace(cfg, sequence_parallel_axis="seq")``."""
    return CausalSequenceModelConfig(
        vocab_size=262,
        max_seq_len=8192,
        max_latents=1024,
        num_channels=512,
        num_heads=8,
        num_self_attention_layers=8,
        cross_attention_dropout=0.5,
        activation_checkpointing=True,
        remat_policy="dots_with_no_batch_dims_saveable",
        fused_qkv=True,
    )
