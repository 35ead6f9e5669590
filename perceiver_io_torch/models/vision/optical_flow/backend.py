"""Perceiver IO optical flow.

Port of ``perceiver_io_tpu/models/vision/optical_flow/backend.py``:
``OpticalFlowEncoderConfig`` / ``OpticalFlowDecoderConfig``,
``OpticalFlowInputAdapter`` (two frames of patch features concatenated over
channels, a Dense projection, then the Fourier position features),
``OpticalFlowOutputAdapter`` (a Dense to two flow channels over
``rescale_factor``, reshaped to the image grid), ``OpticalFlowQueryProvider``
(the decoder is queried by the adapted input: one query per pixel),
``OpticalFlow`` and ``official_41m_config``.

At the official configuration one patch is 368 x 496 = 182,528 pixels of 322
channels (64 projected + 258 Fourier). The encoder's cross-attention is one
head of 322 channels (not a multiple of 64: the masked softmax), its 24
self-attention layers 8 heads of 64 over 2,048 latents (B1a), and the
decoder's cross-attention one head of 512 channels, the 182,528 pixels over
the 2,048 latents (B1a and B1b at their wide width,
``csrc/flash_forward_wide.cu`` and ``csrc/flash_backward_wide.cu`` in bf16).

The model trains (``scripts/convergence.py`` drives it) and runs inference.
Inference belongs under ``torch.inference_mode()`` (``pipelines.py`` runs
it so): the parameters record gradients, so a plain forward would save the
activations for a backward, and B1a would write P in two bf16 terms for B1b
where one is enough.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_torch.models.core.adapter import InputAdapter
from perceiver_io_torch.models.core.config import DecoderConfig, EncoderConfig, PerceiverIOConfig
from perceiver_io_torch.models.core.modules import PerceiverDecoder, PerceiverEncoder
from perceiver_io_torch.models.core.perceiver_ar import resolve_device
from perceiver_io_torch.ops.layers import Dense, reset_parameters
from perceiver_io_torch.ops.position import fourier_position_encodings, num_fourier_channels


@dataclass(frozen=True)
class OpticalFlowEncoderConfig(EncoderConfig):
    image_shape: Tuple[int, int] = (368, 496)
    num_patch_input_channels: int = 27
    num_patch_hidden_channels: int = 64
    num_frequency_bands: int = 64

    def base_kwargs(self, exclude=("freeze", "scan_unroll", "image_shape", "num_patch_input_channels",
                                   "num_patch_hidden_channels", "num_frequency_bands")):
        return super().base_kwargs(exclude=exclude)


@dataclass(frozen=True)
class OpticalFlowDecoderConfig(DecoderConfig):
    image_shape: Tuple[int, int] = (368, 496)
    rescale_factor: float = 100.0

    def base_kwargs(self, exclude=("freeze", "image_shape", "rescale_factor")):
        return super().base_kwargs(exclude=exclude)


OpticalFlowConfig = PerceiverIOConfig[OpticalFlowEncoderConfig, OpticalFlowDecoderConfig]


class OpticalFlowInputAdapter(InputAdapter):
    """(B, 2, C, H, W) frame-pair patch features -> (B, H W, hidden + Fourier)
    : the two frames' channels concatenated per pixel, projected by
    ``linear``, then the Fourier position table. The table (H W x 258 float32
    at the official shape, 188 MB) is made once, on the module's device, as a
    buffer that moves with the module and stays out of the ``state_dict``."""

    def __init__(self, image_shape: Tuple[int, int] = (368, 496), num_patch_input_channels: int = 27,
                 num_patch_hidden_channels: int = 64, num_frequency_bands: int = 64, init_scale: float = 0.02,
                 dtype: Optional[torch.dtype] = None, param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_patch_input_channels = num_patch_input_channels
        self.num_input_channels = num_patch_hidden_channels + num_fourier_channels(image_shape, num_frequency_bands)
        self.linear = Dense(2 * num_patch_input_channels, num_patch_hidden_channels, True, init_scale, dtype,
                            param_dtype, device)
        table = fourier_position_encodings(self.image_shape, num_frequency_bands)
        self.register_buffer("position_encoding", torch.from_numpy(table).to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c, h, w = x.shape
        if t != 2 or c != self.num_patch_input_channels or (h, w) != self.image_shape:
            raise ValueError(f"Input shape {(t, c, h, w)} incompatible with (2, {self.num_patch_input_channels}, "
                             f"{self.image_shape[0]}, {self.image_shape[1]})")
        x = x.permute(0, 3, 4, 1, 2).reshape(b, h, w, t * c)  # the two frames' channels side by side
        x = self.linear(x).reshape(b, h * w, -1)
        enc = self.position_encoding.to(x.dtype).expand(b, -1, -1)
        return torch.cat([x, enc], dim=-1)


class OpticalFlowOutputAdapter(nn.Module):
    def __init__(self, image_shape: Tuple[int, int] = (368, 496), num_output_query_channels: int = 322,
                 num_output_image_channels: int = 2, rescale_factor: float = 100.0, init_scale: float = 0.02,
                 dtype: Optional[torch.dtype] = None, param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_output_image_channels = num_output_image_channels
        self.rescale_factor = rescale_factor
        self.linear = Dense(num_output_query_channels, num_output_image_channels, True, init_scale, dtype,
                            param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x) / self.rescale_factor
        h, w = self.image_shape
        return x.reshape(x.shape[0], h, w, self.num_output_image_channels)


class OpticalFlowQueryProvider(nn.Module):
    """The decoder's query IS the adapted input (dense per-pixel queries)."""

    def __init__(self, num_query_channels: int):
        super().__init__()
        self.num_query_channels = num_query_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.num_query_channels:
            raise ValueError(f"the adapted input has {x.shape[-1]} channels, the decoder's query "
                             f"{self.num_query_channels}")
        return x


class OpticalFlow(nn.Module):
    """Frame-pair patch features (B, 2, C, H, W) -> flow (B, H, W, 2).

    ``device`` defaults to the card (and raises if there is none); ``dtype``
    is the compute dtype (``None``: the parameter dtype), ``param_dtype`` the
    weights' storage dtype; the weights are random from ``seed`` (load real
    ones with ``convert_jax.load_jax_params``). The model is made in eval
    mode; ``train()`` turns on its dropout (drawn from the ``generator`` a
    forward is given) and the encoder's activation checkpointing acts in any
    forward that records gradients."""

    def __init__(self, config: OpticalFlowConfig, device=None, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        enc, dec = config.encoder, config.decoder
        input_adapter = OpticalFlowInputAdapter(enc.image_shape, enc.num_patch_input_channels,
                                                enc.num_patch_hidden_channels, enc.num_frequency_bands,
                                                enc.init_scale, **kw)
        encoder_kwargs = enc.base_kwargs()
        for key in ("num_cross_attention_qk_channels", "num_cross_attention_v_channels"):
            if encoder_kwargs[key] is None:
                encoder_kwargs[key] = input_adapter.num_input_channels
        remat = dict(activation_checkpointing=config.activation_checkpointing, remat_policy=config.remat_policy,
                     activation_offloading=config.activation_offloading)
        self.encoder = PerceiverEncoder(input_adapter, config.num_latents, config.num_latent_channels, **remat, **kw,
                                        **encoder_kwargs)
        self.decoder = PerceiverDecoder(
            OpticalFlowOutputAdapter(dec.image_shape, input_adapter.num_input_channels,
                                     rescale_factor=dec.rescale_factor, init_scale=dec.init_scale, **kw),
            OpticalFlowQueryProvider(input_adapter.num_input_channels), config.num_latent_channels,
            **kw, **dec.base_kwargs(), **remat)
        reset_parameters(self, torch.Generator(device).manual_seed(seed))
        self.eval()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the caller's CPU generator for the dropout masks
        (training mode), one seed a layer that draws."""
        x_latent, x_adapted = self.encoder(x, return_adapted_input=True, generator=generator)
        return self.decoder(x_latent, x_adapted=x_adapted, generator=generator)


def official_41m_config(scan_unroll: int = 1) -> OpticalFlowConfig:
    """The official deepmind/optical-flow-perceiver dimensions (41M
    parameters), as the JAX package's ``official_41m_config``: 368 x 496
    patches of 27 channels a frame, 64 hidden channels, 64 frequency bands,
    2,048 latents of 512 channels, one 322-channel cross-attention head, 24
    self-attention layers of 8 heads, and a decoder of one 512-channel head
    without the attention residual. ``scan_unroll`` is accepted and
    ignored."""
    enc = OpticalFlowEncoderConfig(
        image_shape=(368, 496), num_patch_input_channels=27,
        num_patch_hidden_channels=64, num_frequency_bands=64,
        num_cross_attention_heads=1, num_self_attention_heads=8,
        num_self_attention_layers_per_block=24, num_self_attention_blocks=1,
        scan_unroll=scan_unroll,
    )
    dec = OpticalFlowDecoderConfig(
        image_shape=(368, 496), num_cross_attention_qk_channels=512,
        num_cross_attention_v_channels=512, num_cross_attention_heads=1,
        cross_attention_residual=False,
    )
    return OpticalFlowConfig(encoder=enc, decoder=dec, num_latents=2048, num_latent_channels=512)
