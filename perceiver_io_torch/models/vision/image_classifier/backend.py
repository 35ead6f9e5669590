"""Perceiver IO image classifier.

Port of ``perceiver_io_tpu/models/vision/image_classifier/backend.py``:
``ImageEncoderConfig``, ``ImageClassifierConfig``, ``ImageInputAdapter``
(the image's pixels flattened, each followed by the Fourier position
features of its grid point) and ``ImageClassifier`` (a Perceiver IO encoder
and a one-query decoder into the class logits), plus
``vision_perceiver_fourier_config``, the 48.4M ImageNet model.

At that configuration an image is 224 x 224 = 50,176 pixels of 261 channels
(3 colours + 258 Fourier). The encoder's cross-attention is one head of 261
channels (not a multiple of 64: the masked softmax); its self-attention
block of 6 layers, 8 heads of 128 over 512 latents, runs 8 times with
shared weights: 48 calls of B1a a forward (in inference, where there is no
dropout); the decoder's one query takes the masked softmax. Inference
belongs under ``torch.inference_mode()``, as for ``OpticalFlow``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_torch.models.core.adapter import ClassificationOutputAdapter, InputAdapter, TrainableQueryProvider
from perceiver_io_torch.models.core.config import ClassificationDecoderConfig, EncoderConfig, PerceiverIOConfig
from perceiver_io_torch.models.core.modules import PerceiverDecoder, PerceiverEncoder
from perceiver_io_torch.models.core.perceiver_ar import resolve_device
from perceiver_io_torch.ops.layers import reset_parameters
from perceiver_io_torch.ops.position import fourier_position_encodings, num_fourier_channels


@dataclass(frozen=True)
class ImageEncoderConfig(EncoderConfig):
    image_shape: Tuple[int, int, int] = (224, 224, 3)
    num_frequency_bands: int = 32

    def base_kwargs(self, exclude=("freeze", "scan_unroll", "image_shape", "num_frequency_bands")):
        return super().base_kwargs(exclude=exclude)


ImageClassifierConfig = PerceiverIOConfig[ImageEncoderConfig, ClassificationDecoderConfig]


class ImageInputAdapter(InputAdapter):
    """(B, *spatial, C) images -> (B, prod(spatial), C + Fourier): each pixel's
    channels, cast to the table's float32, then the Fourier position features
    of its grid point. The table is made once, on the module's device, as a
    buffer that moves with the module and stays out of the ``state_dict``."""

    def __init__(self, image_shape: Tuple[int, ...] = (224, 224, 3), num_frequency_bands: int = 32, device=None):
        super().__init__()
        self.image_shape = tuple(image_shape)
        *spatial, c = self.image_shape
        self.num_input_channels = c + num_fourier_channels(spatial, num_frequency_bands)
        table = fourier_position_encodings(spatial, num_frequency_bands)
        self.register_buffer("position_encoding", torch.from_numpy(table).to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *d = x.shape
        if tuple(d) != self.image_shape:
            raise ValueError(f"Input vision shape {tuple(d)} different from required shape {self.image_shape}")
        enc = self.position_encoding
        x = x.reshape(b, -1, self.image_shape[-1]).to(enc.dtype)
        return torch.cat([x, enc.expand(b, -1, -1)], dim=-1)


class ImageClassifier(nn.Module):
    """Images (B, *image_shape) -> class logits (B, num_classes).

    ``device`` defaults to the card (and raises if there is none); ``dtype``
    is the compute dtype (``None``: the parameter dtype), ``param_dtype`` the
    weights' storage dtype; the weights are random from ``seed`` (load real
    ones with ``convert_jax.load_jax_params``). The model is made in eval
    mode; ``train()`` turns on its dropout, drawn from the ``generator`` a
    forward is given. The encoder's cross-attention qk width defaults to the
    adapter's channels, as in the JAX package."""

    def __init__(self, config: ImageClassifierConfig, device=None, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        enc, dec = config.encoder, config.decoder
        input_adapter = ImageInputAdapter(enc.image_shape, enc.num_frequency_bands, device=device)
        encoder_kwargs = enc.base_kwargs()
        if encoder_kwargs["num_cross_attention_qk_channels"] is None:
            encoder_kwargs["num_cross_attention_qk_channels"] = input_adapter.num_input_channels
        remat = dict(activation_checkpointing=config.activation_checkpointing, remat_policy=config.remat_policy,
                     activation_offloading=config.activation_offloading)
        self.encoder = PerceiverEncoder(input_adapter, config.num_latents, config.num_latent_channels, **remat, **kw,
                                        **encoder_kwargs)
        self.decoder = PerceiverDecoder(
            ClassificationOutputAdapter(dec.num_classes, dec.num_output_query_channels, dec.init_scale, **kw),
            TrainableQueryProvider(1, dec.num_output_query_channels, dec.init_scale, param_dtype, device),
            config.num_latent_channels, **kw, **dec.base_kwargs(), **remat)
        reset_parameters(self, torch.Generator(device).manual_seed(seed))
        self.eval()

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``pad_mask`` (B, N) True = padding, over the adapted input's
        positions, as in the JAX package; ``generator``: the caller's CPU
        generator for the dropout masks (training mode), one seed a layer
        that draws."""
        latents = self.encoder(x, pad_mask=pad_mask, generator=generator)
        return self.decoder(latents, generator=generator)


def vision_perceiver_fourier_config() -> ImageClassifierConfig:
    """The deepmind/vision-perceiver-fourier ImageNet classifier (48,440,627
    parameters), with the fields the JAX package's
    ``hf/convert_hf.py:image_classifier_from_hf`` sets from its public
    config: 224 x 224 x 3 images with 64 frequency bands (261 channels a
    pixel), one cross-attention head, 512 latents of 1,024 channels, a block
    of 6 self-attention layers of 8 heads applied 8 times with shared
    weights, attention dropout 0.1, init scale 0.02, and a one-query
    decoder of one 1,024-channel head into 1,000 classes."""
    enc = ImageEncoderConfig(
        image_shape=(224, 224, 3), num_frequency_bands=64,
        num_cross_attention_qk_channels=None, num_cross_attention_v_channels=None,
        num_self_attention_qk_channels=1024, num_self_attention_v_channels=1024,
        num_cross_attention_heads=1, num_self_attention_heads=8,
        num_self_attention_layers_per_block=6, num_self_attention_blocks=8,
        dropout=0.1, init_scale=0.02,
    )
    dec = ClassificationDecoderConfig(
        num_classes=1000, num_output_query_channels=1024, num_cross_attention_heads=1,
        cross_attention_residual=True, dropout=0.1, init_scale=0.02,
    )
    return ImageClassifierConfig(encoder=enc, decoder=dec, num_latents=512, num_latent_channels=1024)
