"""Symbolic audio model over MIDI-event tokens (vocab 389): a thin alias of
``CausalSequenceModel``, as ``perceiver_io_tpu/models/audio/symbolic/
backend.py`` is. Its parameters are the ``CausalSequenceModel`` tree, so
``convert_jax.load_jax_params`` carries a JAX ``SymbolicAudioModel``'s
across."""

from __future__ import annotations

from dataclasses import dataclass

from perceiver_io_torch.models.core.config import CausalSequenceModelConfig
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel


@dataclass(frozen=True)
class SymbolicAudioModelConfig(CausalSequenceModelConfig):
    pass


class SymbolicAudioModel(CausalSequenceModel):
    pass
