"""Causal language model: a thin alias of ``CausalSequenceModel``, as
``perceiver_io_tpu/models/text/clm/backend.py`` is. Its parameters are the
``CausalSequenceModel`` tree, so ``convert_jax.load_jax_params`` carries a
JAX ``CausalLanguageModel``'s across."""

from __future__ import annotations

from dataclasses import dataclass

from perceiver_io_torch.models.core.config import CausalSequenceModelConfig
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel


@dataclass(frozen=True)
class CausalLanguageModelConfig(CausalSequenceModelConfig):
    pass


class CausalLanguageModel(CausalSequenceModel):
    pass
