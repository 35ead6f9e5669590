"""The CLM script's default text data module, backed by HF ``datasets``.

Port of ``perceiver_io_tpu/data/text/datasets.py``'s ``WikiTextDataModule``
(wikitext-103-raw-v1). The fetch happens only inside
``load_source_dataset``, and ``datasets`` is imported there: a prepared
cache (``TextDataModule.prepare_data`` returns when ``preproc_dir`` exists)
works offline. The other data sets of the JAX module are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from perceiver_io_torch.data.text.common import TextDataModule


def _load_dataset(*args, **kwargs):
    from datasets import load_dataset

    return load_dataset(*args, **kwargs)


def _texts(split) -> list:
    return [t for t in split["text"] if t and not t.isspace()]


@dataclass
class WikiTextDataModule(TextDataModule):
    """wikitext-103-raw-v1: its train and validation splits, blank lines dropped."""

    config: str = "wikitext-103-raw-v1"

    def load_source_dataset(self) -> Dict:
        ds = _load_dataset("wikitext", self.config)
        return {"train": _texts(ds["train"]), "valid": _texts(ds["validation"])}
