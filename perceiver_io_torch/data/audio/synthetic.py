"""Synthetic symbolic-audio corpus with an analytic loss floor.

The port's own copy of ``perceiver_io_tpu/data/audio/synthetic.py`` (numpy,
the same seeds, so both give the same batches): the order-2 Markov
construction of ``data/text/synthetic.py`` dressed as the audio pipeline's
data — variable-length "event" chains, LEFT padding through the real
``SymbolicAudioCollator``, a reserved PAD id at the top of the vocab, and
``pad_mask``-masked labels. It exercises what distinguishes the audio trainer
path from the text one (ragged windows and the pad-mask branch of the
causal-LM step) while keeping the validation CE target exact.

Floor exactness: window lengths are drawn from [min_len, max_len] with
``min_len >= max_latents + 8``, so every latent (scored) position is a real
token with >= 8 real-context tokens — its conditional entropy sits exactly at
the order-2 floor (see MarkovByteSource.entropy_floor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from perceiver_io_torch.data.audio.symbolic import SymbolicAudioCollator
from perceiver_io_torch.data.loader import DataLoader
from perceiver_io_torch.data.text.synthetic import MarkovByteSource


class _RaggedChainDataset:
    """Variable-length Markov chains as {'input_ids': (L,)} examples.

    Train mode (``fresh=True``) redraws the whole epoch's chains from rng key
    ``[seed, 816, epoch]`` via the DataLoader's ``on_epoch_start`` hook (the 816
    namespace is disjoint from text synthetic's 815 and the fixed validation
    key), so the training stream never repeats; exact-resume works the same way
    as text's _FreshChainWindows (epoch index in state_dict)."""

    def __init__(self, src: MarkovByteSource, n_chains: int, min_len: int, max_len: int,
                 seed: int, fresh: bool):
        self.src, self.n_chains = src, n_chains
        self.min_len, self.max_len = min_len, max_len
        self.base_seed, self.fresh = seed, fresh
        self.epoch = -1
        self.windows: Optional[np.ndarray] = None
        self.lengths: Optional[np.ndarray] = None
        if not fresh:
            self.epoch = 0
            self._materialize()

    def _materialize(self) -> None:
        key = [self.base_seed, 816, self.epoch] if self.fresh else self.base_seed + 3
        self.windows = self.src.sample_windows(self.n_chains, self.max_len, seed=key)
        len_rng = np.random.default_rng([self.base_seed, 817, max(self.epoch, 0)])
        self.lengths = len_rng.integers(self.min_len, self.max_len + 1, size=self.n_chains)

    def on_epoch_start(self) -> None:
        if self.fresh:
            self.epoch += 1
            self._materialize()

    def state_dict(self) -> dict:
        return {"epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        if self.epoch >= 0:
            self._materialize()

    def __len__(self):
        return self.n_chains

    def __getitem__(self, idx):
        if self.windows is None:
            self.on_epoch_start()
        return {"input_ids": self.windows[idx, : self.lengths[idx]].astype(np.int64)}


@dataclass
class SyntheticMidiDataModule:
    """Markov 'MIDI-event' chains through the real audio collator: event ids
    ``0..vocab_size-1``, PAD id ``vocab_size`` (mirroring the 388-event + PAD
    layout of the MIDI codec), model vocab ``vocab_size + 1``."""

    seq_len: int = 256
    batch_size: int = 16
    n_train_chains: int = 48_000
    n_val_chains: int = 256
    vocab_size: int = 32
    max_latents: int = 128
    concentration: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.seq_len < self.max_latents + 16:
            raise ValueError("seq_len must exceed max_latents by >= 16 for an exact floor")
        self.pad_id = self.vocab_size
        self._rng = np.random.default_rng(self.seed)
        self._collator = SymbolicAudioCollator(self.seq_len + 1, self.pad_id, padding_side="left")
        self.entropy_floor: Optional[float] = None

    @property
    def model_vocab_size(self) -> int:
        return self.vocab_size + 1  # events + PAD

    def prepare_data(self) -> None:
        pass

    def setup(self) -> None:
        src = MarkovByteSource(vocab_size=self.vocab_size, concentration=self.concentration, seed=self.seed)
        self.entropy_floor = src.entropy_floor()
        min_len = self.max_latents + 8
        self.ds_train = _RaggedChainDataset(
            src, self.n_train_chains, min_len, self.seq_len + 1, self.seed, fresh=True
        )
        self.ds_valid = _RaggedChainDataset(
            src, self.n_val_chains, min_len, self.seq_len + 1, self.seed, fresh=False
        )

    def _collate(self, examples):
        labels, input_ids, pad_mask = self._collator(examples)
        return {"labels": labels, "input_ids": input_ids, "pad_mask": pad_mask}

    def train_dataloader(self) -> DataLoader:
        loader_rng = np.random.default_rng(self._rng.integers(0, 2**63))
        return DataLoader(self.ds_train, self.batch_size, collate_fn=self._collate, shuffle=True, rng=loader_rng)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_valid, self.batch_size, collate_fn=self._collate, shuffle=False, drop_last=False)
