"""Symbolic audio data module: MIDI event tokens from a flat int16 memmap.

The port's own copy of ``perceiver_io_tpu/data/audio/symbolic.py`` (numpy,
the same code and seeding, so both give the same batches):
  - MIDI files -> event tokens -> flat int16 memmap with -1 example separators
  - the dataset samples a random window and keeps the longest separator-free
    span, optionally randomly truncated to [min_seq_len, max_seq_len)
  - the left-pad collator produces shifted (labels, input_ids, pad_mask)
  - PAD token 388, vocab 389
``load_source_dataset`` returns local directories of ``.mid`` files; the JAX
package's downloading subclasses (``datasets.py``) are not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perceiver_io_torch.data.audio.midi_processor import encode_midi_files
from perceiver_io_torch.data.loader import DataLoader

EXAMPLE_SEPARATOR = -1
PAD_INPUT_ID = 388
VOCAB_SIZE = 389


class SymbolicAudioNumpyDataset:
    """Random windows over the flat memmap; each item is the longest
    separator-free span within a max_seq_len window."""

    def __init__(
        self,
        data_file: str,
        max_seq_len: int,
        separator_input_id: int = EXAMPLE_SEPARATOR,
        min_seq_len: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self._data = np.memmap(data_file, dtype=np.int16, mode="r")
        self._max_seq_len = max_seq_len
        self._separator = separator_input_id
        self._min_seq_len = min_seq_len
        self._rng = rng if rng is not None else np.random.default_rng()
        self._length = self._data.shape[0] // max_seq_len

    def __len__(self):
        return self._length

    def __getitem__(self, index) -> dict:
        start = int(self._rng.integers(self._data.shape[0] - self._max_seq_len))
        sample = np.asarray(self._data[start : start + self._max_seq_len], dtype=np.int64)

        sep_positions = np.where(sample == self._separator)[0]
        if len(sep_positions):
            spans = np.split(sample, sep_positions)
            example = max(spans, key=len)
            example = example[example != self._separator]
        else:
            example = sample

        if self._min_seq_len is not None and self._min_seq_len < len(example):
            example = example[: int(self._rng.integers(self._min_seq_len, self._max_seq_len))]
        return {"input_ids": example}


class SymbolicAudioCollator:
    """Pad to max_seq_len (left by default), then shift by one:
    (labels, input_ids, pad_mask)."""

    def __init__(self, max_seq_len: int, pad_token: int = PAD_INPUT_ID, padding_side: str = "left"):
        if padding_side not in ("left", "right"):
            raise ValueError(f"Invalid padding side '{padding_side}'")
        self._max_seq_len = max_seq_len
        self._pad_token = pad_token
        self._padding_side = padding_side

    def __call__(self, examples):
        b = len(examples)
        ids = np.full((b, self._max_seq_len), self._pad_token, dtype=np.int64)
        for i, example in enumerate(examples):
            x = example["input_ids"][: self._max_seq_len]
            if self._padding_side == "left":
                ids[i, self._max_seq_len - len(x):] = x
            else:
                ids[i, : len(x)] = x
        pad_mask = ids == self._pad_token
        return ids[:, 1:], ids[:, :-1], pad_mask[:, :-1]


@dataclass
class SymbolicAudioDataModule:
    dataset_dir: str
    max_seq_len: int = 6144
    min_seq_len: Optional[int] = None
    padding_side: str = "left"
    batch_size: int = 16
    preproc_workers: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.min_seq_len is not None and not (0 < self.min_seq_len < self.max_seq_len):
            raise ValueError(
                "Invalid data configuration supplied. "
                "Parameter 'min_seq_len' must adhere to 0 < min_seq_len < max_seq_len."
            )
        self._collator = SymbolicAudioCollator(self.max_seq_len + 1, PAD_INPUT_ID, self.padding_side)
        self._ds_train = None
        self._ds_valid = None
        self._rng = np.random.default_rng(self.seed)

    @property
    def vocab_size(self) -> int:
        return VOCAB_SIZE

    @property
    def preproc_dir(self) -> Path:
        return Path(self.dataset_dir) / "preproc"

    @property
    def train_data_file(self) -> Path:
        return self.preproc_dir / "train.bin"

    @property
    def valid_data_file(self) -> Path:
        return self.preproc_dir / "valid.bin"

    def load_source_dataset(self) -> Dict[str, Path]:
        """Must return {'train': dir, 'valid': dir} of directories with MIDI files."""
        raise NotImplementedError("`load_source_dataset` must return a dictionary with keys 'train' and 'valid'.")

    def _encode_dir(self, directory: Path) -> List[np.ndarray]:
        directory = Path(directory)
        if not directory.exists():
            raise ValueError(f"Invalid directory supplied. Directory '{directory}' does not exist.")
        files = sorted(str(p) for p in list(directory.rglob("**/*.mid")) + list(directory.rglob("**/*.midi")))
        return encode_midi_files(files, num_workers=self.preproc_workers)

    @staticmethod
    def write_memmap(sequences: List[np.ndarray], target_file: Path) -> None:
        """Flatten token sequences with -1 separators into an int16 memmap."""
        flat = np.concatenate([np.append(s, [EXAMPLE_SEPARATOR]) for s in sequences]).astype(np.int16)
        target_file.parent.mkdir(parents=True, exist_ok=True)
        fp = np.memmap(str(Path(target_file).absolute()), dtype=np.int16, mode="w+", shape=flat.shape)
        fp[:] = flat[:]
        fp.flush()

    def prepare_data(self) -> None:
        if os.path.exists(self.preproc_dir):
            return
        dataset = self.load_source_dataset()
        encoded_train = self._encode_dir(dataset["train"])
        encoded_valid = self._encode_dir(dataset["valid"])
        self._rng.shuffle(encoded_train)
        # temp dir + rename so an interrupted run never leaves a partial cache
        tmp_dir = Path(f"{self.preproc_dir}.tmp-{os.getpid()}")
        try:
            self.write_memmap(encoded_train, tmp_dir / self.train_data_file.name)
            self.write_memmap(encoded_valid, tmp_dir / self.valid_data_file.name)
            os.replace(tmp_dir, self.preproc_dir)
        finally:
            if tmp_dir.exists():
                import shutil

                shutil.rmtree(tmp_dir, ignore_errors=True)

    def setup(self) -> None:
        self._ds_train = SymbolicAudioNumpyDataset(
            str(self.train_data_file),
            self.max_seq_len + 1,
            min_seq_len=self.min_seq_len + 1 if self.min_seq_len is not None else None,
            rng=self._rng,
        )
        self._ds_valid = SymbolicAudioNumpyDataset(str(self.valid_data_file), self.max_seq_len + 1, rng=self._rng)

    def _collate(self, examples):
        labels, input_ids, pad_mask = self._collator(examples)
        return {"labels": labels, "input_ids": input_ids, "pad_mask": pad_mask}

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self._ds_train, self.batch_size, collate_fn=self._collate, shuffle=False)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self._ds_valid, self.batch_size, collate_fn=self._collate, shuffle=False, drop_last=False)
