"""Batch collators producing the (labels, input_ids, pad_mask) protocol.

The port's own copy of ``perceiver_io_tpu/data/text/collator.py``'s
``Collator`` (labels, input_ids, pad_mask with True = padding), ``_pad_batch``,
``DefaultCollator`` (pad/truncate to max_seq_len) and
``RandomTruncateCollator`` (a random per-batch sequence length): host-side
numpy, randomness from an explicit ``numpy.random.Generator``, labels -100 at
ignored positions. The MLM masking collators wait for ROADMAP A3.3.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IGNORE = -100


class Collator:
    """Subclasses implement ``collate(examples) -> dict`` with numpy arrays
    ``labels``, ``input_ids``, ``attention_mask``."""

    def collate(self, examples: Sequence[dict]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __call__(self, examples: Sequence[dict]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        result = self.collate(examples)
        return result["labels"], result["input_ids"], ~result["attention_mask"].astype(bool)


def _pad_batch(
    sequences: List[List[int]],
    pad_id: int,
    padding_side: str = "right",
    max_len: Optional[int] = None,
    extra: Optional[List[List[int]]] = None,
    extra_pad: int = IGNORE,
) -> Dict[str, np.ndarray]:
    """Pad (and truncate) a list of token lists; optionally pad a parallel
    ``extra`` (labels) list with ``extra_pad``."""
    n = max(len(s) for s in sequences)
    if max_len is not None:
        n = min(n, max_len)
    b = len(sequences)
    input_ids = np.full((b, n), pad_id, dtype=np.int64)
    attention = np.zeros((b, n), dtype=np.int64)
    labels = np.full((b, n), extra_pad, dtype=np.int64) if extra is not None else None
    for i, seq in enumerate(sequences):
        seq = seq[:n]
        if padding_side == "left":
            input_ids[i, n - len(seq):] = seq
            attention[i, n - len(seq):] = 1
            if extra is not None:
                lab = extra[i][:n]
                labels[i, n - len(lab):] = lab
        else:
            input_ids[i, : len(seq)] = seq
            attention[i, : len(seq)] = 1
            if extra is not None:
                lab = extra[i][:n]
                labels[i, : len(lab)] = lab
    out = {"input_ids": input_ids, "attention_mask": attention}
    if labels is not None:
        out["labels"] = labels
    return out


class DefaultCollator(Collator):
    """Pad/truncate to the longest example (capped at max_seq_len). Examples carry
    ``input_ids`` and either per-position ``label_ids`` or a scalar ``label``."""

    def __init__(self, pad_token_id: int, max_seq_len: Optional[int] = None, padding_side: str = "right"):
        self.pad_token_id = pad_token_id
        self.max_seq_len = max_seq_len
        self.padding_side = padding_side

    def collate(self, examples):
        seqs = [list(e["input_ids"]) for e in examples]
        label_seqs = [list(e.get("label_ids", e["input_ids"])) for e in examples]
        out = _pad_batch(seqs, self.pad_token_id, self.padding_side, self.max_seq_len, extra=label_seqs)
        if "label" in examples[0]:
            out["labels"] = np.asarray([e["label"] for e in examples], dtype=np.int64)
        return out


class RandomTruncateCollator(Collator):
    """Randomly drop 1..(seq_len - min_seq_len) trailing positions per batch, so
    one model serves many sequence lengths."""

    def __init__(self, collator: Collator, min_seq_len: int, rng: Optional[np.random.Generator] = None):
        self.collator = collator
        self.min_seq_len = min_seq_len
        self.rng = rng if rng is not None else np.random.default_rng()

    def collate(self, examples):
        result = self.collator.collate(examples)
        seq_len = result["input_ids"].shape[1]
        if seq_len <= self.min_seq_len:
            return result
        drop = int(self.rng.integers(1, seq_len - self.min_seq_len + 1))
        for key in ("labels", "input_ids", "attention_mask"):
            if result[key].ndim == 2:
                result[key] = result[key][:, :-drop]
        return result
