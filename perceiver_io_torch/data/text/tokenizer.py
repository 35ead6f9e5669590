"""Tokenization: a self-contained UTF-8 byte tokenizer.

The port's own copy of ``perceiver_io_tpu/data/text/tokenizer.py``:
``ByteTokenizer`` lays out the ``deepmind/language-perceiver`` vocabulary (262
= 6 special tokens + 256 bytes) with no download, and ``get_tokenizer``
resolves the byte-tokenizer names to it. Any other name is a
``transformers.AutoTokenizer``, which downloads its files, so the port raises
for it (ROADMAP C19).

Word ids (for whole-word masking) follow the reference's whitespace-boundary
reconstruction: whitespaces preceding a word share its word id; special
tokens get None.
"""

from __future__ import annotations

import string
from typing import List, Optional, Sequence

import numpy as np

_SPECIAL_TOKENS = ["[PAD]", "[BOS]", "[EOS]", "[MASK]", "[CLS]", "[SEP]"]
_BYTE_OFFSET = len(_SPECIAL_TOKENS)  # 6
_SPECIAL_TOKEN_IDS = {tok: i for i, tok in enumerate(_SPECIAL_TOKENS)}

import re  # noqa: E402

_SPECIAL_SPLIT = re.compile("(" + "|".join(re.escape(t) for t in _SPECIAL_TOKENS) + ")")


class ByteTokenizer:
    """UTF-8 byte tokenizer with the deepmind/language-perceiver vocab layout."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    mask_token_id = 3
    cls_token_id = 4
    sep_token_id = 5

    pad_token = "[PAD]"
    eos_token = "[EOS]"
    mask_token = "[MASK]"

    vocab_size = _BYTE_OFFSET + 256  # 262
    padding_side = "right"

    def __init__(self):
        self._whitespace_ids = {b + _BYTE_OFFSET for b in string.whitespace.encode("utf-8")}

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        for part in _SPECIAL_SPLIT.split(text):
            if part in _SPECIAL_TOKEN_IDS:  # literal "[MASK]" etc. -> special id
                ids.append(_SPECIAL_TOKEN_IDS[part])
            else:
                ids.extend(b + _BYTE_OFFSET for b in part.encode("utf-8", errors="replace"))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def encode_array(self, text: str, add_special_tokens: bool = False) -> np.ndarray:
        """Vectorized encode (the corpus-preparation fast path). Parses literal
        special-token strings exactly like ``encode`` so both paths agree."""
        parts = []
        for part in _SPECIAL_SPLIT.split(text):
            if part in _SPECIAL_TOKEN_IDS:
                parts.append(np.asarray([_SPECIAL_TOKEN_IDS[part]], np.int32))
            elif part:
                raw = np.frombuffer(part.encode("utf-8", errors="replace"), dtype=np.uint8)
                parts.append(raw.astype(np.int32) + _BYTE_OFFSET)
        ids = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        if add_special_tokens:
            ids = np.concatenate(([self.cls_token_id], ids, [self.sep_token_id])).astype(np.int32)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        if skip_special_tokens:
            data = bytes(i - _BYTE_OFFSET for i in ids if i >= _BYTE_OFFSET)
            return data.decode("utf-8", errors="replace")
        # preserve special-token positions by decoding byte runs between them
        parts: List[str] = []
        run: List[int] = []
        for i in ids:
            if i < _BYTE_OFFSET:
                if run:
                    parts.append(bytes(run).decode("utf-8", errors="replace"))
                    run = []
                parts.append(_SPECIAL_TOKENS[i])
            else:
                run.append(i - _BYTE_OFFSET)
        if run:
            parts.append(bytes(run).decode("utf-8", errors="replace"))
        return "".join(parts)

    def __call__(self, texts, add_special_tokens: bool = False, **_):
        if isinstance(texts, str):
            texts = [texts]
        return {"input_ids": [self.encode(t, add_special_tokens) for t in texts]}

    def word_ids(self, token_ids: Sequence[int]) -> List[Optional[int]]:
        """Whitespace-boundary word ids (reference data/text/utils.py:13-39)."""
        word_ids: List[Optional[int]] = []
        curr_id = 0
        regular_token = True
        for token_id in token_ids:
            if token_id < _BYTE_OFFSET:  # special token
                word_ids.append(None)
                curr_id += 1
            elif token_id in self._whitespace_ids:
                if regular_token:
                    regular_token = False
                    curr_id += 1
                word_ids.append(curr_id)
            else:
                regular_token = True
                word_ids.append(curr_id)
        return word_ids


BYTE_TOKENIZER_NAMES = {"bytes", "deepmind/language-perceiver", "krasserm/perceiver-io-mlm"}


def get_tokenizer(name: str):
    """'bytes' (or the perceiver byte-tokenizer repo names) -> ByteTokenizer.
    Any other name would be a ``transformers.AutoTokenizer`` loaded from the
    hub, a download the port does not make: it raises."""
    if name in BYTE_TOKENIZER_NAMES:
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name!r} is a transformers AutoTokenizer, which downloads its files; the port has only the byte "
        f"tokenizer ({sorted(BYTE_TOKENIZER_NAMES)})"
    )
