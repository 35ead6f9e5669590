"""Text data module: tokenize -> chunk -> cache -> collated batches.

The port's own copy of ``perceiver_io_tpu/data/text/common.py`` for the
causal-LM and classification tasks: ``Task``, ``TextPreprocessor``
(inference-side text -> (ids, pad_mask)), ``ChunkDataset``,
``RandomShiftDataset`` (random concat-shift augmentation, resumable through
``state_dict``), ``CLMDataset`` (shift-by-one split of max_seq_len + 1
chunks), ``ClfDataset``, the on-disk int32 chunk files (``ChunkFileWriter``,
``open_chunk_file``, the parallel ``_tokenize_shard``) and ``TextDataModule``
with the same preprocessing hash, chunk files and loader seeding as the JAX
module, so both prepare the same bytes and draw the same batches.

``Task.mlm`` needs the masking collators, which wait for ROADMAP A3.3: a
module with that task raises. ``load_source_dataset`` stays abstract; the JAX
package's subclasses (``datasets.py``, ``c4.py``) download and are not
ported.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perceiver_io_torch.data.loader import DataLoader
from perceiver_io_torch.data.text.collator import Collator, DefaultCollator, RandomTruncateCollator
from perceiver_io_torch.data.text.tokenizer import get_tokenizer

WORD_ID_NONE = -1  # encodes None word ids in fixed numpy arrays


class Task(Enum):
    mlm = 0
    clm = 1
    clf = 2


class TextPreprocessor:
    """Inference-side preprocessing: text -> (input_ids, pad_mask)."""

    def __init__(self, tokenizer: str, max_seq_len: int, add_special_tokens: bool = False, padding_side: Optional[str] = None):
        self.tokenizer = get_tokenizer(tokenizer)
        self.max_seq_len = max_seq_len
        self.add_special_tokens = add_special_tokens
        if padding_side is not None:
            self.tokenizer.padding_side = padding_side

    def preprocess(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        xs, pad = self.preprocess_batch([text])
        return xs[0], pad[0]

    def preprocess_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        seqs = [self.tokenizer.encode(t, self.add_special_tokens)[: self.max_seq_len] for t in texts]
        n = max(len(s) for s in seqs)
        ids = np.full((len(seqs), n), self.tokenizer.pad_token_id, dtype=np.int64)
        pad = np.ones((len(seqs), n), dtype=bool)
        for i, s in enumerate(seqs):
            if getattr(self.tokenizer, "padding_side", "right") == "left":
                ids[i, n - len(s):] = s
                pad[i, n - len(s):] = False
            else:
                ids[i, : len(s)] = s
                pad[i, : len(s)] = False
        return ids, pad


class ChunkDataset:
    """Fixed-length chunks stored as (N, chunk_len) memmaps; items are dicts.
    ``labels`` is present for statically-masked MLM data (inputs already masked)."""

    def __init__(
        self,
        chunks: np.ndarray,
        word_ids: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
    ):
        self.chunks = chunks
        self.word_ids = word_ids
        self.labels = labels

    def __len__(self):
        return len(self.chunks)

    def __getitem__(self, idx: int) -> dict:
        out = {"input_ids": self.chunks[idx].tolist()}
        if self.labels is not None:
            out["label_ids"] = self.labels[idx].tolist()
        elif self.word_ids is not None:
            out["word_ids"] = [None if w == WORD_ID_NONE else int(w) for w in self.word_ids[idx]]
        return out


class RandomShiftDataset:
    """Concatenation-shift augmentation: example i is chunk[i][s:] + chunk[i+1][:s]
    with a random shift s (reference common.py:364-387)."""

    def __init__(self, dataset, rng: Optional[np.random.Generator] = None):
        self.dataset = dataset
        self.rng = rng if rng is not None else np.random.default_rng()

    def state_dict(self) -> dict:
        """Augmentation-RNG snapshot: the shift draw advances per fetched
        example, so exact mid-epoch resume must restore it (the DataLoader
        replays skipped batches WITHOUT fetching examples)."""
        return {"rng_state": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng_state"]

    def __len__(self):
        return len(self.dataset) - 1

    def __getitem__(self, idx: int) -> dict:
        e1, e2 = self.dataset[idx], self.dataset[idx + 1]
        shift = None
        out = {}
        for key in e1:
            if shift is None:
                shift = int(self.rng.integers(len(e1[key])))
            out[key] = list(e1[key][shift:]) + list(e2[key][:shift])
        return out


class CLMDataset:
    """Shift-by-one split of (max_seq_len + 1)-length chunks into inputs/labels."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        record = self.dataset[idx]["input_ids"]
        return {"input_ids": record[:-1], "label_ids": record[1:]}


class ClfDataset:
    """Ragged tokenized examples with scalar labels."""

    def __init__(self, input_ids: List[List[int]], labels: List[int]):
        self.input_ids = input_ids
        self.labels = labels

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx: int) -> dict:
        return {"input_ids": self.input_ids[idx], "label": int(self.labels[idx])}


def chunk_token_stream(token_lists: Sequence[Sequence[int]], chunk_size: int) -> np.ndarray:
    """Concatenate token lists and split into fixed chunks, dropping the tail."""
    flat = np.concatenate([np.asarray(t, dtype=np.int32) for t in token_lists]) if token_lists else np.zeros(0, np.int32)
    n = (len(flat) // chunk_size) * chunk_size
    return flat[:n].reshape(-1, chunk_size)


class ChunkFileWriter:
    """Streams token sequences into an on-disk int32 chunk file: O(chunk) host
    memory regardless of corpus size (flagship corpora like Wikipedia/C4 never
    fit in RAM as Python lists; prepared files are memmapped at load time)."""

    def __init__(self, path: str, chunk_size: int):
        self.path = path
        self.chunk_size = chunk_size
        self._fh = open(path, "wb")
        self._buf = np.zeros(0, np.int32)
        self.num_chunks = 0

    def write(self, tokens: Sequence[int]) -> None:
        self._buf = np.concatenate([self._buf, np.asarray(tokens, np.int32)])
        n = (len(self._buf) // self.chunk_size) * self.chunk_size
        if n:
            self._fh.write(self._buf[:n].astype(np.int32).tobytes())
            self.num_chunks += n // self.chunk_size
            self._buf = self._buf[n:]

    def close(self) -> None:
        self._fh.close()


def open_chunk_file(path: str, chunk_size: int) -> np.ndarray:
    if os.path.getsize(path) == 0:  # corpus smaller than one chunk
        return np.zeros((0, chunk_size), np.int32)
    data = np.memmap(path, dtype=np.int32, mode="r")
    return data.reshape(-1, chunk_size)


def _write_token_stream(module, texts, out_dir: str, split: str, suffix: str = "") -> None:
    """Tokenize ``texts`` into ``{split}.ids{suffix}.bin``."""
    writer = ChunkFileWriter(os.path.join(out_dir, f"{split}.ids{suffix}.bin"), module._chunk_size)
    for text in texts:
        writer.write(module._tokenize_one(text))
    writer.close()


def _tokenize_shard(job):
    """Worker: re-load the source in-process and tokenize every num_shards-th
    text starting at shard_idx — texts are never pickled across the process
    boundary (module-level function for pickling)."""
    cls, kwargs, out_dir, split, shard_idx, num_shards = job
    module = cls(**kwargs)
    data = module.load_source_dataset()[split]
    if not isinstance(data, (list, tuple)):
        data = list(data)
    _write_token_stream(module, data[shard_idx::num_shards], out_dir, split, suffix=f".part{shard_idx}")
    return shard_idx


@dataclass
class TextDataModule:
    """Base class for text datasets; subclasses implement ``load_source_dataset``
    returning {'train': ..., 'valid': ...} where each split is a list of texts
    (mlm/clm) or (texts, labels) (clf)."""

    dataset_dir: str
    tokenizer: str = "bytes"
    max_seq_len: int = 4096
    task: Task = Task.mlm
    mask_prob: float = 0.15
    mask_words: bool = True
    static_masking: bool = False
    add_special_tokens: bool = False
    add_eos_token: bool = False
    padding_side: Optional[str] = None
    random_train_shift: bool = False
    random_valid_shift: bool = False
    random_train_truncation: bool = False
    random_valid_truncation: bool = False
    random_min_seq_len: int = 16
    batch_size: int = 64
    valid_batch_size_: Optional[int] = None
    preproc_workers: int = 1  # parallel tokenization shards for prepare_data
    seed: int = 0

    def __post_init__(self):
        if self.task == Task.mlm:
            raise NotImplementedError("the mlm task's masking collators are not ported yet (ROADMAP A3.3); "
                                      "the port's TextDataModule prepares the clm and clf tasks")
        self._tokenizer = get_tokenizer(self.tokenizer)
        if self.padding_side is not None:
            self._tokenizer.padding_side = self.padding_side
        if self.static_masking and not self.mask_words:
            raise ValueError("static_masking=true is only supported for mask_words=true")
        self.ds_train = None
        self.ds_valid = None
        self._rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------- properties
    @property
    def vocab_size(self) -> int:
        return self._tokenizer.vocab_size

    @property
    def valid_batch_size(self) -> int:
        return self.valid_batch_size_ or self.batch_size

    @property
    def random_shift(self) -> bool:
        return self.random_train_shift or self.random_valid_shift

    def preproc_dir_hash_input(self) -> str:
        h = f"{self.tokenizer}-{self.max_seq_len}-{self.task.name}-{self.random_shift}"
        if self.preproc_workers > 1:
            # parallel sharding changes chunk boundaries (each shard drops its
            # own tail) -> different prepared artifact
            h = f"{h}-w{self.preproc_workers}"
        if self.task == Task.mlm and self.static_masking:
            h = f"{h}-{self.mask_words}-{self.mask_prob}"
        if self.add_special_tokens:
            h = f"{h}-st"
        if self.add_eos_token:
            h = f"{h}-eos"
        return h

    @property
    def preproc_dir(self) -> str:
        digest = hashlib.md5(self.preproc_dir_hash_input().encode()).hexdigest()
        return os.path.join(self.dataset_dir, "preproc", digest)

    # ------------------------------------------------------------ preparation
    def load_source_dataset(self) -> Dict:
        raise NotImplementedError

    def prepare_data(self) -> None:
        if os.path.exists(self.preproc_dir):
            return
        source = self.load_source_dataset()
        # write into a temp dir and rename at the end, so an interrupted run never
        # leaves a partial cache that would be mistaken for a complete one
        tmp_dir = f"{self.preproc_dir}.tmp-{os.getpid()}"
        os.makedirs(tmp_dir, exist_ok=True)
        try:
            for split, data in source.items():
                self._prepare_split(tmp_dir, split, data)
            os.replace(tmp_dir, self.preproc_dir)
        finally:
            if os.path.exists(tmp_dir):
                import shutil

                shutil.rmtree(tmp_dir, ignore_errors=True)

    def _tokenize_one(self, text: str) -> np.ndarray:
        tok = self._tokenizer
        if self.add_eos_token:
            text = text + tok.eos_token
        return tok.encode_array(text, self.add_special_tokens)  # the vectorized corpus-preparation path

    @property
    def _chunk_size(self) -> int:
        return self.max_seq_len + 1 if self.task == Task.clm else self.max_seq_len

    def _prepare_split(self, out_dir: str, split: str, data) -> None:
        if self.task == Task.clf:
            texts, labels = data
            ids_list = [self._tokenize_one(t)[: self.max_seq_len] for t in texts]
            np.savez(
                os.path.join(out_dir, f"{split}.npz"),
                input_ids=np.asarray(ids_list, dtype=object),
                labels=np.asarray(labels, dtype=np.int64),
            )
            return

        use_parallel = self.preproc_workers > 1 and (
            not isinstance(data, (list, tuple)) or len(data) >= self.preproc_workers
        )
        if use_parallel:
            self._prepare_split_parallel(out_dir, split)
        else:
            _write_token_stream(self, data, out_dir, split)


    def _prepare_split_parallel(self, out_dir: str, split: str) -> None:
        """Tokenize across worker processes (the reference's datasets.map
        num_proc equivalent, common.py:303-311): each worker re-loads the source
        itself and streams every num_workers-th text into its own part file
        (texts never cross the process boundary); parts concatenate in shard
        order via streaming copies.

        Note: chunk boundaries differ from the serial result (each shard drops
        its own sub-chunk tail), so the cache key includes the worker count."""
        import concurrent.futures
        import multiprocessing
        import shutil

        jobs = [
            (type(self), self._prepare_args(), out_dir, split, i, self.preproc_workers)
            for i in range(self.preproc_workers)
        ]
        # forkserver: forking a multi-threaded parent (torch's thread pools)
        # can deadlock the children
        ctx = multiprocessing.get_context("forkserver")
        with concurrent.futures.ProcessPoolExecutor(max_workers=self.preproc_workers, mp_context=ctx) as pool:
            list(pool.map(_tokenize_shard, jobs))
        with open(os.path.join(out_dir, f"{split}.ids.bin"), "wb") as out:
            for i in range(self.preproc_workers):
                part = os.path.join(out_dir, f"{split}.ids.part{i}.bin")
                with open(part, "rb") as f:
                    shutil.copyfileobj(f, out)
                os.remove(part)

    def _prepare_args(self) -> dict:
        """Constructor kwargs to rebuild an equivalent module in a worker."""
        import dataclasses

        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def _load_split(self, split: str):
        clf_path = os.path.join(self.preproc_dir, f"{split}.npz")
        if os.path.exists(clf_path):
            data = np.load(clf_path, allow_pickle=True)
            return ClfDataset([list(x) for x in data["input_ids"]], data["labels"].tolist())
        return ChunkDataset(open_chunk_file(os.path.join(self.preproc_dir, f"{split}.ids.bin"), self._chunk_size))

    def setup(self) -> None:
        self.ds_train = self._load_split("train")
        self.ds_valid = self._load_split("valid")
        if self.task == Task.clm:
            if self.random_train_shift:
                self.ds_train = RandomShiftDataset(self.ds_train, self._rng)
            if self.random_valid_shift:
                self.ds_valid = RandomShiftDataset(self.ds_valid, self._rng)
            self.ds_train = CLMDataset(self.ds_train)
            self.ds_valid = CLMDataset(self.ds_valid)

    # ----------------------------------------------------------------- loading
    def _collator(self) -> Collator:
        tok = self._tokenizer
        return DefaultCollator(
            pad_token_id=tok.pad_token_id,
            max_seq_len=self.max_seq_len,
            padding_side=self.padding_side or getattr(tok, "padding_side", "right"),
        )

    def _dataloader(
        self, dataset, batch_size: int, shuffle: bool, random_truncation: bool, drop_last: bool = True
    ) -> DataLoader:
        collator = self._collator()
        if random_truncation:
            collator = RandomTruncateCollator(collator, self.random_min_seq_len, rng=self._rng)

        def collate(examples):
            labels, input_ids, pad_mask = collator(examples)
            return {"labels": labels, "input_ids": input_ids, "pad_mask": pad_mask}

        # the loader gets its OWN generator (spawned off the module seed) so its
        # state_dict/exact-resume covers the batch order independently of the
        # collators' per-batch draws (dynamic masking/truncation), which remain
        # fresh randomness after a restore; the shift augmentation's RNG IS
        # resume-exact (RandomShiftDataset.state_dict via the loader snapshot)
        loader_rng = np.random.default_rng(self._rng.integers(0, 2**63))
        return DataLoader(dataset, batch_size, collate_fn=collate, shuffle=shuffle, drop_last=drop_last, rng=loader_rng)

    def train_dataloader(self) -> DataLoader:
        return self._dataloader(
            self.ds_train, self.batch_size, shuffle=True, random_truncation=self.random_train_truncation
        )

    def val_dataloader(self) -> DataLoader:
        # evaluation sees the full set (no batch-truncation of metrics)
        return self._dataloader(
            self.ds_valid, self.valid_batch_size, shuffle=False,
            random_truncation=self.random_valid_truncation, drop_last=False,
        )

    def text_preprocessor(self) -> TextPreprocessor:
        return TextPreprocessor(self.tokenizer, self.max_seq_len, self.add_special_tokens, self.padding_side)
