"""Synthetic text corpus for training runs that need no download.

The port's own copy of ``perceiver_io_tpu/data/text/synthetic.py``:
``MarkovByteSource`` (an order-2 Markov chain over a byte alphabet with a
seeded Dirichlet transition tensor and an analytically known entropy floor),
the chain-window datasets, ``python_source_corpus`` (the installed packages'
own ``.py`` files as a byte corpus: real text with no download) and
``SyntheticTextDataModule`` over either. The same seeds, files and numpy
calls as the JAX package's, so both give the same batches bit for bit. The
corpus's ``packages`` default is the JAX package's; where those are not
installed (the card's machine has no jax, flax or optax) pass others, such
as ``("torch", "numpy")``.

Batches follow the CLM trainer contract: ``input_ids`` (B, L) and ``labels``
= the next token at each position.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from perceiver_io_torch.data.loader import DataLoader


@dataclass
class MarkovByteSource:
    """Order-2 Markov chain with an analytically known entropy floor."""

    vocab_size: int = 64
    concentration: float = 0.05  # Dirichlet alpha: smaller = peakier rows = lower entropy
    seed: int = 0

    def transitions(self) -> np.ndarray:
        """T[a, b, c] = P(next = c | prev = a, b), deterministic in seed."""
        rng = np.random.default_rng(self.seed)
        A = self.vocab_size
        T = rng.dirichlet(np.full(A, self.concentration), size=(A, A)).astype(np.float64)
        return T

    def entropy_floor(self) -> float:
        """Exact conditional entropy H(X_t | X_{t-2}, X_{t-1}) in nats/token:
        the stationary pair distribution (power iteration on the (a,b)->(b,c)
        chain) weighting each row's Shannon entropy. A model with >= 2 tokens
        of context cannot do better; validation CE converging here is a
        correctness proof for the whole training stack."""
        T = self.transitions()
        A = self.vocab_size
        pi = np.full((A, A), 1.0 / (A * A))
        for _ in range(200):
            # pi'(b, c) = sum_a pi(a, b) T[a, b, c]
            nxt = np.einsum("ab,abc->bc", pi, T)
            if np.abs(nxt - pi).max() < 1e-14:
                pi = nxt
                break
            pi = nxt
        logT = np.log(T, out=np.zeros_like(T), where=T > 0)
        row_h = -np.sum(T * logT, axis=-1)  # (A, A)
        return float(np.sum(pi * row_h))

    def sample(self, n_tokens: int, seed: Optional[int] = None) -> np.ndarray:
        """Draw one corpus of ``n_tokens`` int32 ids (inverse-CDF sampling)."""
        T = self.transitions()
        cdf = np.cumsum(T, axis=-1)
        rng = np.random.default_rng(self.seed + 1 if seed is None else seed)
        out = np.empty(n_tokens, np.int32)
        a, b = rng.integers(0, self.vocab_size, size=2)
        u = rng.random(n_tokens)
        for i in range(n_tokens):
            c = int(np.searchsorted(cdf[a, b], u[i], side="right"))
            c = min(c, self.vocab_size - 1)
            out[i] = c
            a, b = b, c
        return out

    def stationary_pairs(self) -> np.ndarray:
        """Stationary distribution over (prev, cur) pair states of the chain."""
        T = self.transitions()
        A = self.vocab_size
        pi = np.full((A, A), 1.0 / (A * A))
        for _ in range(200):
            nxt = np.einsum("ab,abc->bc", pi, T)
            if np.abs(nxt - pi).max() < 1e-14:
                return nxt
            pi = nxt
        return pi

    def sample_windows(self, n_windows: int, window_len: int, seed: Optional[int] = None) -> np.ndarray:
        """Draw ``n_windows`` INDEPENDENT stationary chains of ``window_len``
        tokens, vectorized across windows (a window_len-step loop instead of a
        per-token one — ~1000x faster than ``sample`` for corpus-scale draws).
        Each chain's (first, second) tokens come from the stationary pair
        distribution, so every position with >= 2 tokens of context sits
        exactly at the analytic floor; position 1 is predicted from a single
        token of context, so H(w1|w0) exceeds the order-2 floor slightly
        (harmless for the Perceiver AR loss, whose latent positions all have
        >= 2 tokens of context) — and fresh windows can be drawn per epoch,
        eliminating the finite-corpus memorization gap that a fixed training
        sample develops (a model can drive its training CE below the floor by
        memorizing sampling noise; validation against fresh draws cannot)."""
        T = self.transitions()
        A = self.vocab_size
        cdf = np.cumsum(T.reshape(A * A, A), axis=-1)
        rng = np.random.default_rng(self.seed + 1 if seed is None else seed)

        pi = self.stationary_pairs().reshape(-1)
        pair = rng.choice(A * A, size=n_windows, p=pi / pi.sum())
        out = np.empty((n_windows, window_len), np.int32)
        out[:, 0] = pair // A
        if window_len > 1:
            out[:, 1] = pair % A
        a, b = out[:, 0].copy(), out[:, 1 if window_len > 1 else 0].copy()
        u = rng.random((n_windows, window_len))
        for i in range(2, window_len):
            rows = cdf[a * A + b]  # (n_windows, A)
            c = (rows < u[:, i, None]).sum(axis=-1).astype(np.int32)
            np.minimum(c, A - 1, out=c)
            out[:, i] = c
            a, b = b, c
        return out


def python_source_corpus(max_bytes: int = 8_000_000, packages=("jax", "numpy", "flax", "optax")) -> np.ndarray:
    """Byte corpus from the installed site-packages' .py files (deterministic
    sorted traversal, capped at ``max_bytes``): real human-written text
    available without network access. Returns uint8 ids (byte-level vocab)."""
    import sysconfig

    root = sysconfig.get_paths()["purelib"]
    chunks, total = [], 0
    for pkg in packages:
        for path in sorted(glob.glob(os.path.join(root, pkg, "**", "*.py"), recursive=True)):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            chunks.append(np.frombuffer(data, np.uint8))
            total += len(data)
            if total >= max_bytes:
                break
        if total >= max_bytes:
            break
    return np.concatenate(chunks)[:max_bytes]


class _ChainWindows:
    """Independent (n, L+1)-token chains as CLM examples: x = w[:-1], y = w[1:]."""

    def __init__(self, windows: np.ndarray):
        self.x = windows[:, :-1].astype(np.int32)
        self.y = windows[:, 1:].astype(np.int32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        return {"input_ids": self.x[idx], "labels": self.y[idx]}


class _FreshChainWindows:
    """Train-side chain windows redrawn FRESH each epoch via the DataLoader's
    ``on_epoch_start`` hook: epoch e is materialized deterministically from rng
    key ``[seed, 815, e]`` (the 815 namespace cannot collide with the fixed
    validation key ``seed + 2`` for any seed), so the training stream never
    repeats — a fixed finite sample lets the model drive train CE below the
    analytic floor by memorization — while staying exact-resume compatible:
    ``state_dict`` records the epoch index and ``load_state_dict``
    re-materializes the identical windows."""

    def __init__(self, src: "MarkovByteSource", n_windows: int, window_len: int, seed: int):
        self.src, self.n_windows, self.window_len, self.base_seed = src, n_windows, window_len, seed
        self.epoch = -1  # first on_epoch_start -> epoch 0
        self.x = self.y = None

    def _materialize(self) -> None:
        w = self.src.sample_windows(self.n_windows, self.window_len, seed=[self.base_seed, 815, self.epoch])
        self.x = w[:, :-1].astype(np.int32)
        self.y = w[:, 1:].astype(np.int32)

    def on_epoch_start(self) -> None:
        self.epoch += 1
        self._materialize()

    def state_dict(self) -> dict:
        return {"epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        if self.epoch >= 0:
            self._materialize()

    def __len__(self):
        return self.n_windows

    def __getitem__(self, idx):
        if self.x is None:  # direct iteration without a loader epoch hook
            self.on_epoch_start()
        return {"input_ids": self.x[idx], "labels": self.y[idx]}


class _WindowDataset:
    """Non-overlapping fixed-length windows with next-token labels."""

    def __init__(self, ids: np.ndarray, seq_len: int):
        n = (len(ids) - 1) // seq_len
        self.x = ids[: n * seq_len].reshape(n, seq_len).astype(np.int32)
        self.y = ids[1 : n * seq_len + 1].reshape(n, seq_len).astype(np.int32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        return {"input_ids": self.x[idx], "labels": self.y[idx]}


@dataclass
class SyntheticTextDataModule:
    """CLM data module over a Markov or python-source byte corpus."""

    source: str = "markov"  # "markov" | "python_source"
    seq_len: int = 512
    batch_size: int = 16
    n_train_tokens: int = 2_000_000
    n_val_tokens: int = 100_000
    vocab_size: int = 64  # markov only; python_source is byte-level (256)
    concentration: float = 0.05
    seed: int = 0
    shuffle: bool = True

    def __post_init__(self):
        self.ds_train = None
        self.ds_valid = None
        self._rng = np.random.default_rng(self.seed)
        self.entropy_floor: Optional[float] = None

    @property
    def effective_vocab_size(self) -> int:
        return self.vocab_size if self.source == "markov" else 256

    def prepare_data(self) -> None:
        pass  # nothing to download

    def setup(self) -> None:
        if self.source == "markov":
            src = MarkovByteSource(vocab_size=self.vocab_size, concentration=self.concentration, seed=self.seed)
            self.entropy_floor = src.entropy_floor()
            self._markov_src = src
            # independent stationary windows, redrawn fresh each epoch through
            # the DataLoader's on_epoch_start hook: the training stream never
            # repeats, so training CE cannot be driven below the floor by
            # memorizing a fixed sample (observed with the old fixed 1M-token
            # corpus: train CE 0.85 vs floor 1.23 while validation CE climbed)
            n_windows = max(self.n_train_tokens // self.seq_len, 1)
            self.ds_train = _FreshChainWindows(src, n_windows, self.seq_len + 1, self.seed)
            n_val = max(self.n_val_tokens // self.seq_len, 1)
            self.ds_valid = _ChainWindows(src.sample_windows(n_val, self.seq_len + 1, seed=self.seed + 2))
            return
        if self.source != "python_source":
            raise ValueError(f"unknown source {self.source!r}: expected markov | python_source")
        want = self.n_train_tokens + self.n_val_tokens
        corpus = python_source_corpus(max_bytes=want)
        if len(corpus) < want:
            # a silent shortfall would leave an empty split and an endless
            # epoch loop; fail with the actual numbers instead
            raise ValueError(
                f"python_source corpus holds only {len(corpus)} bytes; "
                f"requested {want} (n_train_tokens + n_val_tokens) — lower the request "
                "or add packages to python_source_corpus"
            )
        self.ds_train = _WindowDataset(corpus[: self.n_train_tokens], self.seq_len)
        self.ds_valid = _WindowDataset(corpus[self.n_train_tokens :], self.seq_len)

    def _collate(self, examples):
        return {
            "input_ids": np.stack([e["input_ids"] for e in examples]),
            "labels": np.stack([e["labels"] for e in examples]),
        }

    def train_dataloader(self) -> DataLoader:
        loader_rng = np.random.default_rng(self._rng.integers(0, 2**63))
        return DataLoader(self.ds_train, self.batch_size, collate_fn=self._collate, shuffle=self.shuffle, rng=loader_rng)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_valid, self.batch_size, collate_fn=self._collate, shuffle=False, drop_last=False)
