"""Port parity: the offline text data path (``data/text/tokenizer.py``,
``collator.py``, ``common.py`` and ``synthetic.py:python_source_corpus``)
against the JAX package's modules on the same inputs: the same token ids,
arrays, chunk files (byte for byte) and batches, and the same corpus bytes."""

import os

import numpy as np
import pytest

import perceiver_io_torch.data.text as ttext
from perceiver_io_torch.data.text import collator as tcoll
from perceiver_io_torch.data.text import common as tcommon
from perceiver_io_torch.data.text import synthetic as tsyn
from perceiver_io_torch.data.text import tokenizer as ttok
from perceiver_io_tpu.data.text import collator as jcoll
from perceiver_io_tpu.data.text import common as jcommon
from perceiver_io_tpu.data.text import synthetic as jsyn
from perceiver_io_tpu.data.text import tokenizer as jtok

TEXTS = [
    "Hello, world!",
    "  two  spaces\tand a tab\nnewline",
    "Grüße aus Köln — ünïcödé ✓",
    "[CLS] literal [MASK] and [SEP] tokens [PAD]",
    "",
    "x",
]


def _corpus(seed, n):
    rs = np.random.RandomState(seed)
    words = ["def", "return", "self", "import", "numpy", "torch", "(", ")", ":", "\n", "    ", "ü", "✓", "[EOS]"]
    return ["".join(rs.choice(words, rs.randint(5, 120))) for _ in range(n)]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("special", [False, True])
def test_byte_tokenizer_matches_jax(text, special):
    mine, theirs = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    ids = mine.encode(text, special)
    assert ids == theirs.encode(text, special)
    np.testing.assert_array_equal(mine.encode_array(text, special), theirs.encode_array(text, special))
    assert mine.word_ids(ids) == theirs.word_ids(ids)
    for skip in (True, False):
        assert mine.decode(ids, skip) == theirs.decode(ids, skip)
    assert mine([text, "ab"], add_special_tokens=special) == theirs([text, "ab"], add_special_tokens=special)
    assert (mine.vocab_size, mine.pad_token_id, mine.eos_token, mine.padding_side) == \
        (theirs.vocab_size, theirs.pad_token_id, theirs.eos_token, theirs.padding_side)


def test_get_tokenizer_names():
    for name in sorted(ttok.BYTE_TOKENIZER_NAMES):
        assert isinstance(ttok.get_tokenizer(name), ttok.ByteTokenizer)
    assert ttok.BYTE_TOKENIZER_NAMES == jtok.BYTE_TOKENIZER_NAMES
    with pytest.raises(NotImplementedError, match="downloads"):
        ttok.get_tokenizer("bert-base-uncased")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("max_len", [None, 7])
@pytest.mark.parametrize("kind", ["label_ids", "label"])
def test_default_collator_matches_jax(side, max_len, kind):
    rs = np.random.RandomState(len(side) + (max_len or 0))
    examples = []
    for n in (3, 9, 5, 1):
        ids = rs.randint(6, 262, n).tolist()
        extra = {"label_ids": rs.randint(6, 262, n).tolist()} if kind == "label_ids" else {"label": int(rs.randint(4))}
        examples.append({"input_ids": ids, **extra})
    got = tcoll.DefaultCollator(0, max_len, side)(examples)
    want = jcoll.DefaultCollator(0, max_len, side)(examples)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("seed", range(3))
def test_random_truncate_collator_matches_jax(seed):
    examples = [{"input_ids": list(range(6, 6 + n))} for n in (20, 13, 17)]
    got = tcoll.RandomTruncateCollator(tcoll.DefaultCollator(0, 16), 4, np.random.default_rng(seed))
    want = jcoll.RandomTruncateCollator(jcoll.DefaultCollator(0, 16), 4, np.random.default_rng(seed))
    for _ in range(4):
        for a, b in zip(got(examples), want(examples), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("side", [None, "left", "right"])
def test_text_preprocessor_matches_jax(side):
    got = tcommon.TextPreprocessor("bytes", 12, add_special_tokens=True, padding_side=side).preprocess_batch(TEXTS)
    want = jcommon.TextPreprocessor("bytes", 12, add_special_tokens=True, padding_side=side).preprocess_batch(TEXTS)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_random_shift_dataset_matches_jax_and_resumes():
    chunks = np.arange(6 * 9, dtype=np.int32).reshape(6, 9)
    got = tcommon.RandomShiftDataset(tcommon.ChunkDataset(chunks), np.random.default_rng(4))
    want = jcommon.RandomShiftDataset(jcommon.ChunkDataset(chunks), np.random.default_rng(4))
    assert len(got) == len(want) == 5
    for i in (0, 3, 1):
        assert got[i] == want[i]
    snap = got.state_dict()
    after = [got[i] for i in range(5)]
    got.load_state_dict(snap)
    assert [got[i] for i in range(5)] == after
    want.load_state_dict(snap)  # the snapshots are interchangeable
    assert [want[i] for i in range(5)] == after


def test_chunk_stream_and_writer_match_jax(tmp_path):
    lists = [list(range(n)) for n in (5, 11, 3, 17)]
    np.testing.assert_array_equal(tcommon.chunk_token_stream(lists, 4), jcommon.chunk_token_stream(lists, 4))
    for mod, name in ((tcommon, "port.bin"), (jcommon, "jax.bin")):
        w = mod.ChunkFileWriter(str(tmp_path / name), 6)
        for t in lists:
            w.write(t)
        w.close()
        assert w.num_chunks == sum(map(len, lists)) // 6
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    np.testing.assert_array_equal(tcommon.open_chunk_file(str(tmp_path / "port.bin"), 6),
                                  jcommon.open_chunk_file(str(tmp_path / "jax.bin"), 6))


def _modules(tmp_path, task_name, **kw):
    train, valid = _corpus(1, 40), _corpus(2, 12)
    if task_name == "clf":
        rs = np.random.RandomState(3)
        source = {"train": (train, rs.randint(0, 3, len(train)).tolist()),
                  "valid": (valid, rs.randint(0, 3, len(valid)).tolist())}
    else:
        source = {"train": train, "valid": valid}

    class Port(tcommon.TextDataModule):
        def load_source_dataset(self):
            return source

    class Jax(jcommon.TextDataModule):
        def load_source_dataset(self):
            return source

    port = Port(str(tmp_path / "port"), task=tcommon.Task[task_name], **kw)
    jax = Jax(str(tmp_path / "jax"), task=jcommon.Task[task_name], **kw)
    return port, jax


CASES = {
    "clm_plain": ("clm", dict(max_seq_len=32, batch_size=4)),
    "clm_shift_left": ("clm", dict(max_seq_len=32, batch_size=3, random_train_shift=True, random_valid_shift=True,
                                   padding_side="left", add_eos_token=True, seed=2)),
    "clm_truncate_special": ("clm", dict(max_seq_len=24, batch_size=4, random_train_truncation=True,
                                         random_min_seq_len=8, add_special_tokens=True, seed=5)),
    "clf": ("clf", dict(max_seq_len=40, batch_size=4, seed=1)),
    "clf_left": ("clf", dict(max_seq_len=30, batch_size=5, padding_side="left", random_valid_truncation=True,
                             random_min_seq_len=6, seed=7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_text_data_module_matches_jax(tmp_path, case):
    task, kw = CASES[case]
    port, jax = _modules(tmp_path, task, **kw)
    assert port.preproc_dir_hash_input() == jax.preproc_dir_hash_input()
    assert os.path.basename(port.preproc_dir) == os.path.basename(jax.preproc_dir)
    for m in (port, jax):
        m.prepare_data()
        m.setup()
    assert sorted(os.listdir(port.preproc_dir)) == sorted(os.listdir(jax.preproc_dir))
    for name in sorted(os.listdir(port.preproc_dir)):
        if name.endswith(".bin"):
            with open(os.path.join(port.preproc_dir, name), "rb") as a, \
                    open(os.path.join(jax.preproc_dir, name), "rb") as b:
                assert a.read() == b.read(), name
    for loaders in ((port.train_dataloader(), jax.train_dataloader()), (port.val_dataloader(), jax.val_dataloader())):
        for _ in range(2):  # two epochs
            batches = list(zip(*loaders, strict=True))
            assert batches
            for got, want in batches:
                assert set(got) == set(want)
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if task == "clm":
        example = port.ds_train[0]
        assert len(example["input_ids"]) == len(example["label_ids"]) == kw["max_seq_len"]
    pre, jpre = port.text_preprocessor(), jax.text_preprocessor()
    for a, b in zip(pre.preprocess_batch(TEXTS[:3]), jpre.preprocess_batch(TEXTS[:3]), strict=True):
        np.testing.assert_array_equal(a, b)


def test_clm_loader_resumes_mid_epoch_with_the_shift_rng(tmp_path):
    """The loader's snapshot covers the shift augmentation's generator
    (``RandomShiftDataset.state_dict``): a restored loader gives the same
    next batches as the uninterrupted one."""
    port, _ = _modules(tmp_path, "clm", max_seq_len=16, batch_size=2, random_train_shift=True, seed=3)
    port.prepare_data()
    port.setup()
    loader = port.train_dataloader()
    it = iter(loader)
    next(it)
    snap = loader.state_dict()
    rest = [b["input_ids"] for b in it]
    loader.load_state_dict(snap)
    again = [b["input_ids"] for b in loader]
    assert len(rest) == len(again) > 0
    for a, b in zip(rest, again):
        np.testing.assert_array_equal(a, b)


_PARALLEL_SOURCE = {"train": _corpus(4, 30), "valid": _corpus(5, 9)}


class _PortParallel(tcommon.TextDataModule):  # module level: the workers rebuild it by import path
    def load_source_dataset(self):
        return _PARALLEL_SOURCE


class _JaxParallel(jcommon.TextDataModule):
    def load_source_dataset(self):
        return _PARALLEL_SOURCE


def test_parallel_preparation_writes_jaxs_shards(tmp_path):
    """Two tokenizing worker processes: the same hash (with the worker
    count), the same concatenated chunk files."""
    port = _PortParallel(str(tmp_path / "port"), task=tcommon.Task.clm, max_seq_len=16, preproc_workers=2)
    jax = _JaxParallel(str(tmp_path / "jax"), task=jcommon.Task.clm, max_seq_len=16, preproc_workers=2)
    assert os.path.basename(port.preproc_dir) == os.path.basename(jax.preproc_dir)
    for m in (port, jax):
        m.prepare_data()
    for split in ("train", "valid"):
        with open(os.path.join(port.preproc_dir, f"{split}.ids.bin"), "rb") as a, \
                open(os.path.join(jax.preproc_dir, f"{split}.ids.bin"), "rb") as b:
            assert a.read() == b.read()


def test_mlm_task_waits_for_its_collators(tmp_path):
    with pytest.raises(NotImplementedError, match="A3.3"):
        tcommon.TextDataModule(str(tmp_path), task=tcommon.Task.mlm)


@pytest.mark.parametrize("max_bytes", [1, 50_000, 700_000])
def test_python_source_corpus_matches_jax(max_bytes):
    packages = ("numpy", "torch")  # installed beside both packages here and on the card
    got = tsyn.python_source_corpus(max_bytes, packages=packages)
    want = jsyn.python_source_corpus(max_bytes, packages=packages)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes() and len(got) == max_bytes


def test_package_exports():
    for name in ("ByteTokenizer", "get_tokenizer", "DefaultCollator", "RandomTruncateCollator", "TextDataModule",
                 "Task", "CLMDataset", "RandomShiftDataset", "TextPreprocessor", "python_source_corpus"):
        assert hasattr(ttext, name), name
