"""Port parity: the MIDI codec (``data/audio/midi_processor.py``), the
Standard MIDI File reader/writer (``smf.py``) and the symbolic-audio data
modules (``symbolic.py``, ``synthetic.py``) against the JAX package's: the
same tokens, the same bytes written, each package reading the other's files,
and the same batches."""

import struct
from dataclasses import dataclass, field

import numpy as np
import pytest

import perceiver_io_torch.data.audio as taudio
from perceiver_io_torch.data.audio import midi_processor as tmp
from perceiver_io_torch.data.audio import smf as tsmf
from perceiver_io_torch.data.audio import symbolic as tsym
from perceiver_io_torch.data.audio import synthetic as tsynth
from perceiver_io_tpu.data.audio import midi_processor as jmp
from perceiver_io_tpu.data.audio import smf as jsmf
from perceiver_io_tpu.data.audio import symbolic as jsym
from perceiver_io_tpu.data.audio import synthetic as jsynth


def _notes(mod, seed, n=40, chords=True):
    rs = np.random.RandomState(seed)
    notes, t = [], 0.0
    for _ in range(n):
        t += float(rs.choice([0.0, 0.01, 0.05, 0.37, 1.23, 2.5])) if chords else float(rs.uniform(0.01, 1.5))
        notes.append(mod.Note(pitch=int(rs.randint(21, 109)), velocity=int(rs.randint(1, 128)),
                              start=round(t, 3), end=round(t + float(rs.uniform(0.02, 3.0)), 3)))
    return notes


def _pedal(mod, seed):
    rs = np.random.RandomState(seed)
    ccs, t = [], 0.0
    for _ in range(6):
        t += float(rs.uniform(0.1, 4.0))
        ccs.append(mod.ControlChange(number=64, value=int(rs.choice([0, 30, 64, 127])), time=round(t, 3)))
    ccs.append(mod.ControlChange(number=7, value=100, time=0.5))  # not a pedal: ignored by the codec
    return ccs


def _same_notes(a, b):
    assert [(n.pitch, n.velocity, n.start, n.end) for n in a] == [(n.pitch, n.velocity, n.start, n.end) for n in b]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pedal", [False, True])
def test_codec_matches_jax(seed, pedal):
    tnotes, jnotes = _notes(tmp, seed, chords=seed % 2 == 0), _notes(jmp, seed, chords=seed % 2 == 0)
    tccs, jccs = (_pedal(tmp, seed), _pedal(jmp, seed)) if pedal else ((), ())
    tokens = tmp.encode_notes(tnotes, tccs)
    assert tokens == jmp.encode_notes(jnotes, jccs)
    assert max(tokens) < tmp.NUM_EVENTS == jmp.NUM_EVENTS == 388
    _same_notes(tmp.decode_notes(tokens), jmp.decode_notes(tokens))
    assert tmp.encode_notes(tmp.decode_notes(tokens)) == jmp.encode_notes(jmp.decode_notes(tokens))


def test_decode_is_tolerant_like_jax():
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 388, 500).tolist()  # unmatched offs, zero-length notes, stray velocities
    _same_notes(tmp.decode_notes(tokens), jmp.decode_notes(tokens))


@pytest.mark.parametrize("seed", range(3))
def test_written_bytes_are_jaxs_and_each_reads_the_others(tmp_path, seed):
    tnotes, jnotes = _notes(tmp, seed), _notes(jmp, seed)
    tccs, jccs = _pedal(tmp, seed), _pedal(jmp, seed)
    data = tsmf.serialize_smf(tnotes, tccs)
    assert data == jsmf.serialize_smf(jnotes, jccs)
    tsmf.write_smf(tmp_path / "port.mid", tnotes, tccs)
    jsmf.write_smf(tmp_path / "jax.mid", jnotes, jccs)
    assert (tmp_path / "port.mid").read_bytes() == (tmp_path / "jax.mid").read_bytes() == data
    for reader_t, reader_j in ((tsmf.read_smf(tmp_path / "jax.mid"), jsmf.read_smf(tmp_path / "port.mid")),):
        _same_notes(reader_t.notes, reader_j.notes)
        assert [(c.number, c.value, c.time) for c in reader_t.control_changes] == \
            [(c.number, c.value, c.time) for c in reader_j.control_changes]
    tokens = tmp.encode_midi(tsmf.read_smf(tmp_path / "jax.mid"))
    assert tokens == jmp.encode_midi(jsmf.read_smf(tmp_path / "port.mid"))
    doc = tmp.decode_midi(tokens, file_path=str(tmp_path / "decoded.mid"))
    jmp.decode_midi(tokens, file_path=str(tmp_path / "jdecoded.mid"))
    assert (tmp_path / "decoded.mid").read_bytes() == (tmp_path / "jdecoded.mid").read_bytes()
    assert tmp.encode_midi(doc) == jmp.encode_midi(jmp.decode_midi(tokens))


def _track(events):
    body = b"".join(events)
    return b"MTrk" + struct.pack(">I", len(body)) + body


def _format1_smpte_bytes(division):
    """A hand-built file: format 1, a tempo track with two tempo changes, a
    note track in running status with velocity-0 note-offs, a sustain pedal,
    program change and pitch bend, and a vendor chunk to skip."""
    tempo = _track([b"\x00\xff\x51\x03\x07\xa1\x20", b"\x83\x60\xff\x51\x03\x0f\x42\x40", b"\x00\xff\x2f\x00"])
    notes = _track([
        b"\x00\xc0\x05", b"\x00\x90\x3c\x40", b"\x10\x40\x50", b"\x20\x3c\x00", b"\x00\xb0\x40\x7f",
        b"\x30\x90\x43\x60", b"\x00\xe0\x00\x40", b"\x40\x80\x40\x00", b"\x81\x00\x90\x43\x00",
        b"\x00\xb0\x40\x00", b"\x00\xf0\x02\x01\x02", b"\x00\xff\x2f\x00"])
    vendor = b"XFIH" + struct.pack(">I", 3) + b"abc"
    header = b"MThd" + struct.pack(">IHHH", 6, 1, 2, division)
    return header + tempo + vendor + notes


@pytest.mark.parametrize("division", [96, 480, 0xE728], ids=["ppq96", "ppq480", "smpte25x40"])
def test_reader_matches_jax_on_format1_tempo_map_and_running_status(division):
    data = _format1_smpte_bytes(division)
    got, want = tsmf.parse_smf(data), jsmf.parse_smf(data)
    _same_notes(got.notes, want.notes)
    assert len(got.notes) == 3
    assert [(c.number, c.value, c.time) for c in got.control_changes] == \
        [(c.number, c.value, c.time) for c in want.control_changes]


@pytest.mark.parametrize("data", [b"RIFF....", b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x01\xf4MTrk\x00\x00\x00\x09\x00"])
def test_malformed_files_raise_valueerror_like_jax(data):
    with pytest.raises(ValueError) as got:
        tsmf.parse_smf(data)
    with pytest.raises(ValueError) as want:
        jsmf.parse_smf(data)
    assert str(got.value) == str(want.value)


@dataclass
class _PmNote:
    pitch: int
    velocity: int
    start: float
    end: float


@dataclass
class _PmInstrument:
    notes: list
    control_changes: list = field(default_factory=list)


@dataclass
class _PrettyMidiShaped:
    instruments: list


def test_pretty_midi_shaped_documents_are_accepted():
    notes = [_PmNote(n.pitch, n.velocity, n.start, n.end) for n in _notes(tmp, 5)]
    doc = _PrettyMidiShaped([_PmInstrument(notes[:20]), _PmInstrument(notes[20:], _pedal(tmp, 5))])
    assert tmp.encode_midi(doc) == jmp.encode_midi(doc)


def _midi_dirs(tmp_path, n_train=5, n_valid=2):
    for split, n in (("train", n_train), ("valid", n_valid)):
        d = tmp_path / "midi" / split
        d.mkdir(parents=True)
        for i in range(n):
            tsmf.write_smf(d / f"{i}.mid", _notes(tmp, 10 * i + len(split), n=60), _pedal(tmp, i))
    (tmp_path / "midi" / "train" / "broken.mid").write_bytes(b"not midi")  # skipped, as the JAX module skips it
    return {"train": tmp_path / "midi" / "train", "valid": tmp_path / "midi" / "valid"}


@pytest.mark.parametrize("kw", [dict(max_seq_len=64, batch_size=3), dict(max_seq_len=48, min_seq_len=16,
                                                                         batch_size=2, padding_side="right", seed=4)],
                         ids=["left", "right_truncated"])
def test_symbolic_audio_data_module_matches_jax(tmp_path, kw):
    source = _midi_dirs(tmp_path)

    class Port(tsym.SymbolicAudioDataModule):
        def load_source_dataset(self):
            return source

    class Jax(jsym.SymbolicAudioDataModule):
        def load_source_dataset(self):
            return source

    port, jax = Port(str(tmp_path / "port"), **kw), Jax(str(tmp_path / "jax"), **kw)
    for m in (port, jax):
        m.prepare_data()
        m.setup()
    for name in ("train.bin", "valid.bin"):
        assert (port.preproc_dir / name).read_bytes() == (jax.preproc_dir / name).read_bytes(), name
    assert port.vocab_size == jax.vocab_size == 389
    for loaders in ((port.train_dataloader(), jax.train_dataloader()), (port.val_dataloader(), jax.val_dataloader())):
        batches = list(zip(*loaders, strict=True))
        assert batches
        for got, want in batches:
            for key in ("labels", "input_ids", "pad_mask"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_collator_matches_jax():
    examples = [{"input_ids": np.arange(n)} for n in (3, 10, 7)]
    for side in ("left", "right"):
        for a, b in zip(tsym.SymbolicAudioCollator(9, padding_side=side)(examples),
                        jsym.SymbolicAudioCollator(9, padding_side=side)(examples), strict=True):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="Invalid padding side"):
        tsym.SymbolicAudioCollator(9, padding_side="middle")


def test_synthetic_midi_data_module_matches_jax():
    kw = dict(seq_len=48, batch_size=4, n_train_chains=24, n_val_chains=8, vocab_size=16, max_latents=16, seed=2)
    port, jax = tsynth.SyntheticMidiDataModule(**kw), jsynth.SyntheticMidiDataModule(**kw)
    for m in (port, jax):
        m.setup()
    assert port.entropy_floor == jax.entropy_floor and port.model_vocab_size == jax.model_vocab_size == 17
    train = (port.train_dataloader(), jax.train_dataloader())
    for _ in range(2):  # fresh chains each epoch
        for got, want in zip(*train, strict=True):
            for key in ("labels", "input_ids", "pad_mask"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for got, want in zip(port.val_dataloader(), jax.val_dataloader(), strict=True):
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    state = port.ds_train.state_dict()
    again = tsynth.SyntheticMidiDataModule(**kw)
    again.setup()
    again.ds_train.load_state_dict(state)
    np.testing.assert_array_equal(again.ds_train[3]["input_ids"], port.ds_train[3]["input_ids"])


def test_package_exports():
    for name in ("encode_notes", "decode_notes", "encode_midi", "decode_midi", "SMF", "read_smf", "write_smf",
                 "SymbolicAudioDataModule", "SymbolicAudioCollator", "SymbolicAudioNumpyDataset",
                 "SyntheticMidiDataModule"):
        assert hasattr(taudio, name), name
