"""MIDI event codec: notes <-> Music-Transformer-style event tokens.

The port's own copy of ``perceiver_io_tpu/data/audio/midi_processor.py``
(pure Python and numpy, the same code). The event vocabulary:
  - note_on   pitch 0..127      -> token 0..127
  - note_off  pitch 0..127      -> token 128..255
  - time_shift 10ms..1s (100)   -> token 256..355 (value+1 hundredths of a second)
  - velocity  32 4-step bins    -> token 356..387
388 event tokens; the data module adds PAD=388 for a model vocab of 389.

It works on plain ``Note``/``ControlChange`` records, and ``.mid`` files are
read and written by the port's Standard-MIDI-File codec in ``smf.py``. A
pretty_midi-shaped document (``.instruments`` with notes and control
changes) is accepted duck-typed; pretty_midi is never imported.
Sustain-pedal (CC64) handling matches the reference: notes sounding while the
pedal is down are extended until the next onset of the same pitch or the pedal
release, whichever comes first.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

RANGE_NOTE_ON = 128
RANGE_NOTE_OFF = 128
RANGE_TIME_SHIFT = 100
RANGE_VEL = 32

NOTE_ON_OFFSET = 0
NOTE_OFF_OFFSET = RANGE_NOTE_ON
TIME_SHIFT_OFFSET = RANGE_NOTE_ON + RANGE_NOTE_OFF
VELOCITY_OFFSET = RANGE_NOTE_ON + RANGE_NOTE_OFF + RANGE_TIME_SHIFT
NUM_EVENTS = VELOCITY_OFFSET + RANGE_VEL  # 388


@dataclass
class Note:
    pitch: int
    velocity: int
    start: float
    end: float


@dataclass
class ControlChange:
    number: int
    value: int
    time: float


def _apply_sustain(notes: List[Note], control_changes: Sequence[ControlChange]) -> List[Note]:
    """Extend notes held through a down sustain pedal (CC64 >= 64) until the next
    onset of the same pitch or the pedal release."""
    pedal_spans: List[Tuple[float, float]] = []
    down: Optional[float] = None
    for cc in sorted((c for c in control_changes if c.number == 64), key=lambda c: c.time):
        if cc.value >= 64 and down is None:
            down = cc.time
        elif cc.value < 64 and down is not None:
            pedal_spans.append((down, cc.time))
            down = None
    if down is not None:
        pedal_spans.append((down, max((n.end for n in notes), default=down)))

    if not pedal_spans:
        return sorted(notes, key=lambda n: n.start)

    notes = sorted((replace(n) for n in notes), key=lambda n: n.start)
    for span_start, span_end in pedal_spans:
        managed = [n for n in notes if span_start <= n.start <= span_end]
        # walk backwards: each managed note sustains to the next onset of the same
        # pitch, or to the pedal release
        next_onset: Dict[int, float] = {}
        for n in reversed(managed):
            n.end = next_onset.get(n.pitch, max(span_end, n.end))
            next_onset[n.pitch] = n.start
    return sorted(notes, key=lambda n: n.start)


def _time_shift_tokens(prev_time: float, post_time: float) -> List[int]:
    interval = int(round((post_time - prev_time) * 100))
    tokens = []
    while interval >= RANGE_TIME_SHIFT:
        tokens.append(TIME_SHIFT_OFFSET + RANGE_TIME_SHIFT - 1)
        interval -= RANGE_TIME_SHIFT
    if interval > 0:
        tokens.append(TIME_SHIFT_OFFSET + interval - 1)
    return tokens


def encode_notes(notes: Sequence[Note], control_changes: Sequence[ControlChange] = ()) -> List[int]:
    """Notes -> event token sequence."""
    notes = _apply_sustain(list(notes), control_changes)
    # split into timestamped on/off markers
    markers: List[Tuple[float, int, int, Optional[int]]] = []  # (time, order, pitch, velocity|None)
    for n in notes:
        markers.append((n.start, 0, n.pitch, n.velocity))
        markers.append((n.end, 1, n.pitch, None))
    markers.sort(key=lambda m: m[0])

    tokens: List[int] = []
    cur_time = 0.0
    cur_vel_bin = 0
    for time, kind, pitch, velocity in markers:
        tokens.extend(_time_shift_tokens(cur_time, time))
        if velocity is not None:
            vel_bin = velocity // 4
            if vel_bin != cur_vel_bin:
                tokens.append(VELOCITY_OFFSET + vel_bin)
                cur_vel_bin = vel_bin
            tokens.append(NOTE_ON_OFFSET + pitch)
        else:
            tokens.append(NOTE_OFF_OFFSET + pitch)
        cur_time = time
    return tokens


def decode_notes(tokens: Sequence[int]) -> List[Note]:
    """Event token sequence -> notes (zero-length notes are dropped; unmatched
    note_offs are ignored, matching the reference's tolerant decoding). Notes
    come back in onset order with ties broken by NOTE_ON token order — chords
    keep their event order, so encode_notes(decode_notes(t)) == t."""
    timeline = 0.0
    velocity = 0
    seq = 0
    open_notes: Dict[int, Tuple[float, int, int]] = {}  # pitch -> (start, velocity, onset_seq)
    staged: List[Tuple[float, int, Note]] = []
    for token in tokens:
        token = int(token)
        if token < NOTE_OFF_OFFSET:
            open_notes[token] = (timeline, velocity, seq)
            seq += 1
        elif token < TIME_SHIFT_OFFSET:
            pitch = token - NOTE_OFF_OFFSET
            if pitch in open_notes:
                start, vel, s = open_notes.pop(pitch)
                if timeline > start:
                    staged.append((start, s, Note(pitch=pitch, velocity=vel, start=start, end=timeline)))
        elif token < VELOCITY_OFFSET:
            timeline += (token - TIME_SHIFT_OFFSET + 1) / 100.0
        elif token < NUM_EVENTS:
            velocity = (token - VELOCITY_OFFSET) * 4
    staged.sort(key=lambda x: (x[0], x[1]))
    return [n for _, _, n in staged]


# -------------------------------------------------------------------- file IO
# The Standard-MIDI-File parse/serialize of data/audio/smf.py; pretty_midi
# documents are accepted duck-typed (their .instruments attribute).


def encode_midi(midi) -> List[int]:
    """A MIDI document -> tokens. Accepts an ``smf.SMF`` (native reader output)
    or any pretty_midi-shaped object (``.instruments`` with notes/CCs)."""
    if hasattr(midi, "instruments"):  # a pretty_midi.PrettyMIDI-shaped document
        notes = [Note(n.pitch, n.velocity, n.start, n.end) for inst in midi.instruments for n in inst.notes]
        ccs = [ControlChange(c.number, c.value, c.time) for inst in midi.instruments for c in inst.control_changes]
        return encode_notes(notes, ccs)
    return encode_notes(midi.notes, midi.control_changes)


def decode_midi(tokens: Sequence[int], file_path: Optional[str] = None):
    """Tokens -> ``smf.SMF`` document (dependency-free); writes a format-0
    .mid file when ``file_path`` is given."""
    from perceiver_io_torch.data.audio.smf import SMF

    doc = SMF(notes=decode_notes(tokens))
    if file_path is not None:
        doc.write(file_path)
    return doc


def encode_midi_file(path: str) -> Optional[np.ndarray]:
    try:
        from perceiver_io_torch.data.audio.smf import read_smf

        doc = read_smf(str(path))
        return np.asarray(encode_notes(doc.notes, doc.control_changes), dtype=np.int16)
    except Exception as e:  # noqa: BLE001 — skip unreadable files like the reference
        print(f"Error encoding midi file [{path}]: {e}")
        return None


def encode_midi_files(files: Sequence[str], num_workers: int = 1) -> List[np.ndarray]:
    if num_workers > 1:
        from multiprocessing import Pool

        with Pool(processes=num_workers) as pool:
            results = pool.map(encode_midi_file, files)
    else:
        results = [encode_midi_file(f) for f in files]
    return [r for r in results if r is not None]
