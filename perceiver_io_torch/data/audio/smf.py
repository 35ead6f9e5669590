"""Dependency-free Standard MIDI File (SMF) reader/writer.

The port's own copy of ``perceiver_io_tpu/data/audio/smf.py`` (pure Python,
the same code, so both packages read each other's files and write the same
bytes). Scope — the subset the symbolic-audio task consumes and produces:
  read  formats 0/1, PPQ and SMPTE divisions, tempo map (all tempo changes,
        any track), running status, note on/off pairing (FIFO per
        channel+pitch, velocity-0 note-on = note-off), control changes
        (sustain CC64 is what the codec uses), sysex/meta and alien-chunk
        skipping. Format-2 files parse tolerantly but their independent
        sequences are merged onto one timeline.
  write format 0, PPQ division 500 at 120 bpm (1 tick = 1 ms, so the codec's
        10 ms time grid is exactly representable), note events + control
        changes + end-of-track.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from perceiver_io_torch.data.audio.midi_processor import ControlChange, Note

_WRITE_DIVISION = 500  # ticks per quarter note
_WRITE_TEMPO_US = 500_000  # microseconds per quarter note (120 bpm) -> 1 tick = 1 ms


@dataclass
class SMF:
    """A parsed (or to-be-written) MIDI document at the Note/CC level — the
    minimal surface the pipeline needs (``.notes``, ``.control_changes``,
    ``.write``); pretty_midi's richer object model is intentionally not
    mirrored."""

    notes: List[Note] = field(default_factory=list)
    control_changes: List[ControlChange] = field(default_factory=list)

    def write(self, path) -> None:
        with open(path, "wb") as f:
            f.write(serialize_smf(self.notes, self.control_changes))


# ------------------------------------------------------------------- reading


def _read_varlen(data: bytes, i: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, i


def _parse_track(data: bytes):
    """One MTrk payload -> (events, tempo_changes); times in absolute ticks.
    events: (tick, kind, channel, a, b) with kind in {"on", "off", "cc"}."""
    events = []
    tempos = []  # (tick, us_per_quarter)
    tick = 0
    i = 0
    status = 0
    while i < len(data):
        delta, i = _read_varlen(data, i)
        tick += delta
        b = data[i]
        if b & 0x80:
            status = b
            i += 1
        elif status == 0:
            raise ValueError("running status byte before any status byte")
        if status == 0xFF:  # meta
            mtype = data[i]
            length, i = _read_varlen(data, i + 1)
            if mtype == 0x51 and length == 3:
                tempos.append((tick, int.from_bytes(data[i : i + 3], "big")))
            i += length
            if mtype == 0x2F:  # end of track
                break
            status = 0  # meta/sysex cancel running status
        elif status in (0xF0, 0xF7):  # sysex
            length, i = _read_varlen(data, i)
            i += length
            status = 0
        else:
            kind = status & 0xF0
            ch = status & 0x0F
            if kind in (0xC0, 0xD0):  # program change / channel pressure: 1 byte
                i += 1
            else:
                a, b2 = data[i], data[i + 1]
                i += 2
                if kind == 0x90 and b2 > 0:
                    events.append((tick, "on", ch, a, b2))
                elif kind == 0x80 or (kind == 0x90 and b2 == 0):
                    events.append((tick, "off", ch, a, b2))
                elif kind == 0xB0:
                    events.append((tick, "cc", ch, a, b2))
                # 0xA0 polytouch / 0xE0 pitch bend: parsed (2 bytes) and dropped
    return events, tempos


def _tick_to_seconds(division: int, tempos: List[Tuple[int, int]]):
    """Piecewise-linear tick -> seconds under the (sorted) tempo map."""
    if division & 0x8000:  # SMPTE: tempo-independent
        fps = 256 - (division >> 8)  # two's complement of the negative high byte
        tpf = division & 0xFF
        per_tick = 1.0 / (fps * tpf)
        return lambda tick: tick * per_tick

    tempos = sorted(tempos) or [(0, _WRITE_TEMPO_US)]
    if tempos[0][0] != 0:
        tempos.insert(0, (0, _WRITE_TEMPO_US))  # SMF default 120 bpm before the first change
    # prefix sums: seconds at each tempo-change tick
    starts = [0.0]
    for (t0, us0), (t1, _) in zip(tempos, tempos[1:]):
        starts.append(starts[-1] + (t1 - t0) * us0 / (1e6 * division))

    def to_sec(tick: int) -> float:
        # linear scan is fine: real files have a handful of tempo changes
        k = 0
        for j, (t0, _) in enumerate(tempos):
            if t0 <= tick:
                k = j
            else:
                break
        t0, us0 = tempos[k]
        return starts[k] + (tick - t0) * us0 / (1e6 * division)

    return to_sec


def parse_smf(data: bytes) -> SMF:
    """SMF bytes -> notes + control changes (times in seconds). Raises
    ValueError (never raw IndexError/struct.error) on malformed input."""
    try:
        return _parse_smf(data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"malformed/truncated Standard MIDI File: {e}") from e


def _parse_smf(data: bytes) -> SMF:
    if data[:4] != b"MThd":
        raise ValueError("not a Standard MIDI File (missing MThd)")
    hlen, fmt, ntrks, division = struct.unpack(">IHHH", data[4:14])
    i = 8 + hlen

    all_events = []
    all_tempos = []
    tracks_seen = 0
    while tracks_seen < ntrks and i + 8 <= len(data):
        tag = data[i : i + 4]
        (tlen,) = struct.unpack(">I", data[i + 4 : i + 8])
        if i + 8 + tlen > len(data):
            raise ValueError(
                f"malformed SMF: truncated chunk {tag!r} declares {tlen} bytes "
                f"but only {len(data) - i - 8} remain"
            )
        if tag == b"MTrk":
            events, tempos = _parse_track(data[i + 8 : i + 8 + tlen])
            all_events.extend(events)
            all_tempos.extend(tempos)
            tracks_seen += 1
        # else: alien chunk (vendor extensions like Yamaha XF) — the spec says
        # skip ANY unrecognized chunk by its declared length (tags with spaces
        # or punctuation are legal); only a length overrunning the file is fatal
        i += 8 + tlen

    to_sec = _tick_to_seconds(division, all_tempos)
    all_events.sort(key=lambda e: (e[0], e[1] != "off"))  # offs first at equal ticks

    ordered = []  # (start_sec, onset_seq, Note) — onset_seq preserves chord order
    ccs: List[ControlChange] = []
    open_notes = {}  # (channel, pitch) -> [(start_sec, velocity, onset_seq), ...] FIFO
    onset_seq = 0
    for tick, kind, ch, a, b in all_events:
        t = to_sec(tick)
        if kind == "on":
            open_notes.setdefault((ch, a), []).append((t, b, onset_seq))
            onset_seq += 1
        elif kind == "off":
            stack = open_notes.get((ch, a))
            if stack:
                start, vel, seq = stack.pop(0)
                if t > start:
                    ordered.append((start, seq, Note(pitch=a, velocity=vel, start=start, end=t)))
        else:
            ccs.append(ControlChange(number=a, value=b, time=t))
    # sort by onset time, ties broken by ONSET order (not note-off order): a
    # chord's note-on sequence survives a parse -> re-encode roundtrip
    ordered.sort(key=lambda s: (s[0], s[1]))
    return SMF(notes=[n for _, _, n in ordered], control_changes=ccs)


def read_smf(path) -> SMF:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return parse_smf(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


# ------------------------------------------------------------------- writing


def _varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"variable-length quantity must be non-negative, got {value}")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def serialize_smf(notes: Sequence[Note], control_changes: Sequence[ControlChange] = ()) -> bytes:
    """Notes + control changes -> format-0 SMF bytes (single track, fixed
    120 bpm, 1 ms ticks). Notes shorter than one tick are stretched to one tick
    (an off at the on's tick would sort first and read back as a dropped note).
    """
    markers = []  # (tick, order, status, data1, data2) — offs < ccs < ons at equal ticks
    for n in notes:
        vel = min(max(int(n.velocity), 1), 127)  # velocity 0 would read back as note-off
        on_tick = max(round(n.start * 1000), 0)  # negative times clamp to 0
        off_tick = max(round(n.end * 1000), on_tick + 1)
        markers.append((on_tick, 2, 0x90, int(n.pitch) & 0x7F, vel))
        markers.append((off_tick, 0, 0x80, int(n.pitch) & 0x7F, 0x40))
    for c in control_changes:
        markers.append((max(round(c.time * 1000), 0), 1, 0xB0, int(c.number) & 0x7F, int(c.value) & 0x7F))
    markers.sort(key=lambda m: (m[0], m[1]))

    track = bytearray()
    track += _varlen(0) + bytes([0xFF, 0x51, 0x03]) + _WRITE_TEMPO_US.to_bytes(3, "big")
    prev_tick = 0
    for tick, _, status, pitch, vel in markers:
        track += _varlen(tick - prev_tick) + bytes([status, pitch, vel])
        prev_tick = tick
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])

    header = b"MThd" + struct.pack(">IHHH", 6, 0, 1, _WRITE_DIVISION)
    return header + b"MTrk" + struct.pack(">I", len(track)) + bytes(track)


def write_smf(path, notes: Sequence[Note], control_changes: Sequence[ControlChange] = ()) -> None:
    SMF(notes=list(notes), control_changes=list(control_changes)).write(path)
