"""Musical note naming for frequency readouts; a copy of the JAX package's
``utils/musical.py``.

Reference parity: ``src/util/audio/musical.rs``.
"""

from __future__ import annotations

import dataclasses
import math

A440_HZ = 440.0
A440_MIDI = 69
SEMITONES_PER_OCTAVE = 12
MIDI_OCTAVE_OFFSET = 1

NOTE_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")


def _freq_to_midi(freq_hz: float) -> float | None:
    if not (isinstance(freq_hz, (int, float)) and math.isfinite(freq_hz) and freq_hz > 0):
        return None
    m = A440_MIDI + SEMITONES_PER_OCTAVE * math.log2(freq_hz / A440_HZ)
    return m if math.isfinite(m) else None


@dataclasses.dataclass(frozen=True)
class MusicalNote:
    midi_number: int

    @staticmethod
    def from_frequency(freq_hz: float) -> "MusicalNote | None":
        m = _freq_to_midi(freq_hz)
        return MusicalNote(round(m)) if m is not None else None

    @property
    def name(self) -> str:
        return NOTE_NAMES[self.midi_number % SEMITONES_PER_OCTAVE]

    @property
    def octave(self) -> int:
        return self.midi_number // SEMITONES_PER_OCTAVE - MIDI_OCTAVE_OFFSET

    def to_frequency(self) -> float:
        return A440_HZ * 2.0 ** ((self.midi_number - A440_MIDI) / SEMITONES_PER_OCTAVE)

    @property
    def is_black(self) -> bool:
        return len(self.name) == 2

    def __str__(self) -> str:
        return f"{self.name}{self.octave}"


@dataclasses.dataclass(frozen=True)
class NoteInfo:
    """Nearest note and cents deviation (reference musical.rs:62-88)."""

    note: MusicalNote
    cents: int

    @staticmethod
    def from_frequency(freq_hz: float) -> "NoteInfo | None":
        m = _freq_to_midi(freq_hz)
        if m is None:
            return None
        rounded = round(m)
        return NoteInfo(MusicalNote(rounded), round((m - rounded) * 100.0))

    def fmt_note_cents(self) -> str:
        sign = "+" if self.cents >= 0 else "-"
        return f"{str(self.note):<4}{sign} {abs(self.cents)} Cents"
