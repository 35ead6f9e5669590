from perceiver_io_torch.data.audio.midi_processor import decode_midi, decode_notes, encode_midi, encode_notes
from perceiver_io_torch.data.audio.smf import SMF, read_smf, write_smf
from perceiver_io_torch.data.audio.symbolic import (
    SymbolicAudioCollator,
    SymbolicAudioDataModule,
    SymbolicAudioNumpyDataset,
)
from perceiver_io_torch.data.audio.synthetic import SyntheticMidiDataModule
