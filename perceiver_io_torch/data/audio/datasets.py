"""The symbolic-audio script's default data module: GiantMIDI-Piano.

Port of ``perceiver_io_tpu/data/audio/datasets.py``'s
``GiantMidiPianoDataModule``: download and extract the archive and split
its MIDI files into train and valid directories. The network is touched
only in ``load_source_dataset``; a prepared memmap works offline
(``SymbolicAudioDataModule.prepare_data`` returns when it exists). Maestro
V3 is not ported.
"""

from __future__ import annotations

import os
import shutil
import urllib.request
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

from perceiver_io_torch.data.audio.symbolic import SymbolicAudioDataModule

GIANTMIDI_URL = "https://github.com/bytedance/GiantMIDI-Piano/releases/download/d1.0/midis_v1.2.zip"


def _download_and_extract(url: str, target_dir: Path) -> Path:
    target_dir.mkdir(parents=True, exist_ok=True)
    archive = target_dir / os.path.basename(url)
    if not archive.exists():
        urllib.request.urlretrieve(url, archive)  # noqa: S310
    extracted = target_dir / "extracted"
    if not extracted.exists():
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(extracted)
    return extracted


@dataclass
class GiantMidiPianoDataModule(SymbolicAudioDataModule):
    """GiantMIDI-Piano: a deterministic split of the sorted files, the first
    ``valid_fraction`` of them for validation."""

    valid_fraction: float = 0.01

    def load_source_dataset(self) -> Dict[str, Path]:
        root = Path(self.dataset_dir)
        extracted = _download_and_extract(GIANTMIDI_URL, root / "source")
        files = sorted(extracted.rglob("**/*.mid")) + sorted(extracted.rglob("**/*.midi"))
        n_valid = max(1, int(len(files) * self.valid_fraction))
        train_dir, valid_dir = root / "split" / "train", root / "split" / "valid"
        for d, split_files in ((train_dir, files[n_valid:]), (valid_dir, files[:n_valid])):
            d.mkdir(parents=True, exist_ok=True)
            for f in split_files:
                target = d / f.name
                if not target.exists():
                    shutil.copy(f, target)
        return {"train": train_dir, "valid": valid_dir}
