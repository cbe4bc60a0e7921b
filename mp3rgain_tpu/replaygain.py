"""ReplayGain 1.0 analysis API (track/album/peak).

Mirrors the reference surface (/root/reference/src/replaygain.rs:929-1074,
1119-1257): analyze_track(_with_index), analyze_album(_with_index),
find_peak_amplitude, is_available, ReplayGainResult, AlbumGainResult.

The analysis pipeline is the device path: native C++ entropy decode
front-end → JAX decode back-end → equal-loudness IIR + RMS windows +
loudness histogram on device (see mp3rgain_tpu.ops / .decode / .analysis).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# 89 dB SPL reference (reference src/replaygain.rs:35-37).
REPLAYGAIN_REFERENCE_DB = 89.0

# Loudness of the -14 dB FS pink-noise calibration signal
# (reference src/replaygain.rs:39-44): gain_db = PINK_REF - loudness_db.
PINK_REF = 64.82

GAIN_STEP_DB = 1.5


@dataclass
class ReplayGainResult:
    loudness_db: float
    gain_db: float
    peak: float
    sample_rate: int
    file_type: str  # "mp3" | "aac"

    def gain_steps(self) -> int:
        from .bitstream import db_to_steps

        return db_to_steps(self.gain_db)


@dataclass
class AlbumGainResult:
    tracks: list[ReplayGainResult]
    album_loudness_db: float
    album_gain_db: float
    album_peak: float

    def album_gain_steps(self) -> int:
        from .bitstream import db_to_steps

        return db_to_steps(self.album_gain_db)


@dataclass
class PeakAmplitudeResult:
    peak: float
    peak_pcm: float
    sample_rate: int


def is_available() -> bool:
    try:
        from . import analysis  # noqa: F401

        return True
    except Exception:
        return False


def analyze_track(path: os.PathLike | str) -> ReplayGainResult:
    return analyze_track_with_index(path, None)


def analyze_track_with_index(
    path: os.PathLike | str, track_index: int | None
) -> ReplayGainResult:
    from . import analysis

    return analysis.analyze_track_internal(path, track_index).result


def analyze_album(files) -> AlbumGainResult:
    return analyze_album_with_index(files, None)


def analyze_album_with_index(files, track_index: int | None) -> AlbumGainResult:
    from . import analysis

    return analysis.analyze_album(files, track_index)


def find_peak_amplitude(path: os.PathLike | str) -> PeakAmplitudeResult:
    from . import analysis

    return analysis.find_peak_amplitude(path)
