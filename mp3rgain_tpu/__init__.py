"""mp3rgain_tpu — batch audio-gain framework on JAX (GPU).

A ground-up rebuild of mp3rgain's capabilities (lossless MP3 gain surgery +
ReplayGain 1.0 analysis) as a device-first pipeline:

- host C++ core for all byte-level work (frame sync, global_gain bit surgery,
  APEv2/ID3/Xing/MP4 handling, MP3 entropy decode front-end),
- JAX/Pallas decode back-end and DSP (equal-loudness IIR, RMS windows,
  loudness histogram, percentile) running batched on device,
- data-parallel scaling over a jax.sharding.Mesh with psum album reduction.

Public surface mirrors the reference library (/root/reference/src/lib.rs).
"""

from .bitstream import (
    GAIN_STEP_DB,
    MAX_GAIN,
    MIN_GAIN,
    Channel,
    Mp3Analysis,
    Mp3Error,
    analyze,
    analyze_data,
    apply_gain,
    apply_gain_channel,
    apply_gain_channel_with_undo,
    apply_gain_db,
    apply_gain_with_undo,
    apply_gain_with_undo_wrap,
    apply_gain_wrap,
    db_to_steps,
    find_max_amplitude,
    is_mono,
    steps_to_db,
    undo_gain,
)
from .ape import (
    ApeTag,
    TAG_MP3GAIN_ALBUM_MINMAX,
    TAG_MP3GAIN_MINMAX,
    TAG_MP3GAIN_UNDO,
    TAG_REPLAYGAIN_ALBUM_GAIN,
    TAG_REPLAYGAIN_ALBUM_PEAK,
    TAG_REPLAYGAIN_TRACK_GAIN,
    TAG_REPLAYGAIN_TRACK_PEAK,
    delete_ape_tag,
    read_ape_tag,
    read_ape_tag_from_file,
    write_ape_tag,
)

__version__ = "0.1.0"

__all__ = [
    "GAIN_STEP_DB",
    "MAX_GAIN",
    "MIN_GAIN",
    "Channel",
    "Mp3Analysis",
    "Mp3Error",
    "ApeTag",
    "analyze",
    "analyze_data",
    "apply_gain",
    "apply_gain_channel",
    "apply_gain_channel_with_undo",
    "apply_gain_db",
    "apply_gain_with_undo",
    "apply_gain_with_undo_wrap",
    "apply_gain_wrap",
    "db_to_steps",
    "delete_ape_tag",
    "find_max_amplitude",
    "is_mono",
    "read_ape_tag",
    "read_ape_tag_from_file",
    "steps_to_db",
    "undo_gain",
    "write_ape_tag",
    "TAG_MP3GAIN_UNDO",
    "TAG_MP3GAIN_MINMAX",
    "TAG_MP3GAIN_ALBUM_MINMAX",
    "TAG_REPLAYGAIN_TRACK_GAIN",
    "TAG_REPLAYGAIN_TRACK_PEAK",
    "TAG_REPLAYGAIN_ALBUM_GAIN",
    "TAG_REPLAYGAIN_ALBUM_PEAK",
    "__version__",
]
