"""ReplayGain analysis drivers: the host↔device glue.

Single-track and album analysis mirroring the reference drivers
(/root/reference/src/replaygain.rs:796-941, 1031-1074): native entropy
decode → device decode back-end → equal-loudness filter → RMS windows →
loudness histogram → host percentile readout; gain = PINK_REF − loudness.

Batched multi-track / multi-device analysis lives in
mp3rgain_tpu.parallel.runner; these drivers are the simple sequential
path used by the CLI for small file sets.
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

from .utils.jaxcache import ensure_compilation_cache

ensure_compilation_cache()

from . import backend, mp4meta
from .decode import frontend
from .ops import histogram as hi
from .replaygain import (
    AlbumGainResult,
    PINK_REF,
    PeakAmplitudeResult,
    ReplayGainResult,
)

# Filters operate in the 16-bit integer sample range, not normalized floats
# (reference src/replaygain.rs:943-949).
SAMPLE_SCALE_16BIT = 32768.0


class AnalysisError(RuntimeError):
    pass


class TrackAnalysisInternal:
    def __init__(self, result: ReplayGainResult, hist, audio_seconds: float = 0.0):
        self.result = result
        self.histogram = hist  # (12000,) int32, device array
        self.audio_seconds = audio_seconds


def _sniff_adts(head: bytes) -> bool:
    """True if `head` starts (after any ID3v2 tag) with a plausible ADTS
    AAC frame. ADTS sync is 12 bits of 1s with layer '00'
    (b1 & 0xF6 == 0xF0); MP3 Layer III has nonzero layer bits there, so
    the two never collide. Confirmed by checking the next frame header at
    aac_frame_length, mirroring the MP3 iterator's two-frame validation."""
    pos = 0
    if head[:3] == b"ID3" and len(head) >= 10:
        size = (
            (head[6] & 0x7F) << 21 | (head[7] & 0x7F) << 14
            | (head[8] & 0x7F) << 7 | (head[9] & 0x7F)
        )
        pos = 10 + size
    if pos + 7 > len(head):
        return False
    b = head[pos:]
    if b[0] != 0xFF or (b[1] & 0xF6) != 0xF0:
        return False
    frame_len = ((b[3] & 0x03) << 11) | (b[4] << 3) | (b[5] >> 5)
    if frame_len < 7:
        return False
    nxt = pos + frame_len
    if nxt + 2 <= len(head):
        return head[nxt] == 0xFF and (head[nxt + 1] & 0xF6) == 0xF0
    return nxt >= len(head)  # single trailing frame


def _detect_file_type(path) -> str:
    """File-type routing (reference src/replaygain.rs:779-785 plus the
    symphonia probe's extension hint, src/replaygain.rs:811-822): MP4
    containers and raw ADTS AAC streams both take the AAC path."""
    if mp4meta.is_mp4_file(path):
        return "aac"
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
    if _sniff_adts(head):
        return "aac"
    return "mp3"


@lru_cache(maxsize=None)
def _single_track_fn(n_channels: int, sample_rate: int, dtype):
    from .parallel.runner import _analysis_core

    return jax.jit(
        partial(
            _analysis_core,
            n_channels=n_channels,
            sample_rate=sample_rate,
            dtype=dtype,
        )
    )


@lru_cache(maxsize=None)
def _single_track_fn_light(n_channels: int, sample_rate: int, dtype,
                           nb: int, lanes: int, g_max: int, interpret: bool):
    from .parallel.runner import _analysis_core_light

    return jax.jit(
        partial(
            _analysis_core_light,
            nb=nb, lanes=lanes, g_max=g_max,
            n_channels=n_channels, sample_rate=sample_rate,
            dtype=dtype, interpret=interpret,
        )
    )


def _analyze_mp3_on_device(path, dtype):
    """Whole-track device pipeline; only scalars return to host.

    Where backend.device_entropy() says so (the GPU), the Huffman stage
    also runs on device (raw-bits manifest + Pallas entropy kernel,
    decode/entropy_kernel.py); elsewhere the host decodes spectra
    (decode/frontend.unpack_file)."""
    from .parallel.runner import (
        prepare_batch_arrays,
        prepare_batch_arrays_light,
    )

    if backend.device_entropy():
        with open(path, "rb") as f:
            u = frontend.unpack_data_light_packed(f.read())
        if u.n == 0:
            raise AnalysisError("No valid MP3 frames found")
        sr, nch = u.sample_rate, u.n_channels
        prep, rest, g_max = prepare_batch_arrays_light([u], nch)
        fn = _single_track_fn_light(
            nch, sr, dtype, prep.nb, prep.lanes, g_max,
            backend.interpret_kernels(),
        )
        hist, loud_idx, peak = fn(*prep.device_args(), *rest)
        jax.block_until_ready((hist, loud_idx, peak))
        from .utils import bufpool

        bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
    else:
        u = frontend.unpack_file(path)
        if u.n == 0:
            raise AnalysisError("No valid MP3 frames found")
        sr, nch = u.sample_rate, u.n_channels
        args = prepare_batch_arrays([u], nch)
        fn = _single_track_fn(nch, sr, dtype)
        hist, loud_idx, peak = fn(*args)
    stats = np.asarray(
        jnp.stack([loud_idx[0].astype(jnp.float32), peak[0].astype(jnp.float32)])
    )
    return hist[0], hi.index_to_loudness(stats[0]), float(stats[1]), sr


def analyze_track_internal(
    path: os.PathLike | str,
    track_index: int | None = None,
    dtype=jnp.float32,
) -> TrackAnalysisInternal:
    file_type = _detect_file_type(path)
    if file_type == "aac":
        from . import aac

        return aac.analyze_track_internal(
            path, dtype=dtype, track_index=track_index
        )

    # MP3 streams have exactly one audio track (reference message:
    # src/replaygain.rs:838-851).
    if track_index not in (None, 0):
        raise AnalysisError(
            f"Track index {track_index} out of range (file has 1 audio track(s))"
        )
    hist, loudness_db, peak, sr = _analyze_mp3_on_device(path, dtype)
    result = ReplayGainResult(
        loudness_db=loudness_db,
        gain_db=PINK_REF - loudness_db,
        peak=peak,
        sample_rate=sr,
        file_type=file_type,
    )
    return TrackAnalysisInternal(result, hist)


def analyze_album(files, track_index: int | None = None, dtype=jnp.float32) -> AlbumGainResult:
    """Sequential album analysis: union histogram (duration-weighted), peak
    max — mirrors reference analyze_album_with_index
    (src/replaygain.rs:1044-1074). Histograms accumulate on device; the
    data-parallel mesh version is in mp3rgain_tpu.parallel.runner."""
    tracks = []
    album_peak = 0.0
    album_hist = None
    for f in files:
        internal = analyze_track_internal(f, track_index, dtype=dtype)
        album_peak = max(album_peak, internal.result.peak)
        h = jnp.asarray(internal.histogram)
        album_hist = h if album_hist is None else album_hist + h
        tracks.append(internal.result)
    album_loudness = float(hi.loudness_from_histogram_device(album_hist[None])[0])
    return AlbumGainResult(
        tracks=tracks,
        album_loudness_db=album_loudness,
        album_gain_db=PINK_REF - album_loudness,
        album_peak=album_peak,
    )


def find_peak_amplitude(path: os.PathLike | str, dtype=jnp.float32) -> PeakAmplitudeResult:
    """True decoded peak over all channels (reference src/replaygain.rs:1140-1249).

    Unlike the reference's decoder (which clips at ±1.0), the device
    decode path reports the true unclipped peak — matching original mp3gain."""
    if _detect_file_type(path) == "aac":
        from . import aac

        return aac.find_peak_amplitude(path, dtype=dtype)
    _, _, peak, sr = _analyze_mp3_on_device(path, dtype)
    return PeakAmplitudeResult(peak=peak, peak_pcm=peak * SAMPLE_SCALE_16BIT, sample_rate=sr)
