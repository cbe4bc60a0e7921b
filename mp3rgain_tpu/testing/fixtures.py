"""MP3 fixture generation via libmp3lame (ctypes).

Mirrors the reference CI's ffmpeg-generated 1-second 440 Hz sine fixtures
(reference .github/workflows/ci.yml, docs/compatibility-report.md:159-164):
stereo CBR 128k, mono CBR 64k, joint stereo, and VBR — plus extra rates and
MPEG-2/2.5 variants for decoder branch coverage.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_lame = ctypes.CDLL("libmp3lame.so.0")
_lame.lame_init.restype = ctypes.c_void_p
for name in [
    "lame_set_in_samplerate",
    "lame_set_out_samplerate",
    "lame_set_num_channels",
    "lame_set_brate",
    "lame_set_mode",
    "lame_set_VBR",
    "lame_set_VBR_q",
    "lame_set_quality",
    "lame_set_bWriteVbrTag",
    "lame_set_disable_reservoir",
]:
    fn = getattr(_lame, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
_lame.lame_init_params.restype = ctypes.c_int
_lame.lame_init_params.argtypes = [ctypes.c_void_p]
_lame.lame_encode_buffer.restype = ctypes.c_int
_lame.lame_encode_buffer.argtypes = [
    ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_short),
    ctypes.POINTER(ctypes.c_short),
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_ubyte),
    ctypes.c_int,
]
_lame.lame_encode_flush.restype = ctypes.c_int
_lame.lame_encode_flush.argtypes = [
    ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_ubyte),
    ctypes.c_int,
]
_lame.lame_get_lametag_frame.restype = ctypes.c_size_t
_lame.lame_get_lametag_frame.argtypes = [
    ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_ubyte),
    ctypes.c_size_t,
]
_lame.lame_close.restype = ctypes.c_int
_lame.lame_close.argtypes = [ctypes.c_void_p]

# LAME MPEG_mode values.
MODE_STEREO = 0
MODE_JOINT = 1
MODE_MONO = 3

# LAME vbr_mode values.
VBR_OFF = 0
VBR_DEFAULT = 4


def encode_mp3(
    pcm: np.ndarray,
    sample_rate: int,
    bitrate: int = 128,
    mode: int = MODE_STEREO,
    vbr: bool = False,
    vbr_quality: int = 4,
    write_vbr_tag: bool = True,
    reservoir: bool = True,
) -> bytes:
    """Encode int16 PCM (shape (n,) mono or (n, 2) stereo) to an MP3 buffer.

    When write_vbr_tag is set, the leading placeholder frame is patched with
    the final LAME Xing/Info tag, like lame's file writer does — this gives
    fixtures a realistic VBR-header frame to exercise the Xing-skip logic.
    reservoir=False turns the bit reservoir off, so every frame is
    self-contained and any sequence of whole frames is a valid stream.
    """
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        raise ValueError("pcm must be int16")
    if pcm.ndim == 1:
        channels = 1
        left = np.ascontiguousarray(pcm)
        right = left
    else:
        channels = 2
        left = np.ascontiguousarray(pcm[:, 0])
        right = np.ascontiguousarray(pcm[:, 1])

    gf = _lame.lame_init()
    try:
        _lame.lame_set_in_samplerate(gf, sample_rate)
        _lame.lame_set_out_samplerate(gf, sample_rate)
        _lame.lame_set_num_channels(gf, channels)
        _lame.lame_set_mode(gf, MODE_MONO if channels == 1 else mode)
        _lame.lame_set_quality(gf, 2)
        _lame.lame_set_bWriteVbrTag(gf, 1 if write_vbr_tag else 0)
        _lame.lame_set_disable_reservoir(gf, 0 if reservoir else 1)
        if vbr:
            _lame.lame_set_VBR(gf, VBR_DEFAULT)
            _lame.lame_set_VBR_q(gf, vbr_quality)
        else:
            _lame.lame_set_VBR(gf, VBR_OFF)
            _lame.lame_set_brate(gf, bitrate)
        if _lame.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")

        n = len(left)
        out_cap = int(1.25 * n * channels * 2 + 7200) + 7200
        out = (ctypes.c_ubyte * out_cap)()
        nbytes = _lame.lame_encode_buffer(
            gf,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            n,
            out,
            out_cap,
        )
        if nbytes < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {nbytes}")
        flush = (ctypes.c_ubyte * 16384)()
        fbytes = _lame.lame_encode_flush(gf, flush, 16384)
        if fbytes < 0:
            raise RuntimeError(f"lame_encode_flush failed: {fbytes}")
        data = bytearray(bytes(out[:nbytes]) + bytes(flush[:fbytes]))

        if write_vbr_tag:
            tag = (ctypes.c_ubyte * 8192)()
            tag_len = _lame.lame_get_lametag_frame(gf, tag, 8192)
            if 0 < tag_len <= len(data):
                data[:tag_len] = bytes(tag[:tag_len])
        return bytes(data)
    finally:
        _lame.lame_close(gf)


def sine_pcm(
    sample_rate: int,
    seconds: float = 1.0,
    freq: float = 440.0,
    amplitude: float = 0.5,
    channels: int = 2,
) -> np.ndarray:
    n = int(sample_rate * seconds)
    t = np.arange(n, dtype=np.float64) / sample_rate
    wave = amplitude * np.sin(2 * np.pi * freq * t)
    samples = np.clip(wave * 32767.0, -32768, 32767).astype(np.int16)
    if channels == 2:
        return np.stack([samples, samples], axis=1)
    return samples


def encode_m4a(pcm: np.ndarray, sample_rate: int, bitrate: int = 128000) -> bytes:
    """Encode float PCM (n, ch) to a minimal M4A file (AAC-LC in MP4)."""
    return encode_m4a_multi([(pcm, sample_rate)], bitrate=bitrate)


def encode_m4a_multi(
    tracks: "list[tuple[np.ndarray, int]]", bitrate: int = 128000
) -> bytes:
    """Encode one or more (pcm, sample_rate) pairs as audio tracks of a
    single M4A file (AAC-LC in MP4). Multi-track files exercise the CLI's
    `-i` track selection (reference src/replaygain.rs:838-851)."""
    from . import avcodec
    from .corpus import adts_frames, mux_m4a

    muxed = []
    for pcm, sample_rate in tracks:
        adts = avcodec.encode_adts(np.asarray(pcm, np.float32), sample_rate, bitrate)
        channels = 1 if np.asarray(pcm).ndim == 1 else np.asarray(pcm).shape[1]
        muxed.append((adts_frames(adts), sample_rate, channels))
    return mux_m4a(muxed)


def generate_standard_fixtures(out_dir: os.PathLike | str) -> Path:
    """Generate the standard fixture set; returns the directory."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    specs = {
        # Mirrors the reference fixture set (1 s, 440 Hz sine).
        "test_stereo.mp3": dict(sr=44100, mode=MODE_STEREO, bitrate=128, ch=2),
        "test_mono.mp3": dict(sr=44100, mode=MODE_MONO, bitrate=64, ch=1),
        "test_joint_stereo.mp3": dict(sr=44100, mode=MODE_JOINT, bitrate=128, ch=2),
        "test_vbr.mp3": dict(sr=44100, mode=MODE_JOINT, vbr=True, ch=2),
        # Decoder branch coverage: MPEG-2 and MPEG-2.5 rates.
        "test_mpeg2_22050.mp3": dict(sr=22050, mode=MODE_JOINT, bitrate=64, ch=2),
        "test_mpeg25_11025.mp3": dict(sr=11025, mode=MODE_MONO, bitrate=32, ch=1),
        "test_48000.mp3": dict(sr=48000, mode=MODE_STEREO, bitrate=192, ch=2),
        "test_32000.mp3": dict(sr=32000, mode=MODE_JOINT, bitrate=96, ch=2),
        "test_mpeg2_24000.mp3": dict(sr=24000, mode=MODE_JOINT, bitrate=64, ch=2),
        "test_mpeg2_16000.mp3": dict(sr=16000, mode=MODE_MONO, bitrate=32, ch=1),
        "test_mpeg25_12000.mp3": dict(sr=12000, mode=MODE_JOINT, bitrate=40, ch=2),
        "test_mpeg25_8000.mp3": dict(sr=8000, mode=MODE_MONO, bitrate=16, ch=1),
    }
    for name, s in specs.items():
        path = out / name
        if path.exists():
            continue
        pcm = sine_pcm(s["sr"], seconds=1.0, channels=s["ch"])
        data = encode_mp3(
            pcm,
            s["sr"],
            bitrate=s.get("bitrate", 128),
            mode=s["mode"],
            vbr=s.get("vbr", False),
        )
        path.write_bytes(data)
    return out
