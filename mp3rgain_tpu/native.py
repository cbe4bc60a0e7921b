"""ctypes bindings for the native host core (mp3rgain_tpu/_native).

Low-level buffer-transform API; the user-facing file API lives in
mp3rgain_tpu.bitstream / .ape / .mp4meta.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ._native.build import build


class _MgAnalysis(ctypes.Structure):
    _fields_ = [
        ("frame_count", ctypes.c_int64),
        ("min_gain", ctypes.c_uint8),
        ("max_gain", ctypes.c_uint8),
        ("avg_gain", ctypes.c_double),
        ("mpeg_version", ctypes.c_int32),
        ("channel_mode", ctypes.c_int32),
    ]


_u8p = ctypes.POINTER(ctypes.c_uint8)


def _tune_malloc() -> None:
    """Keep large freed buffers in the heap instead of munmapping them.

    glibc mmaps allocations above ~128 KB and munmaps them on free, so
    every scan wave would re-fault its multi-MB manifest buffers.
    Raising the mmap threshold and disabling trim keeps them mapped.
    Trade-off: RSS stays at the high-water mark.
    Opt out with MP3RGAIN_NO_MALLOC_TUNING=1."""
    import os

    if os.environ.get("MP3RGAIN_NO_MALLOC_TUNING") == "1":
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 256 << 20)
        libc.mallopt(M_TRIM_THRESHOLD, -1)
    except (OSError, AttributeError):  # non-glibc: nothing to tune
        pass


def _load() -> ctypes.CDLL:
    _tune_malloc()
    lib = ctypes.CDLL(build())
    lib.mg_analyze.restype = ctypes.c_int32
    lib.mg_analyze.argtypes = [_u8p, ctypes.c_size_t, ctypes.POINTER(_MgAnalysis)]
    lib.mg_apply_gain.restype = ctypes.c_int64
    lib.mg_apply_gain.argtypes = [_u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32]
    lib.mg_apply_gain_channel.restype = ctypes.c_int64
    lib.mg_apply_gain_channel.argtypes = [_u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32]
    lib.mg_read_gains.restype = ctypes.c_int64
    lib.mg_read_gains.argtypes = [_u8p, ctypes.c_size_t, _u8p, ctypes.c_int64]
    lib.mg_frame_index.restype = ctypes.c_int64
    lib.mg_frame_index.argtypes = [_u8p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.mg_find_audio_end.restype = ctypes.c_int64
    lib.mg_find_audio_end.argtypes = [_u8p, ctypes.c_size_t]
    lib.mg_read_bits8.restype = ctypes.c_uint8
    lib.mg_read_bits8.argtypes = [_u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint8]
    lib.mg_write_bits8.restype = None
    lib.mg_write_bits8.argtypes = [_u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint8, ctypes.c_uint8]
    lib.mg_ape_find_footer.restype = ctypes.c_int64
    lib.mg_ape_find_footer.argtypes = [_u8p, ctypes.c_size_t]
    lib.mg_ape_parse.restype = ctypes.c_int64
    lib.mg_ape_parse.argtypes = [_u8p, ctypes.c_size_t, _u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.mg_ape_serialize.restype = ctypes.c_int64
    lib.mg_ape_serialize.argtypes = [_u8p, ctypes.c_size_t, ctypes.c_int64, _u8p, ctypes.c_int64]
    lib.mg_ape_remove_region.restype = ctypes.c_int32
    lib.mg_ape_remove_region.argtypes = [_u8p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    return lib


_lib = _load()


def _inbuf(data) -> _u8p:
    """Read-only view of bytes-like data as a ctypes uint8 pointer."""
    if isinstance(data, bytearray):
        return ctypes.cast((ctypes.c_uint8 * len(data)).from_buffer(data), _u8p)
    return ctypes.cast(ctypes.c_char_p(bytes(data)), _u8p)


def _mutbuf(data: bytearray):
    return (ctypes.c_uint8 * len(data)).from_buffer(data)


@dataclass
class Analysis:
    frame_count: int
    min_gain: int
    max_gain: int
    avg_gain: float
    mpeg_version: int  # 1, 2, 25
    channel_mode: int  # 0 stereo, 1 joint, 2 dual, 3 mono


def analyze(data: bytes) -> Analysis | None:
    out = _MgAnalysis()
    rc = _lib.mg_analyze(_inbuf(data), len(data), ctypes.byref(out))
    if rc != 0:
        return None
    return Analysis(
        frame_count=out.frame_count,
        min_gain=out.min_gain,
        max_gain=out.max_gain,
        avg_gain=out.avg_gain,
        mpeg_version=out.mpeg_version,
        channel_mode=out.channel_mode,
    )


def apply_gain(data: bytearray, steps: int, wrap: bool = False) -> int:
    """Adjust every global_gain in place; returns modified frame count."""
    buf = _mutbuf(data)
    return _lib.mg_apply_gain(
        ctypes.cast(buf, _u8p), len(data), steps, 1 if wrap else 0
    )


def apply_gain_channel(data: bytearray, channel: int, steps: int) -> int:
    buf = _mutbuf(data)
    return _lib.mg_apply_gain_channel(ctypes.cast(buf, _u8p), len(data), channel, steps)


def read_gains(data: bytes) -> np.ndarray:
    cap = max(16, (len(data) // 24) * 4 + 64)
    out = np.empty(cap, dtype=np.uint8)
    n = _lib.mg_read_gains(
        _inbuf(data), len(data), out.ctypes.data_as(_u8p), cap
    )
    if n < 0:
        out = np.empty(-n, dtype=np.uint8)
        n = _lib.mg_read_gains(_inbuf(data), len(data), out.ctypes.data_as(_u8p), -n)
    return out[:n].copy()


def frame_index(data: bytes) -> np.ndarray:
    """(n_frames, 3) int64 array of [offset, frame_size, header_word]."""
    cap = max(16, len(data) // 24 + 64)
    out = np.empty((cap, 3), dtype=np.int64)
    n = _lib.mg_frame_index(
        _inbuf(data), len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap
    )
    if n < 0:
        out = np.empty((-n, 3), dtype=np.int64)
        n = _lib.mg_frame_index(
            _inbuf(data), len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), -n
        )
    return out[:n].copy()


def find_audio_end(data: bytes) -> int:
    return _lib.mg_find_audio_end(_inbuf(data), len(data))


def read_bits8(data: bytes, byte_offset: int, bit_offset: int) -> int:
    return _lib.mg_read_bits8(_inbuf(data), len(data), byte_offset, bit_offset)


def write_bits8(data: bytearray, byte_offset: int, bit_offset: int, value: int) -> None:
    buf = (ctypes.c_uint8 * len(data)).from_buffer(data)
    _lib.mg_write_bits8(ctypes.cast(buf, _u8p), len(data), byte_offset, bit_offset, value)


# ---------------------------------------------------------------------------
# APEv2
# ---------------------------------------------------------------------------


def ape_find_footer(data: bytes) -> int:
    """Footer offset or -1."""
    return _lib.mg_ape_find_footer(_inbuf(data), len(data))


def ape_parse(data: bytes) -> list[tuple[bytes, bytes]] | None:
    """Parse APEv2 tag at end of `data` into [(key, value), ...]."""
    cap = len(data) + 4096
    out = (ctypes.c_uint8 * cap)()
    count = ctypes.c_int64()
    n = _lib.mg_ape_parse(_inbuf(data), len(data), ctypes.cast(out, _u8p), cap, ctypes.byref(count))
    if n < 0:
        return None
    raw = bytes(out[:n])
    items = []
    pos = 0
    for _ in range(count.value):
        klen = int.from_bytes(raw[pos : pos + 4], "little")
        vlen = int.from_bytes(raw[pos + 4 : pos + 8], "little")
        pos += 8
        key = raw[pos : pos + klen]
        pos += klen
        value = raw[pos : pos + vlen]
        pos += vlen
        items.append((key, value))
    return items


def ape_serialize(items: list[tuple[bytes, bytes]]) -> bytes:
    """Serialize [(key, value), ...] to a full APEv2 tag (header+items+footer)."""
    if not items:
        return b""
    packed = bytearray()
    for key, value in items:
        packed += len(key).to_bytes(4, "little")
        packed += len(value).to_bytes(4, "little")
        packed += key
        packed += value
    cap = len(packed) + 64 + 9 * len(items) + 64
    out = (ctypes.c_uint8 * cap)()
    n = _lib.mg_ape_serialize(
        _inbuf(packed), len(packed), len(items), ctypes.cast(out, _u8p), cap
    )
    if n < 0:
        raise RuntimeError("ape_serialize: buffer too small")
    return bytes(out[:n])


def ape_remove_region(data: bytes) -> tuple[int, int] | None:
    """(audio_end, tail_start) for stripping the APE tag; None if no tag."""
    audio_end = ctypes.c_int64()
    tail = ctypes.c_int64()
    rc = _lib.mg_ape_remove_region(
        _inbuf(data), len(data), ctypes.byref(audio_end), ctypes.byref(tail)
    )
    if rc != 0:
        return None
    return audio_end.value, tail.value
