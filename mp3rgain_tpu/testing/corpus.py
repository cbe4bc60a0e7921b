"""Deterministic evaluation corpus built from committed clips.

The clips (``testing/clips/``) are a few seconds of encoded audio per
format: MP3 with the bit reservoir off, so that every frame is
self-contained, and AAC-LC as raw ADTS. Long tracks are built from a
seed by concatenating whole frames, so building a corpus needs no
encoder library: only this module and the native frame scanner.
``python tools/make_clips.py`` regenerates the clips (libmp3lame and
libavcodec).

Deployments the corpus stands for (ROADMAP R1):
  - album: one beets album, 12 tracks of 240 s, 44.1 kHz stereo, CBR
    and VBR mixed;
  - library: 64 tracks of 60 s over MPEG-1/2/2.5 rates, mono and
    stereo, one short-block-heavy clip, plus one 60-minute mono 22.05 kHz
    podcast;
  - m4a: 8 AAC-LC tracks at 44.1 or 48 kHz plus one at 96 kHz.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

CLIPS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "clips")


@dataclass(frozen=True)
class Clip:
    name: str
    sample_rate: int
    channels: int
    content: str  # "music", "speech" or "transient"
    bitrate: int = 0  # kbit/s (MP3 CBR) or bit/s (AAC); 0 = MP3 VBR
    mode: str = "stereo"  # MP3 channel mode: stereo, joint, mono
    seconds: float = 3.0

    @property
    def path(self) -> str:
        ext = "aac" if self.name.startswith("aac") else "mp3"
        return os.path.join(CLIPS_DIR, f"{self.name}.{ext}")


MP3_CLIPS = (
    Clip("mp3_44k_cbr192", 44100, 2, "music", 192, "stereo"),
    Clip("mp3_44k_vbr", 44100, 2, "music", 0, "joint"),
    Clip("mp3_44k_transient", 44100, 2, "transient", 160, "joint"),
    Clip("mp3_48k_cbr128", 48000, 2, "music", 128, "stereo"),
    Clip("mp3_32k_cbr96", 32000, 2, "music", 96, "joint"),
    Clip("mp3_24k_cbr64", 24000, 2, "music", 64, "joint"),
    Clip("mp3_22k_mono32", 22050, 1, "speech", 32, "mono"),
    Clip("mp3_16k_mono32", 16000, 1, "music", 32, "mono"),
    Clip("mp3_11k_mono24", 11025, 1, "speech", 24, "mono"),
    Clip("mp3_8k_mono16", 8000, 1, "speech", 16, "mono"),
)
AAC_CLIPS = (
    Clip("aac_44k", 44100, 2, "music", 128000),
    Clip("aac_48k", 48000, 2, "music", 128000),
    Clip("aac_96k", 96000, 2, "music", 160000),
)
CLIPS = {c.name: c for c in MP3_CLIPS + AAC_CLIPS}


# ---------------------------------------------------------------------------
# Clip content (used only when the clips are regenerated).
# ---------------------------------------------------------------------------


def synth_pcm(clip: Clip, seed: int) -> np.ndarray:
    """(n, channels) float32 test signal in [-1, 1] for one clip."""
    rng = np.random.default_rng(seed)
    sr = clip.sample_rate
    n = int(sr * clip.seconds)
    t = np.arange(n) / sr
    nyq = sr / 2
    if clip.content == "speech":
        # Voiced buzz under a syllable-rate envelope, with pauses.
        f0 = 110 + 30 * np.sin(2 * np.pi * 0.7 * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        buzz = sum(np.sin(k * phase) / k for k in range(1, 20)
                   if k * 140 < nyq)
        env = np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None) ** 2
        env *= (np.sin(2 * np.pi * 0.4 * t) > -0.6)
        x = 0.5 * buzz * env + 0.01 * rng.standard_normal(n)
    elif clip.content == "transient":
        # Castanet-like clicks: decaying noise bursts every 60-140 ms,
        # which the encoder codes with short blocks.
        x = 0.05 * np.sin(2 * np.pi * 330 * t)
        pos = 0
        while pos < n:
            burst = min(int(0.02 * sr), n - pos)
            decay = np.exp(-np.arange(burst) / (0.003 * sr))
            x[pos : pos + burst] += 0.9 * decay * rng.standard_normal(burst)
            pos += int(sr * rng.uniform(0.06, 0.14))
    else:
        # Chords changing every 250 ms, a bass line and noise hats.
        x = np.zeros(n)
        step = int(0.25 * sr)
        for s0 in range(0, n, step):
            seg = slice(s0, min(s0 + step, n))
            tt = t[seg] - t[s0]
            env = np.exp(-3.0 * tt)
            root = 110.0 * 2 ** (rng.integers(0, 12) / 12)
            for ratio in (1.0, 1.26, 1.5, 2.0, 3.0):
                f = root * ratio * 2
                if f < nyq:
                    x[seg] += 0.12 * env * np.sin(2 * np.pi * f * tt)
            x[seg] += 0.2 * env * np.sin(2 * np.pi * root / 2 * tt)
            hat = min(int(0.01 * sr), len(tt))
            x[s0 : s0 + hat] += 0.15 * rng.standard_normal(hat)
        x += 0.02 * rng.standard_normal(n)
    x = np.clip(x, -1.0, 1.0)
    if clip.channels == 1:
        return x[:, None].astype(np.float32)
    right = np.roll(x, int(0.0007 * sr)) * 0.9
    return np.stack([x, right], axis=1).astype(np.float32)


def make_clips(out_dir: str = CLIPS_DIR, seed: int = 2024) -> list[str]:
    """Encode every clip (needs libmp3lame and libavcodec)."""
    from . import avcodec, fixtures

    modes = {"stereo": fixtures.MODE_STEREO, "joint": fixtures.MODE_JOINT,
             "mono": fixtures.MODE_MONO}
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, clip in enumerate(MP3_CLIPS + AAC_CLIPS):
        pcm = synth_pcm(clip, seed + i)
        if clip in AAC_CLIPS:
            data = avcodec.encode_adts(pcm, clip.sample_rate, clip.bitrate)
        else:
            pcm16 = np.round(pcm * 32767).astype(np.int16)
            if clip.channels == 1:
                pcm16 = pcm16[:, 0]
            data = fixtures.encode_mp3(
                pcm16, clip.sample_rate, bitrate=clip.bitrate or 128,
                mode=modes[clip.mode], vbr=clip.bitrate == 0,
                write_vbr_tag=False, reservoir=False,
            )
        path = os.path.join(out_dir, os.path.basename(clip.path))
        with open(path, "wb") as f:
            f.write(data)
        written.append(path)
    return written


# ---------------------------------------------------------------------------
# Frames and containers.
# ---------------------------------------------------------------------------


def mp3_frames(data: bytes) -> list[bytes]:
    """Whole MPEG audio frames of a stream (native frame scanner)."""
    from .. import native

    return [data[int(o) : int(o) + int(n)]
            for o, n, _ in native.frame_index(data)]


def adts_frames(adts: bytes) -> list[bytes]:
    """Raw AAC frames (ADTS headers stripped) of an ADTS stream."""
    frames = []
    pos = 0
    while pos + 7 <= len(adts):
        full = ((adts[pos + 3] & 0x3) << 11) | (adts[pos + 4] << 3) | (
            adts[pos + 5] >> 5)
        hdr = 7 if adts[pos + 1] & 1 else 9  # protection_absent
        frames.append(adts[pos + hdr : pos + full])
        pos += full
    return frames


def mux_m4a(tracks: list[tuple[list[bytes], int, int]]) -> bytes:
    """Minimal M4A file (AAC-LC in MP4) from raw AAC frames.

    tracks: [(frames, sample_rate, channels)]; each becomes one audio
    track (multi-track files exercise the CLI's `-i` selection)."""
    st = struct

    def box(t, payload):
        return st.pack(">I", 8 + len(payload)) + t + payload

    def full_box(t, payload, version=0, flags=0):
        return box(t, st.pack(">I", (version << 24) | flags) + payload)

    def desc(tag, payload):
        return bytes([tag, len(payload)]) + payload

    traks = []
    for track_id, (frames, sample_rate, channels) in enumerate(tracks, 1):
        sr_index = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4,
                    32000: 5, 24000: 6, 22050: 7, 16000: 8, 12000: 9,
                    11025: 10, 8000: 11}[sample_rate]
        asc = bytes([(2 << 3) | (sr_index >> 1),
                     ((sr_index & 1) << 7) | (channels << 3)])
        dsi = desc(0x05, asc)
        dec_conf = desc(0x04, bytes([0x40, 0x15, 0, 0, 0])
                        + st.pack(">II", 0, 0) + dsi)
        sl = desc(0x06, b"\x02")
        es = desc(0x03, st.pack(">HB", track_id, 0) + dec_conf + sl)
        esds = full_box(b"esds", es)
        mp4a = box(
            b"mp4a",
            bytes(6) + st.pack(">H", 1) + bytes(8)
            + st.pack(">HHI", channels, 16, 0)
            # 16.16 rate field; rates above 65535 (96 kHz) live in the
            # AudioSpecificConfig only.
            + st.pack(">I", (sample_rate if sample_rate < 65536 else 0) << 16)
            + esds,
        )
        stsd = full_box(b"stsd", st.pack(">I", 1) + mp4a)
        n = len(frames)
        stts = full_box(b"stts", st.pack(">III", 1, n, 1024))
        stsc = full_box(b"stsc", st.pack(">IIII", 1, 1, n, 1))
        stsz = full_box(b"stsz", st.pack(">II", 0, n)
                        + b"".join(st.pack(">I", len(f)) for f in frames))
        stco = full_box(b"stco", st.pack(">II", 1, 0))  # patched below
        stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
        dref = full_box(b"dref", st.pack(">I", 1)
                        + full_box(b"url ", b"", flags=1))
        minf = box(b"minf", full_box(b"smhd", bytes(4)) + box(b"dinf", dref)
                   + stbl)
        duration = n * 1024
        mdhd = full_box(b"mdhd", st.pack(">IIIIHH", 0, 0, sample_rate,
                                         duration, 0x55C4, 0))
        hdlr = full_box(b"hdlr", bytes(4) + b"soun" + bytes(12) + b"\x00")
        mdia = box(b"mdia", mdhd + hdlr + minf)
        tkhd = full_box(b"tkhd", st.pack(">IIIII", 0, 0, track_id, 0,
                                         duration) + bytes(60), flags=7)
        traks.append(box(b"trak", tkhd + mdia))

    sr0 = tracks[0][1]
    dur0 = len(tracks[0][0]) * 1024
    mvhd = full_box(
        b"mvhd",
        st.pack(">IIII", 0, 0, sr0, dur0) + st.pack(">I", 0x00010000)
        + st.pack(">H", 0x0100) + bytes(10)
        + st.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + bytes(24) + st.pack(">I", len(tracks) + 1),
    )
    moov = box(b"moov", mvhd + b"".join(traks))
    ftyp = box(b"ftyp", b"M4A " + st.pack(">I", 0) + b"M4A mp42isom")
    payloads = [b"".join(frames) for frames, _, _ in tracks]
    mdat = box(b"mdat", b"".join(payloads))

    out = bytearray(ftyp + moov + mdat)
    # Patch each trak's single chunk offset to its payload position in
    # mdat (trak order == payload order).
    offset = len(ftyp) + len(moov) + 8
    pos = 0
    for payload in payloads:
        stco_pos = out.find(b"stco", pos)
        st.pack_into(">I", out, stco_pos + 12, offset)
        offset += len(payload)
        pos = stco_pos + 4
    return bytes(out)


# ---------------------------------------------------------------------------
# Tracks and the corpus.
# ---------------------------------------------------------------------------


def _clip_frames(name: str) -> list[bytes]:
    clip = CLIPS[name]
    with open(clip.path, "rb") as f:
        data = f.read()
    return adts_frames(data) if name.startswith("aac") else mp3_frames(data)


def _frames_for(frames: list[bytes], n: int, rng) -> list[bytes]:
    """n whole frames, cycling through the clip from a seeded start."""
    start = int(rng.integers(0, len(frames)))
    return [frames[(start + i) % len(frames)] for i in range(n)]


def build_mp3(name: str, seconds: float, rng) -> tuple[bytes, float]:
    """A track of about `seconds` from one clip's frames, at a seeded
    gain offset of -3..+2 global-gain steps (1.5 dB each). Returns the
    file bytes and the exact duration."""
    from .. import native

    clip = CLIPS[name]
    frames = _clip_frames(name)
    per_frame = (1152 if clip.sample_rate >= 32000 else 576) / clip.sample_rate
    n = int(round(seconds / per_frame))
    data = bytearray(b"".join(_frames_for(frames, n, rng)))
    native.apply_gain(data, int(rng.integers(-3, 3)))
    return bytes(data), n * per_frame


def build_m4a(name: str, seconds: float, rng) -> tuple[bytes, float]:
    clip = CLIPS[name]
    frames = _clip_frames(name)
    n = int(round(seconds * clip.sample_rate / 1024))
    data = mux_m4a([(_frames_for(frames, n, rng), clip.sample_rate,
                     clip.channels)])
    return data, n * 1024 / clip.sample_rate


@dataclass
class Corpus:
    album: list[str]
    library: list[str]
    m4a: list[str]
    seconds: dict  # path -> audio duration (s)

    def audio_seconds(self, paths) -> float:
        return float(sum(self.seconds[p] for p in paths))


LIBRARY_MIX = (
    # (clip, tracks): MPEG-1/2/2.5 rates, mono and stereo; the transient
    # clip is the short-block-heavy share.
    ("mp3_44k_cbr192", 10), ("mp3_44k_vbr", 10), ("mp3_44k_transient", 8),
    ("mp3_48k_cbr128", 8), ("mp3_32k_cbr96", 6), ("mp3_24k_cbr64", 6),
    ("mp3_22k_mono32", 5), ("mp3_16k_mono32", 4), ("mp3_11k_mono24", 4),
    ("mp3_8k_mono16", 3),
)
ALBUM_CLIPS = ("mp3_44k_cbr192", "mp3_44k_vbr", "mp3_44k_transient")
M4A_MIX = (("aac_44k", 4), ("aac_48k", 4), ("aac_96k", 1))


def build_corpus(out_dir: str, seed: int = 0, album_tracks: int = 12,
                 album_seconds: float = 240.0, library_seconds: float = 60.0,
                 podcast_seconds: float = 3600.0, m4a_seconds: float = 60.0,
                 library_scale: float = 1.0) -> Corpus:
    """Write the corpus under out_dir; every byte follows from `seed`.

    The defaults are the deployment sizes; tests pass small ones.
    library_scale multiplies the per-clip track counts (64 at 1.0)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    seconds = {}

    def write(name, built):
        data, secs = built
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        seconds[path] = secs
        return path

    album = [
        write(f"album_{i:02d}.mp3",
              build_mp3(ALBUM_CLIPS[i % len(ALBUM_CLIPS)], album_seconds, rng))
        for i in range(album_tracks)
    ]
    library = []
    for name, count in LIBRARY_MIX:
        for j in range(max(1, int(round(count * library_scale)))):
            library.append(write(f"lib_{name}_{j:02d}.mp3",
                                 build_mp3(name, library_seconds, rng)))
    if podcast_seconds:
        library.append(write("lib_podcast.mp3",
                             build_mp3("mp3_22k_mono32", podcast_seconds, rng)))
    m4a = []
    for name, count in M4A_MIX:
        for j in range(count):
            tag = name.split("_")[1]
            m4a.append(write(f"m4a_{tag}_{j:02d}.m4a",
                             build_m4a(name, m4a_seconds, rng)))
    return Corpus(album=album, library=library, m4a=m4a, seconds=seconds)
