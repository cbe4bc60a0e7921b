"""Data-parallel batch ReplayGain analysis over a device mesh.

The workload is embarrassingly parallel over tracks until the album
reduction (SURVEY.md §2.6): tracks are bucketed by (sample_rate,
n_channels, padded granule count), decoded and analyzed in batches on
device, sharded over a 1-D "dp" mesh axis with jax.shard_map. The album
histogram merge is a jax.lax.psum over the mesh — the device-side
equivalent of the reference's LoudnessHistogram::accumulate
(/root/reference/src/replaygain.rs:1053-1066); album peak reduces with
lax.pmax semantics (max + psum of per-shard maxima).

Per-file fault isolation (reference src/main.rs:1603-1615): a track that
fails host unpack is reported as an error and masked out of its batch
lane; it cannot poison the scan.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import backend
from ..utils.jaxcache import ensure_compilation_cache

ensure_compilation_cache()

from ..decode import frontend as fe
from ..decode import synthesis
from ..ops import histogram as hi
from ..ops import iir
from ..replaygain import PINK_REF, ReplayGainResult

SAMPLE_SCALE_16BIT = 32768.0


def _result_of(fn, *args):
    """(value, None) on success, (None, str(error)) on failure."""
    try:
        return fn(*args), None
    except Exception as e:  # per-file isolation
        return None, str(e)


# ---------------------------------------------------------------------------
# Device pipeline: granule tensors -> (histogram, peak) per track.
# ---------------------------------------------------------------------------


def _derive_fields(spectrum, scf, info, *, n_channels: int):
    """Device-side expansion of the packed info tensor into decode fields."""
    kind = info[..., fe.BLOCK_TYPE]
    kind = jnp.where((kind == 2) & (info[..., fe.MIXED] == 1), 4, kind)
    rzero = jnp.maximum(info[..., fe.BIG_END], info[..., fe.COUNT1_END])
    if n_channels == 2:
        # Partner channel's bound (records are channel-paired): swap pairs
        # structurally (a reshape + flip, no gather).
        shape = rzero.shape
        rz = jnp.flip(rzero.reshape(shape[:-1] + (-1, 2)), axis=-1).reshape(shape)
    else:
        rz = rzero
    joint = (info[..., fe.CHANNEL_MODE] == 1).astype(jnp.int32)
    ms = joint * ((info[..., fe.MODE_EXT] & 2) >> 1)
    istereo = joint * (info[..., fe.MODE_EXT] & 1)
    sbg = jnp.stack(
        [info[..., fe.SBG0], info[..., fe.SBG1], info[..., fe.SBG2]], axis=-1
    )
    return (
        spectrum, scf, kind, info[..., fe.SR_ROW], info[..., fe.GLOBAL_GAIN],
        info[..., fe.SCALEFAC_SCALE], info[..., fe.PREFLAG], sbg,
        info[..., fe.BLOCK_TYPE], info[..., fe.MIXED], ms, istereo,
        (info[..., fe.VERSION] != 1).astype(jnp.int32),
        info[..., fe.INTENSITY_SCALE], rz,
    )


def _unpack_spectrum(spec_i8, esc_idx, esc_val):
    """Reconstruct (B, G, 576) int32 spectra from the compact transfer form.

    spec_i8 holds values clipped to int8 over the trimmed extent; escapes
    (|v| > 127) arrive as a sparse (index, value) sideband. Padding escape
    slots point at a dummy column (=576).
    """
    b, g, ext = spec_i8.shape
    spec = spec_i8.astype(jnp.int32)
    spec = jnp.pad(spec, ((0, 0), (0, 0), (0, 576 - ext)))
    # Dense compare-and-select per escape slot (E is small, usually 4).
    cols = jnp.arange(576, dtype=jnp.int32)[None, None, :]
    for e in range(esc_idx.shape[-1]):
        hit = cols == esc_idx[:, :, e : e + 1].astype(jnp.int32)
        spec = jnp.where(hit, esc_val[:, :, e : e + 1].astype(jnp.int32), spec)
    return spec


def _expand_info_light(packed):
    """Device-side expansion of the packed 2×uint16 light-manifest info
    words (fe.pack_info_light) back into the fat (…, INFO_N) int32
    tensor the shared tail reads. Bit layout documented at
    decode/frontend.py::pack_info_light."""
    w0 = packed[..., 0].astype(jnp.int32)
    w1 = packed[..., 1].astype(jnp.int32)
    zero = jnp.zeros_like(w0)
    cols = [zero] * fe.INFO_N
    cols[fe.GLOBAL_GAIN] = w0 & 255
    cols[fe.BLOCK_TYPE] = (w0 >> 8) & 3
    cols[fe.MIXED] = (w0 >> 10) & 1
    cols[fe.SCALEFAC_SCALE] = (w0 >> 11) & 1
    cols[fe.PREFLAG] = (w0 >> 12) & 1
    cols[fe.INTENSITY_SCALE] = (w0 >> 13) & 1
    cols[fe.CHANNEL_MODE] = (w0 >> 14) & 1  # joint flag; 1 == joint
    cols[fe.VERSION] = 1 + ((w0 >> 15) & 1)  # lsf bit -> version 2, else 1
    cols[fe.SBG0] = w1 & 7
    cols[fe.SBG1] = (w1 >> 3) & 7
    cols[fe.SBG2] = (w1 >> 6) & 7
    cols[fe.MODE_EXT] = (w1 >> 9) & 3
    cols[fe.SR_ROW] = (w1 >> 11) & 15
    return jnp.stack(cols, axis=-1)


def _expand_scf_flat(scf, srow, sdata, hrow, hdata):
    """Expand the flat split scalefactor transfer form (fe.pack_scf_rows,
    packed back-to-back in kernel-row order): dense (npad, 12) uint8
    nibbles of slots 0..23, a sparse short-window sideband (srow flat
    row index — npad is the dummy padding target — and sdata (S, 20)
    uint8 nibbles of slots 24..63), and a sparse high-bit sideband
    (hrow, hdata (H, 8) uint8 bitmasks adding 16 to flagged slots; only
    the LSF intensity 5-bit case populates it). Returns the (npad + 1,
    64) int32 slot tensor — row npad is the zero dummy the rowmap's
    padding slots gather."""
    npad = scf.shape[0]
    s = scf.astype(jnp.int32)
    lo = jnp.stack([(s >> 4) & 15, s & 15], axis=-1).reshape(npad, 24)
    d = sdata.astype(jnp.int32)
    hi = jnp.stack([(d >> 4) & 15, d & 15], axis=-1).reshape(
        d.shape[0], fe.SCF_SLOTS - 24
    )
    full = jnp.zeros((npad + 1, fe.SCF_SLOTS), jnp.int32)
    full = full.at[:npad, :24].set(lo)
    full = full.at[srow, 24:].set(hi)
    m = hdata.astype(jnp.int32)
    bits = ((m[:, :, None] >> jnp.arange(8, dtype=jnp.int32)) & 1)
    full = full.at[hrow].add(16 * bits.reshape(m.shape[0], fe.SCF_SLOTS))
    return full


def _analysis_tail(spectrum, scf, info, valid_samples,
                   *, n_channels: int, sample_rate: int, dtype):
    """Shared device pipeline tail: full (B, G, 576) spectra → results."""
    from ..decode.format_tables import SR_ROW

    info = info.astype(jnp.int32)  # light path ships uint16 (h2d halved)
    fields = _derive_fields(spectrum, scf, info, n_channels=n_channels)
    sr_row = SR_ROW[sample_rate]

    def one(args):
        return synthesis._decode_jit(
            *args, n_channels=n_channels, sr_row=sr_row, dtype=dtype
        )

    pcm = jax.vmap(one)(fields)  # (B, C, N)

    bsz, c, n = pcm.shape
    sample_idx = jnp.arange(n)
    peak_mask = (sample_idx[None, None, :] < valid_samples[:, None, None])
    peak = jnp.max(jnp.abs(pcm) * peak_mask, axis=(1, 2))  # (B,)

    x = pcm.reshape(bsz * c, n).astype(dtype) * dtype(SAMPLE_SCALE_16BIT)
    filtered = iir.equal_loudness(x, sample_rate).reshape(bsz, c, n)
    hist = hi._histogram_jit(filtered, valid_samples, hi.window_size(sample_rate))
    loud_idx = hi.loudness_index_device(hist)
    return hist, loud_idx, peak


def _analysis_core(spec_i8, esc_idx, esc_val, scf, info, valid_samples,
                   *, n_channels: int, sample_rate: int, dtype):
    """Single-shard batched pipeline. Leading dim = local batch of tracks.

    Inputs are the compact host→device manifest: spec_i8 (B, G, EXT) int8
    + escape sideband (B, G, E) int16 pairs, scf (B, G, 64) int8,
    info (B, G, INFO_N) int32, valid_samples (B,).
    """
    spectrum = _unpack_spectrum(spec_i8, esc_idx, esc_val)
    return _analysis_tail(
        spectrum, scf, info, valid_samples,
        n_channels=n_channels, sample_rate=sample_rate, dtype=dtype,
    )


def _rowmap_from_counts(counts, g_max: int, npad: int):
    """(B,) per-track granule-channel counts → (B, g_max) row map.

    Track b's records occupy kernel output rows [offs_b, offs_b + n_b)
    in input order (prepare_batch_arrays_light packs tracks
    back-to-back), so the map is derivable on device from the counts
    alone — the earlier explicit rowmap transfer (B*G int32, 2.4 MB on a
    64x60s batch) carried no extra information. Empty padding slots map
    to npad (the dummy zero row)."""
    counts = counts.astype(jnp.int32)
    offs = jnp.cumsum(counts) - counts
    g_idx = jnp.arange(g_max, dtype=jnp.int32)
    return jnp.where(
        g_idx[None, :] < counts[:, None],
        offs[:, None] + g_idx[None, :],
        jnp.int32(npad),
    )


def _light_tail(spec, ends, counts, scf, srow, sdata, hrow, hdata, info,
                valid_samples, *, g_max: int, n_channels: int,
                sample_rate: int, dtype):
    """Raw-bits pipeline tail: entropy-kernel outputs → analysis results.

    Dispatched as its own executable in production (dispatch_light): the
    entropy stage's word-buffer length then only keys the small kernel
    program, not this (much larger) synthesis+IIR+histogram graph.
    spec (npad, 576) and ends (npad, 4) are in input row order
    (decode/entropy_kernel.decode_blocks). scf/info arrive FLAT (npad
    rows, tracks packed back-to-back — no per-track g_max padding
    travels over h2d) and are gathered to (B, G, …) through the same
    counts-derived rowmap as the spectrum; g_max is therefore a static
    arg, not an array shape."""
    npad = spec.shape[0]
    rowmap = _rowmap_from_counts(counts, g_max, npad)
    scf = _expand_scf_flat(scf, srow, sdata, hrow, hdata)[rowmap]
    info = jnp.concatenate(
        [info.astype(jnp.int32), jnp.zeros((1, fe.IP_N), jnp.int32)]
    )[rowmap]
    # Row npad is the dummy target for padding slots.
    spec = jnp.concatenate([spec, jnp.zeros((1, 576), spec.dtype)], axis=0)
    ends = jnp.concatenate([ends, jnp.zeros((1, 4), ends.dtype)], axis=0)

    spectrum = spec[rowmap]  # (B, G, 576) row gather
    info = _expand_info_light(info)
    info = info.at[..., fe.BIG_END].set(ends[rowmap, 0])
    info = info.at[..., fe.COUNT1_END].set(ends[rowmap, 1])
    return _analysis_tail(
        spectrum, scf, info, valid_samples,
        n_channels=n_channels, sample_rate=sample_rate, dtype=dtype,
    )


def _analysis_core_light(buf, woff, rows, meta, counts, scf, srow, sdata,
                         hrow, hdata, info, valid_samples, *, nb: int,
                         lanes: int, g_max: int, n_channels: int,
                         sample_rate: int, dtype, interpret: bool = False):
    """Raw-bits batched pipeline: device entropy decode + analysis tail.

    The host→device manifest is the raw main-data words (decode/
    entropy_kernel.PreparedEntropy) — packed to the true bitstream size —
    plus counts (B,) int32 per-track record counts (the (B, G) row map is
    derived on device, _rowmap_from_counts). The whole thing traces into
    ONE device dispatch: Pallas Huffman decode → gather into (B, G, 576)
    → synthesis → equal-loudness IIR → loudness histogram. (Production
    single-device dispatch splits the two stages — see dispatch_light.)
    """
    from ..decode import entropy_kernel as ek

    spec, ends = ek.decode_blocks(buf, woff, rows, meta, nb=nb,
                                  lanes=lanes, interpret=interpret)
    return _light_tail(
        spec, ends, counts, scf, srow, sdata, hrow, hdata, info,
        valid_samples,
        g_max=g_max, n_channels=n_channels,
        sample_rate=sample_rate, dtype=dtype,
    )


def prepare_batch_arrays(
    unpacked: list[fe.UnpackedMp3], n_channels: int, pad_batch_to: int = 1
):
    """Pack tracks into padded device-ready arrays for _analysis_core.

    Uses narrow transfer dtypes: huffman values fit int16 (|x| <= 15 + 2^13),
    scalefactors fit int8. Returns the positional arg tuple of
    _analysis_core (..., valid_samples)."""
    bsz = len(unpacked)
    g_max = max(u.n for u in unpacked)
    # Pad G to a multiple of 2*n_channels so time reshapes stay valid,
    # on the same shape ladder as the light path (keeps the compile
    # population small AND the two paths bit-identical: equal padded
    # shapes -> equal GEMM shapes -> equal rounding).
    unit = 2 * n_channels
    g_max = _quantize_up(g_max, unit, base=512, ratio=1.3)
    bpad = next((b for b in _B_LADDER if b >= bsz), bsz)
    bpad = -(-bpad // pad_batch_to) * pad_batch_to

    def pad_tracks(get, shape_tail, dtype=np.int32):
        out = np.zeros((bpad, g_max) + shape_tail, dtype=dtype)
        for i, u in enumerate(unpacked):
            a = get(u)
            out[i, : a.shape[0]] = a
        return out

    info = pad_tracks(lambda u: u.info, (fe.INFO_N,))
    spectrum = pad_tracks(lambda u: u.spectrum, (576,), dtype=np.int16)
    scf = pad_tracks(lambda u: u.scf, (64,), dtype=np.int8)
    valid_samples = np.array(
        [u.n // n_channels * 576 for u in unpacked] + [0] * (bpad - bsz),
        dtype=np.int32,
    )

    # Compact transfer form: trim to the nonzero spectral extent (rounded
    # to keep the jit-shape population small), clip to int8, and ship the
    # rare |v| > 127 escapes as a sparse sideband. Host→device bandwidth is
    # the scan bottleneck; this roughly quarters the bytes per track.
    rzero = np.maximum(info[:, :, fe.BIG_END], info[:, :, fe.COUNT1_END])
    ext = min(576, max(96, int(-(-int(rzero.max()) // 96) * 96)))
    spec_t = spectrum[:, :, :ext]
    flat = spec_t.reshape(-1, ext)
    mask = np.abs(flat) > 127
    counts = mask.sum(axis=1)
    n_esc = max(4, int(-(-max(int(counts.max()), 1) // 4) * 4))
    esc_idx = np.full((flat.shape[0], n_esc), 576, dtype=np.int16)
    esc_val = np.zeros((flat.shape[0], n_esc), dtype=np.int16)
    rows, cols = np.nonzero(mask)
    if len(rows):
        pos = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
        esc_idx[rows, pos] = cols
        esc_val[rows, pos] = flat[rows, cols]
    spec_i8 = np.clip(spec_t, -127, 127).astype(np.int8)
    g_max = spectrum.shape[1]
    esc_idx = esc_idx.reshape(bpad, g_max, n_esc)
    esc_val = esc_val.reshape(bpad, g_max, n_esc)
    return (spec_i8, esc_idx, esc_val, scf, info, valid_samples)


_B_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _quantize_up(value: int, unit: int, base: int, ratio: float) -> int:
    """Smallest ladder step >= value (geometric, unit-aligned).

    Shape quantization keeps the compiled-executable population small: a
    mixed-length library otherwise compiles a fresh pipeline for nearly
    every batch. Padding costs <= `ratio` extra device work on the worst
    batch."""
    v = base
    while v < value:
        v = int(v * ratio)
        v = -(-v // unit) * unit
    return max(v, -(-value // unit) * unit)


def prepare_batch_arrays_light(
    unpacked: list[fe.UnpackedMp3Light], n_channels: int,
    pad_batch_to: int = 1,
    force_shapes: tuple | None = None,
):
    """Pack light-unpacked tracks for _analysis_core_light.

    Returns (prep: PreparedEntropy,
    (counts, scf, srow, sdata, hrow, hdata, info, valid_samples),
    g_max). counts[b] is track b's granule-channel record count; the
    (B, G) map from padded track-granule slots to kernel output rows is
    derived on device (_rowmap_from_counts — tracks pack back-to-back
    in input order, so the counts carry the whole map). scf and info
    ship FLAT in the same back-to-back row order — (npad, 12) uint8
    nibbles / (npad, 2) uint16 words for npad = nb*lanes — so the h2d
    payload carries no per-track g_max padding at all; the device
    gathers both through the rowmap it already builds for the spectrum.
    srow/sdata + hrow/hdata are the split-scf sidebands
    (fe.pack_scf_rows; padding entries point at the dummy row npad).
    g_max (static, quantized) sizes the device rowmap.
    force_shapes = (bpad, g_max, nb, n_words, s_pad, h_pad) pins all
    static shapes so independently prepared shards share one
    executable. The big arrays (buf, meta, scf, info) come from the
    shared buffer pool — dispatchers hand them back once the h2d
    transfer has committed."""
    from ..decode import entropy_kernel as ek
    from ..utils import bufpool

    bsz = len(unpacked)
    g_max = max(u.n for u in unpacked)
    unit = 2 * n_channels
    g_max = _quantize_up(g_max, unit, base=512, ratio=1.3)
    bpad = next((b for b in _B_LADDER if b >= bsz), bsz)
    bpad = -(-bpad // pad_batch_to) * pad_batch_to
    force_nb = force_w = force_s = force_h = None
    if force_shapes is not None:
        bpad, g_max, force_nb, force_w, force_s, force_h = force_shapes

    prep = ek.prepare_batch(
        [u.md for u in unpacked], [u.meta for u in unpacked],
        quantize=True, force_nb=force_nb, force_words=force_w,
    )
    npad = prep.npad

    counts = np.zeros(bpad, np.int32)
    counts[:bsz] = [u.n for u in unpacked]
    # Device-read info fields travel packed (2 uint16 words per gch,
    # fe.pack_info_light) and flat (back-to-back rows, no g_max pad);
    # scalefactors travel as the flat split form (fe.pack_scf_rows).
    info = bufpool.take_zeroed((npad, fe.IP_N), np.uint16)
    scf = bufpool.take_zeroed((npad, fe.SCF_MAIN_BYTES), np.uint8)
    # Per-track fills in ONE native pass each (mg_pack_light_track), in
    # place of a chain of small numpy ops per track (pack_info_light +
    # pack_scf_rows). The sideband scratch is sized to the largest track
    # and reused; only the filled rows are copied out.
    import ctypes

    from ..native import _lib

    side_rows: list = []
    side_data: list = []
    hi_rows: list = []
    hi_data: list = []
    cap = max((u.n for u in unpacked), default=1) or 1
    srow_t = np.empty(cap, np.int32)
    sdata_t = np.empty((cap, fe.SCF_SIDE_BYTES), np.uint8)
    hrow_t = np.empty(cap, np.int32)
    hmask_t = np.empty((cap, fe.SCF_HI_BYTES), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ns_c = ctypes.c_int64()
    nh_c = ctypes.c_int64()
    off = 0
    for u in unpacked:
        if not u.n:
            continue
        if hasattr(u, "ip"):
            # Packed walk (fe.unpack_data_light_packed): the rows ARE
            # the transfer form — plain row copies, no repack at all.
            info[off : off + u.n] = u.ip
            scf[off : off + u.n] = u.scf_main
            if len(u.srows):
                side_rows.append(u.srows + off)
                side_data.append(u.sdata)
            if len(u.hrows):
                hi_rows.append(u.hrows + off)
                hi_data.append(u.hmask)
            off += u.n
            continue
        tinfo = np.ascontiguousarray(u.info, dtype=np.int32)
        tscf = np.ascontiguousarray(u.scf, dtype=np.int32)
        rc = _lib.mg_pack_light_track(
            tinfo.ctypes.data_as(i32p), tscf.ctypes.data_as(i32p),
            ctypes.c_int64(u.n),
            info[off:].ctypes.data_as(u16p),
            scf[off:].ctypes.data_as(u8p),
            srow_t.ctypes.data_as(i32p), sdata_t.ctypes.data_as(u8p),
            hrow_t.ctypes.data_as(i32p), hmask_t.ctypes.data_as(u8p),
            ctypes.c_int64(off), ctypes.byref(ns_c), ctypes.byref(nh_c),
        )
        if rc != 0:
            raise ValueError("scalefactor slot exceeds 5 bits")
        if ns_c.value:
            side_rows.append(srow_t[: ns_c.value].copy())
            side_data.append(sdata_t[: ns_c.value].copy())
        if nh_c.value:
            hi_rows.append(hrow_t[: nh_c.value].copy())
            hi_data.append(hmask_t[: nh_c.value].copy())
        off += u.n

    def _sideband(rows_l, data_l, width, force, base):
        n = int(sum(len(r) for r in rows_l))
        pad = _quantize_up(max(n, 1), 8, base=base, ratio=4.0)
        if force is not None:
            assert force >= pad or force >= n, (force, n)
            pad = max(force, pad) if force < pad else force
        # Padding entries scatter zero rows into the dummy slot npad.
        rows = np.full(pad, npad, np.int32)
        data = np.zeros((pad, width), np.uint8)
        if n:
            rows[:n] = np.concatenate(rows_l)
            data[:n] = np.concatenate(data_l)
        return rows, data

    srow, sdata = _sideband(
        side_rows, side_data, fe.SCF_SIDE_BYTES, force_s, base=256
    )
    hrow, hdata = _sideband(
        hi_rows, hi_data, fe.SCF_HI_BYTES, force_h, base=64
    )
    valid_samples = np.array(
        [u.n // n_channels * 576 for u in unpacked] + [0] * (bpad - bsz),
        dtype=np.int32,
    )
    return prep, (counts, scf, srow, sdata, hrow, hdata, info,
                  valid_samples), g_max


def prepare_batch_arrays_light_sharded(
    unpacked: list[fe.UnpackedMp3Light], n_channels: int, n_shards: int
):
    """Round-robin shard tracks and prepare every shard with IDENTICAL
    static shapes, ready to stack on a leading device axis for
    shard_map dispatch. Returns (args: tuple of (D, ...) np arrays,
    nb, g_max, shard_index) where shard_index[d][j] is the original
    track index of shard d's j-th track."""
    order = sorted(range(len(unpacked)), key=lambda i: unpacked[i].n,
                   reverse=True)
    shard_index = [order[d::n_shards] for d in range(n_shards)]
    assert all(shard_index), "need at least one track per shard"
    shards = [[unpacked[i] for i in idxs] for idxs in shard_index]

    from ..utils import bufpool

    first = [
        prepare_batch_arrays_light(s, n_channels) for s in shards
    ]
    bpad = max(r[1][0].shape[0] for r in first)
    g_max = max(r[2] for r in first)
    nb = max(r[0].nb for r in first)
    n_words = max(r[0].n_words for r in first)
    s_pad = max(r[1][2].shape[0] for r in first)
    h_pad = max(r[1][4].shape[0] for r in first)
    results = []
    for s, r in zip(shards, first):
        prep, rest, g_here = r
        if (rest[0].shape[0] != bpad or g_here != g_max or prep.nb != nb
                or prep.n_words != n_words or rest[2].shape[0] != s_pad
                or rest[4].shape[0] != h_pad):
            bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
            prep, rest, _ = prepare_batch_arrays_light(
                s, n_channels,
                force_shapes=(bpad, g_max, nb, n_words, s_pad, h_pad),
            )
        results.append((prep, rest))

    def stack(get):
        return np.stack([get(p, r) for p, r in results])

    args = tuple(
        stack(lambda p, r, j=j: p.device_args()[j]) for j in range(4)
    ) + tuple(
        stack(lambda p, r, j=j: r[j]) for j in range(8)
    )
    for p, r in results:
        bufpool.give(p.buf, p.meta, r[1], r[6])
    return args, nb, g_max, shard_index


# ---------------------------------------------------------------------------
# Mesh runner
# ---------------------------------------------------------------------------


@dataclass
class TrackOutcome:
    path: str
    ok: bool
    error: str | None = None
    result: ReplayGainResult | None = None
    histogram: np.ndarray | None = None


@dataclass
class BatchResult:
    tracks: list[TrackOutcome]
    audio_seconds: float
    wall_seconds: float
    album_histogram: np.ndarray | None = None
    album_peak: float = 0.0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)


@lru_cache(maxsize=None)
def _single_device_pipeline(n_channels: int, sample_rate: int, dtype):
    """Module-level cache: compiled pipelines must outlive any one
    MeshRunner (scan_files builds a fresh runner per call)."""
    core = partial(
        _analysis_core,
        n_channels=n_channels, sample_rate=sample_rate, dtype=dtype,
    )
    return jax.jit(core)


@lru_cache(maxsize=None)
def _light_tail_pipeline(n_channels: int, sample_rate: int, g_max: int,
                         dtype):
    core = partial(
        _light_tail,
        g_max=g_max,
        n_channels=n_channels, sample_rate=sample_rate, dtype=dtype,
    )
    return jax.jit(core)


class MeshRunner:
    """Batched analysis over a 1-D data-parallel device mesh."""

    def __init__(self, mesh: Mesh | None = None, dtype=jnp.float32,
                 max_batch: int = 64):
        if mesh is None:
            # LOCAL devices: in a multi-host jax.distributed group each
            # process analyzes its own track slice (tracks are
            # independent); a global default mesh would turn every
            # batch into a cross-host collective with per-process
            # shapes (they diverge — different files, different g_max)
            # and crash the transport. The one cross-host reduction is
            # the album union (parallel/multihost.album_union_global).
            # Single-process: local == global, no behavior change.
            devices = np.array(backend.local_devices())
            mesh = Mesh(devices, axis_names=("dp",))
        self.mesh = mesh
        self.dtype = dtype
        self.max_batch = max_batch
        self.n_devices = int(np.prod(mesh.devices.shape))
        self._jitted = {}

    def _pipeline(self, n_channels: int, sample_rate: int):
        key = (n_channels, sample_rate)
        if key in self._jitted:
            return self._jitted[key]

        core = partial(
            _analysis_core,
            n_channels=n_channels,
            sample_rate=sample_rate,
            dtype=self.dtype,
        )
        if self.n_devices == 1:
            # Plain jit on a single device, cached at module level so
            # compiles survive runner churn.
            run = _single_device_pipeline(n_channels, sample_rate, self.dtype)
        else:
            spec_b = P("dp")

            @partial(jax.jit)
            def run(*args):
                shard = jax.shard_map(
                    lambda *a: core(*a),
                    mesh=self.mesh,
                    in_specs=tuple(spec_b for _ in args),
                    out_specs=(spec_b, spec_b, spec_b),
                )
                return shard(*args)

        self._jitted[key] = run
        return run

    def _pipeline_light_sharded(self, n_channels: int, sample_rate: int,
                                nb: int, g_max: int):
        """Raw-bits pipeline over the dp mesh: each device runs its own
        Pallas entropy grid + analysis tail on its shard (cached per
        instance — the mesh is part of the closure)."""
        from ..decode import entropy_kernel as ek

        interpret = backend.interpret_kernels()
        key = ("light-sh", n_channels, sample_rate, nb, g_max, interpret)
        if key in self._jitted:
            return self._jitted[key]
        core = partial(
            _analysis_core_light,
            nb=nb, lanes=ek.LANES, g_max=g_max,
            n_channels=n_channels, sample_rate=sample_rate,
            dtype=self.dtype, interpret=interpret,
        )
        mesh = self.mesh
        spec = P("dp")

        @jax.jit
        def run(*args):
            def shard(*a):
                h, li, pk = core(*(x[0] for x in a))
                return h[None], li[None], pk[None]

            # check_vma=False: pallas_call's out_shape carries no
            # varying-mesh-axes annotation, and every operand/output here
            # is explicitly dp-sharded anyway.
            return jax.shard_map(
                shard, mesh=mesh,
                in_specs=tuple(spec for _ in args),
                out_specs=(spec, spec, spec),
                check_vma=False,
            )(*args)

        self._jitted[key] = run
        return run

    def dispatch_light_sharded(
        self, unpacked: list[fe.UnpackedMp3Light], sample_rate: int,
        n_channels: int,
    ):
        """Enqueue a raw-bits batch sharded over the dp mesh."""
        if len(unpacked) < self.n_devices:
            return self.dispatch_light(unpacked, sample_rate, n_channels)
        args, nb, g_max, shard_index = prepare_batch_arrays_light_sharded(
            unpacked, n_channels, self.n_devices
        )
        sharding = NamedSharding(self.mesh, P("dp"))
        dev_args = [jax.device_put(a, sharding) for a in args]
        run = self._pipeline_light_sharded(
            n_channels, sample_rate, nb, g_max
        )
        hist, loud_idx, peak = run(*dev_args)  # (D, B, ...)
        return ("sharded", hist, loud_idx, peak, shard_index,
                len(unpacked))

    def dispatch_light(
        self, unpacked: list[fe.UnpackedMp3Light], sample_rate: int,
        n_channels: int, force_shapes: tuple | None = None,
    ):
        """Enqueue a raw-bits batch; returns a handle for collect().

        Dispatch is async: the host is free to unpack/pack the next batch
        while the device works this one. Two device dispatches: the
        entropy stage (keyed by nb + word-buffer length — small, fast to
        compile) feeds the analysis tail (keyed by nb/B/G only) through
        device-resident intermediates. Pooled host buffers are recycled
        once their transfers commit.

        force_shapes=(bpad, g_max, nb) pins static shapes to a scan
        plan's class key (see _plan_scan) so similar batches share one
        compiled executable. Pins are advisory upper bounds: if the
        unpacked data needs more (the plan probed with a different
        resync walk), the real requirement wins — a fresh key, not a
        crash."""
        from ..decode import entropy_kernel as ek

        bsz = len(unpacked)
        interpret = backend.interpret_kernels()
        trace = os.environ.get("MP3RGAIN_SCAN_TIME") == "2"
        marks = [("t0", time.monotonic())]

        def mark(name):
            if trace:
                marks.append((name, time.monotonic()))

        full_force = None
        if force_shapes is not None:
            bpad_f, g_f, nb_f = force_shapes
            g_req = _quantize_up(
                max(u.n for u in unpacked), 2 * n_channels,
                base=512, ratio=1.3,
            )
            b_req = next((b for b in _B_LADDER if b >= bsz), bsz)
            nb_req = ek.quantize_nb(
                -(-sum(u.n for u in unpacked) // ek.LANES)
            )
            full_force = (
                max(bpad_f, b_req), max(g_f, g_req), max(nb_f, nb_req),
                None, None, None,
            )
        prep, (counts, scf, srow, sdata, hrow, hdata, info, valid), g_max = (
            prepare_batch_arrays_light(
                unpacked, n_channels, 1, force_shapes=full_force
            )
        )
        mark("pack")
        dev1 = jax.device_put(prep.device_args())
        mark("put1")
        spec, ends = ek.decode_blocks(*dev1, nb=prep.nb, lanes=prep.lanes,
                                      interpret=interpret)
        mark("entropy_launch")
        dev2 = jax.device_put((counts, scf, srow, sdata, hrow, hdata, info,
                               valid))
        mark("put2")
        tail = _light_tail_pipeline(n_channels, sample_rate, g_max,
                                    self.dtype)
        hist, loud_idx, peak = tail(spec, ends, *dev2)
        mark("tail_launch")
        if not interpret:
            # Defer the input-transfer wait and host-buffer recycling to
            # collect(): the uploader thread returns as soon as the
            # launches are queued, so the wait overlaps the next batch's
            # pack instead of serializing dispatch.
            recycle = ((dev1, dev2), (prep.buf, prep.meta, scf, info))
            if trace:
                spans = " ".join(
                    f"{name}={t1 - t0:.2f}s"
                    for (_, t0), (name, t1) in zip(marks, marks[1:])
                )
                print(f"dispatch_light trace: {spans} "
                      f"(buf {prep.buf.nbytes / 1e6:.0f} MB)",
                      file=sys.stderr, flush=True)
            return (hist, loud_idx, peak, bsz, recycle)
        # CPU jax may ALIAS the host numpy buffer in device_put;
        # recycling an aliased buffer lets the next batch's pack
        # overwrite memory the still-queued computation reads (a race
        # observed as cross-bucket result corruption on the
        # CPU/interpret path) — so the interpret path never pools.
        return (hist, loud_idx, peak, bsz)

    def collect(self, handle):
        """Block on a dispatched batch; only small scalars cross d2h."""
        from ..utils import bufpool

        if isinstance(handle[0], str) and handle[0] == "sharded":
            _, hist, loud_idx, peak, shard_index, total = handle
            # Un-shard back to original track order (device row gather).
            d_idx = np.empty(total, np.int32)
            j_idx = np.empty(total, np.int32)
            for d, idxs in enumerate(shard_index):
                for j, i in enumerate(idxs):
                    d_idx[i] = d
                    j_idx[i] = j
            handle = (
                hist[d_idx, j_idx], loud_idx[d_idx, j_idx],
                peak[d_idx, j_idx], total,
            )
        hist, loud_idx, peak, bsz = handle[:4]
        stats = np.asarray(
            jnp.concatenate(
                [loud_idx[:bsz].astype(jnp.float32), peak[:bsz].astype(jnp.float32)]
            )
        )
        louds = np.array([hi.index_to_loudness(i) for i in stats[:bsz]])
        if len(handle) == 5 and handle[4] is not None:
            # Deferred from dispatch_light: the batch has executed (the
            # stats readback above forced it), so the input transfers
            # are long done — wait out the ready events and recycle the
            # pooled host buffers for the next pack.
            dev_arrays, host_bufs = handle[4]
            jax.block_until_ready(dev_arrays)
            bufpool.give(*host_bufs)
        return hist[:bsz], louds, stats[bsz:]

    def analyze_unpacked_light(
        self, unpacked: list[fe.UnpackedMp3Light], sample_rate: int,
        n_channels: int,
    ):
        """Analyze same-format tracks from the raw-bits manifest.

        Same contract as analyze_unpacked, but the host→device payload is
        raw main-data words and the Huffman decode runs on device (one
        dispatch end-to-end)."""
        return self.collect(
            self.dispatch_light(unpacked, sample_rate, n_channels)
        )

    def _album_reduce(self):
        """Device-side album reduction: histogram psum + peak max."""
        mesh = self.mesh

        @jax.jit
        def reduce_fn(hist, peak):
            def shard(h, p):
                local_h = jnp.sum(h, axis=0, dtype=jnp.uint32)
                local_p = jnp.max(p)
                total_h = jax.lax.psum(local_h, axis_name="dp")
                total_p = jax.lax.pmax(local_p, axis_name="dp")
                return total_h[None], total_p[None]

            h, p = jax.shard_map(
                shard, mesh=mesh,
                in_specs=(P("dp"), P("dp")),
                out_specs=(P("dp"), P("dp")),
            )(hist, peak)
            return h[0], p[0]

        return reduce_fn

    def analyze_unpacked(
        self, unpacked: list[fe.UnpackedMp3], sample_rate: int, n_channels: int
    ):
        """Analyze same-format tracks.

        Returns (hist_device (B,12000) int32 on device, loudness (B,) np,
        peak (B,) np). Histograms stay on device: only the album
        reduction ever needs histogram contents, and it runs on device
        too."""
        return self.collect(
            self.dispatch_heavy(unpacked, sample_rate, n_channels)
        )

    def dispatch_heavy(
        self, unpacked: list[fe.UnpackedMp3], sample_rate: int,
        n_channels: int,
    ):
        """Enqueue a host-decoded batch; returns a handle for collect()."""
        bsz = len(unpacked)
        args = prepare_batch_arrays(unpacked, n_channels, self.n_devices)
        if self.n_devices == 1:
            dev_args = jax.device_put(args)
        else:
            sharding = NamedSharding(self.mesh, P("dp"))
            dev_args = [jax.device_put(a, sharding) for a in args]
        run = self._pipeline(n_channels, sample_rate)
        hist, loud_idx, peak = run(*dev_args)
        # Only the small per-track scalars come back to host (collect).
        return (hist, loud_idx, peak, bsz)

    def album_reduce_device(self, hist: np.ndarray, peak: np.ndarray):
        """psum album histogram + pmax peak over the mesh."""
        bsz = hist.shape[0]
        bpad = -(-bsz // self.n_devices) * self.n_devices
        hist_p = np.zeros((bpad, hi.HISTOGRAM_SIZE), dtype=hist.dtype)
        hist_p[:bsz] = hist
        peak_p = np.zeros(bpad, dtype=np.float32)
        peak_p[:bsz] = peak
        sharding = NamedSharding(self.mesh, P("dp"))
        h = jax.device_put(jnp.asarray(hist_p), sharding)
        p = jax.device_put(jnp.asarray(peak_p), sharding)
        total_h, total_p = self._album_reduce()(h, p)
        return np.asarray(total_h), float(total_p)


_SR_BY_VERSION = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000),
                  0: (11025, 12000, 8000)}


def _probe_mp3(path):
    """Cheap native header walk: (sample_rate, n_channels, gch_count)
    or None. One mg_frame_index pass (resync walk, no entropy decode,
    ~1 ms/track) gives the exact frame count; the first header word
    gives rate/mode. gch may overcount (frames the full unpack later
    rejects) but never undercounts — plan shapes derived from it are
    safe upper bounds."""
    import ctypes

    from .. import native as nat

    try:
        with open(path, "rb") as f:
            data = f.read()
        out = np.zeros(3, np.int64)
        n = nat._lib.mg_frame_index(
            nat._inbuf(data), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 1,
        )
    except Exception:
        return None
    frames = -n if n < 0 else n
    if frames <= 0:
        return None
    hdr = int(out[2])
    version = (hdr >> 19) & 3
    sr_idx = (hdr >> 10) & 3
    if version not in _SR_BY_VERSION or sr_idx > 2:
        return None
    sr = _SR_BY_VERSION[version][sr_idx]
    nch = 1 if ((hdr >> 6) & 3) == 3 else 2
    granules = 2 if version == 3 else 1
    return sr, nch, frames * granules * nch


def _plan_scan(paths, max_batch: int, rows_cap: int):
    """Pre-scan pass for big libraries: probe every file's shape, then
    pin ONE compile key per (bucket, length-class) and order the walk
    so each distinct key's first batch dispatches as early as possible.

    Cold scans are compile-bound; the two levers here are (a) fewer
    executable keys — every chunk of a class is forced to the class
    shape (bpad, g_pin, nb_pin), so remainder batches and
    slightly-shorter batches reuse the class executable instead of
    minting (B, g_max) variants — and (b) compile concurrency: the walk
    order leads with one chunk per class, so all distinct keys start
    compiling (on the uploader threads) in the first few waves instead
    of being discovered serially as buckets happen to fill.

    Returns (order, queues): order is the walk order as indices into
    paths (probe failures go last, through the normal error path);
    queues[(sr, nch)] is the in-order list of (size, (bpad, g_pin,
    nb_pin)) chunks the flusher should cut."""
    from ..decode import entropy_kernel as ek

    buckets: dict = {}
    unknown = []
    for i, p in enumerate(paths):
        probe = _probe_mp3(p)
        if probe is None:
            unknown.append(i)
            continue
        sr, nch, gch = probe
        buckets.setdefault((sr, nch), []).append((i, gch))

    queues: dict = {}
    leads: list = []  # first chunk of each class: [(key, [idx...])]
    rest: list = []
    for key, members in sorted(buckets.items()):
        sr, nch = key
        members.sort(key=lambda t: t[1])
        unit = 2 * nch

        # Cut rows-capped chunks over the sorted members.
        chunks = []
        i = 0
        while i < len(members):
            c = min(len(members) - i, max_batch)
            while c > 1:
                g = _quantize_up(members[i + c - 1][1], unit,
                                 base=512, ratio=1.3)
                bpad = next((b for b in _B_LADDER if b >= c), c)
                if bpad * g <= rows_cap:
                    break
                lower = [b for b in _B_LADDER if b < bpad]
                c = min(c - 1, lower[-1] if lower else 1)
            chunks.append(members[i : i + c])
            i += c

        # Classes by pinned g; every chunk adopts its class's key.
        classes: dict = {}
        for ch in chunks:
            g = _quantize_up(ch[-1][1], unit, base=512, ratio=1.3)
            classes.setdefault(g, []).append(ch)
        # Merge affordable classes upward: at low rates a bucket's whole
        # span fits one key (64 x g_bucket_max under the rows cap), so
        # shorter classes adopt the largest g — one compile saved per
        # merge, for a few MB of zero-padded info/scf h2d and some
        # padded tail compute on the short batches (bounded by the 2.5x
        # ratio guard).
        if len(classes) > 1:
            g_top = max(classes)
            b_top = max(
                next((b for b in _B_LADDER if b >= len(ch)), len(ch))
                for ch in classes[g_top]
            )
            for g in sorted(classes):
                if g == g_top:
                    continue
                b_here = max(
                    next((bb for bb in _B_LADDER if bb >= len(ch)),
                         len(ch))
                    for ch in classes[g]
                )
                b_merged = max(b_top, b_here)
                if b_merged * g_top <= rows_cap and g_top <= 2.5 * g:
                    classes[g_top] = classes[g] + classes[g_top]
                    del classes[g]
                    b_top = b_merged
        for g, chs in classes.items():
            bpad = max(
                next((b for b in _B_LADDER if b >= len(ch)), len(ch))
                for ch in chs
            )
            nb = max(
                ek.quantize_nb(-(-sum(m[1] for m in ch) // ek.LANES))
                for ch in chs
            )
            force = (bpad, g, nb)
            entries = [(len(ch), force, [m[0] for m in ch]) for ch in chs]
            leads.append((key, entries[0]))
            rest.extend((key, e) for e in entries[1:])

    order: list = []
    seq: dict = {}
    for key, (size, force, idxs) in leads + rest:
        order.extend(idxs)
        seq.setdefault(key, []).append((size, force))
    order.extend(unknown)
    return order, seq


def analyze_library(
    paths,
    runner: MeshRunner | None = None,
    album: bool = False,
    dtype=jnp.float32,
    device_entropy: bool | None = None,
    wave_size: int | None = None,
    batch_cb=None,
) -> BatchResult:
    """Analyze many tracks with bucketed batching and fault isolation.

    Streams the library in waves of `wave_size` files so a 10k-track scan
    never holds more than a wave of unpacked audio (plus one pending
    partial batch per format bucket), and overlaps the host stages of
    wave k+1 with the device batches of wave k: device dispatches are
    async, and results are collected one batch behind.

    batch_cb, if given, is called with the list of TrackOutcome completed
    after each collected batch (scan checkpointing hook)."""
    runner = runner or MeshRunner(dtype=dtype)
    t0 = time.monotonic()
    if device_entropy is None:
        device_entropy = backend.device_entropy()
    if wave_size is None:
        wave_size = 4 * runner.max_batch

    outcomes: dict[int, TrackOutcome] = {}
    buckets: dict[tuple[int, int], list] = {}
    audio_seconds = 0.0
    album_state = {"hist": None}
    inflight = []  # [(handle, idxs, sr)]

    # Host entropy decode scales across cores: the native unpack runs
    # without the GIL (ctypes foreign call), so a thread pool gives
    # near-linear speedup on multi-core hosts (no-op on one core).
    # With device_entropy the host stage is the ~14x cheaper light walk
    # (side info + scalefactors only) and Huffman decode runs on-chip.
    def _unpack(path):
        if device_entropy:
            # Packed-emission walk: rows land in the transfer form, so
            # the batch prep is pure row copies (~4x less walk write
            # traffic than the dense light form).
            with open(path, "rb") as f:
                u = fe.unpack_data_light_packed(f.read())
        else:
            u = fe.unpack_file(path)
        if u.n == 0:
            raise RuntimeError("No valid MP3 frames found")
        return u

    if not device_entropy:
        dispatch = runner.dispatch_heavy
    elif runner.n_devices > 1:
        dispatch = runner.dispatch_light_sharded
    else:
        dispatch = runner.dispatch_light

    # Scan-stage attribution, enabled with MP3RGAIN_SCAN_TIME=1: one
    # stderr line per collected batch (dispatch wall on the uploader
    # thread, collect wait on the main thread, batch size).
    scan_time = bool(os.environ.get("MP3RGAIN_SCAN_TIME"))

    def _timed_dispatch(ups, sr, nch, force=None):
        td0 = time.monotonic()
        if force is not None:
            h = dispatch(ups, sr, nch, force_shapes=force)
        else:
            h = dispatch(ups, sr, nch)
        return h, time.monotonic() - td0

    def _est_resident_bytes(ups) -> int:
        """Approximate HBM a dispatched batch holds while queued: its
        input manifest plus the entropy-stage int16 spectrum (the tail's
        transients are transient — executions serialize on device).
        1.3x covers ladder/ragged padding."""
        n = sum(u.n for u in ups)
        inputs = sum(
            a.nbytes for u in ups for a in vars(u).values()
            if isinstance(a, np.ndarray)
        )
        return int(1.3 * inputs + 1.3 * n * 576 * 2)

    def _retryable(e) -> bool:
        """Device-memory exhaustion, which halving/retrying can relieve:
        XLA reports it as RESOURCE_EXHAUSTED (at compile or at run
        time) or "Ran out of memory"."""
        text = f"{type(e).__name__}: {e}"
        return "RESOURCE_EXHAUSTED" in text or "Ran out of memory" in text

    def _dispatch_collect_halving(ups, idxs, sr, nch):
        """Synchronous fallback after a pressure-class dispatch failure:
        dispatch+collect immediately (no other batch in flight), halving
        the batch until it fits. At n=1 retry once after a backoff (the
        pressure window may pass), then isolate the track as a failed
        outcome — a 1k-track scan must degrade, not die."""
        try:
            return [(idxs, runner.collect(dispatch(ups, sr, nch)))]
        except Exception as e:
            if not _retryable(e):
                raise
            if len(ups) == 1:
                time.sleep(float(
                    os.environ.get("MP3RGAIN_PRESSURE_BACKOFF_S", 10.0)
                ))
                try:
                    return [(idxs, runner.collect(dispatch(ups, sr, nch)))]
                except Exception as e2:
                    if not _retryable(e2):
                        raise
                    return [(idxs, e2)]
            if scan_time:
                print(f"scan batch: device pressure at n={len(ups)}, "
                      f"halving", file=sys.stderr, flush=True)
            mid = len(ups) // 2
            out = []
            for lo, hi in ((0, mid), (mid, len(ups))):
                out += _dispatch_collect_halving(
                    ups[lo:hi], idxs[lo:hi], sr, nch
                )
            return out

    def collect_one():
        fut, idxs, sr, nch, ups, _est = inflight.pop(0)
        tc0 = time.monotonic()
        try:
            handle, dispatch_dt = fut.result()
        except Exception as e:
            if not _retryable(e):
                raise
            for idxs2, collected in _dispatch_collect_halving(
                ups, idxs, sr, nch
            ):
                _finish_batch(idxs2, sr, collected)
            return
        try:
            hist_dev, louds, peaks = runner.collect(handle)
        except Exception as e:
            if not _retryable(e):
                raise
            for idxs2, collected in _dispatch_collect_halving(
                ups, idxs, sr, nch
            ):
                _finish_batch(idxs2, sr, collected)
            return
        if scan_time:
            print(
                f"scan batch: n={len(idxs)} sr={sr} "
                f"dispatch={dispatch_dt:.2f}s "
                f"collect_wait={time.monotonic() - tc0:.2f}s",
                file=sys.stderr, flush=True,
            )
        _finish_batch(idxs, sr, (hist_dev, louds, peaks))

    def _finish_batch(idxs, sr, collected):
        if isinstance(collected, Exception):
            # Single track that failed even after halving + backoff:
            # isolate it (same contract as a corrupt file — no result,
            # no checkpoint callback) instead of aborting the scan.
            for i in idxs:
                outcomes[i] = TrackOutcome(
                    path=str(paths[i]), ok=False,
                    error=(
                        f"device dispatch failed under pressure: "
                        f"{collected}"
                    ),
                )
            return
        hist_dev, louds, peaks = collected
        if album:
            batch_sum = jnp.sum(hist_dev, axis=0)
            album_state["hist"] = (
                batch_sum if album_state["hist"] is None
                else album_state["hist"] + batch_sum
            )
        done = []
        for j, i in enumerate(idxs):
            loud = float(louds[j])
            outcomes[i] = TrackOutcome(
                path=str(paths[i]),
                ok=True,
                result=ReplayGainResult(
                    loudness_db=loud,
                    gain_db=PINK_REF - loud,
                    peak=float(peaks[j]),
                    sample_rate=sr,
                    file_type="mp3",
                ),
                histogram=hist_dev[j],
            )
            done.append(outcomes[i])
        if batch_cb:
            batch_cb(done)

    # The pack + h2d + launch of batch k+1 runs on uploader threads
    # while the device computes batch k (and while the main thread
    # walks the next wave of files — the native unpack drops the GIL).
    # Several workers so that cold scans compile DIFFERENT shape keys
    # concurrently; collect order stays FIFO via the inflight queue.
    uploader = ThreadPoolExecutor(max_workers=4)

    # Admission is byte-aware, not just count-capped: two batches always
    # overlap; beyond that a batch is admitted only while the estimated
    # resident total of queued inputs + entropy spectra stays under the
    # budget. Small cold-compile batches stay 4-wide.
    hbm_budget = int(
        float(os.environ.get("MP3RGAIN_INFLIGHT_HBM_MB", 3072)) * 1e6
    )

    def _chunk_size(members, max_batch: int) -> int:
        """Largest prefix of the length-sorted members whose padded
        (bpad x g_max) row footprint stays under the device cap.

        Bounds every batch's device-memory demand by construction: 64
        of the LONGEST tracks can pad to ~1.5x the rows of a 64x60 s
        batch, and the padded IIR/synthesis temporaries grow with them.
        Splitting by rows instead of count keeps long-track batches
        inside the envelope short-track batches prove out."""
        cap = int(os.environ.get("MP3RGAIN_BATCH_ROWS", 640_000))
        c = min(len(members), max_batch)
        while c > 1:
            u = members[c - 1][1]
            g = _quantize_up(u.n, 2 * u.n_channels, base=512, ratio=1.3)
            bpad = next((b for b in _B_LADDER if b >= c), c)
            if bpad * g <= cap:
                break
            lower = [b for b in _B_LADDER if b < bpad]
            c = min(c - 1, lower[-1] if lower else 1)
        return c

    def flush_bucket(key, members, force=None):
        sr, nch = key
        idxs = [i for i, _ in members]
        ups = [u for _, u in members]
        est = _est_resident_bytes(ups)
        while inflight and (
            len(inflight) >= 4
            or (
                len(inflight) >= 2
                and sum(e[5] for e in inflight) + est > hbm_budget
            )
        ):
            collect_one()
        inflight.append(
            (uploader.submit(_timed_dispatch, ups, sr, nch, force), idxs,
             sr, nch, ups, est)
        )

    paths = list(paths)

    # Big libraries get a planned walk: a cheap native header pre-scan
    # pins one compile key per (bucket, length-class) and fronts each
    # class's first batch, so cold scans start ALL their compiles
    # in the first waves and remainder batches reuse class executables
    # (see _plan_scan). Small scans and mesh/heavy paths keep the plain
    # streaming walk.
    rows_cap = int(os.environ.get("MP3RGAIN_BATCH_ROWS", 640_000))
    plan_q: dict = {}
    order = list(range(len(paths)))
    if (
        device_entropy
        and runner.n_devices == 1
        and len(paths) >= 2 * runner.max_batch
        and not os.environ.get("MP3RGAIN_NO_SCAN_PLAN")
    ):
        order, plan_q = _plan_scan(paths, runner.max_batch, rows_cap)
        plan_q = {k: list(v) for k, v in plan_q.items()}

    def _flush_ready(key, members, final=False):
        """Cut batches off a bucket: planned class chunks when a plan
        queue exists (members arrive pre-sorted in plan order), else
        length-sorted rows-capped chunks at max_batch granularity."""
        q = plan_q.get(key)
        while q and len(members) >= q[0][0]:
            size, force = q.pop(0)
            flush_bucket(key, members[:size], force)
            del members[:size]
        if q:
            if final and members:
                # Unpack failures left the last planned chunk short.
                size, force = q.pop(0)
                flush_bucket(key, members[:size], force)
                del members[:size]
            return
        if not final:
            if len(members) >= runner.max_batch:
                members.sort(key=lambda iu: iu[1].n)
                while len(members) >= runner.max_batch:
                    c = _chunk_size(members, runner.max_batch)
                    flush_bucket(key, members[:c])
                    del members[:c]
        else:
            members.sort(key=lambda iu: iu[1].n)
            while members:
                c = _chunk_size(members, runner.max_batch)
                flush_bucket(key, members[:c])
                del members[:c]

    workers = min(max(len(paths), 1), os.cpu_count() or 1, 16)
    try:
        for wstart in range(0, len(order), wave_size):
            widx = order[wstart : wstart + wave_size]
            wave = [paths[i] for i in widx]
            if workers > 1 and len(wave) > 1:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    unpacked = list(
                        pool.map(lambda p: _result_of(_unpack, p), wave)
                    )
            else:
                unpacked = [_result_of(_unpack, p) for p in wave]

            for i, path, (u, err) in zip(widx, wave, unpacked):
                if err is not None:
                    outcomes[i] = TrackOutcome(path=str(path), ok=False, error=err)
                    continue
                sr, nch = u.sample_rate, u.n_channels
                buckets.setdefault((sr, nch), []).append((i, u))
                audio_seconds += (u.n // nch) * 576 / sr
            # Flush ready batches at wave end (planned class chunks, or
            # length-sorted full batches: batching similar-length tracks
            # shrinks each batch's padded g_max, which every manifest
            # buffer and its h2d bytes scale with).
            for key, members in buckets.items():
                _flush_ready(key, members)

        for key, members in buckets.items():
            while members:
                _flush_ready(key, members, final=True)
        while inflight:
            collect_one()
    finally:
        uploader.shutdown(wait=True)

    tracks = [outcomes[i] for i in range(len(paths))]
    result = BatchResult(
        tracks=tracks,
        audio_seconds=audio_seconds,
        wall_seconds=time.monotonic() - t0,
    )

    if album and album_state["hist"] is not None:
        ok = [t for t in tracks if t.ok]
        result.album_histogram = np.asarray(album_state["hist"])
        result.album_peak = max(t.result.peak for t in ok)
    return result
