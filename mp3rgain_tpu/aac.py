"""AAC/M4A analysis path: host AAC-LC front-end + shared device DSP.

The M4A path reuses the same equal-loudness filter and histogram kernels
as MP3 (BASELINE: "the mp4meta AAC path reuses the same filter+histogram
kernels"); only the decode back-end differs (AAC IMDCT/windowing instead
of the MP3 hybrid filterbank + polyphase).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

from . import backend
from .decode import aac_frontend as af
from .decode import aac_synthesis
from .ops import histogram as hi
from .ops import iir
from .replaygain import PINK_REF, PeakAmplitudeResult, ReplayGainResult

SAMPLE_SCALE_16BIT = 32768.0

# AAC analysis clips decoded samples at ±1.0, matching the reference's
# decoder (symphonia clips; the reference's AAC peaks and loudness are
# computed from clipped PCM). This is the opposite of our MP3 contract
# (true unclipped peak, mp3gain parity) because mp3gain never handled
# AAC — the reference IS the AAC peer — and because AAC encoder priming
# can decode to wild magnitudes with no container metadata to trim by
# (ffmpeg-aac fixture: ±13,218 full-scale in samples 1024..4095, bit-
# identical in libavcodec's own decode).
AAC_CLIP = 1.0


class AacError(RuntimeError):
    pass


def _analysis_tail(spec, window_seq, window_shape, valid_samples,
                   *, n_channels: int, sample_rate: int, dtype):
    """Shared device tail: (B, F, 1024) spectra -> (hist, loud_idx, peak)."""

    def one(args):
        return aac_synthesis._decode_jit(
            *args, n_channels=n_channels, dtype=dtype
        )

    pcm = jax.vmap(one)((spec, window_seq, window_shape))  # (B, C, N)
    pcm = jnp.clip(pcm, -AAC_CLIP, AAC_CLIP)
    bsz, c, n = pcm.shape
    mask = (jnp.arange(n)[None, None, :] < valid_samples[:, None, None])
    peak = jnp.max(jnp.abs(pcm) * mask, axis=(1, 2))  # (B,)
    x = pcm.reshape(bsz * c, n).astype(dtype) * dtype(SAMPLE_SCALE_16BIT)
    filtered = iir.equal_loudness(x, sample_rate).reshape(bsz, c, n)
    hist = hi._histogram_jit(
        filtered, valid_samples, hi.window_size(sample_rate)
    )
    loud_idx = hi.loudness_index_device(hist)
    return hist, loud_idx, peak


@lru_cache(maxsize=None)
def _batch_fn(n_channels: int, sample_rate: int, dtype):
    """Batched AAC pipeline: vmapped decode + shared DSP tail.

    Module-level cache + ladder-quantized shapes (prepare_batch_arrays_aac)
    for the same reasons as the MP3 path: compiled executables must
    survive caller churn, and per-track lengths must not each compile."""

    def core(spec, sexp, window_seq, window_shape, valid_samples):
        # Block-scaled f16 transfer format: true spectrum is
        # spec * 2^sexp (sexp all-zero when the host shipped f32).
        spec = spec.astype(dtype) * jnp.exp2(sexp.astype(dtype))[..., None]
        return _analysis_tail(
            spec, window_seq, window_shape, valid_samples,
            n_channels=n_channels, sample_rate=sample_rate, dtype=dtype,
        )

    return jax.jit(core)


@lru_cache(maxsize=None)
def _batch_fn_q(n_channels: int, sample_rate: int, dtype):
    """Batched device-requant AAC pipeline: quantized coefficients in,
    spectral prep (requantize/PNS/stereo, decode/aac_prep.py) + IMDCT +
    DSP on device."""
    from .decode import aac_prep

    def core(spec_q4, meta, esc_idx, esc_val,
             fb16, fbexp, fbmap, window_seq, window_shape, valid_samples):
        spec = aac_prep.prep_spectra(
            spec_q4, meta, esc_idx, esc_val,
            fb16, fbexp, fbmap,
            sample_rate=sample_rate, n_channels=n_channels, dtype=dtype,
        )
        return _analysis_tail(
            spec, window_seq.astype(jnp.int32),
            window_shape.astype(jnp.int32), valid_samples,
            n_channels=n_channels, sample_rate=sample_rate, dtype=dtype,
        )

    return jax.jit(core)


def prepare_batch_arrays_aac(unpacked: list, n_channels: int):
    """Pad AAC tracks to ladder-quantized (B, F) shapes for _batch_fn.

    Zero-spectrum padding frames decode to zero PCM; everything past a
    track's valid_samples is masked out of peak and histogram. When
    every track was unpacked with f16=True the batch ships block-scaled
    float16 + per-frame exponents (half the h2d payload); otherwise
    float32 with zero exponents (f16 entries upconvert exactly)."""
    from .parallel.runner import _B_LADDER, _quantize_up

    bsz = len(unpacked)
    f_max = max((u.n // n_channels) * n_channels for u in unpacked)
    f_max = _quantize_up(max(f_max, n_channels), n_channels, base=128,
                         ratio=1.3)
    bpad = next((b for b in _B_LADDER if b >= bsz), bsz)
    all_f16 = all(u.spec16 is not None for u in unpacked)
    # Pooled buffers: beyond skipping first-touch page faults, the
    # runtime caches transfer-path setup (pinning) PER HOST BUFFER —
    # a reused buffer moves h2d at ~1,200 MB/s where a fresh one moves
    # at 20-120 MB/s (measured). analyze_batch gives these back once
    # the transfer has committed.
    from .utils import bufpool

    spec = bufpool.take_zeroed((bpad, f_max, 1024),
                               np.float16 if all_f16 else np.float32)
    sexp = bufpool.take_zeroed((bpad, f_max), np.int8)
    wseq = bufpool.take_zeroed((bpad, f_max), np.int32)
    wshape = bufpool.take_zeroed((bpad, f_max), np.int32)
    valid = np.zeros(bpad, np.int32)
    for i, u in enumerate(unpacked):
        n = (u.n // n_channels) * n_channels
        if all_f16:
            spec[i, :n] = u.spec16[:n]
            sexp[i, :n] = u.sexp[:n]
        elif u.spec16 is not None:
            spec[i, :n] = u.spec16[:n].astype(np.float32)
            spec[i, :n] *= np.exp2(u.sexp[:n].astype(np.float32))[:, None]
        else:
            spec[i, :n] = u.spec[:n]
        wseq[i, :n] = u.info[:n, af.WINDOW_SEQ]
        wshape[i, :n] = u.info[:n, af.WINDOW_SHAPE]
        valid[i] = (n // n_channels) * 1024
    return spec, sexp, wseq, wshape, valid


def use_device_prep() -> bool:
    """Route AAC spectral prep (requantize/PNS/stereo) on device.

    backend.aac_device_prep() decides: on by default on the GPU; on the
    CPU the host-requant f16 path stays the oracle (and its PNS noise
    values are the decoder-specific host LCG)."""
    return backend.aac_device_prep()


# Fallback-row ladder: keeps the (rare) fallback sideband's shape key
# population small across batches.
_FB_LADDER = (4, 16, 64, 256, 1024, 4096, 16384)

# Escape-coefficient ladder (|q| > 7 positions, sparse scatter-add;
# ~1.4% of coefficients on real content, 6 B each). Geometric at the
# bottom, then linear 128k steps: coarse top steps would ship megabytes
# of zero padding per batch.
_ESC_LADDER = tuple([512, 2048, 8192, 32768]
                    + [131072 * k for k in range(1, 129)])


def prepare_batch_arrays_aac_q(unpacked: list, n_channels: int,
                               force_shapes: tuple | None = None):
    """Pad device-requant AAC tracks into ladder-quantized batch arrays
    for _batch_fn_q. Returns the positional device-arg tuple.
    force_shapes = (bpad, f_max, ext, ecap, fbp) pins every static
    shape so independently prepared shards stack into one sharded
    executable (prepare_batch_arrays_aac_q_sharded)."""
    from .decode import aac_frontend as af
    from .decode.aac_format_tables import SWB_1024_MAP, SWB_LONG_TABLES
    from .parallel.runner import _B_LADDER, _quantize_up
    from .utils import bufpool

    bsz = len(unpacked)
    f_max = max((u.n // n_channels) * n_channels for u in unpacked)
    # Finer frame-count quantization than the f16/heavy path (1.3-ratio
    # ladder padded a same-length batch by 26%): spec_q4 + meta dominate
    # the h2d payload and both scale with f_max, while the tail compile
    # this keys is cheap relative to the transfer it saves on scans.
    f_max = _quantize_up(max(f_max, n_channels), 8 * n_channels, base=128,
                         ratio=1.08)
    bpad = next((b for b in _B_LADDER if b >= bsz), bsz)

    # Coded extent: quantized coefficients live only in btype==1 bands,
    # so the batch ships (B, F, EXT) with EXT from the largest coded
    # band, rounded to 128 to keep the executable population small.
    sr = unpacked[0].sample_rate
    swb = SWB_LONG_TABLES[SWB_1024_MAP[af.ADTS_SR_INDEX[sr]]]
    kmax = 0
    for u in unpacked:
        nz = np.nonzero((u.btype == 1).any(axis=0))[0]
        if len(nz):
            kmax = max(kmax, int(nz[-1]) + 1)
    ext = min(1024, max(128, -(-swb[min(kmax, len(swb) - 1)] // 128) * 128))

    force_ecap = force_fbp = None
    if force_shapes is not None:
        f_bpad, f_fmax, f_ext, force_ecap, force_fbp = force_shapes
        assert f_bpad >= bsz and f_fmax >= f_max and f_ext >= ext
        bpad, f_max, ext = f_bpad, f_fmax, f_ext

    # The spectrum buffer dominates the payload: two signed 4-bit
    # coefficients per byte, with every |q| > 7 routed to the sparse
    # escape sideband (prep_spectra scatter-adds them back exactly).
    # Take it unzeroed and memset only the regions the per-track copies
    # leave stale (pad rows per track + unused batch lanes) — a full
    # fill() would re-touch every page of the biggest array per batch.
    exth = ext // 2
    from .decode import aac_prep

    nbands = aac_prep.n_bands(sr)
    spec_q4 = bufpool.take((bpad, f_max, exth), np.int8)
    meta = bufpool.take_zeroed((bpad, f_max, nbands), np.uint16)
    wseq = bufpool.take_zeroed((bpad, f_max), np.uint8)
    wshape = bufpool.take_zeroed((bpad, f_max), np.uint8)
    valid = np.zeros(bpad, np.int32)
    fbmap = bufpool.take((bpad * f_max,), np.int32)
    fbmap[:] = np.arange(bpad * f_max, dtype=np.int32)

    # Escape entries ship as one flat coefficient index (row*1024 + pos)
    # + the exact int16 value: 6 B/entry instead of the earlier
    # (row, pos, val) 8 B. int64 indices only when the batch's flat
    # coefficient space outgrows int32 (batches of many ~40-min tracks).
    idx_dt = np.int32 if bpad * f_max * 1024 < 2**31 else np.int64

    fb_rows = []
    fb_exps = []
    esc_idxs = []
    esc_vals = []
    for i, u in enumerate(unpacked):
        n = (u.n // n_channels) * n_channels
        a = u.qspec[:n, :ext]
        big = (a > 7) | (a < -7)  # not np.abs: abs(int8 -128) overflows
        if big.any():
            r2, p2 = np.nonzero(big)
            esc_idxs.append(((r2 + i * f_max).astype(idx_dt) << 10)
                            | p2.astype(idx_dt))
            esc_vals.append(a[r2, p2].astype(np.int16))
            a = np.where(big, np.int8(0), a)
        # Two's-complement nibble pack: low nibble = even coefficient.
        spec_q4[i, :n] = (a[:, 0::2] & np.int8(15)) | (a[:, 1::2] << 4)
        spec_q4[i, n:] = 0
        # lvl (sf / PNS energy / intensity position) fits 12 bits with
        # a +2048 bias (values beyond ±2048 overflow exp2 in f32 anyway
        # — only reachable through corrupt streams, hence the clip);
        # btype (0..4) in bits 12-14, ms_used in bit 15.
        meta[i, :n] = (
            (np.clip(u.lvl[:n, :nbands], -2048, 2047).astype(np.int32)
             + 2048)
            | (u.btype[:n, :nbands].astype(np.int32) << 12)
            | (u.msf[:n, :nbands].astype(np.int32) << 15)
        ).astype(np.uint16)
        wseq[i, :n] = u.info[:n, af.WINDOW_SEQ].astype(np.uint8)
        wshape[i, :n] = u.info[:n, af.WINDOW_SHAPE].astype(np.uint8)
        valid[i] = (n // n_channels) * 1024
        if len(u.esc_idx):
            row = u.esc_idx >> 10
            keep = row < n
            # Escape positions always lie inside a coded band, and ext
            # covers every coded band in the batch, so pos < ext.
            esc_idxs.append(((row[keep] + i * f_max).astype(idx_dt) << 10)
                            | (u.esc_idx & 1023)[keep].astype(idx_dt))
            esc_vals.append(u.esc_val[keep])
        for j, row in enumerate(u.fbrows):
            if row >= n:
                continue
            fbmap[i * f_max + int(row)] = bpad * f_max + len(fb_rows)
            fb_rows.append(u.fb16[j])
            fb_exps.append(u.fbexp[j])
    spec_q4[bsz:] = 0

    n_esc = sum(len(e) for e in esc_idxs)
    ecap = next((e for e in _ESC_LADDER if e >= max(n_esc, 1)),
                max(n_esc, 1))
    if force_ecap is not None:
        assert force_ecap >= n_esc
        ecap = force_ecap
    esc_idx = np.zeros(ecap, idx_dt)  # padding adds 0 at index 0
    esc_val = np.zeros(ecap, np.int16)
    if n_esc:
        esc_idx[:n_esc] = np.concatenate(esc_idxs)
        esc_val[:n_esc] = np.concatenate(esc_vals)

    fbp = next((f for f in _FB_LADDER if f >= max(len(fb_rows), 1)),
               max(len(fb_rows), 1))
    if force_fbp is not None:
        assert force_fbp >= len(fb_rows)
        fbp = force_fbp
    fb16 = np.zeros((fbp, 1024), np.uint16)
    fbexp = np.zeros(fbp, np.int8)
    if fb_rows:
        fb16[: len(fb_rows)] = np.stack(fb_rows)
        fbexp[: len(fb_rows)] = np.array(fb_exps, np.int8)
    return (spec_q4, meta, esc_idx, esc_val,
            fb16.view(np.float16), fbexp, fbmap, wseq, wshape, valid)


def prepare_batch_arrays_aac_q_sharded(unpacked: list, n_channels: int,
                                       n_shards: int):
    """Round-robin shard AAC tracks and prepare every shard with
    IDENTICAL static shapes, ready to stack on a leading device axis
    for shard_map dispatch (mirrors parallel.runner.
    prepare_batch_arrays_light_sharded). Returns (args tuple of
    (D, ...) arrays, shard_index)."""
    order = sorted(range(len(unpacked)), key=lambda i: unpacked[i].n,
                   reverse=True)
    shard_index = [order[d::n_shards] for d in range(n_shards)]
    assert all(shard_index), "need at least one track per shard"
    shards = [[unpacked[i] for i in idxs] for idxs in shard_index]

    first = [prepare_batch_arrays_aac_q(s, n_channels) for s in shards]
    # args layout: spec_q4, meta, esc_idx, esc_val, fb16, fbexp, fbmap,
    # wseq, wshape, valid
    bpad = max(r[0].shape[0] for r in first)
    f_max = max(r[0].shape[1] for r in first)
    ext = max(r[0].shape[2] * 2 for r in first)
    ecap = max(r[2].shape[0] for r in first)
    fbp = max(r[4].shape[0] for r in first)
    shapes = (bpad, f_max, ext, ecap, fbp)
    results = []
    for s, r in zip(shards, first):
        if (r[0].shape != (bpad, f_max, ext // 2)
                or r[2].shape[0] != ecap or r[4].shape[0] != fbp):
            r = prepare_batch_arrays_aac_q(s, n_channels,
                                           force_shapes=shapes)
        results.append(r)
    args = tuple(np.stack([r[j] for r in results])
                 for j in range(len(results[0])))
    return args, shard_index


def analyze_batch_q_sharded(unpacked: list, sample_rate: int,
                            n_channels: int, mesh=None, dtype=jnp.float32):
    """Device-requant AAC batch analysis over a data-parallel device
    mesh: each device runs the full spectral-prep + IMDCT + DSP pipeline
    on its shard via shard_map (the MP3 light path's
    dispatch_light_sharded pattern). Falls back to the single-device
    path when the mesh has one device or fewer tracks than devices."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if mesh is None:
        devices = np.array(backend.local_devices())
        mesh = Mesh(devices, axis_names=("dp",))
    n_dev = int(np.prod(mesh.devices.shape))
    if n_dev == 1 or len(unpacked) < n_dev:
        return analyze_batch_q(unpacked, sample_rate, n_channels,
                               dtype=dtype)

    bsz = len(unpacked)
    args, shard_index = prepare_batch_arrays_aac_q_sharded(
        unpacked, n_channels, n_dev
    )
    sharding = NamedSharding(mesh, P("dp"))
    dev_args = [jax.device_put(a, sharding) for a in args]
    run = _batch_fn_q_sharded(mesh, n_channels, sample_rate, dtype)
    hist, loud_idx, peak = run(*dev_args)  # (D, B, ...)

    d_idx = np.empty(bsz, np.int32)
    j_idx = np.empty(bsz, np.int32)
    for d, idxs in enumerate(shard_index):
        for j, i in enumerate(idxs):
            d_idx[i] = d
            j_idx[i] = j
    hist = hist[d_idx, j_idx]
    loud_idx = loud_idx[d_idx, j_idx]
    peak = peak[d_idx, j_idx]
    stats = np.asarray(
        jnp.concatenate(
            [loud_idx.astype(jnp.float32), peak.astype(jnp.float32)]
        )
    )
    louds = np.array([hi.index_to_loudness(i) for i in stats[:bsz]])
    return hist, louds, stats[bsz:]


@lru_cache(maxsize=None)
def _batch_fn_q_sharded(mesh, n_channels: int, sample_rate: int, dtype):
    from jax.sharding import PartitionSpec as P

    from .decode import aac_prep

    def core(*a):
        spec = aac_prep.prep_spectra(
            *a[:7], sample_rate=sample_rate, n_channels=n_channels,
            dtype=dtype,
        )
        return _analysis_tail(
            spec, a[7].astype(jnp.int32), a[8].astype(jnp.int32), a[9],
            n_channels=n_channels, sample_rate=sample_rate, dtype=dtype,
        )

    spec = P("dp")

    @jax.jit
    def run(*args):
        def shard(*a):
            h, li, pk = core(*(x[0] for x in a))
            return h[None], li[None], pk[None]

        return jax.shard_map(
            shard, mesh=mesh,
            in_specs=tuple(spec for _ in args),
            out_specs=(spec, spec, spec),
            check_vma=False,
        )(*args)

    return run


def analyze_batch_q(unpacked: list, sample_rate: int, n_channels: int,
                    dtype=jnp.float32):
    """Device-requant batch analysis (spectral prep on device)."""
    import os as _os
    import time as _time

    from .utils import bufpool

    scan_time = bool(_os.environ.get("MP3RGAIN_SCAN_TIME"))
    t0 = _time.monotonic()
    bsz = len(unpacked)
    args = prepare_batch_arrays_aac_q(unpacked, n_channels)
    t1 = _time.monotonic()
    fn = _batch_fn_q(n_channels, sample_rate, dtype)
    dev_args = jax.device_put(args)
    jax.block_until_ready(dev_args)
    bufpool.give(*args[:2], args[6], args[7], args[8])
    t2 = _time.monotonic()
    hist, loud_idx, peak = fn(*dev_args)
    stats = np.asarray(
        jnp.concatenate(
            [loud_idx[:bsz].astype(jnp.float32),
             peak[:bsz].astype(jnp.float32)]
        )
    )
    if scan_time:
        import sys as _sys

        nbytes = sum(a.nbytes for a in args)
        print(
            f"aac analyze_batch_q: n={bsz} prepare={t1 - t0:.2f}s "
            f"h2d={t2 - t1:.2f}s ({nbytes / 1e6:.0f} MB) "
            f"compute+stats={_time.monotonic() - t2:.2f}s",
            file=_sys.stderr, flush=True,
        )
    louds = np.array([hi.index_to_loudness(i) for i in stats[:bsz]])
    return hist[:bsz], louds, stats[bsz:]


def analyze_batch(unpacked: list, sample_rate: int, n_channels: int,
                  dtype=jnp.float32):
    """Analyze same-format AAC tracks in one device dispatch.

    Returns (hist (B, 12000) device, louds (B,) np, peaks (B,) np)."""
    import os as _os
    import time as _time

    from .utils import bufpool

    scan_time = bool(_os.environ.get("MP3RGAIN_SCAN_TIME"))
    t0 = _time.monotonic()
    bsz = len(unpacked)
    args = prepare_batch_arrays_aac(unpacked, n_channels)
    t1 = _time.monotonic()
    fn = _batch_fn(n_channels, sample_rate, dtype)
    dev_args = jax.device_put(args)
    # Pooled host buffers go back once the transfer has committed.
    jax.block_until_ready(dev_args)
    bufpool.give(*args[:4])
    t2 = _time.monotonic()
    hist, loud_idx, peak = fn(*dev_args)
    stats = np.asarray(
        jnp.concatenate(
            [loud_idx[:bsz].astype(jnp.float32), peak[:bsz].astype(jnp.float32)]
        )
    )
    if scan_time:
        import sys as _sys

        print(
            f"aac analyze_batch: n={bsz} prepare={t1 - t0:.2f}s "
            f"h2d={t2 - t1:.2f}s compute+stats={_time.monotonic() - t2:.2f}s",
            file=_sys.stderr, flush=True,
        )
    louds = np.array([hi.index_to_loudness(i) for i in stats[:bsz]])
    return hist[:bsz], louds, stats[bsz:]


def _analyze_on_device(path, dtype, track_index=None):
    if use_device_prep():
        u = af.unpack_file_q(path, track_index=track_index)
        batch = analyze_batch_q
    else:
        u = af.unpack_file(path, track_index=track_index, f16=True)
        batch = analyze_batch
    if u.n == 0:
        raise AacError("No decodable AAC frames found")
    nch = u.n_channels or 1
    sr = u.sample_rate
    hist, louds, peaks = batch([u], sr, nch, dtype=dtype)
    n = (u.n // nch) * nch
    audio_seconds = (n // nch) * 1024 / sr if sr else 0.0
    return hist[0], float(louds[0]), float(peaks[0]), sr, audio_seconds


def analyze_track_internal(path, dtype=jnp.float32, track_index=None):
    from .analysis import TrackAnalysisInternal

    hist, loudness_db, peak, sr, audio_seconds = _analyze_on_device(
        path, dtype, track_index
    )
    result = ReplayGainResult(
        loudness_db=loudness_db,
        gain_db=PINK_REF - loudness_db,
        peak=peak,
        sample_rate=sr,
        file_type="aac",
    )
    return TrackAnalysisInternal(result, hist, audio_seconds=audio_seconds)


def find_peak_amplitude(path, dtype=jnp.float32) -> PeakAmplitudeResult:
    _, _, peak, sr, _ = _analyze_on_device(path, dtype)
    return PeakAmplitudeResult(
        peak=peak, peak_pcm=peak * SAMPLE_SCALE_16BIT, sample_rate=sr
    )


def decode_file(path, dtype=jnp.float32):
    return aac_synthesis.decode_file(path, dtype)
