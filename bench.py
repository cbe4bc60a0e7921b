"""Benchmark: ReplayGain analysis throughput on a GPU.

Prints ONE JSON line:
  {"metric": "replaygain_analysis_throughput", "value": <audio-hours/sec>,
   "unit": "audio-hours/sec", ...}

Headline (`value`): the END-TO-END PIPELINED bound — audio_seconds /
max(host walk+pack, h2d transfer, device compute) — of one 64 x 60 s
44.1 kHz stereo batch on the raw-bits path. It is arithmetic over
stage times, not a measured overlap; `scan_steady_x` is the measured
analyze_library rate. The JSON also carries:
  mp3_device_x       device rate of the raw-bits pipeline (Pallas
                     entropy decode -> synthesis -> IIR -> histogram)
  mp3_e2e_serial_x   audio / (host + h2d + device), no overlap credited
  scan_steady_x      median of measured analyze_library passes
  aac_*              the same for the M4A device-prep pipeline
  host_cores         cores available to the host stages
Tracks come from the committed clips (mp3rgain_tpu/testing/corpus.py).
A run that finds no GPU fails.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

TRACK_SECONDS = int(os.environ.get("BENCH_TRACK_SECONDS", 60))
BATCH_TRACKS = int(os.environ.get("BENCH_BATCH_TRACKS", 64))
ITERS = 8


def _timed(fn):
    t0 = time.monotonic()
    fn()
    return time.monotonic() - t0


def _device_time(fn, args) -> float:
    """Mean wall time of fn(*args) over ITERS runs after one warm-up,
    each ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.monotonic()
    for _ in range(ITERS):
        jax.block_until_ready(fn(*args))
    return (time.monotonic() - t0) / ITERS


def _h2d(args) -> float:
    """Steady host->device time of a payload (best of the warm puts)."""
    import jax

    samples = []
    for _ in range(3):
        t0 = time.monotonic()
        jax.block_until_ready(jax.device_put(args))
        samples.append(time.monotonic() - t0)
    return min(samples[1:])


def main() -> None:
    from functools import partial

    import jax
    import jax.numpy as jnp

    from mp3rgain_tpu.decode import frontend as fe
    from mp3rgain_tpu.parallel.runner import (
        _analysis_core_light,
        prepare_batch_arrays_light,
    )
    from mp3rgain_tpu.testing import corpus
    from mp3rgain_tpu.utils import bufpool

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform}")
    print(f"bench device: {dev.platform} {dev.device_kind}",
          file=sys.stderr, flush=True)

    data, _ = corpus.build_mp3("mp3_44k_cbr192", TRACK_SECONDS,
                               np.random.default_rng(7))
    full_dt = min(_timed(lambda: fe.unpack_data(data)) for _ in range(3))
    light_dt = min(
        _timed(lambda: fe.unpack_data_light_packed(data)) for _ in range(3)
    )
    u_light = fe.unpack_data_light_packed(data)
    sr, nch = u_light.sample_rate, u_light.n_channels
    audio_sec_per_track = (u_light.n // nch) * 576 / sr
    print(
        f"host full unpack: {audio_sec_per_track / full_dt:.0f}x real-time/core; "
        f"light walk: {audio_sec_per_track / light_dt:.0f}x real-time/core",
        file=sys.stderr, flush=True,
    )
    audio_seconds = audio_sec_per_track * BATCH_TRACKS

    # Batch pack: the buffers are pooled (utils/bufpool), so the warm
    # rounds are what a long scan pays per batch.
    prep_dt = None
    for i in range(4):
        t0 = time.monotonic()
        prep, rest, g_max = prepare_batch_arrays_light(
            [u_light] * BATCH_TRACKS, nch, 1
        )
        dt = time.monotonic() - t0
        prep_dt = dt if prep_dt is None else min(prep_dt, dt)
        if i < 3:
            bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
    args = prep.device_args() + rest
    h2d_dt = _h2d(args)
    nbytes = sum(a.nbytes for a in args)
    print(f"host pack: {prep_dt:.2f}s; h2d raw-bits manifest: "
          f"{nbytes / 1e6:.0f} MB in {h2d_dt:.3f}s",
          file=sys.stderr, flush=True)

    fn = jax.jit(partial(
        _analysis_core_light, nb=prep.nb, lanes=prep.lanes, g_max=g_max,
        n_channels=nch, sample_rate=sr, dtype=jnp.float32,
    ))
    wall = _device_time(fn, jax.device_put(args))
    host_share = light_dt * BATCH_TRACKS + prep_dt
    rtf = audio_seconds / wall
    e2e = audio_seconds / (wall + h2d_dt + host_share)
    bottleneck = max(wall, h2d_dt, host_share)
    print(
        f"device pipeline: {BATCH_TRACKS} tracks x {audio_sec_per_track:.1f}s "
        f"in {wall * 1000:.1f}ms -> {rtf:.0f}x real-time; serial {e2e:.0f}x; "
        f"max of stages (host {host_share:.2f}s, h2d {h2d_dt:.2f}s, "
        f"device {wall:.3f}s) {audio_seconds / bottleneck:.0f}x",
        file=sys.stderr, flush=True,
    )
    record = {
        "metric": "replaygain_analysis_throughput",
        "value": round(audio_seconds / bottleneck / 3600.0, 4),
        "unit": "audio-hours/sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "mp3_device_x": round(rtf, 1),
        "mp3_e2e_serial_x": round(e2e, 1),
        "mp3_e2e_pipelined_x": round(audio_seconds / bottleneck, 1),
        "host_cores": os.cpu_count(),
    }
    record.update(_bench_aac())
    if not os.environ.get("BENCH_SKIP_SCAN"):
        record.update(_bench_scan())
    print(json.dumps(record))


def _bench_scan(tracks: int = 128, passes: int = 3) -> dict:
    """Measured library-scan throughput: analyze_library over an on-disk
    corpus of mixed-length 44.1 kHz stereo tracks (one batch bucket), one
    warm-up pass (pays the compiles) + `passes` timed passes; reports
    the per-pass rates and their median."""
    from mp3rgain_tpu.parallel.runner import MeshRunner, analyze_library
    from mp3rgain_tpu.testing import corpus

    work = tempfile.mkdtemp(prefix="bench_scan_")
    paths = []
    for i in range(tracks):
        p = os.path.join(work, f"t{i:03d}.mp3")
        data, _ = corpus.build_mp3("mp3_44k_vbr", 38 + (i % 4) * 3,
                                   np.random.default_rng(1000 + i))
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)

    runner = MeshRunner()
    rates = []
    for i in range(passes + 1):
        res = analyze_library(paths, runner=runner)
        bad = [t for t in res.tracks if not t.ok]
        assert not bad, [t.error for t in bad]
        label = "warmup" if i == 0 else f"pass {i}"
        print(f"scan {label}: {res.audio_seconds:.0f}s audio in "
              f"{res.wall_seconds:.2f}s = {res.realtime_factor:.0f}x",
              file=sys.stderr, flush=True)
        if i > 0:
            rates.append(round(res.realtime_factor, 1))
    return {
        "scan_steady_x": sorted(rates)[len(rates) // 2],
        "scan_passes_x": rates,
        "scan_tracks": len(paths),
    }


def _bench_aac(tracks: int = 16, seconds: int = 60) -> dict:
    """AAC (BASELINE config 4): host quantized unpack, h2d, and the
    device-prep pipeline (decode/aac_prep.py) on one batch."""
    import jax
    import jax.numpy as jnp

    from mp3rgain_tpu import aac
    from mp3rgain_tpu.decode import aac_frontend as af
    from mp3rgain_tpu.testing import corpus

    m4a, _ = corpus.build_m4a("aac_44k", seconds, np.random.default_rng(11))
    adts = af.mp4_to_adts(m4a)
    host_dt = min(_timed(lambda: af.unpack_adts_q(adts)) for _ in range(3))
    u = af.unpack_adts_q(adts)
    sr, nch = u.sample_rate, u.n_channels or 2
    track_sec = ((u.n // nch) * 1024) / sr
    args = aac.prepare_batch_arrays_aac_q([u] * tracks, nch)
    h2d_dt = _h2d(args)
    wall = _device_time(aac._batch_fn_q(nch, sr, jnp.float32),
                        jax.device_put(args))
    audio_seconds = track_sec * tracks
    host_share = host_dt * tracks
    device_x = audio_seconds / wall
    e2e = audio_seconds / (wall + h2d_dt + host_share)
    pipe = audio_seconds / max(wall, h2d_dt, host_share)
    print(
        f"aac device pipeline: {tracks} tracks x {track_sec:.1f}s in "
        f"{wall * 1000:.1f}ms -> {device_x:.0f}x; e2e serial {e2e:.0f}x, "
        f"max of stages {pipe:.0f}x (host {host_share:.2f}s, h2d "
        f"{h2d_dt:.3f}s, device {wall:.3f}s)",
        file=sys.stderr, flush=True,
    )
    return {
        "aac_device_x": round(device_x, 1),
        "aac_e2e_serial_x": round(e2e, 1),
        "aac_e2e_pipelined_x": round(pipe, 1),
        "aac_host_frontend_x": round(track_sec / host_dt, 1),
    }


if __name__ == "__main__":
    main()
