"""Stage and path timings of the MP3 analysis on a GPU.

Measures on the card (refuses to run elsewhere), with the card's name and
power limit printed first:
  1. end to end: analyze_library on the raw-bits path (Triton entropy
     kernel + XLA tail) against the host-decoded path (fe.unpack_file +
     the same XLA tail), steady state, in turns raw, host, host, raw —
     on a 64 x 60 s 44.1 kHz stereo batch and on a 12 x 240 s album;
  2. the raw-bits stages on the 64 x 60 s batch: entropy kernel alone,
     then the analysis tail;
  3. the XLA requantize -> stereo span on that batch, isolated (inputs
     resident, output written), against its HBM roofline (3.35 TB/s,
     H100 SXM data sheet);
  4. the tail at DSP matmul precisions TF32, three bf16 passes and
     float32 ("highest");
  5. a profiler trace of steady raw-bits batches: device time by kernel
     and the device's busy share.
Writes chiprun_out/stage_times.json.

Run: python tools/stage_times.py [--seed N] [--reps N]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def _median_time(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.monotonic()
        jax.block_until_ready(fn())
        ts.append(time.monotonic() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def end_to_end(paths, reps):
    from mp3rgain_tpu.parallel import runner as rn

    runner = rn.MeshRunner()
    out = {True: [], False: []}
    audio = 0.0
    for de in (True, False):  # cold: compiles
        rn.analyze_library(paths, runner=runner, device_entropy=de)
    for _ in range(reps):
        for de in (True, False, False, True):
            t0 = time.monotonic()
            res = rn.analyze_library(paths, runner=runner, device_entropy=de)
            out[de].append(time.monotonic() - t0)
            audio = res.audio_seconds
    return {
        "audio_seconds": audio,
        "raw_bits_s": sorted(out[True]),
        "host_decoded_s": sorted(out[False]),
        "raw_bits_x": audio / min(out[True]),
        "host_decoded_x": audio / min(out[False]),
    }


def stages(paths, reps):
    import jax
    import numpy as np

    from mp3rgain_tpu.decode import entropy_kernel as ek
    from mp3rgain_tpu.decode import frontend as fe
    from mp3rgain_tpu.decode import synthesis
    from mp3rgain_tpu.decode.format_tables import SR_ROW
    from mp3rgain_tpu.parallel import runner as rn

    ups = []
    for p in paths:
        with open(p, "rb") as f:
            ups.append(fe.unpack_data_light_packed(f.read()))
    sr, nch = ups[0].sample_rate, ups[0].n_channels
    prep, rest, g_max = rn.prepare_batch_arrays_light(ups, nch)
    dev1 = jax.device_put(prep.device_args())
    dev2 = jax.device_put(rest)
    tail = rn._light_tail_pipeline(nch, sr, g_max, np.float32)

    def entropy():
        return ek.decode_blocks(*dev1, nb=prep.nb, lanes=prep.lanes)

    spec, ends = entropy()
    t_entropy = _median_time(entropy, reps)
    t_tail = _median_time(lambda: tail(spec, ends, *dev2), reps)

    @jax.jit
    def fields_of(spec, ends, counts, scf, srow, sdata, hrow, hdata, info,
                  valid):
        npad = spec.shape[0]
        rowmap = rn._rowmap_from_counts(counts, g_max, npad)
        scf = rn._expand_scf_flat(scf, srow, sdata, hrow, hdata)[rowmap]
        info = jax.numpy.concatenate(
            [info.astype(np.int32), np.zeros((1, fe.IP_N), np.int32)]
        )[rowmap]
        spec = jax.numpy.concatenate([spec, np.zeros((1, 576), spec.dtype)])
        ends = jax.numpy.concatenate([ends, np.zeros((1, 4), ends.dtype)])
        info = rn._expand_info_light(info)
        info = info.at[..., fe.BIG_END].set(ends[rowmap, 0])
        info = info.at[..., fe.COUNT1_END].set(ends[rowmap, 1])
        return rn._derive_fields(spec[rowmap], scf, info.astype(np.int32),
                                 n_channels=nch)

    fields = jax.block_until_ready(fields_of(spec, ends, *dev2))
    rt = synthesis.row_tables(SR_ROW[sr])

    @jax.jit
    def span(fields):
        def one(a):
            b = synthesis.GranuleBatch(*a, n_channels=nch)
            masks = synthesis._class_masks(b.kind)
            xr = synthesis._requantize(b, rt, masks, np.float32)
            return synthesis._stereo(b, xr, rt, masks, np.float32)

        return jax.vmap(one)(fields)

    xr = span(fields)
    t_span = _median_time(lambda: span(fields), reps)
    span_bytes = sum(int(a.nbytes) for a in fields) + int(xr.nbytes)
    roof = span_bytes / HBM_BYTES_PER_S
    audio = sum((u.n // nch) * 576 / sr for u in ups)
    return {
        "granule_channels": int(prep.n),
        "h2d_bytes": int(sum(a.nbytes for a in prep.device_args())
                         + sum(a.nbytes for a in rest)),
        "entropy_kernel_s": t_entropy,
        "tail_s": t_tail,
        "device_x": audio / (t_entropy + t_tail),
        "requant_span_s": t_span,
        "requant_span_bytes": span_bytes,
        "requant_span_roofline_s": roof,
        "requant_span_x_roofline": t_span / roof,
    }, (spec, ends, dev2, tail, nch, sr, g_max)


def precision_cost(state, reps):
    """The tail at the DSP matmul precisions tried on the card."""
    import jax
    import numpy as np

    from mp3rgain_tpu import backend
    from mp3rgain_tpu.parallel import runner as rn

    spec, ends, dev2, _, nch, sr, g_max = state
    out = {}
    shipped = backend.GPU_DSP_PRECISION
    try:
        for prec in ("tensorfloat32", "BF16_BF16_F32_X3", "highest"):
            backend.GPU_DSP_PRECISION = prec
            jax.clear_caches()
            rn._light_tail_pipeline.cache_clear()
            tail = rn._light_tail_pipeline(nch, sr, g_max, np.float32)
            out[prec] = _median_time(lambda: tail(spec, ends, *dev2), reps)
    finally:
        backend.GPU_DSP_PRECISION = shipped
        jax.clear_caches()
        rn._light_tail_pipeline.cache_clear()
    return out


def trace(state, outdir):
    """Device time by kernel over two steady tail runs, and busy share."""
    import jax

    spec, ends, dev2, tail, *_ = state
    jax.block_until_ready(tail(spec, ends, *dev2))
    t0 = time.monotonic()
    with jax.profiler.trace(outdir):
        for _ in range(2):
            jax.block_until_ready(tail(spec, ends, *dev2))
    window = time.monotonic() - t0
    path = sorted(glob.glob(os.path.join(outdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    by_name, spans = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            for ev in line.events:
                by_name[ev.name] = by_name.get(ev.name, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "window_s": window,
        "device_busy_s": busy / 1e9,
        "top_kernels_ms": [(n[:80], d / 1e6) for n, d in top],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        sys.exit("stage_times: needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card, f"host cores {os.cpu_count()}", flush=True)

    from mp3rgain_tpu.testing import corpus

    rng = np.random.default_rng(args.seed)
    work = tempfile.mkdtemp(prefix="stage_times_")

    def write(name, built):
        path = os.path.join(work, name)
        with open(path, "wb") as f:
            f.write(built[0])
        return path

    batch = [write(f"b{i:02d}.mp3", corpus.build_mp3("mp3_44k_cbr192", 60, rng))
             for i in range(64)]
    album = [write(f"a{i:02d}.mp3", corpus.build_mp3(
        corpus.ALBUM_CLIPS[i % 3], 240, rng)) for i in range(12)]

    report = {"card": card, "host_cores": os.cpu_count()}
    for name, paths in (("batch_64x60s", batch), ("album_12x240s", album)):
        report[f"e2e_{name}"] = end_to_end(paths, max(1, args.reps // 2))
        print(name, json.dumps(report[f"e2e_{name}"]), flush=True)
    st, state = stages(batch, args.reps)
    report["stages_64x60s"] = st
    print("stages", json.dumps(st), flush=True)
    report["tail_precision_s"] = precision_cost(state, args.reps)
    print("precision", json.dumps(report["tail_precision_s"]), flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    report["trace"] = trace(state, os.path.join(out, "trace_stage_times"))
    print("trace", json.dumps(report["trace"]), flush=True)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "stage_times.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
