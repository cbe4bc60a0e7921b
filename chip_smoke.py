#!/usr/bin/env python3
"""Smoke test of the ReplayGain scan on one GPU (or four: --four-cards).

Drives the main path through the entry points users call, on a corpus
generated from a seed (mp3rgain_tpu/testing/corpus.py, built from
committed clips), and holds it to the same files run on the CPU backend
in the same process at matmul precision "highest" — the path the tier-1
tests hold to the float64 reference.

Phases (one card, the default):
  (a) device: the platform must be "gpu" (no CPU fallback); prints the
      card's name and power limit, the host core count and the compile
      cache directory;
  (b) corpus: a beets album (12 x 240 s, 44.1 kHz stereo, CBR + VBR), a
      library slice (64 x 60 s over MPEG-1/2/2.5 rates, mono and stereo,
      short-block-heavy content, plus a 60-minute 22.05 kHz mono
      podcast) and 9 M4A files (44.1/48 kHz, one 96 kHz);
  (c) album: cli.main(["-o", "-s", "s", "-k", "-d", "0", *album]), then
      the same with -a (album gain applied to the files);
  (d) library: scan.scan_files with a manifest, again without it
      (steady), then a resume from the manifest; M4A through _scan_aac;
  (e) the entropy kernel's integer spectra equal the host decoder's on
      every smoke MP3 (exact);
  (f) precision: the one-hot reorder/expansion stages are exact at
      spectrum magnitude 8206; prints what matmul precision HIGH lowers
      to;
  (g) every track gain and album gain within +-0.05 dB of the CPU run;
      peaks within 1% (relative) — a peak only feeds clipping
      prevention (-k), which moves gain in 1.5 dB steps; the gain edits
      -a writes are byte-identical;
  (h) set-up (compile) and steady time per phase, audio-seconds per
      second, peak device memory.

--four-cards runs only the data-parallel path on a 1-D "dp" mesh of 4
GPUs (dispatch_light_sharded, sharded dispatch_heavy, the psum/pmax
album reduction, the sharded AAC batch) against a 1-device mesh in the
same process.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or outside a checkout of the repository, the script exits
non-zero and prints no result.

Run: python chip_smoke.py [--four-cards] [--seed N] [--keep DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

GAIN_TOL_DB = 0.05
PEAK_TOL_REL = 0.01
SPECTRUM_MAX = 8206  # 15 + (2**13 - 1) linbits: the largest |value|


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Helpers (tested on the CPU: tests/test_chip_smoke.py).
# ---------------------------------------------------------------------------


def parse_tsv(text: str) -> dict:
    """mp3gain-style TSV (-o) -> {file name: (dB gain, max amplitude)}."""
    out = {}
    for line in text.splitlines():
        cols = line.split("\t")
        if len(cols) < 4 or cols[0] in ("File", '"Album"', "Album"):
            continue
        out[cols[0]] = (float(cols[2]), float(cols[3]))
    return out


def compare(name: str, got: dict, ref: dict, tol_db=GAIN_TOL_DB,
            peak_rel=PEAK_TOL_REL, ref_name: str = "CPU run") -> dict:
    """Compare {key: (gain_db, peak)} maps; raises on any miss.

    Returns the worst gain and peak deviations."""
    check(set(got) == set(ref),
          f"{name}: track sets differ: {sorted(set(got) ^ set(ref))[:5]}")
    worst_g = worst_p = 0.0
    for k in ref:
        g, p = got[k]
        rg, rp = ref[k]
        dg = abs(g - rg)
        dp = abs(p - rp) / max(abs(rp), 1e-12)
        check(dg <= tol_db,
              f"{name}: {k}: gain {g:.4f} vs {rg:.4f} dB (> {tol_db})")
        check(dp <= peak_rel,
              f"{name}: {k}: peak {p:.6g} vs {rp:.6g} (> {peak_rel:.0%})")
        worst_g, worst_p = max(worst_g, dg), max(worst_p, dp)
    log(f"  {name}: {len(ref)} tracks within +-{tol_db} dB of the {ref_name} "
        f"(worst {worst_g:.4f} dB; peaks worst {worst_p:.2e} rel)")
    return {"gain_db": worst_g, "peak_rel": worst_p}


def scan_gains(result) -> dict:
    """scan.ScanResult -> {path: (gain_db, peak)}; failed tracks raise."""
    out = {}
    for path, res in result.results.items():
        check(not isinstance(res, Exception), f"{path}: {res}")
        out[os.path.basename(path)] = (res.gain_db, res.peak)
    return out


def run_cli(argv) -> str:
    """cli.main in-process; returns its standard output."""
    from mp3rgain_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    check(rc == 0, f"cli.main({argv[:6]}...) exited {rc}")
    return buf.getvalue()


def album_json(text: str) -> tuple[dict, float]:
    """`-o json -a` output -> ({file: (gain from loudness, peak)}, album
    gain)."""
    from mp3rgain_tpu.replaygain import PINK_REF

    doc = json.loads(text)
    tracks = {os.path.basename(f["file"]): (PINK_REF - f["loudness_db"],
                                            f["peak"]) for f in doc["files"]}
    return tracks, float(doc["album"]["gain_db"])


class Timer:
    """Per-phase wall times (host clock around work that ends in a
    device sync)."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.monotonic()
        yield
        self.times[name] = time.monotonic() - t0
        log(f"  [{name}] {self.times[name]:.2f} s")


@contextlib.contextmanager
def on_cpu():
    """Route this process's JAX work to the CPU backend at precision
    "highest" (global config: the scan's uploader threads see it too)."""
    import jax

    old_dev = jax.config.jax_default_device
    old_prec = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        yield
    finally:
        jax.config.update("jax_default_device", old_dev)
        jax.config.update("jax_default_matmul_precision", old_prec)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        sys.exit(2)
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs; JAX found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()
    for line in smi:
        log(line)
    from mp3rgain_tpu.utils import jaxcache

    log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}; "
        f"host cores {os.cpu_count()}; compile cache {jaxcache.cache_dir()}")
    return devs


def phase_precision():
    """(f): exactness of the selection stages at |x| = 8206, and what
    matmul precision HIGH lowers to on this card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mp3rgain_tpu import backend
    from mp3rgain_tpu.decode import synthesis
    from mp3rgain_tpu.decode.tables import row_tables

    rng = np.random.default_rng(0)
    g = 4096
    x = rng.integers(-SPECTRUM_MAX, SPECTRUM_MAX + 1, (g, 576))
    x[:, :8] = [SPECTRUM_MAX, -SPECTRUM_MAX, 8191, -8191, 2049, -2049, 1, 0]
    x = x.astype(np.float32)
    scf = rng.integers(0, 32, (g, 64)).astype(np.float32)
    rt = row_tables(0)
    masks = [jnp.full((g, 1), c == 1) for c in range(3)]  # short class
    with jax.default_matmul_precision(backend.dsp_precision()):
        got = np.asarray(jax.jit(
            lambda v: synthesis._reorder(v, masks, rt, jnp.float32))(x))
        got_s = np.asarray(jax.jit(
            lambda v: synthesis._expand(v, rt.slot, masks))(scf))
    check(np.array_equal(got, x[:, rt.perm_short]),
          "short-block reorder is not exact on the card")
    check(np.array_equal(got_s, scf[:, rt.slot[1]]),
          "scalefactor expansion is not exact on the card")
    log(f"  reorder and expansion exact at |x| <= {SPECTRUM_MAX}")

    # What "high" lowers to: the compiled HLO's dot, and its rounding of
    # the same integers through a one-hot matmul.
    perm = np.eye(576, dtype=np.float32)[rt.perm_short]
    report = {}
    for prec in ("default", "high", "highest"):
        f = jax.jit(lambda a, b: jnp.dot(a, b, precision=prec))
        hlo = f.lower(x, perm.T).compile().as_text()
        line = next((ln.strip() for ln in hlo.splitlines()
                     if "__cublas$gemm" in ln or " dot(" in ln), "")
        cfg = {}
        for key in ("custom_call_target", "algorithm", "operand_precision",
                    "precision_config"):
            i = line.find(key)
            if i >= 0:
                cfg[key] = line[i: i + 120].split("}")[0]
        err = float(np.abs(np.asarray(f(x, perm.T)) - x[:, rt.perm_short])
                    .max())
        report[prec] = err
        log(f"  matmul precision {prec!r}: max |error| on integers <= "
            f"{SPECTRUM_MAX} = {err:g}; {cfg or line[:160]}")
    return report


def phase_entropy(corpus):
    """(e): device entropy decode == host decoder, exact, every MP3."""
    import numpy as np

    from mp3rgain_tpu.decode import entropy_kernel as ek
    from mp3rgain_tpu.decode import frontend as fe

    lanes = 0
    for group in (corpus.album, corpus.library):
        fulls, lights = [], []
        for p in group:
            with open(p, "rb") as f:
                data = f.read()
            fulls.append(fe.unpack_data(data))
            lights.append(fe.unpack_data_light(data))
        spec, big_end, c1end, _ = ek.decode_spectra(
            [u.md for u in lights], [u.meta for u in lights])
        spec = np.asarray(spec)
        c1end = np.asarray(c1end)
        off = 0
        for p, full in zip(group, fulls):
            rows = slice(off, off + full.n)
            valid = full.info[:, fe.VALID] == 1
            check(np.array_equal(spec[rows][valid], full.spectrum[valid]),
                  f"{os.path.basename(p)}: kernel spectra differ from host")
            check(np.array_equal(c1end[rows][valid],
                                 full.info[valid, fe.COUNT1_END]),
                  f"{os.path.basename(p)}: count1 ends differ from host")
            off += full.n
        lanes += off
    log(f"  kernel spectra equal the host decoder's on "
        f"{len(corpus.album) + len(corpus.library)} files ({lanes} "
        f"granule-channels)")


def one_card(corpus, work, timer):
    import jax

    from mp3rgain_tpu import scan

    album_args = ["-o", "-s", "s", "-k", "-d", "0"]
    aud = {k: corpus.audio_seconds(getattr(corpus, k))
           for k in ("album", "library", "m4a")}
    lib = corpus.library + corpus.m4a
    manifest = os.path.join(work, "manifest.json")

    log("(c) album through cli.main")
    with timer("album cold"):
        tsv = parse_tsv(run_cli(album_args + corpus.album))
    with timer("album steady"):
        tsv2 = parse_tsv(run_cli(album_args + corpus.album))
    check(tsv == tsv2, "album: repeated run gave other gains")
    gpu_copy = os.path.join(work, "album_gpu")
    cpu_copy = os.path.join(work, "album_cpu")
    for d in (gpu_copy, cpu_copy):
        shutil.copytree(os.path.dirname(corpus.album[0]), d,
                        ignore=shutil.ignore_patterns("lib_*", "m4a_*",
                                                      "*.json"))
    names = [os.path.basename(p) for p in corpus.album]
    with timer("album -a"):
        a_tracks, a_gain = album_json(run_cli(
            ["-o", "json", "-s", "s", "-k", "-d", "0", "-a"]
            + [os.path.join(gpu_copy, n) for n in names]))

    log("(d) library scan through scan.scan_files")
    with timer("library cold"):
        cold = scan.scan_files(lib, manifest_path=manifest)
    with timer("library steady"):
        steady = scan.scan_files(lib)
    with timer("library resume"):
        resumed = scan.scan_files(lib, manifest_path=manifest)
    check(resumed.resumed == len(lib),
          f"resume: {resumed.resumed} of {len(lib)} from the manifest")
    lib_gpu = scan_gains(cold)
    check(lib_gpu == scan_gains(steady), "library: steady run differs")
    check(lib_gpu == scan_gains(resumed), "library: resume differs")
    mem = jax.devices()[0].memory_stats() or {}

    log("(e) entropy kernel against the host decoder")
    with timer("entropy check"):
        phase_entropy(corpus)
    log("(f) precision")
    precision = phase_precision()

    log("(g) the same files on the CPU backend, precision highest")
    with on_cpu():
        with timer("cpu album"):
            tsv_cpu = parse_tsv(run_cli(album_args + corpus.album))
            c_tracks, c_gain = album_json(run_cli(
                ["-o", "json", "-s", "s", "-k", "-d", "0", "-a"]
                + [os.path.join(cpu_copy, n) for n in names]))
        with timer("cpu library"):
            lib_cpu = scan_gains(scan.scan_files(lib))
    worst = {
        "album_tsv": compare("album (-o)", tsv, tsv_cpu),
        "album_tracks": compare("album (-a)", a_tracks, c_tracks),
        "library": compare("library + m4a", lib_gpu, lib_cpu),
    }
    check(abs(a_gain - c_gain) <= GAIN_TOL_DB,
          f"album gain {a_gain:.4f} vs CPU {c_gain:.4f} dB")
    log(f"  album gain {a_gain:+.4f} dB vs CPU {c_gain:+.4f} dB")
    for n in names:
        with open(os.path.join(gpu_copy, n), "rb") as f1, \
                open(os.path.join(cpu_copy, n), "rb") as f2:
            check(f1.read() == f2.read(), f"{n}: -a gain edits differ")
    log(f"  -a gain edits byte-identical on {len(names)} files")

    log("(h) report")
    t = timer.times
    report = {
        "audio_seconds": aud,
        "album_setup_s": t["album cold"] - t["album steady"],
        "album_steady_s": t["album steady"],
        "album_x": aud["album"] / t["album steady"],
        "library_setup_s": t["library cold"] - t["library steady"],
        "library_steady_s": t["library steady"],
        "library_x": (aud["library"] + aud["m4a"]) / t["library steady"],
        "resume_s": t["library resume"],
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        "precision_max_err": precision,
        "worst": worst,
    }
    for k, v in report.items():
        log(f"  {k}: {v}")
    return report


def four_cards(corpus, work, timer):
    """Data-parallel path on a 4-GPU dp mesh vs a 1-device mesh."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from mp3rgain_tpu import aac
    from mp3rgain_tpu.decode import aac_frontend as af
    from mp3rgain_tpu.ops import histogram as hi
    from mp3rgain_tpu.parallel import runner as rn
    from mp3rgain_tpu.replaygain import PINK_REF

    devs = jax.devices()[:4]
    mesh4 = Mesh(np.array(devs), ("dp",))
    mesh1 = Mesh(np.array(devs[:1]), ("dp",))
    mp3 = corpus.library + corpus.album

    def gains(res):
        out = {}
        for t in res.tracks:
            check(t.ok, f"{t.path}: {t.error}")
            out[os.path.basename(t.path)] = (t.result.gain_db, t.result.peak)
        return out

    report = {}
    ups = [af.unpack_file_q(p) for p in corpus.m4a]
    by_fmt = {}
    for p, u in zip(corpus.m4a, ups):
        by_fmt.setdefault((u.sample_rate, u.n_channels), []).append((p, u))
    got, ref = {}, {}
    with timer("4 cards m4a"):
        for (sr, nch), items in by_fmt.items():
            us = [u for _, u in items]
            h4, l4, p4 = aac.analyze_batch_q_sharded(us, sr, nch, mesh=mesh4)
            h1, l1, p1 = aac.analyze_batch_q(us, sr, nch)
            # Per-track window counts are exact; bins are held through
            # the gains (see the MP3 album histograms below).
            check(np.array_equal(np.asarray(h4).sum(axis=-1),
                                 np.asarray(h1).sum(axis=-1)),
                  f"aac {sr}: sharded histogram totals differ")
            for (p, _), a, b, c, d in zip(items, l4, p4, l1, p1):
                got[os.path.basename(p)] = (PINK_REF - float(a), float(b))
                ref[os.path.basename(p)] = (PINK_REF - float(c), float(d))
    report["aac"] = compare("m4a sharded", got, ref,
                            ref_name="1-device mesh")

    for de, path in ((True, "light_sharded"), (False, "heavy")):
        r4 = rn.MeshRunner(mesh4)
        with timer(f"4 cards {path} cold"):
            rn.analyze_library(mp3, runner=r4, album=True, device_entropy=de)
        with timer(f"4 cards {path}"):
            res4 = rn.analyze_library(mp3, runner=r4, album=True,
                                      device_entropy=de)
        with timer(f"1 card {path}"):
            res1 = rn.analyze_library(mp3, runner=rn.MeshRunner(mesh1),
                                      album=True, device_entropy=de)
        report[path] = compare(f"mp3 {path}", gains(res4), gains(res1),
                               ref_name="1-device mesh")
        # Window counts are exact; a window whose loudness sits on a bin
        # edge may land one 0.01 dB bin over where the GEMMs run at
        # other shapes, so bins are compared through the album gain.
        h4, h1 = res4.album_histogram, res1.album_histogram
        check(int(h4.sum()) == int(h1.sum()),
              f"{path}: album histogram totals differ")
        g4 = PINK_REF - hi.loudness_from_histogram(h4)
        g1 = PINK_REF - hi.loudness_from_histogram(h1)
        check(abs(g4 - g1) <= GAIN_TOL_DB, f"{path}: album gain {g4} vs {g1}")
        check(abs(res4.album_peak - res1.album_peak)
              <= PEAK_TOL_REL * res1.album_peak, f"{path}: album peak")
        log(f"  {path}: album histogram totals equal ({int(h4.sum())} "
            f"windows, {int((h4 != h1).sum())} bins differ); album gain "
            f"{g4:+.4f} vs {g1:+.4f} dB")

        # The psum/pmax album reduction over NCCL.
        hists = np.stack([np.asarray(t.histogram) for t in res4.tracks])
        peaks = np.array([t.result.peak for t in res4.tracks], np.float32)
        total_h, total_p = r4.album_reduce_device(hists, peaks)
        check(np.array_equal(np.asarray(total_h),
                             hists.sum(axis=0).astype(np.uint32)),
              "psum album histogram differs from the host sum")
        check(total_p == peaks.max(), "pmax album peak differs")
    log("  psum/pmax album reduction equals the host reduction")

    # The album through the CLI: -a over a batch scan, whose default
    # MeshRunner spans all four cards.
    copy = os.path.join(work, "album_4")
    os.makedirs(copy)
    for p in corpus.album:
        shutil.copy(p, copy)
    with timer("4 cards cli -a"):
        tracks4, gain4 = album_json(run_cli(
            ["-o", "json", "--batch", "-s", "s", "-k", "-d", "0", "-a"]
            + [os.path.join(copy, os.path.basename(p))
               for p in corpus.album]))
    res1 = rn.analyze_library(corpus.album, runner=rn.MeshRunner(mesh1),
                              album=True)
    report["cli_album"] = compare("album -a (cli)", tracks4, gains(res1),
                                  ref_name="1-device mesh")
    gain1 = PINK_REF - hi.loudness_from_histogram(res1.album_histogram)
    check(abs(gain4 - gain1) <= GAIN_TOL_DB,
          f"4-card album gain {gain4:.4f} vs 1-device {gain1:.4f} dB")
    log(f"  album gain {gain4:+.4f} dB on 4 cards vs {gain1:+.4f} dB")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU data-parallel path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep", help="build the corpus here and keep it")
    args = ap.parse_args(argv)

    log("(a) device")
    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    sys.path.insert(0, HERE)
    from mp3rgain_tpu.testing import corpus as corpus_mod

    timer = Timer()
    work = args.keep or tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        log("(b) corpus")
        with timer("corpus build"):
            corpus = corpus_mod.build_corpus(os.path.join(work, "corpus"),
                                             seed=args.seed)
        log(f"  {len(corpus.album)} album, {len(corpus.library)} library, "
            f"{len(corpus.m4a)} m4a files; "
            f"{sum(corpus.seconds.values()) / 3600:.2f} audio-hours")
        if args.four_cards:
            report = four_cards(corpus, work, timer)
        else:
            report = one_card(corpus, work, timer)
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           f"chip_smoke_{n_cards}.json"), "w") as f:
        json.dump({"report": report, "times": timer.times}, f, indent=1,
                  default=str)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
