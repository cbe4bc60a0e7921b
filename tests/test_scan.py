"""Batch scan + manifest resume tests (config 5: library-scale scans)."""

import json
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from mp3rgain_tpu import backend, cli, scan  # noqa: E402
from mp3rgain_tpu.ops import histogram as hi  # noqa: E402


@pytest.fixture()
def library(fixtures_dir, tmp_path):
    paths = []
    for i in range(20):
        name = ["test_vbr.mp3", "test_joint_stereo.mp3", "test_mono.mp3"][i % 3]
        dst = tmp_path / f"track{i:02d}.mp3"
        shutil.copy(fixtures_dir / name, dst)
        paths.append(dst)
    return paths


def test_scan_matches_sequential(library):
    from mp3rgain_tpu import analysis

    res = scan.scan_files(library[:6])
    for p in library[:6]:
        got = res.results[str(p)]
        seq = analysis.analyze_track_internal(p).result
        assert got.gain_db == pytest.approx(seq.gain_db, abs=1e-9)
    assert res.audio_seconds > 5.0
    assert res.realtime_factor > 0


def test_manifest_resume(library, tmp_path):
    manifest = tmp_path / "scan.json"
    r1 = scan.scan_files(library, manifest_path=manifest)
    assert r1.resumed == 0
    assert manifest.exists()
    r2 = scan.scan_files(library, manifest_path=manifest)
    assert r2.resumed == len(library)
    for p in library:
        assert r2.results[str(p)].gain_db == r1.results[str(p)].gain_db
        assert np.array_equal(r2.histograms[str(p)], r1.histograms[str(p)])
    # Touching a file invalidates its manifest entry.
    library[0].touch()
    import os, time
    os.utime(library[0], (time.time() + 5, time.time() + 5))
    r3 = scan.scan_files(library, manifest_path=manifest)
    assert r3.resumed == len(library) - 1


def test_killed_scan_resumes_from_last_batch(library, tmp_path, monkeypatch):
    """A scan killed mid-run must leave a manifest covering every batch
    collected so far, and a re-run must resume those tracks from it
    (SURVEY §5 checkpoint/resume; VERDICT r1 item 6)."""
    from mp3rgain_tpu.parallel import runner as pr

    manifest = tmp_path / "scan.json"

    # Force small batches so several checkpoints happen, and kill the
    # scan right after the second one.
    real_init = pr.MeshRunner.__init__

    def tiny_init(self, *a, **kw):
        real_init(self, *a, **kw)
        self.max_batch = 4

    monkeypatch.setattr(pr.MeshRunner, "__init__", tiny_init)

    calls = {"n": 0}
    real_analyze = pr.analyze_library

    def killing_analyze(paths, runner=None, batch_cb=None, **kw):
        def cb(done):
            batch_cb(done)
            calls["n"] += 1
            if calls["n"] == 2:
                raise KeyboardInterrupt

        return real_analyze(paths, runner=runner, batch_cb=cb, **kw)

    monkeypatch.setattr(pr, "analyze_library", killing_analyze)
    with pytest.raises(KeyboardInterrupt):
        scan.scan_files(library, manifest_path=manifest)

    # Both collected batches must be durable (snapshot + journal — the
    # per-batch checkpoint appends to a journal; full snapshots are
    # end-of-scan only).
    saved = scan.Manifest(manifest).data
    assert len(saved) == 8  # two collected batches of 4

    monkeypatch.setattr(pr, "analyze_library", real_analyze)
    r2 = scan.scan_files(library, manifest_path=manifest)
    assert r2.resumed == 8
    for p in library:
        assert not isinstance(r2.results[str(p)], Exception)


def test_album_union_matches_sequential(library):
    from mp3rgain_tpu import analysis

    subset = library[:6]
    res = scan.scan_files(subset)
    loud, gain, peak = scan.album_union(res, subset)
    seq = analysis.analyze_album(subset)
    assert gain == pytest.approx(seq.album_gain_db, abs=1e-9)
    assert peak == pytest.approx(seq.album_peak, abs=1e-6)


def test_cli_batch_track_gain(library, capsys):
    rc = cli.main(["-q", "--batch", "-r", "-n", "-o", "json", *map(str, library)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["files"]) == len(library)
    assert all(r["status"] == "dry_run" for r in out["files"])


def test_cli_batch_album_gain(library, capsys):
    rc = cli.main(["-a", "-n", "-o", "json", *map(str, library)])  # auto batch (20 >= 16)
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert "album" in out and out["album"]["gain_steps"] is not None


def test_cli_fault_isolation_in_batch(library, tmp_path, capsys):
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"corrupt" * 64)
    rc = cli.main(["-q", "--batch", "-r", "-n", "-o", "json", str(bad), *map(str, library[:3])])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    statuses = {r["file"].split("/")[-1]: r["status"] for r in out["files"]}
    assert statuses["bad.mp3"] == "error"
    assert all(v == "dry_run" for k, v in statuses.items() if k != "bad.mp3")


def test_sparse_histogram_readback_matches_dense():
    """_pull_histograms (top-k compaction) must reproduce the dense
    histogram bit-exactly, including the dense fallback when a batch
    exceeds the ladder."""
    import jax.numpy as jnp

    from mp3rgain_tpu import scan as sc

    rng = np.random.default_rng(42)
    dense = np.zeros((3, 12000), np.uint32)
    # sparse rows under the ladder
    for r, nnz in enumerate((5, 900, 1023)):
        idx = rng.choice(12000, size=nnz, replace=False)
        dense[r, idx] = rng.integers(1, 3000, size=nnz).astype(np.uint32)
    got = sc._pull_histograms(jnp.asarray(dense))
    np.testing.assert_array_equal(got, dense)

    # a row denser than the ladder forces the dense fallback
    big = np.zeros((1, 12000), np.uint32)
    big[0, : 9000] = 1
    got = sc._pull_histograms(jnp.asarray(big))
    np.testing.assert_array_equal(got, big)


def test_aac_scan_streams_batches(tmp_path):
    """The wave-streamed AAC scan (uploader thread, per-batch manifest
    checkpoints) must match per-file analysis, isolate corrupt files,
    and resume from the manifest."""
    from mp3rgain_tpu import analysis
    from mp3rgain_tpu.testing import fixtures

    sr = 44100
    t = np.arange(sr * 2) / sr
    pcm = np.stack([0.4 * np.sin(2 * np.pi * 440.0 * t)] * 2, axis=1)
    data = fixtures.encode_m4a(pcm.astype(np.float32), sr)
    paths = []
    for i in range(18):
        dst = tmp_path / f"aac{i:02d}.m4a"
        dst.write_bytes(data)
        paths.append(dst)
    bad = tmp_path / "bad.m4a"
    bad.write_bytes(b"\x00" * 4096)
    paths.append(bad)

    manifest = tmp_path / "aacscan.json"
    res = scan.scan_files(paths, manifest_path=manifest)
    assert isinstance(res.results[str(bad)], Exception)
    seq = analysis.analyze_track_internal(paths[0]).result
    for p in paths[:18]:
        got = res.results[str(p)]
        assert got.gain_db == pytest.approx(seq.gain_db, abs=1e-9)
        assert got.file_type == "aac"
    assert res.audio_seconds > 18 * 1.5

    # The per-batch checkpoint persisted every good track: a second
    # scan resumes all of them without re-decoding.
    r2 = scan.scan_files(paths, manifest_path=manifest)
    assert r2.resumed == 18
    for p in paths[:18]:
        assert r2.results[str(p)].gain_db == res.results[str(p)].gain_db


def test_oom_dispatch_halves_and_recovers(library, monkeypatch):
    """A RESOURCE_EXHAUSTED dispatch (device memory pressure)
    must degrade to smaller synchronous batches, not kill the scan."""
    from mp3rgain_tpu import parallel as pr
    from mp3rgain_tpu.parallel import runner as rmod

    runner = pr.MeshRunner()
    dispatch_sizes = []
    # Patch the same entry point analyze_library selects (dispatch_heavy
    # on the CPU test mesh, the light paths under device entropy).
    if not backend.device_entropy():
        name = "dispatch_heavy"
    elif runner.n_devices > 1:
        name = "dispatch_light_sharded"
    else:
        name = "dispatch_light"
    real = getattr(runner, name)
    fails = {"left": 2}

    def flaky(ups, sr, nch):
        dispatch_sizes.append(len(ups))
        if len(ups) > 2 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("RESOURCE_EXHAUSTED: out of device memory")
        return real(ups, sr, nch)

    monkeypatch.setattr(runner, name, flaky)
    res = rmod.analyze_library(library, runner=runner)
    print("DISPATCH_SIZES", dispatch_sizes, "fails", fails)
    assert all(t.ok for t in res.tracks)
    # The failing full batch was re-dispatched in halves.
    assert any(s <= max(dispatch_sizes) // 2 for s in dispatch_sizes)

    # Results match an unfaulted scan.
    res2 = rmod.analyze_library(library, runner=pr.MeshRunner())
    for a, b in zip(res.tracks, res2.tracks):
        assert a.result.gain_db == pytest.approx(b.result.gain_db, abs=1e-9)
        assert a.result.peak == pytest.approx(b.result.peak, abs=1e-12)


def test_scan_plan_pins_class_shapes(library, monkeypatch):
    """Big scans pre-plan: a native header probe pins one compile key
    per length class and the walk leads with each class's first batch
    (cold compiles all start early). Planned and unplanned walks
    must produce identical results."""
    import jax
    from jax.sharding import Mesh

    from mp3rgain_tpu import parallel as pr
    from mp3rgain_tpu.parallel import runner as rmod

    monkeypatch.setenv("MP3RGAIN_DEVICE_ENTROPY", "1")
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))

    runner = pr.MeshRunner(mesh=mesh, max_batch=8)
    dispatched = []
    real = runner.dispatch_light

    def spy(ups, sr, nch, force_shapes=None):
        dispatched.append((len(ups), force_shapes))
        return real(ups, sr, nch, force_shapes=force_shapes)

    monkeypatch.setattr(runner, "dispatch_light", spy)
    res = rmod.analyze_library(library, runner=runner, device_entropy=True)
    assert all(t.ok for t in res.tracks)
    assert dispatched and all(f is not None for _, f in dispatched), (
        "every planned batch must carry pinned class shapes"
    )

    monkeypatch.setenv("MP3RGAIN_NO_SCAN_PLAN", "1")
    ref = rmod.analyze_library(
        library, runner=pr.MeshRunner(mesh=mesh, max_batch=8),
        device_entropy=True,
    )
    by_path = {t.path: t for t in ref.tracks}
    for t in res.tracks:
        assert t.result.gain_db == pytest.approx(
            by_path[t.path].result.gain_db, abs=1e-9
        )
        assert t.result.peak == pytest.approx(
            by_path[t.path].result.peak, abs=1e-12
        )


def test_compile_crash_isolates_not_dies(library, monkeypatch):
    """A batch whose compile exhausts device memory (RESOURCE_EXHAUSTED
    from buffer assignment) is retried by halving, once more at n=1,
    and then the stubborn track is isolated instead of killing the
    scan."""
    from mp3rgain_tpu import parallel as pr
    from mp3rgain_tpu.parallel import runner as rmod

    monkeypatch.setenv("MP3RGAIN_PRESSURE_BACKOFF_S", "0")
    runner = pr.MeshRunner()
    if not backend.device_entropy():
        name = "dispatch_heavy"
    elif runner.n_devices > 1:
        name = "dispatch_light_sharded"
    else:
        name = "dispatch_light"
    real = getattr(runner, name)
    poisoned = {"u": None}

    def flaky(ups, sr, nch):
        # One specific track never compiles (even at n=1, even on the
        # retry); everything batched with it must still succeed.
        if poisoned["u"] is None and len(ups) > 1:
            poisoned["u"] = ups[0]
        if any(u is poisoned["u"] for u in ups):
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: Failed to allocate buffers while "
                "compiling the analysis pipeline"
            )
        return real(ups, sr, nch)

    monkeypatch.setattr(runner, name, flaky)
    # batch_cb mirrors the scan checkpoint contract: it must never see
    # a failed track (their histogram is None — stacking one killed a
    # real 1k scan).
    cb_tracks = []
    res = rmod.analyze_library(
        library, runner=runner, batch_cb=cb_tracks.extend
    )
    assert all(t.ok and t.histogram is not None for t in cb_tracks)
    bad = [t for t in res.tracks if not t.ok]
    assert len(bad) == 1
    # TrackOutcome.error is declared `str | None`; the pressure path
    # must honor that so scan.py's RuntimeError(track.error) wrap gives
    # a single clean user-visible message (round-4 VERDICT weak #5).
    assert isinstance(bad[0].error, str)
    assert "pressure" in bad[0].error
    assert "RuntimeError" not in str(RuntimeError(bad[0].error))
    good = [t for t in res.tracks if t.ok]
    assert good, "every other track must survive the poisoned batch"
    ref = rmod.analyze_library(library, runner=pr.MeshRunner())
    by_path = {t.path: t for t in ref.tracks}
    for t in good:
        assert t.result.gain_db == pytest.approx(
            by_path[t.path].result.gain_db, abs=1e-9
        )
