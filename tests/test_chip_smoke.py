"""chip_smoke.py's helpers, corpus and phases, rehearsed on the CPU.

The card run itself (`python chip_smoke.py`) needs a GPU; here the same
phase functions run on the CPU backend at a tiny corpus size, and the
script's refusal to run without a GPU is checked.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from mp3rgain_tpu import native  # noqa: E402
from mp3rgain_tpu.testing import corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_smoke()


def _tiny(out, seed=5):
    return corpus.build_corpus(
        str(out), seed=seed, album_tracks=3, album_seconds=6.0,
        library_seconds=3.0, podcast_seconds=20.0, m4a_seconds=3.0,
        library_scale=0.1,
    )


def test_parse_tsv_reads_gain_and_amplitude():
    text = (
        "File\tMP3 gain\tdB gain\tMax Amplitude\tMax global_gain\tMin\n"
        "a.mp3\t-1\t-2.200000\t30723.25\t191\t140\n"
        "b.mp3\t3\t4.860000\t26955.08\t224\t121\n"
        '"Album"\t1\t1.500000\t30723.25\t224\t121\n'
    )
    assert cs.parse_tsv(text) == {
        "a.mp3": (-2.2, 30723.25), "b.mp3": (4.86, 26955.08),
    }


@pytest.mark.parametrize("dg,dp,ok", [
    (0.0, 0.0, True),
    (0.049, 0.009, True),
    (0.051, 0.0, False),
    (0.0, 0.011, False),
])
def test_compare_holds_gain_and_peak_tolerances(dg, dp, ok):
    ref = {"t": (-3.0, 0.5)}
    got = {"t": (-3.0 + dg, 0.5 * (1 + dp))}
    if ok:
        worst = cs.compare("x", got, ref)
        assert worst["gain_db"] == pytest.approx(dg)
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.compare("x", got, ref)


def test_compare_refuses_missing_tracks():
    with pytest.raises(cs.SmokeFailure):
        cs.compare("x", {"a": (0.0, 1.0)}, {"a": (0.0, 1.0), "b": (0, 1)})


def test_corpus_is_a_function_of_the_seed(tmp_path):
    a = _tiny(tmp_path / "a", seed=3)
    b = _tiny(tmp_path / "b", seed=3)
    c = _tiny(tmp_path / "c", seed=4)
    for pa, pb in zip(a.album + a.library + a.m4a, b.album + b.library + b.m4a):
        assert open(pa, "rb").read() == open(pb, "rb").read()
    assert any(open(pa, "rb").read() != open(pc, "rb").read()
               for pa, pc in zip(a.album, c.album))
    assert len(a.m4a) == 9 and sum(1 for p in a.m4a if "96k" in p) == 1
    assert a.audio_seconds(a.album) == pytest.approx(18.0, abs=0.1)


@pytest.mark.parametrize("clip", [c.name for c in corpus.MP3_CLIPS])
def test_mp3_clips_are_reservoir_free(clip):
    """Every frame's main_data_begin is 0, so any run of whole frames is
    a valid stream."""
    data = open(corpus.CLIPS[clip].path, "rb").read()
    idx = native.frame_index(data)
    assert len(idx) > 20
    for off, _, hdr in idx:
        p = int(off) + 4 + (0 if (int(hdr) >> 16) & 1 else 2)
        lsf = ((int(hdr) >> 19) & 3) != 3
        word = int.from_bytes(data[p : p + 2], "big")
        assert word >> (8 if lsf else 7) == 0


def test_built_m4a_round_trips_through_the_demuxer(tmp_path):
    from mp3rgain_tpu import mp4meta
    from mp3rgain_tpu.decode import aac_frontend as af

    data, secs = corpus.build_m4a("aac_96k", 2.0, np.random.default_rng(0))
    p = tmp_path / "x.m4a"
    p.write_bytes(data)
    assert mp4meta.is_mp4_file(p)
    u = af.unpack_file_q(str(p))
    assert u.sample_rate == 96000 and u.n > 0
    assert secs == pytest.approx(2.0, abs=0.02)


def test_exits_without_a_gpu_and_prints_no_result(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_one_card_phases_rehearse_on_cpu(tmp_path):
    cp = _tiny(tmp_path / "corpus")
    report = cs.one_card(cp, str(tmp_path), cs.Timer())
    assert report["worst"]["library"]["gain_db"] <= cs.GAIN_TOL_DB
    assert report["audio_seconds"]["m4a"] > 0


def test_four_card_phase_rehearses_on_the_cpu_mesh(tmp_path):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual 8-device CPU mesh")
    cp = _tiny(tmp_path / "corpus")
    report = cs.four_cards(cp, str(tmp_path), cs.Timer())
    assert set(report) == {"light_sharded", "heavy", "aac", "cli_album"}
