"""Differential decoder tests: device decode pipeline vs the libmpg123 oracle.

Mirrors the reference's differential-testing strategy (tier 4,
scripts/compatibility-test.sh) applied to the decode path: every fixture
class (MPEG1/2/2.5, mono/stereo/joint/VBR) must match the golden decoder
to float32-oracle precision.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from mp3rgain_tpu.decode import frontend, synthesis  # noqa: E402
from mp3rgain_tpu.testing import mpg123  # noqa: E402

FIXTURES = [
    "test_stereo.mp3",
    "test_mono.mp3",
    "test_joint_stereo.mp3",
    "test_vbr.mp3",
    "test_mpeg2_22050.mp3",
    "test_mpeg25_11025.mp3",
    "test_48000.mp3",
    "test_32000.mp3",
    "test_mpeg2_24000.mp3",
    "test_mpeg2_16000.mp3",
    "test_mpeg25_12000.mp3",
    "test_mpeg25_8000.mp3",
]


@pytest.mark.parametrize("name", FIXTURES)
def test_decode_matches_mpg123(fixtures_dir, name):
    path = fixtures_dir / name
    mine, sr = synthesis.decode_file(path, dtype=jnp.float32)
    ref, sr_ref = mpg123.decode_file(path)
    ref = ref.T
    assert sr == sr_ref
    assert mine.shape == ref.shape  # frame-for-frame alignment
    n = min(mine.shape[1], ref.shape[1])
    err = np.abs(mine[:, :n] - ref[:, :n])
    rms_ref = np.sqrt((ref[:, :n] ** 2).mean())
    # Oracle emits float32; our float32 path adds similar noise. Device
    # backends run bf16x3 matmuls (~5e-4-relative decode noise).
    bound = max(3e-5, 3e-5 * rms_ref)
    if jax.default_backend() != "cpu":
        bound = max(bound, 5e-4 * rms_ref + 1e-5)
    assert err.max() < bound, (err.max(), rms_ref)


@pytest.mark.parametrize("sr,bitrate", [(8000, 16), (24000, 32), (22050, 32), (44100, 64)])
def test_decode_short_block_stress(sr, bitrate, tmp_path):
    """Impulsive content forcing short blocks with real scalefactors and
    subblock gains at LSF rates (regression: the implied window-switch
    region boundary is 3*si[3] = 72 at 8 kHz, not a fixed 36).

    mpg123 itself deviates from ffmpeg/our decoder by ~2e-3 at 24 kHz in
    this regime (verified three-way), so the bound is looser than the
    fixture tests."""
    import numpy as np

    from mp3rgain_tpu.testing import fixtures as fx

    rng = np.random.default_rng(3)
    n = sr
    t = np.arange(n) / sr
    x = 0.02 * rng.standard_normal(n)
    for k in range(8):
        s = int(k * n / 8)
        x[s : s + 200] += 0.8 * np.sin(2 * np.pi * 1000 * t[:200]) * np.hanning(200)
    pcm = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    p = tmp_path / "stress.mp3"
    p.write_bytes(fx.encode_mp3(pcm, sr, bitrate=bitrate, mode=fx.MODE_MONO))
    mine, _ = synthesis.decode_file(p, dtype=jnp.float32)
    ref = mpg123.decode_file(p)[0].T
    nn = min(mine.shape[1], ref.shape[1])
    err = np.abs(mine[:, :nn] - ref[:, :nn]).max()
    assert err < 5e-3, err


def test_frontend_gains_match_l0_scan(fixtures_dir):
    from mp3rgain_tpu import native

    data = (fixtures_dir / "test_joint_stereo.mp3").read_bytes()
    u = frontend.unpack_data(data)
    gains = native.read_gains(data)
    assert np.array_equal(u.info[:, frontend.GLOBAL_GAIN].astype(np.uint8), gains)
    assert (u.info[:, frontend.VALID] == 1).all()


def test_frontend_vbr_has_blocktypes(fixtures_dir):
    u = frontend.unpack_file(fixtures_dir / "test_vbr.mp3")
    # A sine onset encoded by lame produces start/short/stop blocks.
    bts = set(u.info[:, frontend.BLOCK_TYPE].tolist())
    assert 0 in bts
