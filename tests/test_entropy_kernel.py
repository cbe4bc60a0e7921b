"""Device entropy-decode kernel vs the host Huffman decoder (exact).

The host full unpack (mg_mp3_unpack) is the correctness oracle: for every
granule-channel the kernel's spectrum must be integer-identical, and
big_end/count1_end must match (reference semantics in
_native/mp3dec.cpp decode_spectrum).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from mp3rgain_tpu.decode import entropy_kernel as ek  # noqa: E402
from mp3rgain_tpu.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu.testing import fixtures  # noqa: E402


def _assert_matches(data: bytes, label: str):
    full = fe.unpack_data(data)
    light = fe.unpack_data_light(data)
    assert full.n == light.n
    if full.n == 0:
        return
    spec, big_end, c1end, ok = ek.decode_spectra(
        light.md, light.meta, interpret=True
    )
    spec = np.asarray(spec)
    big_end = np.asarray(big_end)
    c1end = np.asarray(c1end)
    ok = np.asarray(ok)

    valid = full.info[:, fe.VALID] == 1
    exp_big = full.info[:, fe.BIG_END]
    exp_c1 = full.info[:, fe.COUNT1_END]
    mismatch_spec = np.nonzero(
        (spec != full.spectrum).any(axis=1) & valid
    )[0]
    assert mismatch_spec.size == 0, (
        f"{label}: {mismatch_spec.size}/{full.n} spectra differ; first at "
        f"gch {mismatch_spec[:3]}: "
        f"{[(int(i), np.nonzero(spec[i] != full.spectrum[i])[0][:5].tolist()) for i in mismatch_spec[:3]]}"
    )
    assert np.array_equal(big_end[valid], exp_big[valid]), label
    assert np.array_equal(c1end[valid], exp_c1[valid]), label


FIXTURE_SPECS = [
    ("stereo_cbr", dict(sr=44100, mode=fixtures.MODE_STEREO, bitrate=128, ch=2)),
    ("mono", dict(sr=44100, mode=fixtures.MODE_MONO, bitrate=64, ch=1)),
    ("joint", dict(sr=44100, mode=fixtures.MODE_JOINT, bitrate=128, ch=2)),
    ("vbr", dict(sr=44100, mode=fixtures.MODE_JOINT, vbr=True, ch=2)),
    ("mpeg2", dict(sr=22050, mode=fixtures.MODE_JOINT, bitrate=64, ch=2)),
    ("mpeg25", dict(sr=11025, mode=fixtures.MODE_MONO, bitrate=32, ch=1)),
    ("high_rate", dict(sr=48000, mode=fixtures.MODE_STEREO, bitrate=320, ch=2)),
    ("low_rate", dict(sr=8000, mode=fixtures.MODE_MONO, bitrate=16, ch=1)),
]


@pytest.mark.parametrize("label,spec", FIXTURE_SPECS)
def test_kernel_matches_host_sine(label, spec):
    pcm = fixtures.sine_pcm(spec["sr"], seconds=0.5, channels=spec["ch"])
    data = fixtures.encode_mp3(
        pcm, spec["sr"], bitrate=spec.get("bitrate", 128),
        mode=spec["mode"], vbr=spec.get("vbr", False),
    )
    _assert_matches(data, label)


@pytest.mark.parametrize("label,spec", FIXTURE_SPECS[:4])
def test_kernel_matches_host_noise(label, spec):
    """Loud noise maximizes escape codes / long codewords / table 13-24."""
    rng = np.random.default_rng(42)
    n = int(spec["sr"] * 0.5)
    wave = np.clip(rng.standard_normal(n) * 0.5, -1, 1)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    if spec["ch"] == 2:
        pcm = np.stack([pcm, np.roll(pcm, 3)], axis=1)
    data = fixtures.encode_mp3(
        pcm, spec["sr"], bitrate=spec.get("bitrate", 128),
        mode=spec["mode"], vbr=spec.get("vbr", False),
    )
    _assert_matches(data, label)


def test_kernel_matches_host_loud_tonal():
    """Full-scale multitone at high bitrate: large values, linbits paths."""
    sr = 44100
    t = np.arange(int(sr * 0.5)) / sr
    wave = sum(
        np.sin(2 * np.pi * f * t) / 6.0
        for f in (60, 440, 1870, 6100, 12000, 17000)
    )
    pcm = np.clip(wave * 6 * 0.99 * 32767, -32768, 32767).astype(np.int16)
    pcm = np.stack([pcm, -pcm], axis=1)
    data = fixtures.encode_mp3(pcm, sr, bitrate=320, mode=fixtures.MODE_STEREO)
    _assert_matches(data, "loud_tonal")


@pytest.mark.parametrize(
    "name",
    [
        "craft_intensity_stream",
        "craft_mixed_block_stream",
        "craft_count1b_stream",
        "craft_scalefactor_stream",
        "craft_lsf_intensity_stream",
    ],
)
def test_kernel_matches_host_crafted(name):
    """Crafted streams (IS/MS/mixed blocks/count1B/LSF) through the kernel."""
    from mp3rgain_tpu.testing import craft

    kw = {}
    if name == "craft_scalefactor_stream":
        kw = dict(scf=[3, 2, 1, 4, 5, 6, 7, 0, 1, 2, 3] + [1, 2, 3, 0, 1, 2, 3, 0, 1, 2],
                  preflag=1, scfsi=0b1010)
    data = getattr(craft, name)(**kw)
    _assert_matches(data, name)


def test_truncated_stream_no_crash():
    pcm = fixtures.sine_pcm(44100, seconds=0.3, channels=2)
    data = fixtures.encode_mp3(pcm, 44100, bitrate=128)
    _assert_matches(data[: len(data) // 2], "truncated")


def _noise_and_tone_tracks():
    """Loud noise (long codes, escapes, ~288 steps per granule) and a
    quiet tone (a few big-value pairs) — very unequal step counts."""
    rng = np.random.default_rng(3)
    sr = 44100
    n = int(sr * 0.25)
    loud = np.clip(rng.standard_normal(n) * 0.6, -1, 1)
    quiet = 0.002 * np.sin(2 * np.pi * 440 * np.arange(n) / sr)
    out = []
    for wave in (loud, quiet):
        pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
        out.append(fixtures.encode_mp3(np.stack([pcm, pcm], axis=1), sr,
                                       bitrate=320))
    return out


@pytest.mark.parametrize("lanes", [32, 256])
def test_kernel_block_sizes(lanes):
    """Other program widths decode identically (multi-track input)."""
    datas = _noise_and_tone_tracks()
    fulls = [fe.unpack_data(d) for d in datas]
    lights = [fe.unpack_data_light(d) for d in datas]
    spec, big_end, c1end, ok = ek.decode_spectra(
        [u.md for u in lights], [u.meta for u in lights], lanes=lanes,
        interpret=True,
    )
    full_spec = np.concatenate([f.spectrum for f in fulls])
    valid = np.concatenate([f.info[:, fe.VALID] == 1 for f in fulls])
    assert np.array_equal(np.asarray(spec)[valid], full_spec[valid])
    assert np.array_equal(
        np.asarray(c1end)[valid],
        np.concatenate([f.info[:, fe.COUNT1_END] for f in fulls])[valid],
    )


def test_kernel_block_with_unequal_step_counts():
    """One program whose lanes need very different step counts: the
    short lanes must stop and stay put while the long ones run on."""
    datas = _noise_and_tone_tracks()
    lights = [fe.unpack_data_light(d) for d in datas]
    meta = np.concatenate([u.meta for u in lights])
    bvp = meta[:, fe.LM_BVP]
    assert len(meta) <= 256 and bvp.max() - bvp.min() > 150
    p = ek.prepare_batch([u.md for u in lights], [u.meta for u in lights],
                         lanes=256)
    assert p.nb == 1  # every lane in the same program
    for d in datas:
        _assert_matches(d, "unequal")
    full = np.concatenate([fe.unpack_data(d).spectrum for d in datas])
    spec, *_ = ek.decode_spectra([u.md for u in lights],
                                 [u.meta for u in lights], lanes=256,
                                 interpret=True)
    assert np.array_equal(np.asarray(spec), full)


@pytest.mark.gpu
def test_kernel_compiled_on_the_card_matches_host(gpu_device):
    """The Triton-compiled kernel (no interpret mode) on a GPU."""
    import jax

    data = _noise_and_tone_tracks()[0]
    full = fe.unpack_data(data)
    light = fe.unpack_data_light(data)
    with jax.default_device(gpu_device):
        spec, *_ = ek.decode_spectra(light.md, light.meta, interpret=False)
    valid = full.info[:, fe.VALID] == 1
    assert np.array_equal(np.asarray(spec)[valid], full.spectrum[valid])
