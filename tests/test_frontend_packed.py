"""Locks for the round-5 host front-end rework.

The packed-emission light walk (mg_mp3_unpack_light2) and the native
batch-prep helpers (mg_pack_light_track, mg_sort_est_bits) must stay
bit-identical to the dense walk + pure-Python packers they replaced —
these tests pin that equivalence permanently (it was verified
interactively when shipped; a regression here silently corrupts every
device decode).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from mp3rgain_tpu.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu.testing import craft, fixtures  # noqa: E402
from mp3rgain_tpu.utils import bufpool  # noqa: E402


def _tone_mp3(seconds=4, sr=44100, mode=None):
    rng = np.random.default_rng(5)
    t = np.arange(sr * seconds) / sr
    wave = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(len(t))
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    stereo = np.stack([pcm, np.roll(pcm, 7)], axis=1)
    kw = {"mode": mode} if mode else {}
    return fixtures.encode_mp3(stereo, sr, bitrate=128, **kw)


@pytest.mark.parametrize("name,data", [
    ("tone", None),  # filled in the test (needs fixtures import)
    ("crafted-mixed", craft.craft_mixed_block_stream(8)),
    ("garbage", b"\xff\xfb" + b"\x00" * 4096),
    ("empty", b""),
])
def test_packed_walk_matches_dense_plus_python_pack(name, data):
    if data is None:
        data = _tone_mp3()
    ud = fe.unpack_data_light(data)
    up = fe.unpack_data_light_packed(data)
    assert up.n == ud.n
    if not ud.n:
        return
    assert up.sample_rate == ud.sample_rate
    assert up.n_channels == ud.n_channels
    assert np.array_equal(up.ip, fe.pack_info_light(ud.info))
    main, rows, side, hrows, hmask = fe.pack_scf_rows(ud.scf)
    assert np.array_equal(up.scf_main, main)
    assert np.array_equal(up.srows, rows)
    assert np.array_equal(up.sdata, side)
    assert np.array_equal(up.hrows, hrows)
    assert np.array_equal(up.hmask, hmask)
    assert np.array_equal(up.meta, ud.meta)
    # md rows agree over the read extent the packer may touch
    # (((p0+p23)+95)//32 words); beyond it both buffers are undefined.
    nb = np.minimum(
        (ud.meta[:, fe.LM_P0] + ud.meta[:, fe.LM_P23] + 95) // 32 * 4,
        fe.MD_STRIDE,
    )
    for r in range(ud.n):
        e = int(nb[r])
        assert np.array_equal(ud.md[r, :e], up.md[r, :e]), r


def test_batch_prep_identical_for_dense_and_packed_inputs():
    data = _tone_mp3(seconds=6)
    ud = fe.unpack_data_light(data)
    up = fe.unpack_data_light_packed(data)
    p1, r1, g1 = pr.prepare_batch_arrays_light([ud] * 5, 2, 1)
    p2, r2, g2 = pr.prepare_batch_arrays_light([up] * 5, 2, 1)
    assert g1 == g2
    for a, b in zip(r1, r2):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for f in ("woff", "rows", "meta"):
        assert np.array_equal(getattr(p1, f), getattr(p2, f)), f
    # buf comes from the shared pool and its tail past the last window
    # carries stale bytes by design — compare each real lane's live word
    # extent, which is exactly what the kernel may read.
    meta_all = np.concatenate([ud.meta] * 5)
    bits = meta_all[:, fe.LM_P0] + meta_all[:, fe.LM_P23]
    nwords = np.minimum((bits + 95) // 32, fe.MD_STRIDE // 4)
    lane_of = np.argsort(p1.rows)
    for src in range(p1.n):
        off = int(p1.woff[lane_of[src]])
        a = p1.buf[off : off + int(nwords[src])]
        c = p2.buf[off : off + int(nwords[src])]
        assert np.array_equal(a, c), src
    bufpool.give(p1.buf, p1.meta, r1[1], r1[6])
    bufpool.give(p2.buf, p2.meta, r2[1], r2[6])


def test_native_sort_matches_lexsort_and_is_stable():
    """mg_sort_est_bits must reproduce np.lexsort((bits, est)) exactly,
    including tie stability (ties keep source order), across the full
    key ranges incl. the clamped extremes."""
    import ctypes

    from mp3rgain_tpu.native import _lib

    rng = np.random.default_rng(9)
    n = 50_000
    est = rng.integers(0, 289, n).astype(np.int32)
    bits = rng.integers(0, 4104, n).astype(np.int64)
    # Heavy tie pressure + boundary values.
    est[: n // 4] = 0
    bits[: n // 8] = 0
    est[-5:] = 288
    bits[-5:] = 4103
    order = np.empty(n, np.int32)
    inv = np.empty(n, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _lib.mg_sort_est_bits(
        est.ctypes.data_as(i32p),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        order.ctypes.data_as(i32p), inv.ctypes.data_as(i32p),
    )
    ref = np.lexsort((bits, est)).astype(np.int32)
    assert np.array_equal(order, ref)
    assert np.array_equal(inv[order], np.arange(n, dtype=np.int32))


def test_count_gch_matches_walk():
    """The exact-size count pre-pass must agree with the walk's record
    count on clean, crafted, resync-dirty and garbage inputs (a
    mismatch would truncate the manifest)."""
    import ctypes

    from mp3rgain_tpu.native import _lib, _u8p

    def count(data: bytes):
        buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
            data or b"\x00"
        )
        return int(_lib.mg_mp3_count_gch(
            ctypes.cast(buf, _u8p), len(data)))

    clean = _tone_mp3()
    dirty = b"\x00" * 37 + clean[: len(clean) // 2] + b"\xff\xe0garbage" + clean
    for data in (clean, craft.craft_mixed_block_stream(5), dirty, b"", b"\xff" * 64):
        assert count(data) == fe.unpack_data_light(data).n
