"""AAC device back-end: IMDCT + windowing + overlap-add on device.

Consumes the native front-end's natural-order requantized spectra and
produces PCM. Window sequences/shapes are handled with precomputed
constants selected by per-frame masks (no gathers):

- long sequences (ONLY_LONG / LONG_START / LONG_STOP): one unwindowed
  2048x1024 IMDCT matmul, then an elementwise window selected by
  (sequence, previous shape, current shape);
- EIGHT_SHORT: four pre-windowed 2048x1024 matrices (the eight 256-point
  sub-IMDCTs overlap-add each other inside the matrix, so the window must
  be folded in), selected by (previous shape, current shape);
- overlap-add across frames is a pure shift (out = z[:1024] + prev z[1024:]).

Windows are sine or Kaiser-Bessel-derived (alpha 4 long / 6 short),
computed in float64 at table-build time.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
from scipy.special import i0 as _bessel_i0

import jax
import jax.numpy as jnp

from .. import backend
from . import aac_frontend as af

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)


def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    m = n // 2
    t = (np.arange(m + 1) / m - 0.5) * 2.0
    w = _bessel_i0(np.pi * alpha * np.sqrt(np.clip(1.0 - t * t, 0.0, 1.0)))
    c = np.cumsum(w[:-1])
    half = np.sqrt(c / (c[-1] + w[-1]))
    # full window (rising half + mirrored falling half)
    return np.concatenate([half, half[::-1]])


def _half_windows(n: int):
    """(2, n/2) rising halves for shape 0 (sine) and 1 (KBD)."""
    alpha = 4.0 if n == 2048 else 6.0
    return np.stack([_sine_window(n)[: n // 2], _kbd_window(n, alpha)[: n // 2]])


def _imdct_matrix(n: int) -> np.ndarray:
    """Unwindowed IMDCT: out (n,) from (n/2,) coefficients."""
    n0 = (n / 2 + 1) / 2
    t = np.arange(n)[:, None]
    k = np.arange(n // 2)[None, :]
    return (2.0 / n) * np.cos(2.0 * np.pi / n * (t + n0) * (k + 0.5))


@lru_cache(maxsize=1)
def _tables():
    rise_long = _half_windows(2048)  # (2, 1024)
    rise_short = _half_windows(256)  # (2, 128)
    fall_long = rise_long[:, ::-1]
    fall_short = rise_short[:, ::-1]

    m_long = _imdct_matrix(2048)  # (2048, 1024)

    # Long-sequence full windows W[seq, prev, cur] (3 seqs: 0,1,3 -> idx 0,1,2).
    w_long = np.zeros((3, 2, 2, 2048))
    for prev in range(2):
        for cur in range(2):
            left_ol = rise_long[prev]
            right_ol = fall_long[cur]
            # ONLY_LONG
            w_long[0, prev, cur] = np.concatenate([left_ol, right_ol])
            # LONG_START: right = 448 ones + short fall + 448 zeros
            w_long[1, prev, cur] = np.concatenate(
                [left_ol, np.ones(448), fall_short[cur], np.zeros(448)]
            )
            # LONG_STOP: left = 448 zeros + short rise + 448 ones
            w_long[2, prev, cur] = np.concatenate(
                [np.zeros(448), rise_short[prev], np.ones(448), right_ol]
            )

    # EIGHT_SHORT pre-windowed matrices per (prev, cur).
    m256 = _imdct_matrix(256)  # (256, 128)
    m_short = np.zeros((2, 2, 2048, 1024))
    for prev in range(2):
        for cur in range(2):
            for w in range(8):
                left = rise_long[prev][:0]  # unused
                wl = rise_short[prev] if w == 0 else rise_short[cur]
                win = np.concatenate([wl, fall_short[cur]])  # (256,)
                block = m256 * win[:, None]
                m_short[prev, cur, 448 + 128 * w : 448 + 128 * w + 256,
                        128 * w : 128 * (w + 1)] += block
    return m_long, w_long, m_short


@partial(jax.jit, static_argnames=("n_channels", "dtype"))
def _decode_jit(spec, window_seq, window_shape, n_channels, dtype):
    m_long_np, w_long_np, m_short_np = _tables()
    m_long = jnp.asarray(m_long_np, dtype)
    w_long = jnp.asarray(w_long_np, dtype)
    m_short = jnp.asarray(m_short_np, dtype)

    f = spec.shape[0]
    x = spec.astype(dtype)
    return _decode_body(x, window_seq, window_shape, n_channels, dtype,
                        m_long, w_long, m_short)


def _decode_body(x, window_seq, window_shape, n_channels, dtype,
                 m_long, w_long, m_short):
    with jax.default_matmul_precision(backend.dsp_precision()):
        return _decode_inner(x, window_seq, window_shape, n_channels, dtype,
                             m_long, w_long, m_short)


def _decode_inner(x, window_seq, window_shape, n_channels, dtype,
                  m_long, w_long, m_short):
    f = x.shape[0]

    # Previous frame's shape per channel (records are channel-paired).
    shape = window_shape
    if n_channels == 2:
        s2 = shape.reshape(-1, 2)
        prev = jnp.concatenate([jnp.zeros_like(s2[:1]), s2[:-1]], axis=0).reshape(-1)
    else:
        prev = jnp.concatenate([jnp.zeros_like(shape[:1]), shape[:-1]])

    z_long = jnp.dot(x, m_long.T, preferred_element_type=dtype)  # (F, 2048)
    z = jnp.zeros_like(z_long)
    seq_map = {ONLY_LONG: 0, LONG_START: 1, LONG_STOP: 2}
    for seq, wi in seq_map.items():
        for p in range(2):
            for c in range(2):
                sel = ((window_seq == seq) & (prev == p) & (shape == c))[:, None]
                z = z + jnp.where(sel, z_long * w_long[wi, p, c][None, :], 0.0)
    for p in range(2):
        for c in range(2):
            sel = ((window_seq == EIGHT_SHORT) & (prev == p) & (shape == c))[:, None]
            zs = jnp.dot(x, m_short[p, c].T, preferred_element_type=dtype)
            z = z + jnp.where(sel, zs, 0.0)

    # Overlap-add across frames per channel.
    t = f // n_channels
    z = z.reshape(t, n_channels, 2048)
    prev_tail = jnp.concatenate(
        [jnp.zeros_like(z[:1, :, 1024:]), z[:-1, :, 1024:]], axis=0
    )
    out = z[:, :, :1024] + prev_tail  # (T, C, 1024)
    return out.transpose(1, 0, 2).reshape(n_channels, t * 1024)


def decode_unpacked(u: af.UnpackedAac, dtype=jnp.float32):
    if u.n == 0:
        return np.zeros((1, 0), np.float32), 0
    nch = u.n_channels or 1
    n = (u.n // nch) * nch
    pcm = _decode_jit(
        jnp.asarray(u.spec[:n]),
        jnp.asarray(u.info[:n, af.WINDOW_SEQ]),
        jnp.asarray(u.info[:n, af.WINDOW_SHAPE]),
        n_channels=nch,
        dtype=dtype,
    )
    return pcm, u.sample_rate


def decode_file(path, dtype=jnp.float32):
    """Full-file AAC decode; returns (pcm (C, N) np array, sample_rate)."""
    u = af.unpack_file(path)
    pcm, sr = decode_unpacked(u, dtype)
    return np.asarray(pcm), sr
