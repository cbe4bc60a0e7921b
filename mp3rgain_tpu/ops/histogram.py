"""50 ms RMS windows, loudness histogram, and the 95th-percentile readout.

Replicates the reference analyzer's semantics exactly
(/root/reference/src/replaygain.rs:624-771):

- windows of sample_rate*50/1000 samples; the trailing partial window is
  flushed with its own (smaller) sample count;
- mean_square = (lsum + rsum) / totsamp * 0.5 (mono adds the same square
  to both sums);
- bin index = trunc(100 * 10 * log10(ms + 1e-37)) + 2000, truncation
  toward zero, dropped when outside [0, 12000);
- loudness = (i - 2000)/100 for the topmost bin where the top-down
  cumulative count reaches ceil(total * (1.0 - 0.95)) — including the
  float64 representation quirk of (1.0 - 0.95);
- album histograms accumulate by summation (device-side psum).

Histograms are built on device (scatter-add); the 12000-bin percentile
readout runs on host in float64 to preserve the reference's exact
threshold arithmetic.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

HISTOGRAM_SIZE = 12000
STEPS_PER_DB = 100.0
HISTOGRAM_OFFSET = 2000
RMS_PERCENTILE = 0.95
RMS_WINDOW_MS = 50


def window_size(sample_rate: int) -> int:
    return (sample_rate * RMS_WINDOW_MS) // 1000


@partial(jax.jit, static_argnames=("win",))
def _histogram_jit(filtered, valid_len, win: int):
    """filtered: (B, C, T) equal-loudness output; valid_len: (B,).

    Returns (B, HISTOGRAM_SIZE) int32 histograms.
    """
    b, c, t = filtered.shape
    n_win = -(-t // win)
    pad = n_win * win - t
    f = jnp.pad(filtered, ((0, 0), (0, 0), (0, pad)))
    sq = (f * f).reshape(b, c, n_win, win)

    idx = jnp.arange(n_win * win).reshape(n_win, win)
    mask = (idx[None] < valid_len[:, None, None]).astype(f.dtype)  # (B, n_win, win)

    # lsum + rsum: mono (C == 1) doubles the same square into both sums
    # (reference add_mono_sample, src/replaygain.rs:731-740).
    ch_sum = sq.sum(axis=1) * (2.0 if c == 1 else 1.0)  # (B, n_win, win)
    sums = (ch_sum * mask).sum(axis=-1)  # (B, n_win)
    totsamp = mask.sum(axis=-1)  # (B, n_win)

    ms = sums / jnp.maximum(totsamp, 1.0) * 0.5
    val = STEPS_PER_DB * 10.0 * jnp.log10(ms + 1e-37)
    bin_idx = val.astype(jnp.int32) + HISTOGRAM_OFFSET  # trunc toward zero
    ok = (totsamp > 0) & (bin_idx >= 0) & (bin_idx < HISTOGRAM_SIZE)

    # Compare-reduce instead of scatter-add: XLA fuses the
    # (B, n_win, 12000) equality compare straight into the sum (nothing
    # materializes). Dropped windows compare against -1 and land
    # nowhere. Whether a scatter-add is faster on the GPU is unmeasured.
    bsel = jnp.where(ok, bin_idx, -1)
    iota = jnp.arange(HISTOGRAM_SIZE, dtype=jnp.int32)
    hist = jnp.sum(
        (bsel[:, :, None] == iota[None, None, :]).astype(jnp.int32), axis=1
    )
    return hist


def loudness_histogram(filtered, valid_len, sample_rate: int):
    """Per-track loudness histograms from filtered audio.

    filtered: (B, C, T) with C in {1, 2}; valid_len: (B,) valid sample
    counts (per channel) for padded batches.
    """
    return _histogram_jit(filtered, jnp.asarray(valid_len), window_size(sample_rate))


@jax.jit
def loudness_index_device(hist):
    """Device-side 95th-percentile readout, (B, 12000) int32 -> (B,) int32
    histogram bin index (-1 for an empty histogram).

    Exactly equivalent to the host readout: the reference threshold
    ceil(total * (1.0 - 0.95)) — where fl(1.0 - 0.95) > 1/20 by ~4.4e-17 —
    equals total // 20 + 1 for every attainable total, so the quirky f64
    arithmetic reduces to pure integer math (proven in tests against the
    host implementation). The dB conversion happens on host in float64.
    """
    total = hist.sum(axis=1)
    threshold = total // 20 + 1
    rev = jnp.cumsum(hist[:, ::-1], axis=1)
    k = jnp.argmax(rev >= threshold[:, None], axis=1)
    idx = HISTOGRAM_SIZE - 1 - k
    return jnp.where(total > 0, idx, -1).astype(jnp.int32)


def index_to_loudness(idx: int) -> float:
    return -20.0 if idx < 0 else (int(idx) - HISTOGRAM_OFFSET) / STEPS_PER_DB


def loudness_from_histogram_device(hist):
    """Convenience wrapper: (B, 12000) device histograms -> (B,) host floats."""
    idx = np.asarray(loudness_index_device(hist))
    return np.array([index_to_loudness(i) for i in idx])


def loudness_from_histogram(hist: np.ndarray) -> float:
    """95th-percentile loudness readout (host, reference-exact arithmetic)."""
    hist = np.asarray(hist, dtype=np.uint64)
    total = int(hist.sum())
    if total == 0:
        return -20.0
    threshold = int(np.ceil(total * (1.0 - RMS_PERCENTILE)))
    rev_cum = np.cumsum(hist[::-1])
    k = int(np.argmax(rev_cum >= threshold))
    if rev_cum[k] < threshold:
        return -20.0
    return ((HISTOGRAM_SIZE - 1 - k) - HISTOGRAM_OFFSET) / STEPS_PER_DB
