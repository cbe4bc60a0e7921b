"""Device-side AAC spectral prep: requantize + PNS + stereo on-chip.

Replaces the host requant/PNS/stereo/TNS stages of the AAC front-end
(reference analysis path: /root/reference/src/replaygain.rs:779-785 via
the symphonia AAC codec): the host ships QUANTIZED integer coefficients
plus per-band metadata (decode/aac_frontend.unpack_adts_q), and this
module replays ISO 14496-3 requantization (|q|^(4/3) * 2^(0.25(sf-100)),
4.6.3), perceptual noise substitution (4.6.13) and M/S + intensity
stereo (4.6.8) as batched XLA ops — elementwise work plus 0/1
(64 -> 1024) scalefactor-band expansion matmuls at full float32.

The quantized spectrum ships as two signed 4-bit coefficients per byte
(the payload's dominant term; |q| <= 7 covers ~98.6% of coefficients on
real AAC content) with every |q| > 7 coefficient in a sparse escape
sideband (flat index row*1024+pos int32, exact int16 value) that a
device scatter-add reconstructs exactly. Band metadata packs into one
uint16 per band — bits 0-11 the scalefactor/PNS-energy/intensity-
position value biased by +2048, bits 12-14 the band type, bit 15
ms_used — over n_bands(sr) slots (num_swb rounded to 4), not all 64.
Payload size sets the host->device transfer time, hence the aggressive
packing. Frames the
device path cannot express (EIGHT_SHORT windows, TNS, |q| > int16)
arrive as fully host-decoded f16 fallback rows and are row-gathered
over the computed spectra at the end (frame-granular, so a device lane
never reads a fallback lane through the stereo coupling).

PNS noise is decoder-specific by design (energies must match, values
need not — the host decoder documents the same stance); the device path
uses a counter-hash LCG keyed by (lane, position), energy-normalized
per band exactly like the host (_native/aacdec.cpp apply_pns).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from .aac_format_tables import SWB_1024_MAP, SWB_LONG_TABLES
from .aac_frontend import ADTS_SR_INDEX

N_BANDS = 64  # host-side band slots (num_swb <= 51 for all rates)


def _exact(a, b):
    """Band <-> coefficient expansion and band sums against the 0/1
    band_expand_matrix, at full float32 (a TF32 or bf16 pass would round
    the gains and energies it selects)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


@lru_cache(maxsize=None)
def n_bands(sample_rate: int) -> int:
    """Transfer band-slot count for one sample rate: the long-window
    num_swb rounded up to a multiple of 4. The host decoder's fixed
    64-slot form is trimmed to this before transfer (band metadata is
    ~18% of the batch payload; slots past num_swb are always zero)."""
    swb = SWB_LONG_TABLES[SWB_1024_MAP[ADTS_SR_INDEX[sample_rate]]]
    return -(-(len(swb) - 1) // 4) * 4


@lru_cache(maxsize=None)
def band_expand_matrix(sample_rate: int) -> np.ndarray:
    """(n_bands(sr), 1024) 0/1 expansion: per-band values -> per-
    coefficient (long windows; the device path never sees EIGHT_SHORT
    frames)."""
    swb = SWB_LONG_TABLES[SWB_1024_MAP[ADTS_SR_INDEX[sample_rate]]]
    e = np.zeros((n_bands(sample_rate), 1024), dtype=np.float32)
    for k in range(len(swb) - 1):
        e[k, swb[k] : swb[k + 1]] = 1.0
    return e


def _noise_uniform(rows: int, cols: int):
    """Deterministic white noise in [-1, 1): an LCG-style integer hash
    keyed by (row, col). int32 multiplies wrap (two's complement), which
    is exactly the LCG arithmetic."""
    key = (
        jnp.arange(rows, dtype=jnp.int32)[:, None] * jnp.int32(1024)
        + jnp.arange(cols, dtype=jnp.int32)[None, :]
    )
    s = key * jnp.int32(-1640531527)  # 2654435761 as int32 (Knuth hash)
    s = s ^ (s >> 16)
    s = s * jnp.int32(1664525) + jnp.int32(1013904223)
    s = s ^ (s >> 13)
    s = s * jnp.int32(1664525) + jnp.int32(1013904223)
    return s.astype(jnp.float32) * jnp.float32(1.0 / 2147483648.0)


def prep_spectra(spec_q4, meta, esc_idx, esc_val,
                 fb16, fbexp, fbmap,
                 *, sample_rate: int, n_channels: int, dtype=jnp.float32):
    """Quantized batch -> requantized natural-order spectra (B, F, 1024).

    spec_q4 (B, F, EXT/2) int8, two signed nibbles per byte (low nibble
    = even coefficient), trimmed to the batch's coded-band extent;
    coefficients outside [-7, 7] arrive sparsely as esc_idx/esc_val
    (flat coefficient index row*1024 + pos int32, exact int16 value —
    the nibble holds 0 there, so a scatter-ADD reconstructs them;
    padding entries add 0 at index 0); meta (B, F, n_bands(sr)) uint16
    = (lvl + 2048) | btype << 12 | ms_used << 15; fb16/fbexp the
    compacted fallback rows; fbmap (B*F,) row-gather map (identity, or
    B*F + j for fallback lanes).
    """
    bsz, fl, exth = spec_q4.shape
    ext = exth * 2
    rows = bsz * fl
    e_mat = jnp.asarray(band_expand_matrix(sample_rate), jnp.float32)

    b = jnp.asarray(spec_q4).reshape(rows, exth)
    lo = ((b << 4) >> 4).astype(jnp.float32)  # int8 shifts sign-extend
    hi = (b >> 4).astype(jnp.float32)
    q = jnp.stack([lo, hi], axis=-1).reshape(rows, ext)
    if ext < 1024:
        q = jnp.pad(q, ((0, 0), (0, 1024 - ext)))
    q = q.at[esc_idx >> 10, esc_idx & 1023].add(
        esc_val.astype(jnp.float32)
    )

    m = meta.astype(jnp.int32).reshape(rows, n_bands(sample_rate))
    btype = (m >> 12) & 7
    msb = ((m >> 15) & 1).astype(jnp.float32)
    lvlf = (m & 0xFFF).astype(jnp.float32) - 2048.0

    # Requantize: sign(q) * |q|^(4/3) * 2^(0.25 (sf - 100) - 15), the -15
    # mapping int16 full scale to 1.0 (host parse_scale_factor_data).
    gain_b = jnp.exp2(0.25 * (lvlf - 100.0) - 15.0)
    gain_c = _exact(jnp.where(btype == 1, gain_b, 0.0), e_mat)  # (R, 1024)
    mag = jnp.power(jnp.abs(q), jnp.float32(4.0 / 3.0))
    spec = jnp.sign(q) * mag * gain_c

    # PNS: energy-normalized white noise per band (host apply_pns).
    noise_b = (btype == 2).astype(jnp.float32)
    r = _noise_uniform(rows, 1024)
    nrg = r * r
    e_band = _exact(nrg, e_mat.T)  # (R, 64) per-band raw noise energy
    scale_b = noise_b * gain_b * jax.lax.rsqrt(e_band + 1e-30)
    spec = spec + r * _exact(scale_b, e_mat)

    if n_channels == 2:
        # M/S + intensity, replaying _native/aacdec.cpp apply_stereo:
        # per band (flags from the RIGHT channel): intensity bands
        # reconstruct right from (post-PNS, pre-M/S) left; else ms_used
        # bands that are not noise get l,r = l+r, l-r.
        t = fl // 2
        sp = spec.reshape(bsz, t, 2, 1024)
        nb = n_bands(sample_rate)
        bt_r = btype.reshape(bsz, t, 2, nb)[:, :, 1]
        ms_r = msb.reshape(bsz, t, 2, nb)[:, :, 1]
        isp_r = lvlf.reshape(bsz, t, 2, nb)[:, :, 1]
        l = sp[:, :, 0]
        rr = sp[:, :, 1]

        is_b = (bt_r == 3) | (bt_r == 4)
        sgn_b = jnp.where(bt_r == 3, 1.0, -1.0)
        sgn_b = jnp.where(ms_r > 0, -sgn_b, sgn_b)  # ms_used inverts
        is_scale_b = jnp.where(is_b, sgn_b * jnp.exp2(-0.25 * isp_r), 0.0)
        ms_b = (ms_r > 0) & (~is_b) & (bt_r != 2)

        is_c = _exact(is_b.astype(jnp.float32), e_mat) > 0
        is_scale_c = _exact(is_scale_b, e_mat)
        ms_c = _exact(ms_b.astype(jnp.float32), e_mat) > 0

        l2 = jnp.where(ms_c, l + rr, l)
        r2 = jnp.where(is_c, is_scale_c * l, jnp.where(ms_c, l - rr, rr))
        spec = jnp.stack([l2, r2], axis=2).reshape(rows, 1024)

    # Fallback merge: host-decoded rows overwrite their lanes entirely
    # (fb16 ships as float16 — the host buffer is a free numpy view of
    # the native uint16 f16 bits).
    fb = fb16.astype(jnp.float32)
    fb = fb * jnp.exp2(fbexp.astype(jnp.float32))[:, None]
    full = jnp.concatenate([spec, fb], axis=0)[fbmap]
    return full.reshape(bsz, fl, 1024).astype(dtype)
