"""JAX decode back-end: quantized spectra → PCM, batched on device.

Pipeline (all jit-compatible, static shapes per call):
  requantize → stereo (MS / intensity) → fused [alias reduction ∘
  IMDCT ∘ window] class-core GEMMs → overlap-add (a pure shift, no
  scan) → fused polyphase synthesis (frequency inversion and the DCT
  matrixing folded into two dewindowing GEMM constants).

Replaces the DSP stage of the reference's external decoder
(symphonia-bundle-mp3; used at /root/reference/src/replaygain.rs:804-904).

Design notes: the sample-rate band-table row is a static compile-time
parameter (batches are bucketed by sample rate), so every per-sample
table lookup is either a structural slice/select or a gather with
constant indices — integer-exact whatever the matmul precision. Alias
reduction, IMDCT and windowing fold into three class-core GEMMs, and the
polyphase synthesis into two more (precision: backend.dsp_precision).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

from .. import backend
from . import frontend as fe
from .tables import CLASS_OF_KIND, build_tables, row_tables


def _block_kind(info: np.ndarray) -> np.ndarray:
    """Block kind per gch: 0 long, 1 start, 2 short, 3 stop, 4 mixed."""
    bt = info[:, fe.BLOCK_TYPE]
    mixed = info[:, fe.MIXED]
    kind = bt.copy()
    kind[(bt == 2) & (mixed == 1)] = 4
    return kind.astype(np.int32)


@dataclass
class GranuleBatch:
    """Device-ready decode inputs for a fixed-shape batch of granule-channels.

    All arrays are indexed (g,) or (g, 576) where g runs over granule-channel
    records in (time, channel) order: g = t * n_channels + ch.
    """

    spectrum: jnp.ndarray  # (G, 576) int
    scf: jnp.ndarray  # (G, 64) int
    kind: jnp.ndarray  # (G,) int32 0..4
    sr_row: jnp.ndarray  # (G,) int32 (uniform; the static row is authoritative)
    global_gain: jnp.ndarray
    scalefac_scale: jnp.ndarray
    preflag: jnp.ndarray
    subblock_gain: jnp.ndarray  # (G, 3)
    block_type: jnp.ndarray
    mixed: jnp.ndarray
    ms_flag: jnp.ndarray
    is_flag: jnp.ndarray
    lsf: jnp.ndarray
    intensity_scale: jnp.ndarray
    rzero_other: jnp.ndarray
    n_channels: int


def batch_from_unpacked(u: fe.UnpackedMp3, dtype=jnp.float32) -> GranuleBatch:
    info = u.info
    nch = u.n_channels or 1
    kind = _block_kind(info)
    rzero = np.maximum(info[:, fe.BIG_END], info[:, fe.COUNT1_END])
    rz = rzero.copy()
    if nch == 2:
        rz[0::2] = rzero[1::2]
        rz[1::2] = rzero[0::2]
    joint = (info[:, fe.CHANNEL_MODE] == 1).astype(np.int32)
    ms = joint * ((info[:, fe.MODE_EXT] & 2) >> 1)
    istereo = joint * (info[:, fe.MODE_EXT] & 1)
    return GranuleBatch(
        spectrum=jnp.asarray(u.spectrum),
        scf=jnp.asarray(u.scf),
        kind=jnp.asarray(kind),
        sr_row=jnp.asarray(info[:, fe.SR_ROW]),
        global_gain=jnp.asarray(info[:, fe.GLOBAL_GAIN]),
        scalefac_scale=jnp.asarray(info[:, fe.SCALEFAC_SCALE]),
        preflag=jnp.asarray(info[:, fe.PREFLAG]),
        subblock_gain=jnp.asarray(info[:, (fe.SBG0, fe.SBG1, fe.SBG2)]),
        block_type=jnp.asarray(info[:, fe.BLOCK_TYPE]),
        mixed=jnp.asarray(info[:, fe.MIXED]),
        ms_flag=jnp.asarray(ms),
        is_flag=jnp.asarray(istereo),
        lsf=jnp.asarray((info[:, fe.VERSION] != 1).astype(np.int32)),
        intensity_scale=jnp.asarray(info[:, fe.INTENSITY_SCALE]),
        rzero_other=jnp.asarray(rz),
        n_channels=nch,
    )


def _class_masks(kind):
    """(G, 1) boolean masks for layout classes (long / short / mixed)."""
    cls = jnp.asarray(CLASS_OF_KIND)[kind]
    return [(cls == c)[:, None] for c in range(3)]


def _select_by_class(masks, variants):
    out = jnp.where(masks[0], variants[0], variants[1])
    return jnp.where(masks[2], variants[2], out)


def _per_sample_const(masks, rows, dtype=None):
    """Select a (576,) constant per class into (G, 576)."""
    rows = [jnp.asarray(r, dtype) if dtype else jnp.asarray(r) for r in rows]
    return _select_by_class(masks, [r[None, :] for r in rows])


def _reorder(x, masks, rt, dtype):
    """Apply the layout permutation: identity (long), short, or mixed
    (identity below sample 36, short above). One constant-index gather:
    exact for every spectrum value (|x| <= 8206), unlike a one-hot
    matmul, which a TF32 or bf16 pass would round."""
    del dtype
    x_perm = jnp.take(x, jnp.asarray(rt.perm_short), axis=1)
    sample_lt36 = (jnp.arange(576) < 36)[None, :]
    x_mixed = jnp.where(sample_lt36, x, x_perm)
    return _select_by_class(masks, [x, x_perm, x_mixed])


def _expand(values, index, masks):
    """Per-sample expansion of per-granule values (scalefactor slots,
    subblock-gain windows): values[:, index[class]] selected by layout
    class — constant-index gathers, exact."""
    return _select_by_class(
        masks, [jnp.take(values, jnp.asarray(index[c]), axis=1)
                for c in range(3)]
    )


def _requantize(b: GranuleBatch, rt, masks, dtype):
    """(G, 576) layout-ordered requantized spectra (gather-free)."""
    spec = b.spectrum.astype(dtype)
    spec = _reorder(spec, masks, rt, dtype)

    scf_s = _expand(b.scf.astype(dtype), rt.slot, masks)  # (G, 576)
    sbg_s = _expand(b.subblock_gain.astype(dtype), rt.win, masks)
    pre = _per_sample_const(masks, list(rt.pretab), dtype)
    short = _per_sample_const(masks, list(rt.is_short.astype(np.float32)), dtype)

    scf_mult = 0.5 * (1.0 + b.scalefac_scale.astype(dtype))[:, None]
    pre_term = jnp.where(b.preflag[:, None] == 1, pre, 0.0)
    exponent = (
        0.25 * (b.global_gain.astype(dtype) - 210.0)[:, None]
        - scf_mult * (scf_s + pre_term)
        - 2.0 * short * sbg_s
    )
    mag = jnp.abs(spec)
    xr = jnp.sign(spec) * mag ** (4.0 / 3.0) * jnp.exp2(exponent)
    return xr


_SQRT2_INV = 1.0 / np.sqrt(2.0)


def _stereo(b: GranuleBatch, xr, rt, masks, dtype):
    if b.n_channels != 2:
        return xr
    x0 = xr[0::2]
    x1 = xr[1::2]
    g0 = lambda a: a[0::2]  # noqa: E731
    masks0 = [m[0::2] for m in masks]

    # MS stereo on the full spectrum.
    ms = g0(b.ms_flag)[:, None] == 1
    left = jnp.where(ms, (x0 + x1) * _SQRT2_INV, x0)
    right = jnp.where(ms, (x0 - x1) * _SQRT2_INV, x1)

    # Intensity stereo above the right channel's nonzero bound.
    isf = g0(b.is_flag)[:, None] == 1
    band_start = _per_sample_const(masks0, list(rt.band_start))
    rzero = g0(b.rzero_other)[:, None]
    in_band = isf & (band_start >= rzero)

    is_pos = _expand(b.scf[1::2].astype(dtype), rt.slot, masks0)

    # MPEG1 intensity: ratio = tan(is_pos * pi / 12); is_pos == 7 illegal.
    angle = is_pos * (np.pi / 12.0)
    tan = jnp.tan(jnp.minimum(angle, 1.55))
    kl1 = jnp.where(is_pos == 6.0, 1.0, tan / (1.0 + tan))
    kr1 = jnp.where(is_pos == 6.0, 0.0, 1.0 / (1.0 + tan))

    # LSF intensity (ISO 13818-3 2.4.3.2). intensity_scale is parsed from
    # ch1's scalefac_compress, so it lives in the ch1 record.
    io = jnp.where(
        b.intensity_scale[1::2][:, None] == 1, dtype(_SQRT2_INV), dtype(2.0**-0.25)
    )
    half_up = jnp.floor((is_pos + 1.0) * 0.5)
    k_odd = io**half_up
    is_odd = jnp.floor(is_pos * 0.5) * 2.0 != is_pos
    kl2 = jnp.where(is_odd, k_odd, 1.0)
    kr2 = jnp.where(
        is_odd, 1.0, jnp.where(is_pos == 0.0, 1.0, io ** jnp.floor(is_pos * 0.5))
    )

    lsf = g0(b.lsf)[:, None] == 1
    kl = jnp.where(lsf, kl2, kl1)
    kr = jnp.where(lsf, kr2, kr1)
    illegal = (~lsf) & (is_pos == 7.0)

    apply_i = in_band & ~illegal
    left = jnp.where(apply_i, kl * x0, left)
    right = jnp.where(apply_i, kr * x0, right)

    g, s = xr.shape
    out = jnp.stack([left, right], axis=1).reshape(g, s)
    return out.astype(xr.dtype)


# Alias-reduction butterfly coefficients (derived from the ISO ci values).
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_CS = (1.0 / np.sqrt(1.0 + _CI**2)).astype(np.float64)
_CA = (_CI / np.sqrt(1.0 + _CI**2)).astype(np.float64)


@lru_cache(maxsize=None)
def _alias_matrices():
    """Alias reduction as (576, 576) linear maps: identity plus, at each
    subband boundary sb, 8 butterflies pairing line 18*sb+17-i with
    18*sb+18+i (ISO 11172-3 2.4.3.4.10.1). A_long applies all 31
    boundaries; A_mixed boundary 0 only."""
    a_long = np.eye(576, dtype=np.float64)
    a_mixed = np.eye(576, dtype=np.float64)
    for sb in range(31):
        targets = (a_long, a_mixed) if sb == 0 else (a_long,)
        for i in range(8):
            a = 18 * sb + 17 - i
            b2 = 18 * sb + 18 + i
            for mat in targets:
                mat[a, a] = _CS[i]
                mat[b2, a] = -_CA[i]
                mat[b2, b2] = _CS[i]
                mat[a, b2] = _CA[i]
    return a_long, a_mixed


@lru_cache(maxsize=None)
def _fused_hybrid_cores():
    """Alias reduction ∘ IMDCT ∘ window as THREE (576, 1152) maps, one
    per layout class, with output columns ordered [head(576) | tail(576)]
    in hybrid line layout (col 18*sb + i).

    Replaces the 2 alias GEMMs + 8 per-block-type IMDCT GEMMs of the
    unfused path with 3 GEMMs: the 36-point IMDCT core is common to
    block types 0/1/3 (only the 36-line window differs — applied
    per-granule elementwise afterwards), the short composite and the
    mixed splice bake their windows, and the alias butterflies (linear,
    class-determined) fold into the input side. Matrices are built in
    f64 and cast once.
    """
    from .tables import _window_long, build_tables

    t = build_tables()
    i = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    core36 = np.cos(np.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
    short_m = t.imdct[2]  # windowed short composite (36, 18)
    long_m0 = t.imdct[0]  # windowed long (mixed blocks, sb < 2)

    def blockdiag(mat_of_sb):
        c = np.zeros((576, 1152))
        for sb in range(32):
            m = mat_of_sb(sb)  # (36, 18): [out line w, input line mm]
            sl = slice(18 * sb, 18 * sb + 18)
            c[sl, sl] = m[:18].T
            c[sl, slice(576 + 18 * sb, 576 + 18 * sb + 18)] = m[18:].T
        return c

    a_long, a_mixed = _alias_matrices()
    core_long = a_long @ blockdiag(lambda sb: core36)  # unwindowed
    core_short = blockdiag(lambda sb: short_m)  # window baked
    core_mixed = a_mixed @ blockdiag(
        lambda sb: long_m0 if sb < 2 else short_m
    )

    wins = np.zeros((4, 1152))
    for bt in (0, 1, 3):
        w = _window_long(bt)
        for sb in range(32):
            wins[bt, 18 * sb : 18 * sb + 18] = w[:18]
            wins[bt, 576 + 18 * sb : 576 + 18 * sb + 18] = w[18:]
    return core_long, core_short, core_mixed, wins


def _imdct_overlap_fused(b: GranuleBatch, xr, masks, dtype):
    """(G, 576) → (T, nch, 576) windowed hybrid outputs, fused form.

    Three class-core GEMMs (alias folded, head|tail column split baked),
    per-granule long-window select, then the same pure-shift overlap-add
    as the unfused path. Frequency inversion is folded into the
    polyphase tail matrices (_tail_matrices_fused), not applied here."""
    core_l, core_s, core_m, wins = _fused_hybrid_cores()
    z_l = jnp.dot(xr, jnp.asarray(core_l, dtype), preferred_element_type=dtype)
    z_s = jnp.dot(xr, jnp.asarray(core_s, dtype), preferred_element_type=dtype)
    z_m = jnp.dot(xr, jnp.asarray(core_m, dtype), preferred_element_type=dtype)

    wins = jnp.asarray(wins, dtype)
    bt = b.block_type
    win = jnp.where(
        (bt == 1)[:, None], wins[1][None, :],
        jnp.where((bt == 3)[:, None], wins[3][None, :], wins[0][None, :]),
    )
    z = _select_by_class(masks, [z_l * win, z_s, z_m])

    g = xr.shape[0]
    nch = b.n_channels
    t = g // nch
    head = z[:, :576].reshape(t, nch, 576)
    tail = z[:, 576:].reshape(t, nch, 576)
    prev_tail = jnp.concatenate(
        [jnp.zeros_like(tail[:1]), tail[:-1]], axis=0
    )
    return head + prev_tail  # (T, nch, 576)


def _synth_kernel() -> np.ndarray:
    """Combined synthesis kernel W (16 taps, 64 in, 32 out):
    PCM_t[j] = sum_k sum_u V[t-k, u] * W[k, u, j]."""
    t = build_tables()
    w = np.zeros((16, 64, 32))
    j = np.arange(32)
    for k in range(16):
        cols = j if k % 2 == 0 else 32 + j
        w[k, cols, j] = t.synth_d[k]
    return w


@lru_cache(maxsize=None)
def _tail_matrices():
    """Polyphase synthesis as three GEMM constants over 576/1152 columns.

    V-row layout per granule-time t: column 64*i + u = V value u of slot
    ts = 18*t + i. N18 does the DCT matrixing from hybrid columns
    (18*sb + i); A/B do the 16-tap dewindowing — a tap reaches at most
    17 slots back, so PCM_t = V_t @ A + V_{t-1} @ B exactly (the old
    conv's 15-zero causal padding = the all-zero V_{-1})."""
    tbs = build_tables()
    n = tbs.synth_n  # (64, 32)
    n18 = np.zeros((576, 1152))
    for sb in range(32):
        for i in range(18):
            n18[18 * sb + i, 64 * i : 64 * i + 64] = n[:, sb]

    w = _synth_kernel()  # (16, 64, 32)
    a = np.zeros((1152, 576))
    b = np.zeros((1152, 576))
    for i in range(18):
        for ip in range(18):
            k = ip - i
            if 0 <= k <= 15:
                a[64 * i : 64 * i + 64, 32 * ip : 32 * ip + 32] = w[k]
            k2 = 18 + ip - i
            if 0 <= k2 <= 15:
                b[64 * i : 64 * i + 64, 32 * ip : 32 * ip + 32] = w[k2]
    return n18, a, b


@lru_cache(maxsize=None)
def _tail_matrices_fused():
    """Polyphase synthesis folded to TWO (576, 576) maps.

    PCM_t = V_t @ A + V_{t-1} @ B with V_t = out18_t @ N18, so
    PCM_t = out18_t @ (N18 @ A) + out18_{t-1} @ (N18 @ B): the (1/18)-
    dense DCT matrixing disappears into the dewindowing constants —
    ~3.3x fewer tail FLOPs and no (T, nch, 1152) intermediate. The
    frequency-inversion sign pattern (odd subbands, odd samples) is a
    per-input-row diagonal and folds into the same constants."""
    n18, a, b = _tail_matrices()
    col = np.arange(576)
    sign = np.where(((col // 18) % 2 == 1) & ((col % 18) % 2 == 1), -1.0, 1.0)
    return sign[:, None] * (n18 @ a), sign[:, None] * (n18 @ b)


def _synthesis(out18, dtype):
    """(T, nch, 576) hybrid outputs → (nch, T*576) PCM, two GEMMs.

    Every tensor keeps a 576-wide minor dim: the earlier einsum+conv
    formulation pivoted through (C, T*18, 32)/(C, 64, TS) layouts whose
    narrow minor dims XLA could materialize at up to 7x tiling padding
    (HBM OOM on some batch shapes)."""
    na, nb = _tail_matrices_fused()
    t, nch = out18.shape[0], out18.shape[1]
    prev = jnp.concatenate([jnp.zeros_like(out18[:1]), out18[:-1]], axis=0)
    pcm = (
        jnp.dot(out18, jnp.asarray(na, dtype), preferred_element_type=dtype)
        + jnp.dot(prev, jnp.asarray(nb, dtype), preferred_element_type=dtype)
    )  # (T, nch, 576)
    return pcm.transpose(1, 0, 2).reshape(nch, t * 576)


@partial(jax.jit, static_argnames=("n_channels", "sr_row", "dtype"))
def _decode_jit(spectrum, scf, kind, sr_row_arr, global_gain, scalefac_scale,
                preflag, subblock_gain, block_type, mixed, ms_flag, is_flag,
                lsf, intensity_scale, rzero_other, n_channels, sr_row, dtype):
    b = GranuleBatch(
        spectrum=spectrum, scf=scf, kind=kind, sr_row=sr_row_arr,
        global_gain=global_gain, scalefac_scale=scalefac_scale,
        preflag=preflag, subblock_gain=subblock_gain, block_type=block_type,
        mixed=mixed, ms_flag=ms_flag, is_flag=is_flag, lsf=lsf,
        intensity_scale=intensity_scale, rzero_other=rzero_other,
        n_channels=n_channels,
    )
    rt = row_tables(sr_row)
    masks = _class_masks(b.kind)
    with jax.default_matmul_precision(backend.dsp_precision()):
        xr = _requantize(b, rt, masks, dtype)
        xr = _stereo(b, xr, rt, masks, dtype)
        out18 = _imdct_overlap_fused(b, xr, masks, dtype)
        return _synthesis(out18, dtype)


def decode_batch(b: GranuleBatch, sr_row: int, dtype=jnp.float32) -> jnp.ndarray:
    """Decode a granule batch to PCM, shape (n_channels, n_samples)."""
    return _decode_jit(
        b.spectrum, b.scf, b.kind, b.sr_row, b.global_gain, b.scalefac_scale,
        b.preflag, b.subblock_gain, b.block_type, b.mixed, b.ms_flag,
        b.is_flag, b.lsf, b.intensity_scale, b.rzero_other,
        n_channels=b.n_channels, sr_row=sr_row, dtype=dtype,
    )


def decode_file(path, dtype=jnp.float32) -> tuple[np.ndarray, int]:
    """Full-file decode; returns (pcm (C, N) float, sample_rate)."""
    u = fe.unpack_file(path)
    if u.n == 0:
        return np.zeros((1, 0), dtype=np.float32), 0
    b = batch_from_unpacked(u, dtype=dtype)
    sr_row = int(u.info[0, fe.SR_ROW])
    pcm = decode_batch(b, sr_row, dtype=dtype)
    return np.asarray(pcm), u.sample_rate
