"""Equal-loudness IIR filter as a blocked linear recurrence on device.

The reference filters one sample at a time in float64
(/root/reference/src/replaygain.rs:586-616). On device the recurrence is
restructured exactly (no approximation) into matmul-friendly pieces.

Default path (MP3RGAIN_IIR_GROUP=1, gated by _group_ok conditioning):
the WHOLE 10th-order Yule stage as one blocked direct-form solve —
an (L, L+10) composite FIR∘AR-Toeplitz matmul per 128-sample block
(_group_apply) — followed by the 2nd-order Butterworth the same way.
Rates whose direct-form blocked operators grow too large (64k/96k;
88.2 kHz is degenerate in the reference's own table) fall back to the
factored biquad cascade (plan.sos), each biquad applied with the same
blocked machinery at P=2.

Block carries s_n = M s_{n-1} + v_n resolve by a two-level affine
prefix (_affine_prefix): level 1 is an (l2·P)² lower-triangular
Toeplitz matmul over superblocks of l2 carries; level 2 composes the
nb2 superblock carries either with one dense block-Toeplitz matmul
(short tracks) or a lax.associative_scan over (M^l2, carry) affine
pairs (long tracks, where the dense operator's (nb2·P)² footprint
would grow quadratically with duration).

An exact per-sample lax.scan implementation (direct-form I, the
reference's formulation) is provided as a validation oracle
(equal_loudness_scan).
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

from .. import backend
from .coeffs import DEGENERATE_RATES, DENORMAL_PREVENTION, filter_plan

DEFAULT_BLOCK = 128

# Group the five Yule biquads into ONE blocked AR(10) solve when the
# direct-form operators are well-conditioned (all rates <= 48 kHz; see
# _group_ok). Cuts the IIR stage from 6 sequential GEMM passes to 2.
GROUP = os.environ.get("MP3RGAIN_IIR_GROUP", "1") != "0"


@lru_cache(maxsize=None)
def _arP_kernels(a_tail: tuple, block: int):
    """Order-P blocked recurrence operators for y_t = f_t - sum a_k y_{t-k}.

    Returns (T_h (L, L) lower-triangular zero-state Toeplitz,
    G (L, P) homogeneous responses to unit initial states y_{-1-j} = 1,
    M (P, P) end-of-block state map, all float64). The block state is
    s = [y_{L-1}, ..., y_{L-P}]; M[i, j] = G[L-1-i, j]."""
    a = np.asarray(a_tail, dtype=np.float64)
    P = len(a)
    L = block
    h = np.zeros(L + P)
    h[0] = 1.0
    for t in range(1, L + P):
        acc = 0.0
        for k in range(1, P + 1):
            if t - k >= 0:
                acc -= a[k - 1] * h[t - k]
        h[t] = acc
    g = np.zeros((L, P))
    for j in range(P):
        hist = np.zeros(P)
        hist[j] = 1.0  # y_{-1-j} = 1
        for t in range(L):
            val = -np.dot(a, hist)
            g[t, j] = val
            hist = np.concatenate([[val], hist[:-1]])
    th = np.zeros((L, L))
    for t in range(L):
        th[t, : t + 1] = h[t::-1][: t + 1]
    m = g[L - 1 - np.arange(P), :]  # (P, P)
    return th, g, m


# Level-2 dense cross-superblock operator cap: below this many
# superblocks the whole level-2 solve is ONE (nb2*P)² matmul against a
# baked constant (~16 MB float32 at the cap for P=10); above it — long
# tracks, where the dense operator grows quadratically with duration
# (ADVICE r3: ~520 MB float64 host + ~260 MB baked constant for a
# 5-minute track) — level 2 switches to an associative scan over
# (M^l2, carry) affine pairs, whose footprint is linear in duration.
# The cap also bounds the lru_cache population: n_blocks only keys the
# dense variant, and only up to the cap.
NB2_DENSE_MAX = 204


@lru_cache(maxsize=None)
def _prefix_kernels(a_tail: tuple, block: int, nb2: int | None, l2: int):
    """Constants for the two-level affine-prefix solve of
    s_n = M s_{n-1} + v_n over first-level carries, P-dim state.

    Returns (T2 (l2*P, l2*P) local prefix operator, T3 (nb2*P, nb2*P)
    strict-lower cross-superblock operator or None when nb2 is None —
    the scan path needs only M^l2, Pw (l2, P, P) powers M^(t+1),
    Ml2 (P, P))."""
    _, _, m = _arP_kernels(a_tail, block)
    P = m.shape[0]

    powers = [np.eye(P)]
    for _ in range(l2 + 1):
        powers.append(m @ powers[-1])

    t2 = np.zeros((l2, l2, P, P))
    for t in range(l2):
        for s in range(t + 1):
            t2[t, s] = powers[t - s]
    ml2 = powers[l2]
    p = np.stack(powers[1 : l2 + 1])
    # TAP-MAJOR layout: out[(i,t)] = sum_{(j,s)} T[(i,t),(j,s)] v[(j,s)].
    # Keeping the tap axis OUTSIDE the flattened dim means no on-device
    # tensor ever carries P as its minor dimension: a (B, NB, P) f32
    # with NB in the tens of thousands tile-pads P=10 -> 128 (12.8x),
    # and XLA's remat kept 8 such 1.6 GB clones alive on a 48x90s
    # batch — a compile-time HBM OOM (measured round 4).
    t2m = t2.transpose(2, 0, 3, 1).reshape(l2 * P, l2 * P)

    t3m = None
    if nb2 is not None:
        ml2_pow = [np.eye(P)]
        for _ in range(nb2):
            ml2_pow.append(ml2 @ ml2_pow[-1])
        t3 = np.zeros((nb2, nb2, P, P))
        for t in range(nb2):
            for s in range(t):
                t3[t, s] = ml2_pow[t - 1 - s]
        t3m = t3.transpose(0, 2, 1, 3).reshape(nb2 * P, nb2 * P)
    return t2m, t3m, p, ml2


def _affine_prefix(v, a_tail: tuple, block: int, l2: int = 128):
    """s_n = M s_{n-1} + v_n (s_{-1} = 0) for v (B, P, N) TAP-MAJOR,
    fully parallel: a lower-triangular Toeplitz matmul over each
    superblock of l2 carries, then the cross-superblock solve — dense
    matmul for short tracks, associative scan of (M^l2, carry) affine
    pairs for long ones (NB2_DENSE_MAX). The (B, P, N) layout keeps the
    large block axis minor on every big tensor (a (B, N, P) layout
    pads the narrow P dim in memory; see _prefix_kernels)."""
    b, P, n = v.shape
    nb2 = -(-n // l2)
    dense = nb2 <= NB2_DENSE_MAX
    t2m, t3m, p, ml2 = _prefix_kernels(
        a_tail, block, nb2 if dense else None, l2
    )
    dtype = v.dtype
    t2m = jnp.asarray(t2m, dtype)
    p = jnp.asarray(p, dtype)

    vp = jnp.pad(v, ((0, 0), (0, 0), (0, nb2 * l2 - n)))
    vb = (
        vp.reshape(b, P, nb2, l2)
        .transpose(0, 2, 1, 3)
        .reshape(b, nb2, P * l2)
    )
    local = jnp.einsum(
        "ts,bns->bnt", t2m, vb, preferred_element_type=dtype
    ).reshape(b, nb2, P, l2)
    carries = local[:, :, :, -1]  # (B, nb2, P) — small; padding is fine
    if dense:
        s_end = jnp.einsum(
            "ts,bs->bt", jnp.asarray(t3m, dtype),
            carries.reshape(b, nb2 * P), preferred_element_type=dtype,
        ).reshape(b, nb2, P)
    else:
        # s2_m = Ml2 s2_{m-1} + c_m as an associative scan of affine
        # pairs; Ml2 is constant so the A-products are its powers (tiny
        # for the stable filters that reach here). s_prev for
        # superblock m is s2_{m-1}.
        ml2d = jnp.broadcast_to(jnp.asarray(ml2, dtype), (b, nb2, P, P))

        def combine(lhs, rhs):
            a1, b1 = lhs
            a2, b2 = rhs
            return (
                jnp.einsum("...ij,...jk->...ik", a2, a1,
                           preferred_element_type=dtype),
                jnp.einsum("...ij,...j->...i", a2, b1,
                           preferred_element_type=dtype) + b2,
            )

        _, s2 = jax.lax.associative_scan(combine, (ml2d, carries), axis=1)
        s_end = jnp.roll(s2, 1, axis=1).at[:, 0].set(0.0)
    cross = jnp.einsum("bmj,tij->bmit", s_end, p,
                       preferred_element_type=dtype)  # (B, nb2, P, l2)
    s = (
        (local + cross)
        .transpose(0, 2, 1, 3)
        .reshape(b, P, nb2 * l2)
    )
    return s[:, :, :n]


@lru_cache(maxsize=None)
def _group_kernels(b_taps: tuple, a_tail: tuple, block: int):
    """Composite blocked-IIR operator Tc (L, L+K-1) = T_h @ Band for a
    direct-form filter with K numerator taps and order-P denominator.

    Band maps the extended input block [x[-(K-1)], ..., x[-1], x[0..L-1]]
    to the FIR output f[t] = sum_k b[k] x[t-k]; T_h is the AR(P)
    zero-state Toeplitz. Folding the FIR here avoids per-sample shifted
    slices."""
    L = block
    K = len(b_taps)
    th, g, m = _arP_kernels(a_tail, block)
    band = np.zeros((L, L + K - 1))
    for t in range(L):
        for k, bk in enumerate(b_taps):
            band[t, t + K - 1 - k] = bk
    return th @ band, g, m


def _group_apply(x, b_taps: tuple, a_tail: tuple, block: int):
    """Apply a full direct-form IIR (K-tap FIR + AR(P)) along the last
    axis of (B, T), blockwise and exactly: one (L, L+K-1) matmul per
    block plus the two-level affine carry prefix. No per-sample shifts."""
    b_taps = tuple(float(c) for c in b_taps)
    a_tail = tuple(float(c) for c in a_tail)
    K = len(b_taps)
    P = len(a_tail)
    b, t = x.shape
    L = block
    nblk = -(-t // L)
    xp = jnp.pad(x, ((0, 0), (0, nblk * L - t)))
    xb = xp.reshape(b, nblk, L)

    tc, g, m = _group_kernels(b_taps, a_tail, L)
    dtype = x.dtype
    tc = jnp.asarray(tc, dtype)
    g = jnp.asarray(g, dtype)

    # Extended input block: previous block's last K-1 samples + this block.
    prev = jnp.pad(xb[:, :-1, L - (K - 1):], ((0, 0), (1, 0), (0, 0)))
    xin = jnp.concatenate([prev, xb], axis=-1)  # (B, NB, L+K-1)

    y_zs = jnp.einsum("ts,bns->bnt", tc, xin, preferred_element_type=dtype)

    # Block carry state s = [y_{L-1}, ..., y_{L-P}], built TAP-MAJOR
    # (B, P, NB) via a one-hot column selector so no large tensor ever
    # has P as its minor dim (a narrow minor dim pads in memory, and P
    # separate 1-wide slices become large rematerialized temporaries).
    sel = np.zeros((L, P))
    for i in range(P):
        sel[L - 1 - i, i] = 1.0
    v = jnp.einsum("bnt,tp->bpn", y_zs, jnp.asarray(sel, dtype),
                   preferred_element_type=dtype)
    s = _affine_prefix(v, a_tail, L)  # (B, P, NB)
    s_prev = jnp.pad(s, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]

    y = y_zs + jnp.einsum("bjn,tj->bnt", s_prev, g,
                          preferred_element_type=dtype)
    return y.reshape(b, nblk * L)[:, :t]


def _biquad_apply(x, section, block: int):
    """Apply a full biquad (FIR + AR2) along the last axis of (B, T),
    blockwise and exactly: one (L, L+2) matmul per block plus the
    two-level affine carry prefix. No per-sample shifts anywhere."""
    b0, b1, b2, a1, a2 = (float(c) for c in section)
    return _group_apply(x, (b0, b1, b2), (a1, a2), block)


@lru_cache(maxsize=None)
def _group_ok(sample_rate: int, block: int) -> bool:
    """True when the direct-form 10th-order Yule blocked operators are
    well-conditioned enough for the grouped solve (empirically: all
    rates <= 48 kHz; 64k/96k grow homogeneous responses to 1.4e3/2.1e4
    and keep the biquad cascade; 88.2k is degenerate everywhere)."""
    from .coeffs import YULE_A

    a_tail = tuple(float(c) for c in YULE_A[sample_rate][1:])
    th, g, m = _arP_kernels(a_tail, block)
    bound = max(np.max(np.abs(th)), np.max(np.abs(g)))
    return bool(np.isfinite(bound) and bound <= 128.0)


@partial(jax.jit, static_argnames=("sample_rate", "block"))
def _equal_loudness_jit(x, sample_rate: int, block: int):
    plan = filter_plan(sample_rate)
    dtype = x.dtype
    y = x
    # The blocked recurrences cancel heavily, so a plain bf16 pass costs
    # ~0.05 dB of loudness; the shared DSP precision holds the budget.
    with jax.default_matmul_precision(backend.dsp_precision()):
        y = _equal_loudness_body(y, plan, dtype, block)
    return y


def _equal_loudness_body(y, plan, dtype, block):
    if plan.sample_rate in DEGENERATE_RATES:
        # The published table row is unstable at this rate; every direct
        # implementation (the reference included) diverges and its NaN
        # windows land in histogram bin 2000 (loudness 0.0) via Rust's
        # `NaN as i32 == 0`. Produce that exact result deterministically:
        # a constant all-ones output has mean_square == 1.0 in every
        # window -> trunc(1000*log10(1)) + 2000 == bin 2000 — without
        # materializing overflowing blocked operators into the
        # _prefix_kernels/_arP_kernels caches (backend NaN->int casts
        # are implementation-defined; this path is not).
        return jnp.ones_like(y)
    if GROUP and _group_ok(plan.sample_rate, block):
        # Grouped path: the whole 10th-order Yule stage as ONE blocked
        # direct-form solve (matches the reference's own formulation,
        # src/replaygain.rs:586-599) instead of 5 sequential biquad
        # GEMM passes — ~2.5x fewer IIR FLOPs.
        from .coeffs import YULE_A

        a_tail = tuple(float(c) for c in YULE_A[plan.sample_rate][1:])
        y = _group_apply(y, tuple(plan.yule_b), a_tail, block)
        # Denormal-prevention constant of the reference (injected at
        # the yule output, src/replaygain.rs:595): preserves the
        # silence-drop histogram behavior.
        y = y + dtype.type(DENORMAL_PREVENTION)
        b = plan.butter_b
        a1, a2 = plan.butter_section
        y = _group_apply(y, (b[0], b[1], b[2]), (a1, a2), block)
        return y + dtype.type(DENORMAL_PREVENTION)
    for i, section in enumerate(plan.sos):
        if i == len(plan.sos) - 1:
            y = y + dtype.type(DENORMAL_PREVENTION)
        y = _biquad_apply(y, tuple(section), block)
    return y + dtype.type(DENORMAL_PREVENTION)


def equal_loudness(x, sample_rate: int, block: int = DEFAULT_BLOCK):
    """Equal-loudness filter along the last axis of (B, T).

    Input must already be scaled to the 16-bit sample range (×32768) as the
    ReplayGain algorithm expects (reference src/replaygain.rs:943-949).
    """
    return _equal_loudness_jit(x, sample_rate, block)


# ---------------------------------------------------------------------------
# Exact per-sample oracle (direct-form I, float64) for validation.
# ---------------------------------------------------------------------------


def equal_loudness_scan(x, sample_rate: int):
    """Reference-exact direct-form-I implementation via lax.scan (float64)."""
    from .coeffs import YULE_A

    plan = filter_plan(sample_rate)
    yb = jnp.asarray(plan.yule_b, jnp.float64)
    ya = jnp.asarray(np.array(YULE_A[sample_rate]), jnp.float64)
    bb = jnp.asarray(plan.butter_b, jnp.float64)
    ba1, ba2 = plan.butter_section

    def step(state, xt):
        # x history (11,), yule-out history (10,), butter-in (2,), butter-out (2,)
        xh, yh, bxh, byh = state
        xh = jnp.concatenate([xt[None], xh[:-1]])
        yt = DENORMAL_PREVENTION + jnp.dot(yb, xh) - jnp.dot(ya[1:], yh)
        zt = (
            DENORMAL_PREVENTION
            + bb[0] * yt
            + bb[1] * bxh[0]
            + bb[2] * bxh[1]
            - ba1 * byh[0]
            - ba2 * byh[1]
        )
        yh = jnp.concatenate([yt[None], yh[:-1]])
        return (xh, yh, jnp.stack([yt, bxh[0]]), jnp.stack([zt, byh[0]])), zt

    def run(sig):
        init = (
            jnp.zeros(11, jnp.float64),
            jnp.zeros(10, jnp.float64),
            jnp.zeros(2, jnp.float64),
            jnp.zeros(2, jnp.float64),
        )
        _, out = jax.lax.scan(step, init, sig)
        return out

    return jax.vmap(run)(x.astype(jnp.float64))
