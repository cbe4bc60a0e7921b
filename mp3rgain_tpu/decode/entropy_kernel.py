"""Device-side MP3 entropy decode: a Pallas Huffman kernel (Triton route).

The host ships raw main-data words instead of decoded spectra, so the
host->device payload is the bitstream itself and the Huffman stage runs
on the device.

Architecture:
  - one lane per granule-channel; a program decodes a block of `lanes`
    lanes in lockstep, all per-lane state in (lanes,) registers;
  - the host sorts lanes by estimated step count (native counting
    sort), so a block's loop bound — the max over its own lanes, taken
    in the kernel — tracks its longest lane, not the batch's;
  - per step each lane decodes ONE spectral item: an (x, y) pair in the
    big-values region, or a 4-value quad in count1;
  - bits come from a per-lane gather of three consecutive big-endian
    words at the lane's bit position in the flat word buffer (each lane
    reads its own window at its own offset);
  - codes resolve through per-lane gathers from small flat tables that
    stay in L1/L2: an 8-bit primary window, long codes through 5- then
    6-bit continuation windows (8 + 5 + 6 = 19 bits, the longest code),
    count1 quads through a 6-bit window (entropy_tables.build_luts);
    escape linbits and sign bits are shift arithmetic;
  - values scatter straight into the (npad, 576) int16 spectrum at the
    lane's source row (big pair n at columns 2n, 2n+1; count1 quad q at
    2*big_end + 4q), exactly matching the host decoder
    (_native/mp3dec.cpp decode_spectrum, incl. the count1 overshoot
    rewind and the zero-spectrum-on-overrun rule).

Oracle: mg_mp3_unpack (full host decode) — tests/test_entropy_kernel.py
asserts exact integer spectrum equality on all fixture classes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import backend
from ..native import _lib as _native_lib
from . import frontend as fe
from .entropy_tables import F2_L3, GROUP_COUNT1_A, build_luts

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_native_lib.mg_entropy_pack_flat.restype = None
_native_lib.mg_entropy_pack_flat.argtypes = [
    _u64p, _u64p, ctypes.c_int64, _i32p, ctypes.c_int64, ctypes.c_int64,
    _i32p, _i32p, _i32p, _u16p,
]

# Granule-channels per program (a power of two, as Triton requires) and
# warps per program: one lane per thread. On an H100 (700 W) the 64x60 s
# stereo batch (588k lanes) decodes in 12.2 ms at 128 lanes / 4 warps
# and 12.4 ms at 256 / 8, against 19.4 ms at two lanes per thread
# (256 / 4, 512 / 4 lanes alike).
LANES = 128
NUM_WARPS = 4
# Per-lane decode metadata travels bit-packed as 5 uint16 rows; layout
# in _native/mp3dec.cpp mg_entropy_pack_flat (keep in sync):
#   w0: p23[0:12]  | p0[12:15] | count1_table_bit[15]  (gcnt = bit + 16)
#   w1: bvp[0:9]   | g0[9:13]
#   w2: r0p[0:9]   | g1[9:13]
#   w3: r1p[0:9]   | g2[9:13]
#   w4: l0[0:4] | l1[4:8] | l2[8:12]
META_ROWS = 5
MAX_STEPS = 288  # >= bvp + (576-2*bvp)/4 for all legal streams
# Words the kernel may read past a lane's window start: the deepest
# extract reaches 19 code bits + 28 escape/sign bits past a position up
# to 31 bits into its word, i.e. word index +2 from the fetch base.
TAIL_WORDS = 3


def _ladder(value: int, unit_shift: int) -> int:
    """Round up to a geometric ladder with 2**unit_shift steps/octave."""
    v = max(int(value), 1)
    unit = 1 << max((v - 1).bit_length() - unit_shift, 0)
    return -(-v // unit) * unit


def quantize_nb(nb: int) -> int:
    """Block count on a half-octave ladder (1, 2, 3, 4, 6, 8, 12, ...):
    the block count keys both the kernel and the analysis tail, so the
    ladder bounds the compiled-executable population across batch
    sizes. Padding blocks carry zero metadata: their loop bounds are 0
    and they cost ~nothing on the device."""
    return _ladder(nb, 1)


def _quantize_words(words: int) -> int:
    """Word-buffer length on a 1/32-octave ladder (<= ~3% padding): the
    buffer length keys only the small kernel executable, while it is
    most of the h2d payload."""
    return _ladder(max(int(words), 1024), 5)


@lru_cache(maxsize=None)
def _luts_flat():
    """The cascade LUTs as one flat int32 table of entries
    ``field0 | field1 << 8`` (entropy_tables.build_luts layout), with the
    table offsets: A[g*256 + win8], B[gid*32 + win5], C[gid*64 + win6],
    CT[g*64 + win6]."""
    lut_a, lut_b, lut_c, lut_ct, n_l2, n_l3 = build_luts()

    def flat(lut):
        lut = lut.astype(np.int32)
        groups = lut.shape[1] // 2
        return np.concatenate(
            [lut[:, 2 * g] | (lut[:, 2 * g + 1] << 8) for g in range(groups)]
        )

    parts = [flat(lut_a), flat(lut_b), flat(lut_c), flat(lut_ct)]
    offs = np.cumsum([0] + [len(p) for p in parts])[:4]
    return np.concatenate(parts).astype(np.int32), tuple(int(o) for o in offs)


def _kernel(lanes: int, n_words: int, offs):
    L = lanes
    _, off_b, off_c, off_ct = offs
    wmax = n_words - TAIL_WORDS

    def kernel(buf_ref, woff_ref, rows_ref, meta_ref, lut_ref, _spec_in,
               spec_ref, ends_ref):
        i32 = jnp.int32
        u32 = jnp.uint32
        pid = pl.program_id(0)
        woff = woff_ref[pl.ds(pid * L, L)]
        rows = rows_ref[pl.ds(pid * L, L)]
        base_out = rows * 576
        w = [meta_ref[pl.ds((pid * META_ROWS + r) * L, L)]
             for r in range(META_ROWS)]
        p23 = w[0] & 0xFFF
        p0 = (w[0] >> 12) & 7
        gcnt = ((w[0] >> 15) & 1) + 16 - GROUP_COUNT1_A
        bvp = w[1] & 511
        g0 = (w[1] >> 9) & 15
        r0p = w[2] & 511
        g1 = (w[2] >> 9) & 15
        r1p = w[3] & 511
        g2 = (w[3] >> 9) & 15
        l0 = w[4] & 15
        l1 = (w[4] >> 4) & 15
        l2 = (w[4] >> 8) & 15
        pend = p0 + p23

        def extractor(p):
            """Bit extractor for windows within ~78 bits after `p`."""
            wi = jnp.minimum(woff + (p >> 5), wmax)
            u = [buf_ref[wi + d].astype(u32) for d in range(3)]
            zero_u = jnp.zeros_like(u[0])
            base_bit = (p >> 5) << 5

            def sel3(j, a, b, c):
                return jnp.where(j == 0, a, jnp.where(j == 1, b, c))

            def extract(qbit, nbits):
                """Top `nbits` (static, <= 28) bits at absolute bit qbit."""
                rel = qbit - base_bit  # 0..~78
                j = rel >> 5
                r = (rel & 31).astype(u32)
                wa = sel3(j, u[0], u[1], u[2])
                wb = sel3(j, u[1], u[2], zero_u)
                cat = jnp.where(
                    r == 0, wa, (wa << r) | (wb >> (u32(32) - r))
                )
                return (cat >> u32(32 - nbits)).astype(i32)

            return extract

        def lut(idx):
            e = lut_ref[idx]
            return e & 255, e >> 8

        def put(col, val, mask):
            plgpu.store(spec_ref.at[base_out + col], val.astype(jnp.int16),
                        mask=mask)

        # --- phase 1: big values; pair n lands at columns (2n, 2n+1) ----
        def big_step(k, carry):
            p, n, alive, bad_ever = carry
            can = (k < bvp) & (p < pend) & (alive == 1)
            extract = extractor(p)
            in0 = n < r0p
            in1 = n < r1p
            gbig = jnp.where(in0, g0, jnp.where(in1, g1, g2))
            linb = jnp.where(in0, l0, jnp.where(in1, l1, l2))

            ab1, af = lut(gbig * 256 + extract(p, 8))
            adv1 = af & 15
            flag1 = af >> 4
            cont = (flag1 == 1) & can
            bad = (flag1 == 3) & can
            # Continuation levels: a 5-bit then a 6-bit window over
            # content-deduped groups (non-continuing lanes read group 0).
            ab2, f2 = lut(off_b + jnp.where(cont, ab1, 0) * 32
                          + extract(p + 8, 5))
            cont3 = cont & (f2 == F2_L3)
            ab3, rem3 = lut(off_c + jnp.where(cont3, ab2, 0) * 64
                            + extract(p + 13, 6))
            bad = bad | (cont & (f2 == 0)) | (cont3 & (rem3 == 0))

            abf = jnp.where(cont3, ab3, jnp.where(cont, ab2, ab1))
            x = abf & 15
            y = abf >> 4
            clen = jnp.where(cont3, 13 + rem3, jnp.where(cont, 8 + f2, adv1))

            # Escape linbits + sign bits: one 28-bit window covers the
            # worst case linbits_x(13) + sign_x(1) + linbits_y(13) +
            # sign_y(1).
            qq = p + clen
            e = extract(qq, 28)
            ex = (x == 15) & (linb > 0)
            xv = x + jnp.where(ex, e >> (28 - linb), 0)
            lx = jnp.where(ex, linb, 0)
            sx = (xv != 0) & can
            xv = jnp.where(sx & (((e >> (27 - lx)) & 1) == 1), -xv, xv)
            o = lx + sx.astype(i32)
            ey = (y == 15) & (linb > 0)
            liny = (e >> (28 - o - linb)) & ((1 << linb) - 1)
            yv = y + jnp.where(ey, liny, 0)
            ly = jnp.where(ey, linb, 0)
            sy = (yv != 0) & can
            yv = jnp.where(sy & (((e >> (27 - o - ly)) & 1) == 1), -yv, yv)
            p_big = qq + o + ly + sy.astype(i32)

            emit = can & (~bad)
            put(2 * n, xv, emit)
            put(2 * n + 1, yv, emit)
            p = jnp.where(emit, p_big, p)
            n = n + emit.astype(i32)
            alive = jnp.where(bad, 0, alive)
            bad_ever = jnp.where(bad, 1, bad_ever)
            return p, n, alive, bad_ever

        zero = jnp.zeros_like(bvp)
        p, n, alive, bad_ever = lax.fori_loop(
            0, jnp.max(bvp), big_step, (p0, zero, zero + 1, zero)
        )

        # --- phase 2: count1 quads; quad q at columns 2n + 4q .. +3 -----
        quads = jnp.maximum(jnp.minimum((576 - 2 * bvp) >> 2, p23), 0)

        def cnt_step(_, carry):
            p, q, alive, bad_ever = carry
            col = 2 * n + 4 * q
            can = (p < pend) & (alive == 1) & (col + 4 <= 576)
            extract = extractor(p)
            v, af = lut(off_ct + gcnt * 64 + extract(p, 6))
            adv1 = af & 15
            bad = ((af >> 4) == 3) & can
            qq = p + adv1
            sb = extract(qq, 4)  # up to 4 sign bits
            v3 = (v >> 3) & 1
            v2 = (v >> 2) & 1
            v1 = (v >> 1) & 1
            v0 = v & 1
            o1 = v3
            o2 = o1 + v2
            o3 = o2 + v1
            p_cnt = qq + o3 + v0
            over = can & (p_cnt > pend)
            emit = can & (~over) & (~bad)
            put(col, jnp.where(v3 == 1, 1 - 2 * ((sb >> 3) & 1), 0), emit)
            put(col + 1, jnp.where(v2 == 1, 1 - 2 * ((sb >> (3 - o1)) & 1), 0),
                emit)
            put(col + 2, jnp.where(v1 == 1, 1 - 2 * ((sb >> (3 - o2)) & 1), 0),
                emit)
            put(col + 3, jnp.where(v0 == 1, 1 - 2 * ((sb >> (3 - o3)) & 1), 0),
                emit)
            p = jnp.where(emit, p_cnt, p)
            q = q + emit.astype(i32)
            alive = jnp.where(bad | over, 0, alive)
            bad_ever = jnp.where(bad, 1, bad_ever)
            return p, q, alive, bad_ever

        p, q, alive, bad_ever = lax.fori_loop(
            0, jnp.max(quads), cnt_step, (p, zero, alive, bad_ever)
        )

        # A lane that hit an invalid code decodes to an all-zero spectrum
        # (host rule): clear what it wrote before going bad.
        is_bad = bad_ever == 1
        written = 2 * n + 4 * q

        def clear(c, carry):
            put(c, zero, is_bad & (c < written))
            return carry

        lax.fori_loop(0, jnp.max(jnp.where(is_bad, written, 0)), clear, ())

        base_e = rows * 4
        for f, val in enumerate((
            jnp.where(is_bad, 0, 2 * n),        # big_end
            jnp.where(is_bad, 0, written),      # count1_end
            bad_ever,
            zero,
        )):
            plgpu.store(ends_ref.at[base_e + f], val)

    return kernel


@lru_cache(maxsize=None)
def _decode_call(nb: int, n_words: int, lanes: int, interpret: bool):
    """Jitted entropy stage: (buf, woff, rows, uint16 meta) ->
    (spectrum (npad, 576) int16, ends (npad, 4) int32), rows in input
    order. Compile key: block count, word-buffer length, lanes."""
    backend.require_route("MP3 entropy kernel", interpret)
    table, offs = _luts_flat()
    npad = nb * lanes
    call = pl.pallas_call(
        _kernel(lanes, n_words, offs),
        grid=(nb,),
        out_shape=(
            jax.ShapeDtypeStruct((npad * 576,), jnp.int16),
            jax.ShapeDtypeStruct((npad * 4,), jnp.int32),
        ),
        # The spectrum starts as zeros: only decoded columns are written.
        input_output_aliases={5: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="mp3_entropy",
    )

    @jax.jit
    def run(buf, woff, rows, meta):
        # meta ships as uint16 (halves the h2d payload); widen once here.
        spec, ends = call(
            buf, woff, rows, meta.reshape(-1).astype(jnp.int32),
            jnp.asarray(table), jnp.zeros((npad * 576,), jnp.int16),
        )
        return spec.reshape(npad, 576), ends.reshape(npad, 4)

    return run


def decode_blocks(buf, woff, rows, meta, *, nb: int, lanes: int = LANES,
                  interpret: bool | None = None):
    """Run the kernel over sorted blocks. Returns (spectrum (npad, 576)
    int16, ends (npad, 4) int32 [big_end, count1_end, bad, 0]), both in
    input row order; bad rows read as zero spectra with ends 0.

    Dispatchable as its own executable so a fresh word-buffer length
    recompiles only this small program, not the analysis tail."""
    if interpret is None:
        interpret = backend.interpret_kernels()
    return _decode_call(nb, int(buf.shape[0]), lanes, interpret)(
        buf, woff, rows, meta
    )


@dataclass
class PreparedEntropy:
    """Host-prepped kernel inputs for one batch of granule-channels.

    The numpy arrays are the exact device transfer payload; nb, lanes and
    buf.shape are the static compile keys. buf and meta come from the
    shared buffer pool — hand them back (utils.bufpool.give) once the
    device transfer completes.
    """

    buf: np.ndarray  # (n_words,) int32 big-endian window words, flat
    woff: np.ndarray  # (npad,) int32 word offset of each sorted lane
    rows: np.ndarray  # (npad,) int32 source row of each sorted lane
    meta: np.ndarray  # (nb, META_ROWS, lanes) uint16
    nb: int
    n: int  # real (unpadded) row count
    lanes: int = LANES

    @property
    def npad(self) -> int:
        return self.nb * self.lanes

    @property
    def n_words(self) -> int:
        return self.buf.shape[0]

    def device_args(self):
        return (self.buf, self.woff, self.rows, self.meta)


def prepare_batch(md, meta, *, lanes: int = LANES, quantize: bool = False,
                  force_nb: int | None = None,
                  force_words: int | None = None) -> PreparedEntropy:
    """Pack per-gch Huffman windows into sorted, blocked kernel inputs.

    md: (N, >=bytes) uint8 main-data windows (from unpack_data_light),
    or a list of such arrays (one per track — never concatenated; the
    native packer walks per-row pointers); meta: matching (N,
    LIGHT_META_N) int32 array or list. quantize puts nb on the
    quantize_nb ladder; force_nb / force_words pin the static shapes (>=
    the data's requirements) so independently prepared shards can share
    one compiled executable (multi-device dispatch).
    """
    from ..utils import bufpool

    md_list = list(md) if isinstance(md, (list, tuple)) else [md]
    meta_list = list(meta) if isinstance(meta, (list, tuple)) else [meta]
    md_list = [np.ascontiguousarray(m) for m in md_list]
    meta_list = [np.ascontiguousarray(m, dtype=np.int32) for m in meta_list]
    counts = [m.shape[0] for m in md_list]
    n = int(sum(counts))
    md_stride = md_list[0].shape[1] if md_list else fe.MD_STRIDE

    nb = max(1, -(-n // lanes))
    if quantize:
        nb = quantize_nb(nb)
    if force_nb is not None:
        assert force_nb >= nb, (force_nb, nb)
        nb = force_nb
    npad = nb * lanes

    est = np.zeros(npad, np.int32)
    bits = np.zeros(npad, np.int64)
    off = 0
    for m, c in zip(meta_list, counts):
        b = m[:, fe.LM_BVP].astype(np.int64)
        p23 = m[:, fe.LM_P23].astype(np.int64)
        qd = np.clip(np.minimum((576 - 2 * b) // 4, p23), 0, None)
        est[off : off + c] = np.minimum(b + qd, MAX_STEPS)
        bits[off : off + c] = m[:, fe.LM_P0].astype(np.int64) + p23
        off += c
    # Sort lanes by estimated steps so each block's loop bound is tight
    # (stable native counting sort on (est, bits); the key range is
    # tiny, so it beats np.lexsort by ~20x).
    order = np.empty(npad, dtype=np.int32)
    inv = np.empty(npad, dtype=np.int32)
    _native_lib.mg_sort_est_bits(
        est.ctypes.data_as(_i32p),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(npad), order.ctypes.data_as(_i32p),
        inv.ctypes.data_as(_i32p),
    )

    # Each lane's window: its bits + 64 bits of overreach slack, clamped
    # to the md row; padding lanes carry none.
    nw = np.where(
        order < n, np.minimum((bits[order] + 95) >> 5, md_stride // 4), 0
    ).astype(np.int32)
    woff = (np.cumsum(nw, dtype=np.int64) - nw).astype(np.int32)
    n_words = _quantize_words(int(nw.sum()) + TAIL_WORDS)
    if force_words is not None:
        assert force_words >= n_words, (force_words, n_words)
        n_words = force_words

    md_rows = np.empty(max(n, 1), dtype=np.uint64)
    meta_rows = np.empty(max(n, 1), dtype=np.uint64)
    off = 0
    for m, mm, c in zip(md_list, meta_list, counts):
        if c == 0:
            continue
        md_rows[off : off + c] = (
            m.ctypes.data + np.arange(c, dtype=np.uint64) * m.strides[0]
        )
        meta_rows[off : off + c] = (
            mm.ctypes.data + np.arange(c, dtype=np.uint64) * mm.strides[0]
        )
        off += c

    # Pooled output buffers (recycled across batches). The packer writes
    # every lane's window and all metadata; the buffer's tail past the
    # last window is read only by lanes whose values are masked.
    buf = bufpool.take((n_words,), np.int32)
    metab = bufpool.take((nb, META_ROWS, lanes), np.uint16)
    _native_lib.mg_entropy_pack_flat(
        md_rows.ctypes.data_as(_u64p), meta_rows.ctypes.data_as(_u64p),
        ctypes.c_int64(n), order.ctypes.data_as(_i32p),
        ctypes.c_int64(npad), ctypes.c_int64(lanes),
        woff.ctypes.data_as(_i32p), nw.ctypes.data_as(_i32p),
        buf.ctypes.data_as(_i32p), metab.ctypes.data_as(_u16p),
    )
    return PreparedEntropy(buf=buf, woff=woff, rows=order, meta=metab,
                           nb=nb, n=n, lanes=lanes)


def decode_spectra(md: np.ndarray, meta: np.ndarray, *, lanes: int = LANES,
                   interpret: bool | None = None):
    """Decode per-gch Huffman windows into (N, 576) int32 spectra.

    Convenience wrapper over prepare_batch + decode_blocks for
    single-shot use (tests, small files). Returns (spectrum (N, 576)
    int32, big_end (N,), count1_end (N,), ok (N,) bool) as jax arrays.
    """
    p = prepare_batch(md, meta, lanes=lanes)
    spec, ends = decode_blocks(
        *(jnp.asarray(a) for a in p.device_args()), nb=p.nb, lanes=lanes,
        interpret=interpret,
    )
    return (spec[: p.n].astype(jnp.int32), ends[: p.n, 0], ends[: p.n, 1],
            ends[: p.n, 2] == 0)
