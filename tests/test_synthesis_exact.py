"""The layout reorder and the per-sample expansions are exact at every
spectrum magnitude, whatever the matmul precision (they are
constant-index gathers, not one-hot matmuls a TF32 or bf16 pass would
round)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu.decode import synthesis  # noqa: E402
from mp3rgain_tpu.decode.tables import row_tables  # noqa: E402

SPECTRUM_MAX = 8206  # 15 + 8191 linbits


def _masks(g, cls):
    return [jnp.full((g, 1), c == cls) for c in range(3)]


@pytest.mark.parametrize("precision", ["bfloat16", "tensorfloat32",
                                       "highest"])
@pytest.mark.parametrize("sr_row", [0, 4, 8])
def test_short_reorder_exact_at_full_magnitude(precision, sr_row):
    rng = np.random.default_rng(sr_row)
    x = rng.integers(-SPECTRUM_MAX, SPECTRUM_MAX + 1, (64, 576))
    x[:, :4] = [SPECTRUM_MAX, -SPECTRUM_MAX, 8191, 2049]
    x = x.astype(np.float32)
    rt = row_tables(sr_row)
    with jax.default_matmul_precision(precision):
        short = np.asarray(synthesis._reorder(
            jnp.asarray(x), _masks(64, 1), rt, jnp.float32))
        mixed = np.asarray(synthesis._reorder(
            jnp.asarray(x), _masks(64, 2), rt, jnp.float32))
    assert np.array_equal(short, x[:, rt.perm_short])
    assert np.array_equal(mixed[:, :36], x[:, :36])
    assert np.array_equal(mixed[:, 36:], x[:, rt.perm_short][:, 36:])


@pytest.mark.parametrize("cls", [0, 1, 2])
def test_scalefactor_and_subblock_expansion_exact(cls):
    rng = np.random.default_rng(cls)
    rt = row_tables(2)
    scf = rng.integers(0, 32, (16, 64)).astype(np.float32)
    sbg = rng.integers(0, 8, (16, 3)).astype(np.float32)
    with jax.default_matmul_precision("bfloat16"):
        got = np.asarray(synthesis._expand(jnp.asarray(scf), rt.slot,
                                           _masks(16, cls)))
        got_w = np.asarray(synthesis._expand(jnp.asarray(sbg), rt.win,
                                             _masks(16, cls)))
    assert np.array_equal(got, scf[:, rt.slot[cls]])
    assert np.array_equal(got_w, sbg[:, rt.win[cls]])
