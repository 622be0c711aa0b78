"""Slice 24 of the port: Stochastic Outlier Selection on the CPU against
the JAX package.

* float64 (the JAX side under x64): ``sos_scores`` and ``SosBatchOp``
  within rtol 1e-9 of the JAX package's ``_sos_kernel`` / op. The
  products sum in other orders, and once a bisection's bracket reaches
  ulps its ``err > 0`` test flips on that noise, moving beta by an ulp,
  so the gate is a tolerance, not bitwise.
* Row blocks: any ``block_rows`` (1, a few, all) within rtol 1e-12 of
  one block (only the column sums' order changes).
* float32 (the JAX side with x64 off): within rtol 1e-5, on data with a
  row whose affinities all underflow at the first beta (``exp`` of
  -142 and below is 0 in float32; the floors are 0 there, as JAX's
  weak-typed ``1e-300`` is), which must still score as the outlier.
* The planted outlier scores highest (the JAX package's own
  ``test_sos_outlier``), through a sparse vector column too.
* Rows whose affinities underflowed float32 before the port shifted
  each row by its nearest distance (the JAX package's scores are NaN
  there) score finite, within rtol 1e-3 of the JAX package's float64
  SOS and of the float64 port.
* ``chip_smoke.py`` phase 24(e): its AUC floors are the JAX package's
  own CPU readings on its data, rounded down (float64 cuts at the third
  decimal, float32 at the second).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.operator.batch.outlier import SosBatchOp as JSos
from alink_tpu.operator.batch.outlier import _sos_kernel
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu_torch.operator.batch.outlier import (SosBatchOp, sos_block_rows,
                                                    sos_scores)
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem

RTOL64 = 1e-9
RTOL32 = 1e-5


def _blobs(n=300, d=5, seed=0, outliers=0.07):
    rng = np.random.RandomState(seed)
    C = rng.randn(4, d) * 4
    X = C[rng.randint(0, 4, n)] + rng.randn(n, d)
    k = int(round(outliers * n))
    X[:k] = rng.uniform(X.min(0) - 2, X.max(0) + 2, size=(k, d))
    return X[rng.permutation(n)]


@pytest.mark.parametrize("n,d,perp", [(300, 5, 4.0), (120, 9, 2.5),
                                      (64, 30, 10.0), (12, 3, 4.0)])
def test_float64_scores_match_the_jax_package(n, d, perp):
    X = _blobs(n, d, seed=n)
    want = np.asarray(_sos_kernel(jnp.asarray(X), perp))
    got = sos_scores(torch.from_numpy(X), perp).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL64, atol=0)


@pytest.mark.parametrize("block", [1, 7, 64, 299, 300])
def test_row_blocks_change_only_the_column_sums_order(block):
    X = torch.from_numpy(_blobs(300, 4, seed=1))
    one = sos_scores(X, 4.0, block_rows=300).numpy()
    got = sos_scores(X, 4.0, block_rows=block).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-12, atol=0)


def test_block_rows_keep_one_block_array_within_the_budget():
    assert sos_block_rows(49_097, 8) == (1 << 30) // (49_097 * 8)
    assert sos_block_rows(49_097, 4) == (1 << 30) // (49_097 * 4)
    assert sos_block_rows(100, 8) == 100
    assert sos_block_rows(10, 8, budget=1) == 1


def test_float32_with_an_underflowing_row_matches_the_jax_package():
    rng = np.random.RandomState(3)
    X = np.vstack([rng.randn(60, 3), [[14.0, 0.0, 0.0]]]).astype(np.float32)
    d2 = ((X[-1] - X[:-1]) ** 2).sum(1)
    assert np.exp(-d2.astype(np.float32)).max() == 0.0   # all underflow
    with jax.enable_x64(False):
        want = np.asarray(_sos_kernel(jnp.asarray(X), 4.0))
        assert want.dtype == np.float32
    got = sos_scores(torch.from_numpy(X), 4.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL32, atol=0)
    assert int(np.argmax(got.numpy())) == 60


def _op_rows(X):
    return [(" ".join(repr(float(v)) for v in x),) for x in X]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_op_matches_the_jax_op_and_finds_the_outlier(dtype):
    rng = np.random.RandomState(0)
    X = np.vstack([rng.randn(40, 2) * 0.5, [[8.0, 8.0]]])
    rows = _op_rows(X)
    kw = dict(vector_col="vec", prediction_col="score", perplexity=5.0)
    t = SosBatchOp(device="cpu", dtype=dtype, **kw).link_from(
        TMem(rows, "vec STRING")).get_output_table()
    s = np.asarray(t.col("score"))
    assert t.col_names == ["vec", "score"] and s.dtype == np.float64
    assert s.argmax() == 40 and s[40] > 0.9 and np.median(s[:40]) < s[40]
    if dtype == torch.float64:
        j = JSos(**kw).link_from(JMem(rows, "vec STRING")).get_output_table()
        np.testing.assert_allclose(s, np.asarray(j.col("score")),
                                   rtol=RTOL64, atol=0)


def test_op_takes_a_sparse_column():
    X = _blobs(80, 6, seed=2)
    X[np.abs(X) < 0.5] = 0.0
    sparse = [("$6$" + " ".join(f"{k}:{float(v)}" for k, v in enumerate(x)
                                if v != 0.0),) for x in X]
    kw = dict(vector_col="vec", prediction_col="p")
    t = SosBatchOp(device="cpu", dtype=torch.float64, **kw).link_from(
        TMem(sparse, "vec STRING")).get_output_table()
    j = JSos(**kw).link_from(JMem(sparse, "vec STRING")).get_output_table()
    np.testing.assert_allclose(np.asarray(t.col("p")),
                               np.asarray(j.col("p")), rtol=RTOL64, atol=0)


_ARMS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1]],
                 float)


@pytest.mark.parametrize("stars", [0, 1, 2])
def test_float32_rows_that_underflowed_score_finite(stars):
    """Each star is a row with five neighbours at exactly distance 3 (the
    entropy stays above log 4, so its beta climbs past 2^60): unshifted,
    its affinities underflow float32 and one such row made every other
    column NaN, two every column. Shifted by each row's nearest distance
    the float32 scores are finite and within rtol 1e-3 of the JAX
    package's float64 SOS of the same rows and of the float64 port's
    (measured: 4.9e-4 from both at all three fixtures, on the smallest
    scores; the float64 port itself parts from the JAX package's float64
    by 8.2e-5 with a star, whose bisection the shift lets run past the
    beta where its unshifted affinities would underflow)."""
    rng = np.random.RandomState(0)
    X = np.vstack([rng.randn(60, 3) + [0.0, 0.0, -30.0]]
                  + [np.vstack([c, c + 3.0 * _ARMS]) for c in
                     (np.array([40.0 * s, 0.0, 0.0]) for s in range(stars))])
    got = sos_scores(torch.from_numpy(X.astype(np.float32)), 4.0).numpy()
    want = sos_scores(torch.from_numpy(X), 4.0).numpy()
    with jax.enable_x64(True):
        jax64 = np.asarray(_sos_kernel(jnp.asarray(X), 4.0))
    assert got.dtype == np.float32 and jax64.dtype == np.float64
    assert np.isfinite(got).all() and np.isfinite(jax64).all()
    np.testing.assert_allclose(got, jax64, rtol=1e-3, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)


@pytest.mark.parametrize("name,x64,rows,decimals", [
    ("shuttle", True, 4_000, 3), ("mnist", True, 4_000, 3),
    ("mnist", False, None, 2)])
def test_chip_smoke_sos_auc_floors_are_the_jax_packages_readings(
        name, x64, rows, decimals):
    """Exact: each floor is the JAX package's ``_sos_kernel`` AUC of the
    planted outliers on the same rows, rounded down."""
    import chip_smoke
    X, flags = chip_smoke.sos_rows(*chip_smoke.P24_SIZES["sos"][name])
    X, flags = X[:rows], flags[:rows]
    with jax.enable_x64(x64):
        p = np.asarray(_sos_kernel(
            jnp.asarray(X if x64 else X.astype(np.float32)),
            chip_smoke.SOS_PERPLEXITY))
    assert p.dtype == (np.float64 if x64 else np.float32)
    auc = chip_smoke.rank_auc(flags.astype(np.int64), p.astype(np.float64))
    floor = (chip_smoke.SOS_AUC_FLOOR if x64
             else chip_smoke.SOS_F32_AUC_FLOOR)[name]
    assert floor == np.floor(auc * 10 ** decimals) / 10 ** decimals
