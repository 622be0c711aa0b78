"""Slice 24 of the port: the hypothesis tests, correlation and the six
statistics ops on the CPU against the JAX package.

Every function and op here is host numpy in both packages, so the
tolerance is 0: equal floats, equal tables.

* ``chi2_sf`` (the regularized upper incomplete gamma, both branches),
  ``chi_square_test``, ``pearson_corr``, ``_ranks`` (average ranks of
  ties, a stable sort) and ``spearman_corr``: equal to the JAX
  package's; the statistic also equal to a numpy recomputation of the
  contingency table's chi-square.
* ``SummarizerBatchOp``, ``VectorSummarizerBatchOp``,
  ``CorrelationBatchOp`` (PEARSON, SPEARMAN), ``VectorCorrelationBatchOp``,
  ``ChiSquareTestBatchOp`` and ``VectorChiSquareTestBatchOp``: equal
  output tables and collected statistics; Pearson also equal to
  ``np.corrcoef`` within 1e-12 (another summation).

The JAX side runs on a 1-device default environment.
"""

import math

import jax
import numpy as np
import pytest

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.batch.statistics import stat_ops as jso
from alink_tpu.operator.common.statistics import hypothesis as jh
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.batch.statistics import stat_ops as tso
from alink_tpu_torch.operator.common.statistics import hypothesis as th

SCHEMA = "a DOUBLE, b DOUBLE, c LONG, s STRING, vec STRING, label STRING"


@pytest.fixture(autouse=True)
def jax_default_1dev():
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _rows(n=240, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(n)
    b = 0.6 * a + 0.8 * rng.randn(n)
    c = rng.randint(0, 4, n)                      # ties for the ranks
    s = np.asarray(["x", "y", "z"])[(c + (rng.rand(n) < 0.3)) % 3]
    label = np.where(a + 0.5 * rng.randn(n) > 0, "pos", "neg")
    vecs = [f"{float(x)} {float(k)} {float(y)}" for x, k, y in zip(a, c, b)]
    return [(float(x), float(y), int(k), str(t), v, str(lab))
            for x, y, k, t, v, lab in zip(a, b, c, s, vecs, label)]


@pytest.mark.parametrize("x,df", [(0.0, 1), (0.5, 1), (3.84, 1), (1.0, 4),
                                  (7.5, 3), (20.0, 5), (200.0, 30),
                                  (1e-3, 10), (55.0, 80)])
def test_chi2_sf_equals_the_jax_package(x, df):
    assert th.chi2_sf(x, df) == jh.chi2_sf(x, df)
    assert 0.0 <= th.chi2_sf(x, df) <= 1.0


def test_chi2_sf_edges():
    assert th.chi2_sf(0.0, 3) == 1.0
    assert math.isnan(th._gammainc_upper_reg(-1.0, 1.0))
    # df 2: the survival function is exp(-x/2)
    for x in (0.3, 2.0, 9.0):
        assert th.chi2_sf(x, 2) == pytest.approx(math.exp(-x / 2), rel=1e-13)


def test_chi_square_test_equals_the_jax_package_and_numpy():
    rows = _rows()
    s = [r[3] for r in rows]
    lab = [r[5] for r in rows]
    got = th.chi_square_test(s, lab)
    assert got == jh.chi_square_test(s, lab)
    xv, yv = sorted(set(s)), sorted(set(lab))
    obs = np.zeros((len(xv), len(yv)))
    for u, v in zip(s, lab):
        obs[xv.index(u), yv.index(v)] += 1
    exp = np.outer(obs.sum(1), obs.sum(0)) / obs.sum()
    assert got[0] == pytest.approx(((obs - exp) ** 2 / exp).sum(), rel=1e-12)
    assert got[2] == (len(xv) - 1) * (len(yv) - 1)


def test_ranks_average_ties_equal_the_jax_package():
    v = np.asarray([3.0, 1.0, 3.0, 2.0, 1.0, 3.0, np.inf, -0.0, 0.0])
    np.testing.assert_array_equal(th._ranks(v), jh._ranks(v))
    np.testing.assert_array_equal(th._ranks(np.asarray([2.0, 1.0, 2.0])),
                                  [2.5, 1.0, 2.5])


@pytest.mark.parametrize("fn", ["pearson_corr", "spearman_corr"])
def test_correlations_equal_the_jax_package(fn):
    rows = _rows()
    X = np.asarray([[r[0], r[1], r[2]] for r in rows])
    X = np.hstack([X, np.ones((len(X), 1))])       # a constant column
    got = getattr(th, fn)(X)
    np.testing.assert_array_equal(got, getattr(jh, fn)(X))
    if fn == "pearson_corr":
        ref = np.corrcoef(X[:, :3], rowvar=False)
        np.testing.assert_allclose(got[:3, :3], ref, rtol=1e-12, atol=1e-12)


def _both(op_name, rows=None, **kw):
    rows = rows or _rows()
    t = getattr(tso, op_name)(**kw).link_from(TMem(rows, SCHEMA))
    j = getattr(jso, op_name)(**kw).link_from(JMem(rows, SCHEMA))
    return t, j


def _tables_equal(t, j):
    assert t.col_names == j.col_names
    assert t.schema.types == j.schema.types
    assert repr(t.to_rows()) == repr(j.to_rows())


def test_summarizer_op():
    t, j = _both("SummarizerBatchOp", selected_cols=["a", "b", "c"])
    _tables_equal(t.get_output_table(), j.get_output_table())
    ts, js = t.collect_summary(), j.collect_summary()
    for c in ("a", "b", "c"):
        for stat in ("mean", "variance", "standard_deviation", "min", "max"):
            assert getattr(ts, stat)(c) == getattr(js, stat)(c)
    a = np.asarray([r[0] for r in _rows()])
    assert ts.mean("a") == pytest.approx(a.mean(), rel=1e-13)


def test_vector_summarizer_op():
    t, j = _both("VectorSummarizerBatchOp", selected_col="vec")
    _tables_equal(t.get_output_table(), j.get_output_table())
    ts, js = t.collect_vector_summary(), j.collect_vector_summary()
    np.testing.assert_array_equal(ts.mean(), js.mean())
    np.testing.assert_array_equal(ts.num_non_zero(), js.num_non_zero())


@pytest.mark.parametrize("method", ["PEARSON", "SPEARMAN"])
def test_correlation_op(method):
    t, j = _both("CorrelationBatchOp", selected_cols=["a", "b", "c"],
                 method=method)
    _tables_equal(t.get_output_table(), j.get_output_table())
    np.testing.assert_array_equal(t.collect_correlation(),
                                  j.collect_correlation())


@pytest.mark.parametrize("method", ["PEARSON", "SPEARMAN"])
def test_vector_correlation_op(method):
    t, j = _both("VectorCorrelationBatchOp", vector_col="vec", method=method)
    _tables_equal(t.get_output_table(), j.get_output_table())
    np.testing.assert_array_equal(t.collect_correlation(),
                                  j.collect_correlation())


def test_chi_square_test_op():
    t, j = _both("ChiSquareTestBatchOp", selected_cols=["s", "c"],
                 label_col="label")
    _tables_equal(t.get_output_table(), j.get_output_table())


def test_vector_chi_square_test_op():
    t, j = _both("VectorChiSquareTestBatchOp", vector_col="vec",
                 label_col="label")
    _tables_equal(t.get_output_table(), j.get_output_table())
    rows = [("1.0 0.0", "0"), ("1.0 1.0", "1"), ("0.0 0.0", "0"),
            ("0.0 1.0", "1")]
    out = tso.VectorChiSquareTestBatchOp(
        vector_col="v", label_col="l").link_from(
        TMem(rows, "v STRING, l STRING")).get_output_table().to_rows()
    assert out[0][1] == pytest.approx(1.0) and out[1][1] < 0.05
