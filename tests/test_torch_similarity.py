"""Slice 24 of the port: the string metrics, the pairwise similarity ops
and the LSH joins on the CPU against the JAX package.

* The eight string metrics (``SIMILARITY_FUNCS``) and ``simhash``: equal
  to the JAX package's on seeded strings (empty, repeated, non-ASCII
  ones too); ``StringSimilarityPairwiseBatchOp`` and
  ``TextSimilarityPairwiseBatchOp``: equal tables for every metric.
* ``BucketRandomProjectionLSH``: the same host draws of ``W`` and ``b``;
  the port's float64 hash (``device="cpu"``) gives equal bucket ids to
  the JAX package's wherever the projection is not within 1e-9 of a
  bucket edge (counted: none on these rows), and its projections within
  rtol 1e-12.
* ``ApproxVectorSimilarityJoinLSHBatchOp`` and ``…TopNLSHBatchOp``
  (Euclidean): equal pairs, distances within rtol 1e-12 (the host's
  re-score in both); the port's own ``bucket_width`` etc. left unset
  give the JAX package's hash.
* The Jaccard (MinHash) joins: equal pairs and distances.
"""

import inspect

import jax
import numpy as np
import pytest

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.common.vector import DenseVector as JDense
from alink_tpu.operator.batch import similarity as jsim
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.similarity import lsh as jlsh
from alink_tpu.operator.common.similarity import metrics as jmet
from alink_tpu_torch.common.vector import DenseVector as TDense
from alink_tpu_torch.operator.batch import similarity as tsim
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.similarity import lsh as tlsh
from alink_tpu_torch.operator.common.similarity import metrics as tmet

RTOL = 1e-12


@pytest.fixture(autouse=True)
def jax_default_1dev():
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _strings(n=60, seed=0):
    rng = np.random.RandomState(seed)
    alpha = list("abcdeé中 ")
    out = ["", "a", "same", "same", "kitten", "sitting"]
    while len(out) < n:
        out.append("".join(rng.choice(alpha, rng.randint(0, 12))))
    return out


@pytest.mark.parametrize("metric", sorted(jmet.SIMILARITY_FUNCS))
def test_string_metrics_equal_the_jax_package(metric):
    s = _strings()
    pairs = list(zip(s, s[::-1])) + list(zip(s, s))
    for a, b in pairs:
        assert tmet.SIMILARITY_FUNCS[metric](a, b) == \
            jmet.SIMILARITY_FUNCS[metric](a, b), (metric, a, b)
    assert sorted(tmet.SIMILARITY_FUNCS) == sorted(jmet.SIMILARITY_FUNCS)


def test_simhash_equals_the_jax_package():
    for t in _strings(30, seed=1):
        for n in (1, 2, 3):
            assert tmet.simhash(t, n) == jmet.simhash(t, n)


@pytest.mark.parametrize("op", ["StringSimilarityPairwiseBatchOp",
                                "TextSimilarityPairwiseBatchOp"])
@pytest.mark.parametrize("metric", ["LEVENSHTEIN", "LCS_SIM", "COSINE",
                                    "SIMHASH_HAMMING_SIM"])
def test_pairwise_ops_equal_the_jax_package(op, metric):
    s = _strings(40, seed=2)
    words = [" ".join(t.split()) or None for t in s]
    rows = list(zip(words, words[::-1]))
    kw = dict(selected_cols=["a", "b"], metric=metric, output_col="sim")
    t = getattr(tsim, op)(**kw).link_from(TMem(rows, "a STRING, b STRING"))
    j = getattr(jsim, op)(**kw).link_from(JMem(rows, "a STRING, b STRING"))
    assert repr(t.get_output_table().to_rows()) == \
        repr(j.get_output_table().to_rows())
    assert "device" not in inspect.signature(
        getattr(tsim, op).__init__).parameters


def _vec_rows(n, d=16, seed=0, offset=0):
    rng = np.random.RandomState(seed)
    C = rng.randn(8, d)
    X = C[rng.randint(0, 8, n)] + 0.3 * rng.randn(n, d)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X, [(offset + i, x) for i, x in enumerate(X)]


def _near_rows():
    """400 unit rights; 60 lefts, each a right moved by 1e-2 (so the
    default hash of 2 tables x 10 projections, width 1, finds them)."""
    Y, right = _vec_rows(400, seed=5, offset=1000)
    rng = np.random.RandomState(4)
    X = Y[:60] + 0.01 * rng.randn(60, Y.shape[1])
    return [(i, x) for i, x in enumerate(X)], right


@pytest.mark.parametrize("width", [0.5, 1.0, 4.0])
def test_hash_equals_the_jax_package_away_from_edges(width):
    X, _ = _vec_rows(500, seed=3)
    kw = dict(num_projections=6, num_hash_tables=3, bucket_width=width,
              seed=11)
    t = tlsh.BucketRandomProjectionLSH(16, device="cpu", **kw)
    j = jlsh.BucketRandomProjectionLSH(16, **kw)
    np.testing.assert_array_equal(t.W, j.W)
    np.testing.assert_array_equal(t.b, j.b)
    proj = t.projections(X).numpy()
    want = (X @ j.W + j.b) / width
    np.testing.assert_allclose(proj, want, rtol=RTOL, atol=RTOL)
    edge = np.abs(want - np.rint(want)) < 1e-9
    assert int(edge.sum()) == 0
    H = t.hash(X)
    assert H.shape == (500, 3, 6) and H.dtype == np.int64
    np.testing.assert_array_equal(H, j.hash(X))
    assert t.keys(X[:50]) == j.keys(X[:50])


def _join_ops(pkg, cls, rows_l, rows_r, **kw):
    mem = TMem if pkg is tsim else JMem
    dense = TDense if pkg is tsim else JDense
    left = mem([(i, dense(x)) for i, x in rows_l], ["lid", "vec"])
    right = mem([(i, dense(x)) for i, x in rows_r], ["rid", "vec"])
    extra = {"device": "cpu"} if pkg is tsim else {}
    return getattr(pkg, cls)(left_col="vec", right_col="vec",
                             left_id_col="lid", right_id_col="rid",
                             **kw, **extra).link_from(left, right)


def _pairs_equal(t, j):
    tt, jt = t.get_output_table(), j.get_output_table()
    assert tt.col_names == jt.col_names == ["lid", "rid", "distance"]
    assert tt.num_rows == jt.num_rows > 0
    assert list(tt.col("lid")) == list(jt.col("lid"))
    assert list(tt.col("rid")) == list(jt.col("rid"))
    np.testing.assert_allclose(np.asarray(tt.col("distance"), float),
                               np.asarray(jt.col("distance"), float),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("cls,kw", [
    ("ApproxVectorSimilarityJoinLSHBatchOp", dict(distance_threshold=0.6)),
    ("ApproxVectorSimilarityJoinLSHBatchOp", dict(distance_threshold=0.4,
                                                  seed=5)),
    ("ApproxVectorSimilarityTopNLSHBatchOp", dict(top_n=3)),
    ("ApproxVectorSimilarityTopNLSHBatchOp", dict(top_n=1, seed=2))])
def test_euclidean_joins_equal_the_jax_package(cls, kw):
    left, right = _near_rows()
    t = _join_ops(tsim, cls, left, right, **kw)
    j = _join_ops(jsim, cls, left, right, **kw)
    _pairs_equal(t, j)
    assert set(t.stage_seconds) == {"extract", "hash", "buckets", "rescore"}


def test_the_ports_hash_params():
    """Unset or set to the default, the JAX package's hash; wider
    buckets find at least as many pairs here."""
    left, right = _near_rows()
    cls = "ApproxVectorSimilarityJoinLSHBatchOp"
    base = _join_ops(tsim, cls, left, right, distance_threshold=0.8)
    same = _join_ops(tsim, cls, left, right, distance_threshold=0.8,
                     bucket_width=1.0)
    assert base.get_output_table().to_rows() == \
        same.get_output_table().to_rows()
    wide = _join_ops(tsim, cls, left, right, distance_threshold=0.8,
                     bucket_width=4.0)
    assert wide.get_output_table().num_rows >= base.get_output_table().num_rows


def _set_rows(n, seed, offset=0):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        base = rng.randint(0, 5)
        idx = sorted(set(rng.randint(base * 8, base * 8 + 12, 6)))
        rows.append((offset + i, f"$64${' '.join(f'{k}:1.0' for k in idx)}"))
    return rows


@pytest.mark.parametrize("cls,kw", [
    ("ApproxVectorSimilarityJoinLSHBatchOp", dict(distance_threshold=0.7)),
    ("ApproxVectorSimilarityTopNLSHBatchOp", dict(top_n=2))])
def test_jaccard_joins_equal_the_jax_package(cls, kw):
    left, right = _set_rows(40, 8), _set_rows(200, 9, offset=500)
    kw = dict(kw, metric="JACCARD", left_col="v", right_col="v",
              left_id_col="lid", right_id_col="rid")
    t = getattr(tsim, cls)(device="cpu", **kw).link_from(
        TMem(left, "lid LONG, v STRING"), TMem(right, "rid LONG, v STRING"))
    j = getattr(jsim, cls)(**kw).link_from(
        JMem(left, "lid LONG, v STRING"), JMem(right, "rid LONG, v STRING"))
    assert repr(t.get_output_table().to_rows()) == \
        repr(j.get_output_table().to_rows())
    assert t.get_output_table().num_rows > 0


def test_bucket_candidates_equal_the_dict_of_keys():
    """The numpy grouping gives each left row the rights of the JAX
    package's dict of (table, key tuple) buckets, ascending."""
    rng = np.random.RandomState(12)
    HY = rng.randint(-2, 2, size=(300, 3, 2))
    HX = rng.randint(-2, 3, size=(40, 3, 2))
    buckets = {}
    for j in range(len(HY)):
        for t in range(3):
            buckets.setdefault((t, tuple(HY[j, t])), []).append(j)
    got = tlsh.bucket_candidates(HY, HX)
    for i in range(len(HX)):
        want = sorted(set().union(*(buckets.get((t, tuple(HX[i, t])), ())
                                    for t in range(3))))
        assert got[i].tolist() == want

