"""Slice 9 of the port, its host modules: feature hashing, the scalers,
the split and JSON stream ops, the binary metrics and the eval ops,
held against the JAX package on the CPU.

* ``murmur32_cells`` (the port's native batch hasher), its numpy plain
  version ``murmur32_cells_plain`` and ``murmur32`` equal the JAX
  package's ``murmur32_cells`` (its native C hasher here) and its
  pure-Python ``murmur32`` exactly, with and without ``mod``: byte
  strings of 0-64 bytes (every tail length), empty strings, NULs inside,
  non-ASCII text.
* ``FeatureHasherBatchOp``: equal indices and bitwise values in the
  flat and field-aware layouts, over integer, string and ``bytes``
  categoricals, numeric columns with ``None`` and NaN, forced collisions
  (``num_features=16``) carrying a ``-0.0``, and ``reserved_cols``.
* ``hash_to_fields``: exactly equal.
* The four scaler train ops: equal model tables (their JSON rows) and
  bitwise float64 transforms, on a constant column and nulls.
* ``binary_metrics``' JSON is equal (tied scores, a one-class set);
  ``EvalBinaryClassBatchOp`` and ``EvalBinaryClassStreamOp`` give equal
  rows on one prediction stream fed to both packages.
* ``SplitStreamOp`` (both sides) and ``JsonValueStreamOp``: equal rows.

The JAX side runs on an explicit 1-device environment, as in the other
``test_torch_*`` files (these ops run on the host in both packages).
"""

import json

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.operator.base import TableSourceBatchOp as TSrc
from alink_tpu_torch.operator.batch.dataproc import scalers as tsc
from alink_tpu_torch.operator.batch.evaluation import \
    EvalBinaryClassBatchOp as TEvalB
from alink_tpu_torch.operator.batch.feature import feature_ops as tfo
from alink_tpu_torch.operator.common.evaluation import metrics as tmet
from alink_tpu_torch.operator.stream.dataproc import SplitStreamOp as TSplit
from alink_tpu_torch.operator.stream.dataproc.format import \
    JsonValueStreamOp as TJson
from alink_tpu_torch.operator.stream.evaluation import \
    EvalBinaryClassStreamOp as TEvalS
from alink_tpu_torch.operator.stream.source import MemSourceStreamOp as TMemS
from alink_tpu_torch.ops.fieldblock import hash_to_fields as t_h2f


@pytest.fixture(scope="module")
def jsid():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield sid
    MLEnvironmentFactory.remove(sid)


def _jfo():
    from alink_tpu.operator.batch.feature import feature_ops
    return feature_ops


def _hash_all(tokens, seed, mod):
    """The five hashers' outputs over one token list (the port's numpy
    plain version first)."""
    jfo = _jfo()
    want = np.array([jfo.murmur32(t, seed) % mod if mod else
                     jfo.murmur32(t, seed) for t in tokens], np.int64)
    plain = tfo.murmur32_cells_plain(tokens, seed=seed, mod=mod)
    np.testing.assert_array_equal(plain, want)
    return (tfo.murmur32_cells(tokens, seed=seed, mod=mod),
            jfo.murmur32_cells(tokens, seed=seed, mod=mod),
            np.array([tfo.murmur32(t, seed) % mod if mod else
                      tfo.murmur32(t, seed) for t in tokens], np.int64),
            want)


_TOKENS = st.lists(st.one_of(
    st.binary(min_size=0, max_size=64),
    st.text(max_size=24).map(lambda s: s.encode("utf-8"))),
    min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(tokens=_TOKENS, seed=st.integers(0, 2 ** 32 - 1),
       mod=st.sampled_from([0, 1, 7, 16, 30000, 1 << 20]))
def test_murmur_matches_jax(tokens, seed, mod):
    got, native, t_py, j_py = _hash_all(tokens, seed, mod)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, j_py)
    np.testing.assert_array_equal(native, j_py)
    np.testing.assert_array_equal(t_py, j_py)


@pytest.mark.parametrize("mod", [0, 5, 30000])
def test_murmur_every_tail_length(mod):
    """Every length 0-64, so every tail (0-3 bytes) after every number
    of blocks; the fixed-width "S" array path too (its contract drops
    trailing NULs)."""
    rng = np.random.RandomState(3)
    tokens = [bytes(rng.randint(1, 256, n).astype(np.uint8))
              for n in range(65)] + [b"", b"a\x00b", "é=ü".encode()]
    got, native, t_py, j_py = _hash_all(tokens, 11, mod)
    np.testing.assert_array_equal(got, j_py)
    np.testing.assert_array_equal(native, j_py)
    arr = np.array(tokens)
    want = _jfo().murmur32_cells(arr, mod=mod)
    np.testing.assert_array_equal(tfo.murmur32_cells(arr, mod=mod), want)
    np.testing.assert_array_equal(tfo.murmur32_cells_plain(arr, mod=mod),
                                  want)


def _hasher_table(case, n=300, seed=0):
    """Columns and schema of one hasher case."""
    rng = np.random.RandomState(seed)
    cols, spec = {}, []
    cols["i"] = rng.randint(-3, 9, n)
    spec.append("i INT")
    s = np.array([f"v{k}" for k in rng.randint(0, 40, n)], object)
    s[::11] = None
    s[5] = "naïve"
    cols["s"] = s
    spec.append("s STRING")
    if case == "bytes":
        cols["b"] = np.array([b"x", b"yy", b"z\xff"], "S")[
            rng.randint(0, 3, n)]
        spec.append("b STRING")
    x = (rng.randn(n) * 2).astype(object)
    x[::7] = None
    x[3] = np.nan
    x[4] = -0.0
    cols["x"] = x
    spec.append("x DOUBLE")
    y = rng.randn(n)
    y[::9] = -0.0
    cols["y"] = y
    spec.append("y DOUBLE")
    cols["keep"] = rng.randint(0, 2, n)
    spec.append("keep LONG")
    return cols, ", ".join(spec)


HASHER_CASES = [
    ("flat", "plain", 30000, None), ("flat", "plain", 16, None),
    ("flat", "bytes", 16, None), ("flat", "bytes", 1 << 18, ["keep"]),
    ("field", "plain", 30000, None), ("field", "plain", 16, ["keep"]),
    ("field", "bytes", 64, None)]


@pytest.mark.parametrize("layout,case,nf,reserved", HASHER_CASES)
def test_feature_hasher_matches_jax(jsid, layout, case, nf, reserved):
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.operator.base import TableSourceBatchOp as JSrc
    cols, spec = _hasher_table(case)
    sel = [c for c in cols if c != "keep"]
    kw = dict(selected_cols=sel, categorical_cols=["i", "s"] + (
        ["b"] if case == "bytes" else []), output_col="v", num_features=nf,
        field_aware=layout == "field")
    if reserved:
        kw["reserved_cols"] = reserved
    got = tfo.FeatureHasherBatchOp(**kw).link_from(
        TSrc(TMTable(dict(cols), spec))).get_output_table()
    want = _jfo().FeatureHasherBatchOp(ml_environment_id=jsid, **kw).link_from(
        JSrc(JMTable(dict(cols), spec))).get_output_table()
    assert got.col_names == want.col_names
    assert list(got.schema.types) == list(want.schema.types)
    negzero = 0
    for a, b in zip(got.col("v"), want.col("v")):
        assert a.n == b.n
        assert a.indices.dtype == b.indices.dtype == np.int32
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.values.tobytes() == b.values.tobytes()
        negzero += int((np.signbit(a.values) & (a.values == 0)).sum())
    if layout == "flat" and nf == 16:
        # collisions sum from 0.0: a lone -0.0 weight becomes +0.0
        assert negzero == 0
    for c in got.col_names:
        if c != "v":
            assert [str(v) for v in got.col(c)] == [str(v) for v in
                                                    want.col(c)]


def test_hash_to_fields_matches_jax():
    from alink_tpu.ops.fieldblock import hash_to_fields as j_h2f
    rng = np.random.RandomState(1)
    cols = [rng.randint(0, 50, 200), np.array([f"c{v}" for v in
                                               rng.randint(0, 9, 200)]),
            rng.randn(200)]
    for S in (16, 48, 2048):
        got = t_h2f(cols, S, seed=5)
        want = j_h2f(cols, S, seed=5)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _scaler_table(n=120, seed=2):
    rng = np.random.RandomState(seed)
    a = rng.randn(n) * 3 + 1
    a[::13] = np.nan
    b = np.full(n, 2.5)                     # a constant column
    c = (rng.rand(n) * 10).astype(object)
    c[::6] = None
    d = rng.randint(-5, 5, n)
    return ({"a": a, "b": b, "c": c, "d": d, "s": np.array(["x"] * n)},
            "a DOUBLE, b DOUBLE, c DOUBLE, d LONG, s STRING")


SCALERS = [("StandardScaler", {}),
           ("StandardScaler", {"with_mean": False}),
           ("StandardScaler", {"with_std": False}),
           ("MinMaxScaler", {"min_out": -1.0, "max_out": 3.0}),
           ("MaxAbsScaler", {}),
           ("Imputer", {"strategy": "MEAN"}),
           ("Imputer", {"strategy": "MAX"}),
           ("Imputer", {"strategy": "VALUE", "fill_value": -7.0})]


@pytest.mark.parametrize("name,kw", SCALERS)
@pytest.mark.parametrize("selected", [["a", "b", "c", "d"], None])
def test_scalers_match_jax(jsid, name, kw, selected):
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.operator.base import TableSourceBatchOp as JSrc
    from alink_tpu.operator.batch.dataproc import scalers as jsc
    cols, spec = _scaler_table()
    if selected:
        kw = dict(kw, selected_cols=selected)
    tsrc = TSrc(TMTable(dict(cols), spec))
    jsrc = JSrc(JMTable(dict(cols), spec))
    tm = getattr(tsc, f"{name}TrainBatchOp")(**kw).link_from(tsrc)
    jm = getattr(jsc, f"{name}TrainBatchOp")(
        ml_environment_id=jsid, **kw).link_from(jsrc)
    assert tm.get_output_table().to_json_rows() == \
        jm.get_output_table().to_json_rows()
    got = getattr(tsc, f"{name}PredictBatchOp")().link_from(
        tm, tsrc).get_output_table()
    want = getattr(jsc, f"{name}PredictBatchOp")(
        ml_environment_id=jsid).link_from(jm, jsrc).get_output_table()
    assert got.col_names == want.col_names
    for c in got.col_names:
        g, w = got.col(c), want.col(c)
        if c == "s":
            assert list(g) == list(w)
        else:
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            assert g.tobytes() == w.tobytes(), c


def _pred_rows(n, seed, ties=False, one_class=False, labels=("0", "1")):
    rng = np.random.RandomState(seed)
    p = rng.rand(n)
    if ties:
        p = np.round(p * 8) / 8
    y = (rng.rand(n) < p).astype(int)
    if one_class:
        y[:] = 1
    lab = np.array([labels[v] for v in y], object)
    det = np.array([json.dumps({labels[1]: float(q), labels[0]: 1.0 - q})
                    for q in p], object)
    return lab, p, det


@pytest.mark.parametrize("ties,one_class,labels", [
    (False, False, ("0", "1")), (True, False, ("0", "1")),
    (False, True, ("0", "1")), (True, False, (0, 1)),
    (False, False, ("neg", "pos"))])
def test_binary_metrics_json_matches_jax(ties, one_class, labels):
    from alink_tpu.operator.common.evaluation import metrics as jmet
    lab, p, _ = _pred_rows(700, 4, ties, one_class, labels)
    for pos in (labels[1], labels[0]):
        assert tmet.binary_metrics(lab, p, pos).to_json() == \
            jmet.binary_metrics(lab, p, pos).to_json()


def _prediction_table(pkg, n=900, seed=5):
    MT = TMTable if pkg == "torch" else __import__(
        "alink_tpu.common.mtable", fromlist=["MTable"]).MTable
    lab, _, det = _pred_rows(n, seed, ties=True)
    lab[:300] = "1"                      # the first window: one class
    return MT({"click": lab, "details": det}, "click STRING, details STRING")


def test_eval_ops_match_jax(jsid):
    from alink_tpu.operator.base import TableSourceBatchOp as JSrc
    from alink_tpu.operator.batch.evaluation import EvalBinaryClassBatchOp
    from alink_tpu.operator.stream.evaluation import EvalBinaryClassStreamOp
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    kw = dict(label_col="click", prediction_detail_col="details")
    got = TEvalB(**kw).link_from(TSrc(_prediction_table("torch")))
    want = EvalBinaryClassBatchOp(ml_environment_id=jsid, **kw).link_from(
        JSrc(_prediction_table("jax")))
    assert got.get_output_table().to_rows() == \
        want.get_output_table().to_rows()
    assert got.collect_metrics().to_json() == \
        want.collect_metrics().to_json()
    for interval in (1.0, 2.5):
        ts = TEvalS(time_interval=interval, **kw).link_from(
            TMemS(_prediction_table("torch"), batch_size=100))
        js = EvalBinaryClassStreamOp(
            time_interval=interval, ml_environment_id=jsid, **kw).link_from(
            MemSourceStreamOp(_prediction_table("jax"), batch_size=100,
                              ml_environment_id=jsid))
        tout = [(t, mt.to_rows()) for t, mt in ts.timed_batches()]
        jout = [(t, mt.to_rows()) for t, mt in js.timed_batches()]
        assert tout == jout
        assert json.loads(tout[0][1][0][1])["AUC"] is None


def _rows_table(pkg, n=500, seed=6):
    from alink_tpu.common.mtable import MTable as JMTable
    rng = np.random.RandomState(seed)
    cols = {"k": np.arange(n), "v": rng.randn(n),
            "js": np.array([json.dumps({"a": {"b": [int(i), float(x)]},
                                        "c": "t" * (i % 3)})
                            for i, x in enumerate(rng.randn(n))], object)}
    return (TMTable if pkg == "torch" else JMTable)(
        cols, "k LONG, v DOUBLE, js STRING")


def _jax_split(jsid, frac, seed):
    from alink_tpu.operator.stream.dataproc import SplitStreamOp
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    return SplitStreamOp(fraction=frac, seed=seed,
                         ml_environment_id=jsid).link_from(
        MemSourceStreamOp(_rows_table("jax"), batch_size=64,
                          ml_environment_id=jsid))


@pytest.mark.parametrize("frac,seed", [(0.5, 0), (0.3, 7)])
def test_split_stream_matches_jax(jsid, frac, seed):
    ts = TSplit(fraction=frac, seed=seed).link_from(
        TMemS(_rows_table("torch"), batch_size=64))
    js = _jax_split(jsid, frac, seed)

    def rows(op):
        return [(t, mt.to_rows()) for t, mt in op.timed_batches()]
    main, side = rows(ts), rows(ts.get_side_stream())
    assert main == rows(js)
    assert side == rows(js.get_side_stream())
    # every drain replays the same split; the sides partition the stream
    assert rows(ts) == main
    keys = sorted(r[0] for _, b in main + side for r in b)
    assert keys == list(range(500))


def test_json_value_stream_matches_jax(jsid):
    from alink_tpu.operator.stream.dataproc.format import JsonValueStreamOp
    kw = dict(selected_col="js", json_path=["$.a.b[0]", "$.a", "$.c",
                                            "$.a.b[1]"],
              output_cols=["b0", "a", "c", "b1"])
    ts = TJson(**kw).link_from(TSplit(fraction=0.5).link_from(
        TMemS(_rows_table("torch"), batch_size=64)))
    js = JsonValueStreamOp(ml_environment_id=jsid, **kw).link_from(
        _jax_split(jsid, 0.5, 0))
    tout = [(t, mt.col_names, mt.to_rows()) for t, mt in ts.timed_batches()]
    jout = [(t, mt.col_names, mt.to_rows()) for t, mt in js.timed_batches()]
    assert tout == jout
    assert ts.get_schema().names == js.get_schema().names
    bad = dict(kw, json_path=["$.zz", "$.a", "$.c", "$.a.b[5]"])
    with pytest.raises(ValueError, match="json path"):
        list(TJson(**bad).link_from(
            TMemS(_rows_table("torch"), batch_size=64)).timed_batches())
    tskip = TJson(skip_failed=True, **bad).link_from(
        TMemS(_rows_table("torch"), batch_size=64))
    jskip = JsonValueStreamOp(skip_failed=True, ml_environment_id=jsid,
                              **bad).link_from(
        __import__("alink_tpu.operator.stream.source.sources",
                   fromlist=["MemSourceStreamOp"]).MemSourceStreamOp(
            _rows_table("jax"), batch_size=64, ml_environment_id=jsid))
    assert [mt.to_rows() for mt in tskip.micro_batches()] == \
        [mt.to_rows() for mt in jskip.micro_batches()]
