"""Slice 15 of the port: ALS on the CPU against the JAX package.

The same seeded ratings go through ``alink_tpu``'s ALS (its JAX side on
a 1-device session, and in float32, as the JAX package trains on its
chip: ``jax.enable_x64(False)``) and the port's (``device="cpu"``).
Both are float32 throughout; XLA's CPU cumsum and its fused
``M - M[:, i] * piv`` round in another order than torch's, so the
factors agree to ulps, not bits. Tolerances, with the gaps measured on
these fixtures:

* ``batched_spd_solve``: float32 within 2e-6 of each row's largest
  |x| (measured 2.8e-7; the JAX package pins about 1e-6 for the solve),
  float64 within 1e-12 (measured 4.7e-16);
* ``als_train`` (explicit, nonnegative, ``shard_solve``): factors
  within 2e-5 of their largest |value| after 6 supersteps (measured
  2.4e-6 to 4.3e-6), the RMSE curve within rtol 1e-6 (measured 9.6e-8);
* implicit preferences (alpha 40, condition numbers in the thousands):
  within 5e-5 after one superstep (measured 1.1e-5); after 6, the
  port's gap to the JAX package in float32 is at most 3x the JAX
  package's own float32-to-float64 gap (measured 1.2e-3 against
  8.4e-4 to 1.8e-3);
* ``shard_solve=True`` is bitwise ``shard_solve=False`` at one worker
  (both collectives are the identity);
* ``batched_nnls`` meets the JAX test's KKT and scipy checks;
* rating and top-K are the JAX package's host float64 numpy: equal to
  the JAX ops' output on the same model table.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.operator.batch.recommendation import als_ops as jops
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.recommendation import als as ja
from alink_tpu.operator.stream.recommendation import \
    AlsPredictStreamOp as JStreamPredict
from alink_tpu.operator.stream.source import MemSourceStreamOp as JMemStream
from alink_tpu.ops.smallsolve import batched_spd_solve as jsolve
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.engine import communication as tcomm
from alink_tpu_torch.operator.batch.recommendation import als_ops as tops
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.recommendation import als as ta
from alink_tpu_torch.operator.stream import AlsPredictStreamOp as TStreamPredict
from alink_tpu_torch.operator.stream.source import \
    MemSourceStreamOp as TMemStream
from alink_tpu_torch.ops.smallsolve import batched_spd_solve as tsolve
from alink_tpu_torch.pipeline import ALS as TALS

SCHEMA = "user LONG, item LONG, rating DOUBLE"


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


@pytest.fixture
def jax_default_1dev(jenv):
    """The JAX ops train on the default session: make it 1-device for
    the test, and put the 8-device one back after."""
    prev = JFactory.get_default()
    JFactory.set_default(jenv)
    yield jenv
    JFactory.set_default(prev)


def _ratings(n_users=30, n_items=20, rank=3, seed=0, frac=0.6):
    """tests/test_als.py::_ratings"""
    rng = np.random.RandomState(seed)
    U = rng.rand(n_users, rank)
    V = rng.rand(n_items, rank)
    R = U @ V.T
    rows = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.rand() < frac:
                rows.append((u, i, float(R[u, i])))
    return rows, R


def _coo(seed=5, n=3000, U=100, I=60):
    """tests/test_als.py::_coo"""
    rng = np.random.RandomState(seed)
    users = rng.randint(0, U, n).astype(np.int32)
    items = rng.randint(0, I, n).astype(np.int32)
    ratings = (rng.rand(n) * 5).astype(np.float32)
    return users, items, ratings, U, I


def _jax_f32(users, items, ratings, p, env, U, I):
    with jax.enable_x64(False):
        uf, if_, curve = ja.als_train(users, items, ratings, p, env,
                                      num_users=U, num_items=I)
    return np.asarray(uf), np.asarray(if_), np.asarray(curve)


def _gap(a, b):
    """max |a - b| over the largest |b|."""
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


def _train_ops(rows, jax_env, **kw):
    """The port's and the JAX package's AlsTrainBatchOp on the same rows."""
    t = TMem(rows, SCHEMA)
    j = JMem(rows, SCHEMA)
    tt = tops.AlsTrainBatchOp(user_col="user", item_col="item",
                              rate_col="rating", device="cpu",
                              **kw).link_from(t)
    with jax.enable_x64(False):
        jt = jops.AlsTrainBatchOp(user_col="user", item_col="item",
                                  rate_col="rating", **kw).link_from(j)
    return t, tt, j, jt


# -- the small solve -----------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6),
                                       (np.float64, 1e-12)])
def test_batched_spd_solve_matches_jax(dtype, tol):
    rng = np.random.RandomState(0)
    M = rng.randn(256, 30, 10).astype(dtype)
    A = np.einsum("nki,nkj->nij", M, M) + dtype(0.1) * np.eye(10, dtype=dtype)
    b = rng.randn(256, 10).astype(dtype)
    want = np.asarray(jsolve(jnp.asarray(A), jnp.asarray(b)))
    got = tsolve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert got.dtype == dtype and want.dtype == dtype
    gap = np.abs(got - want) / np.abs(want).max(1, keepdims=True)
    assert gap.max() <= tol, gap.max()
    exact = np.linalg.solve(A.astype(np.float64),
                            b.astype(np.float64)[..., None])[..., 0]
    assert np.abs(got - exact).max() <= 1e-4 * np.abs(exact).max()


# -- the one-worker collectives -------------------------------------------------

def test_psum_scatter_and_all_gather_at_one_worker():
    x = torch.arange(12.0).reshape(4, 3)
    for tiled_fn in (
            lambda v: tcomm.manifest_psum_scatter(v, "d", tiled=True),
            lambda v: tcomm.manifest_all_gather(v, "d", axis=0, tiled=True)):
        assert tiled_fn(x) is x
    g = tcomm.manifest_all_gather(x, "d", axis=1)
    assert g.shape == (4, 1, 3) and torch.equal(g[:, 0], x)
    s = tcomm.manifest_psum_scatter(x[None], "d", scatter_dimension=0)
    assert s.shape == (4, 3) and torch.equal(s, x)
    with pytest.raises(ValueError, match="length 1"):
        tcomm.manifest_psum_scatter(x, "d", scatter_dimension=0)
    for fn in (tcomm.manifest_psum_scatter, tcomm.manifest_all_gather):
        with pytest.raises(NotImplementedError, match="2 workers"):
            fn(x, "d", tiled=True, num_workers=2)


# -- FISTA ------------------------------------------------------------------------

def test_batched_nnls_kkt_and_scipy_parity():
    """tests/test_als.py's KKT and scipy.optimize.nnls checks, on the
    port's batched_nnls in float64."""
    from scipy.optimize import nnls as scipy_nnls
    rng = np.random.RandomState(0)
    r = 6
    Ms = [rng.randn(20, r) for _ in range(20)]
    ys = [rng.randn(20) for _ in range(20)]
    A = np.stack([M.T @ M for M in Ms])
    b = np.stack([M.T @ y for M, y in zip(Ms, ys)])
    x = ta.batched_nnls(torch.from_numpy(A), torch.from_numpy(b),
                        num_iter=500).numpy()
    assert (x >= 0).all()
    g = np.einsum("nij,nj->ni", A, x) - b
    active = x <= 1e-6
    assert np.abs(g[~active]).max() < 1e-3
    assert g[active].min() > -1e-3
    assert np.abs(g * x).max() < 1e-3
    for i in range(20):
        gold, _ = scipy_nnls(Ms[i], ys[i])
        np.testing.assert_allclose(x[i], gold, atol=5e-4)


def test_batched_nnls_matches_jax():
    """float64, 80 iterations from a warm start: the momentum sequence
    and the projections agree with the JAX package's fori_loop."""
    rng = np.random.RandomState(3)
    M = rng.randn(64, 12, 5)
    A = np.einsum("nki,nkj->nij", M, M)
    b = rng.randn(64, 5)
    x0 = np.maximum(rng.randn(64, 5), 0.0)
    want = np.asarray(ja.batched_nnls(jnp.asarray(A), jnp.asarray(b),
                                      x0=jnp.asarray(x0)))
    got = ta.batched_nnls(torch.from_numpy(A), torch.from_numpy(b),
                          x0=torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


# -- als_train against the JAX package ----------------------------------------

@pytest.mark.parametrize("mode", ["explicit", "nonnegative", "shard_solve"])
def test_als_train_matches_jax(mode, jenv, tenv):
    users, items, ratings, U, I = _coo()
    kw = {} if mode == "explicit" else {mode: True}
    p = ta.AlsTrainParams(rank=4, num_iter=6, seed=2, **kw)
    juf, jif, jc = _jax_f32(users, items, ratings,
                            ja.AlsTrainParams(**vars(p)), jenv, U, I)
    uf, if_, curve = ta.als_train(users, items, ratings, p, tenv,
                                  num_users=U, num_items=I)
    assert uf.dtype == np.float32 and if_.dtype == np.float32
    assert uf.shape == (U, 4) and if_.shape == (I, 4) and len(curve) == 6
    assert _gap(uf, juf) <= 2e-5 and _gap(if_, jif) <= 2e-5, \
        (_gap(uf, juf), _gap(if_, jif))
    np.testing.assert_allclose(curve, jc, rtol=1e-6)
    if mode == "nonnegative":
        assert (uf >= 0).all() and (if_ >= 0).all()


def test_als_train_implicit_matches_jax(jenv, tenv):
    users, items, ratings, U, I = _coo()
    p = ta.AlsTrainParams(rank=4, num_iter=1, seed=2, implicit_prefs=True)
    juf, jif, jc = _jax_f32(users, items, ratings,
                            ja.AlsTrainParams(**vars(p)), jenv, U, I)
    uf, if_, curve = ta.als_train(users, items, ratings, p, tenv,
                                  num_users=U, num_items=I)
    assert _gap(uf, juf) <= 5e-5 and _gap(if_, jif) <= 5e-5
    np.testing.assert_allclose(curve, jc, rtol=1e-5)
    # six supersteps: the condition numbers amplify float32 rounding, so
    # the yardstick is the JAX package's own float32-to-float64 gap
    p6 = replace(p, num_iter=6)
    jp6 = ja.AlsTrainParams(**vars(p6))
    juf, jif, _ = _jax_f32(users, items, ratings, jp6, jenv, U, I)
    j64u, j64i, _ = ja.als_train(users, items, ratings, jp6, jenv,
                                 num_users=U, num_items=I)
    uf, if_, _ = ta.als_train(users, items, ratings, p6, tenv,
                              num_users=U, num_items=I)
    for got, want, ref64 in ((uf, juf, j64u), (if_, jif, j64i)):
        assert _gap(got, want) <= 3 * _gap(want, np.asarray(ref64)), \
            (_gap(got, want), _gap(want, np.asarray(ref64)))


def test_shard_solve_is_plain_at_one_worker(tenv):
    users, items, ratings, U, I = _coo(seed=9, n=1500, U=40, I=30)
    for nonneg in (False, True):
        p = ta.AlsTrainParams(rank=3, num_iter=4, nonnegative=nonneg, seed=1)
        a = ta.als_train(users, items, ratings, p, tenv, num_users=U,
                         num_items=I)
        b = ta.als_train(users, items, ratings, replace(p, shard_solve=True),
                         tenv, num_users=U, num_items=I)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_one_sweep_matches_numpy_normal_equations(tenv):
    """tests/test_als.py's dense numpy reference of one sweep."""
    rng = np.random.RandomState(5)
    U, I, r, nnz = 17, 13, 4, 150
    users = rng.randint(0, U, nnz).astype(np.int32)
    items = rng.randint(0, I, nnz).astype(np.int32)
    ratings = rng.rand(nnz).astype(np.float32) * 4 + 1
    lam = 0.2
    p = ta.AlsTrainParams(rank=r, num_iter=1, lambda_reg=lam, seed=3)
    uf, if_, _ = ta.als_train(users, items, ratings, p, tenv,
                              num_users=U, num_items=I)
    rr = np.random.RandomState(3)
    rr.rand(U, r)                                   # uf0's draw
    if0 = (rr.rand(I, r) / np.sqrt(r)).astype(np.float64)

    def solve_ref(ids, oids, n_rows, ofac):
        out = np.zeros((n_rows, r))
        for row in range(n_rows):
            m = ids == row
            X = ofac[oids[m]]
            cnt = m.sum()
            A = X.T @ X + lam * max(cnt, 1) * np.eye(r)
            b = X.T @ ratings[m].astype(np.float64)
            out[row] = np.linalg.solve(A, b) if cnt else 0.0
        return out

    uf_ref = solve_ref(users, items, U, if0)
    if_ref = solve_ref(items, users, I, uf_ref)
    np.testing.assert_allclose(uf, uf_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(if_, if_ref, rtol=2e-4, atol=2e-5)


def test_tol_early_stop_matches_jax(jenv, tenv):
    """tests/test_als.py's early stop: ``tol > 0`` stops on the RMSE
    delta after the burn-in, and the curve's length is the count run;
    the port stops where the JAX package does (its deltas at the stop lie
    clear of tol on this fixture)."""
    rng = np.random.RandomState(0)
    U, I, r = 40, 30, 3
    uf = rng.rand(U, r).astype(np.float32)
    if_ = rng.rand(I, r).astype(np.float32)
    users, items = np.meshgrid(np.arange(U), np.arange(I), indexing="ij")
    users, items = users.ravel(), items.ravel()
    ratings = (uf[users] * if_[items]).sum(1)
    p = ta.AlsTrainParams(rank=r, num_iter=50, lambda_reg=1e-3, tol=1e-4)
    _, _, curve = ta.als_train(users, items, ratings, p, tenv)
    assert 1 < len(curve) < 50, len(curve)
    assert curve[-1] < 0.1
    _, _, jc = _jax_f32(users, items, ratings, ja.AlsTrainParams(**vars(p)),
                        jenv, U, I)
    deltas = np.abs(np.diff(jc))
    assert np.abs(deltas[-2:] - p.tol).min() > 0.1 * p.tol
    assert len(curve) == len(jc)
    # an RMSE near 6e-4 carries the float32 rounding of O(1) predictions:
    # absolute 1e-6 (measured 2.3e-7)
    np.testing.assert_allclose(curve, jc, rtol=1e-5, atol=1e-6)
    _, _, curve0 = ta.als_train(users, items, ratings,
                                replace(p, num_iter=7, tol=0.0), tenv)
    assert len(curve0) == 7


# -- the operators --------------------------------------------------------------

def test_reconstruction_and_predict_match_jax(jax_default_1dev):
    rows, R = _ratings()
    t, tt, j, jt = _train_ops(rows, jax_default_1dev, rank=6, num_iter=15,
                              lambda_=0.01)
    curve = np.asarray(tt.get_side_output(0).get_output_table()
                       .col("train_rmse"))
    jcurve = np.asarray(jt.get_side_output(0).get_output_table()
                        .col("train_rmse"))
    assert list(tt.get_side_output(0).get_output_table().col("iter")) == \
        list(range(1, 16))
    assert curve[-1] < 0.05 and curve[-1] <= curve[0]
    np.testing.assert_allclose(curve, jcurve, rtol=1e-4)   # measured 5.0e-5
    pred = tops.AlsPredictBatchOp(user_col="user", item_col="item",
                                  prediction_col="pred").link_from(tt, t)
    out = pred.get_output_table()
    err = np.abs(np.asarray(out.col("pred")) - np.asarray(out.col("rating")))
    assert err.mean() < 0.05
    # the port's table rated by the JAX op: the same float64 numbers
    jpred = jops.AlsPredictBatchOp(
        user_col="user", item_col="item", prediction_col="pred").link_from(
        JMem(tt.get_output_table().to_rows(), "model_id LONG, model_info "
             "STRING"), j).get_output_table()
    assert np.array_equal(np.asarray(out.col("pred")),
                          np.asarray(jpred.col("pred")))


def test_topk_and_cold_user(jax_default_1dev):
    rows, R = _ratings()
    t, tt, j, jt = _train_ops(rows, jax_default_1dev, rank=6, num_iter=10,
                              lambda_=0.01)
    users = [(0,), (5,), (9999,)]
    out = tops.AlsTopKPredictBatchOp(
        user_col="user", prediction_col="recs", top_k=5).link_from(
        tt, TMem(users, "user LONG")).get_output_table()
    rec0 = json.loads(out.col("recs")[0])
    assert len(rec0["object"]) == 5
    assert R[0, int(rec0["object"][0])] >= np.median(R[0])
    assert out.col("recs")[2] is None
    # the JAX op on the port's model table gives the same strings
    jout = jops.AlsTopKPredictBatchOp(
        user_col="user", prediction_col="recs", top_k=5).link_from(
        JMem(tt.get_output_table().to_rows(),
             "model_id LONG, model_info STRING"),
        JMem(users, "user LONG")).get_output_table()
    assert list(out.col("recs")) == list(jout.col("recs"))


def test_predict_vectorized_matches_loop(jax_default_1dev):
    """tests/test_als.py: the gather + einsum rating equals a per-row loop
    over the factor dicts, NaN for unknown ids."""
    rows, _ = _ratings()
    t, tt, _, _ = _train_ops(rows, jax_default_1dev, rank=4, num_iter=5)
    rng = np.random.RandomState(7)
    req = [(int(rng.randint(0, 35)), int(rng.randint(0, 24)))
           for _ in range(5000)]
    rater = tops.AlsRater(tt.get_output_table())
    out = rater.rate_table(TMem(req, "user LONG, item LONG")
                           .get_output_table(), "user", "item", "pred")
    got = np.asarray(out.col("pred"), np.float64)
    m = rater.m
    uD = {int(u): f for u, f in zip(m.user_ids, m.user_factors)}
    iD = {int(i): f for i, f in zip(m.item_ids, m.item_factors)}
    want = np.asarray([float(uD[u] @ iD[i]) if u in uD and i in iD
                       else np.nan for u, i in req])
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(want)], want[~np.isnan(want)],
                               rtol=1e-12)


def test_implicit_op(jax_default_1dev):
    rows, R = _ratings(frac=0.5)
    rows = [(u, i, 1.0 if r > np.median(R) else 0.0) for u, i, r in rows]
    _, tt, _, jt = _train_ops(rows, jax_default_1dev, rank=5, num_iter=10,
                              implicit_prefs=True, alpha=10.0)
    m = tops.AlsModelDataConverter().load_model(tt.get_output_table())
    assert m.user_factors.shape == (30, 5)
    lookup = {(u, i): r for u, i, r in rows}
    S = m.user_factors @ m.item_factors.T
    clicked = [S[u, i] for (u, i), r in lookup.items() if r > 0]
    unclicked = [S[u, i] for (u, i), r in lookup.items() if r <= 0]
    assert np.mean(clicked) > np.mean(unclicked)
    jm = jops.AlsModelDataConverter().load_model(jt.get_output_table())
    assert _gap(m.user_factors, jm.user_factors) <= 2e-4   # measured 4.5e-5


def test_nonnegative_op(jax_default_1dev):
    rows, R = _ratings(frac=0.6)
    _, tt, _, jt = _train_ops(rows, jax_default_1dev, rank=5, num_iter=10,
                              nonnegative=True)
    m = tops.AlsModelDataConverter().load_model(tt.get_output_table())
    assert (m.user_factors >= 0).all() and (m.item_factors >= 0).all()
    S = m.user_factors @ m.item_factors.T
    assert np.mean([abs(S[u, i] - r) for u, i, r in rows]) < 0.8
    jm = jops.AlsModelDataConverter().load_model(jt.get_output_table())
    # measured 6.1e-6 and 5.8e-6
    assert _gap(m.user_factors, jm.user_factors) <= 5e-5
    assert _gap(m.item_factors, jm.item_factors) <= 5e-5


def test_string_ids_ordered_as_the_jax_package(jax_default_1dev):
    """Ids are ordered by ``str`` and round-trip through the model table
    as strings; the port's and the JAX package's tables list them
    alike."""
    rows = [(f"u{u}", 10 * i + 3, r) for u, i, r in _ratings()[0]]
    schema = "user STRING, item LONG, rating DOUBLE"
    tt = tops.AlsTrainBatchOp(user_col="user", item_col="item",
                              rate_col="rating", rank=3, num_iter=2,
                              device="cpu").link_from(TMem(rows, schema))
    with jax.enable_x64(False):
        jt = jops.AlsTrainBatchOp(user_col="user", item_col="item",
                                  rate_col="rating", rank=3,
                                  num_iter=2).link_from(JMem(rows, schema))
    m = tops.AlsModelDataConverter().load_model(tt.get_output_table())
    jm = jops.AlsModelDataConverter().load_model(jt.get_output_table())
    assert m.user_ids == jm.user_ids and m.item_ids == jm.item_ids
    assert m.user_ids[:3] == ["u0", "u1", "u10"]


def test_model_tables_load_both_ways(jax_default_1dev):
    rows, _ = _ratings()
    _, tt, _, jt = _train_ops(rows, jax_default_1dev, rank=4, num_iter=3)
    for table, conv in ((tt.get_output_table(), jops.AlsModelDataConverter),
                        (jt.get_output_table(), tops.AlsModelDataConverter)):
        m = conv().load_model(table)
        src = (tops if conv is jops.AlsModelDataConverter else jops) \
            .AlsModelDataConverter().load_model(table)
        assert m.user_ids == src.user_ids and m.item_ids == src.item_ids
        assert np.array_equal(m.user_factors, src.user_factors)
        assert np.array_equal(m.item_factors, src.item_factors)
        assert (m.user_col, m.item_col, m.rate_col) == ("user", "item",
                                                        "rating")
    # a JAX-trained table rated by the port equals the JAX op's rating
    req = [(u, i) for u in range(0, 34, 3) for i in range(0, 22, 4)]
    got = tops.AlsPredictBatchOp(user_col="user", item_col="item",
                                 prediction_col="p").link_from(
        TMem(jt.get_output_table().to_rows(),
             "model_id LONG, model_info STRING"),
        TMem(req, "user LONG, item LONG")).get_output_table()
    want = jops.AlsPredictBatchOp(user_col="user", item_col="item",
                                  prediction_col="p").link_from(
        jt, JMem(req, "user LONG, item LONG")).get_output_table()
    np.testing.assert_array_equal(np.asarray(got.col("p")),
                                  np.asarray(want.col("p")))


def test_stream_predict_equals_batch(jax_default_1dev):
    rows, _ = _ratings()
    _, tt, _, jt = _train_ops(rows, jax_default_1dev, rank=4, num_iter=3)
    rng = np.random.RandomState(2)
    req = [(int(rng.randint(0, 33)), int(rng.randint(0, 22)), float(k))
           for k in range(700)]
    schema = "user LONG, item LONG, k DOUBLE"
    batch = tops.AlsPredictBatchOp(
        user_col="user", item_col="item", prediction_col="p").link_from(
        tt, TMem(req, schema)).get_output_table()
    stream = TStreamPredict(tt, user_col="user", item_col="item",
                            prediction_col="p").link_from(
        TMemStream(req, schema, batch_size=128))
    got = [mt for mt in stream.micro_batches()]
    assert len(got) == 6
    cat = got[0]
    for mt in got[1:]:
        cat = cat.concat_rows(mt)
    assert cat.col_names == batch.col_names
    p = np.asarray(cat.col("p"), np.float64)
    want = np.asarray(batch.col("p"), np.float64)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(p, want)
    # the JAX package's stream op on the same (port-trained) model
    jstream = JStreamPredict(
        JMem(tt.get_output_table().to_rows(),
             "model_id LONG, model_info STRING"),
        user_col="user", item_col="item", prediction_col="p").link_from(
        JMemStream(req, schema, batch_size=128))
    jp = np.concatenate([np.asarray(mt.col("p"), np.float64)
                         for mt in jstream.micro_batches()])
    np.testing.assert_array_equal(p, jp)


def test_pipeline_als_equals_the_ops(jax_default_1dev):
    rows, _ = _ratings()
    src = TMem(rows, SCHEMA)
    model = TALS(user_col="user", item_col="item", rate_col="rating",
                 rank=4, num_iter=4, prediction_col="p",
                 device="cpu").fit(src)
    op = tops.AlsTrainBatchOp(user_col="user", item_col="item",
                              rate_col="rating", rank=4, num_iter=4,
                              device="cpu").link_from(src)
    assert model.get_model_data().to_rows() == \
        op.get_output_table().to_rows()
    got = model.transform(src).get_output_table()
    want = tops.AlsPredictBatchOp(user_col="user", item_col="item",
                                  prediction_col="p").link_from(
        op, src).get_output_table()
    np.testing.assert_array_equal(np.asarray(got.col("p")),
                                  np.asarray(want.col("p")))
    top = model.recommend_top_k(TMem([(1,), (2,)], "user LONG"), k=3) \
        .get_output_table()
    assert [len(json.loads(s)["object"]) for s in top.col("p")] == [3, 3]


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.AlsTrainBatchOp(user_col="u", item_col="i", rate_col="r")
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.als_train([0], [0], [1.0], ta.AlsTrainParams(rank=2, num_iter=1),
                     TEnv())
    table = TMTable({"user": np.array([0, 1]), "item": np.array([1, 0]),
                     "rating": np.array([1.0, 2.0])}, SCHEMA)
    with pytest.raises(RuntimeError, match="CUDA"):
        TALS(user_col="user", item_col="item", rate_col="rating").fit(table)
