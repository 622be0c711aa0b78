"""GMM and bisecting KMeans batch operators.

Counterpart: ``alink_tpu/operator/batch/clustering/gmm_bisecting.py`` (the
re-design of the reference's batch/clustering/GmmTrainBatchOp,
GmmPredictBatchOp with common/clustering/GmmModelData, and
BisectingKMeansTrainBatchOp). The model tables are the JAX package's, so
a table saved by either package loads in the other.

GMM is EM on the one-worker BSP engine (``gmm_train``): the E-step's
responsibilities and the sufficient statistics (``s0`` = sum r, ``s1`` =
sum r x, ``s2`` = sum r x x^T and the weighted log-likelihood), one
``AllReduce``, the update, and a stop when the change of the mean
log-likelihood drops below ``tol``. The log densities (``_log_gauss``)
take batched Cholesky factors and their explicit inverses, one product a
component; ``s2`` is one product a component, ``(x r_c)^T x``, so the
peak holds an ``(n, d)`` block where the JAX package's einsum names an
``(n, k, d, d)`` one. The JAX package's weak-typed constants are the
tensor's dtype here: ``1e-300`` is 0 in float32, as there. The train op
takes ``device=`` and ``dtype=`` as the linear train ops do; the mapper
and the predict op take ``device=`` and compute the log densities there
in float64.

Bisecting KMeans is the JAX package's host loop: the cluster of the
largest SSE splits by ``kmeans_train`` at k = 2 with the seed ``seed +
len(centroids)``, its rows assigned by ``_assign_np`` (host numpy, the
first index on ties). The splits run on ``device`` in ``dtype``. Its
model is the KMeans model; ``KMeansModelMapper`` assigns.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes
from ....engine import AllReduce, IterativeComQueue
from ....engine.comqueue import freeze_config
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import (HasFeatureCols, HasMaxIterDefaultAs100,
                               HasPredictionCol, HasPredictionDetailCol,
                               HasReservedCols, HasSeed, HasVectorCol)
from ...base import BatchOperator
from ...common.clustering.kmeans import kmeans_plus_plus_init, kmeans_train
from ...common.dataproc.feature_extract import (extract_dense_matrix,
                                                resolve_feature_cols)
from ...common.optim.objfunc import check_full_float32
from ..utils.model_map import DeviceModelMapBatchOp, DeviceTrainBatchOp
from .kmeans_ops import (KMeansModelData, KMeansModelDataConverter,
                         KMeansModelMapper, KMeansPredictBatchOp,
                         _KMeansParams)


def _table_to_matrix(op, t: MTable):
    vector_col = op.params._m.get("vector_col")
    feature_cols = op.params._m.get("feature_cols")
    if not vector_col:
        feature_cols = resolve_feature_cols(t, feature_cols)
    return (extract_dense_matrix(t, feature_cols, vector_col), feature_cols,
            vector_col)


# ---------------------------------------------------------------------------
# GMM
# ---------------------------------------------------------------------------

class GmmModelDataConverter(SimpleModelDataConverter):
    """reference: common/clustering/GmmModelData.java"""

    def serialize_model(self, model):
        meta = Params({"k": model["means"].shape[0],
                       "vector_col": model["vector_col"],
                       "feature_cols": model["feature_cols"]})
        return meta, [encode_array(model["weights"]), encode_array(model["means"]),
                      encode_array(model["covs"])]

    def deserialize_model(self, meta, data):
        return {"weights": decode_array(data[0]), "means": decode_array(data[1]),
                "covs": decode_array(data[2]),
                "vector_col": meta._m.get("vector_col"),
                "feature_cols": meta._m.get("feature_cols")}


def _log_gauss(X, means, covs):
    """(n, k) log N(x | mu_c, Sigma_c) by batched Cholesky factors and
    their explicit inverses (small d), one product a component."""
    d = X.shape[1]
    chol = torch.linalg.cholesky(covs)                       # (k, d, d)
    inv_chol = torch.linalg.inv(chol)
    maha = torch.stack([(((X - means[c]) @ inv_chol[c].T) ** 2).sum(-1)
                        for c in range(means.shape[0])], 1)  # (n, k)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(-1)
    return -0.5 * (d * np.log(2 * np.pi) + logdet[None, :] + maha)


def _floor(x, v: float):
    """``max(x, v)`` with ``v`` in ``x``'s dtype (JAX's weak-typed
    constant: ``1e-300`` is 0 in float32)."""
    return torch.maximum(x, torch.tensor(v, dtype=x.dtype, device=x.device))


def gmm_estep(block, d: int, means, covs, weights):
    """The E-step of a ``(n, d + 1)`` block (features, then the row
    weight): ``{"s0", "s1", "s2", "ll"}``, the weighted sums of the
    responsibilities, of ``r x``, of ``r x x^T`` and (log-likelihood,
    weight)."""
    Xb, wb = block[:, :d], block[:, d]
    lg = _log_gauss(Xb, means, covs) + torch.log(_floor(weights, 1e-300))[None, :]
    lse = torch.logsumexp(lg, 1)
    resp = torch.exp(lg - lse[:, None]) * wb[:, None]       # (n, k)
    s0 = resp.sum(0)
    s1 = resp.T @ Xb
    s2 = torch.stack([(Xb * resp[:, c:c + 1]).T @ Xb
                      for c in range(resp.shape[1])])       # (k, d, d)
    ll = (lse * wb).sum()
    return {"s0": s0, "s1": s1, "s2": s2, "ll": torch.stack([ll, wb.sum()])}


def gmm_update(st, d: int, reg: float):
    """The M-step: (weights, means, covs, mean log-likelihood)."""
    s0, s1, s2 = st["s0"], st["s1"], st["s2"]
    tot = _floor(s0.sum(), 1e-12)
    means = s1 / _floor(s0[:, None], 1e-12)
    covs = (s2 / _floor(s0[:, None, None], 1e-12)
            - means[:, :, None] * means[:, None, :])
    covs = covs + reg * torch.eye(d, dtype=covs.dtype, device=covs.device)[None]
    ll = st["ll"][0] / _floor(st["ll"][1], 1e-12)
    return s0 / tot, means, covs, ll


def gmm_train(X: np.ndarray, k: int, max_iter: int = 100, tol: float = 1e-4,
              seed: int = 0, reg: float = 1e-6,
              env: Optional[MLEnvironment] = None,
              dtype: torch.dtype = torch.float64):
    """EM on ``env``'s device in ``dtype`` from k-means++ means of the
    float64 rows ``X``; returns (weights, means, covs, log-likelihood,
    supersteps)."""
    n, d = X.shape
    init_means = kmeans_plus_plus_init(X, k, seed)
    np_dt = DeviceTrainBatchOp.NP_DTYPES[dtype]
    data = np.concatenate([X, np.ones((n, 1))], 1).astype(np_dt)

    def estep(ctx):
        if ctx.is_entry_step:
            check_full_float32({"X": ctx.get_obj("data")})
        if ctx.is_init_step:
            block = ctx.get_obj("data")
            kw = dict(dtype=block.dtype, device=block.device)
            ctx.put_obj("means", ctx.get_obj("init_means"))
            ctx.put_obj("covs", torch.eye(d, **kw)[None].repeat(k, 1, 1))
            ctx.put_obj("weights", torch.full((k,), 1.0 / k, **kw))
            ctx.put_obj("loglik", torch.tensor(-np.inf, **kw))
            ctx.put_obj("delta", torch.tensor(np.inf, **kw))
        ctx.put_obj("stats", gmm_estep(ctx.get_obj("data"), d,
                                       ctx.get_obj("means"),
                                       ctx.get_obj("covs"),
                                       ctx.get_obj("weights")))

    def update(ctx):
        weights, means, covs, ll = gmm_update(ctx.get_obj("stats"), d, reg)
        ctx.put_obj("means", means)
        ctx.put_obj("covs", covs)
        ctx.put_obj("weights", weights)
        ctx.put_obj("delta", torch.abs(ll - ctx.get_obj("loglik")))
        ctx.put_obj("loglik", ll)

    res = (IterativeComQueue(env=env, max_iter=max_iter, seed=seed)
           .init_with_partitioned_data("data", data)
           .init_with_broadcast_data("init_means", init_means.astype(np_dt))
           .add(estep)
           .add(AllReduce("stats"))
           .add(update)
           .set_compare_criterion(lambda ctx: ctx.get_obj("delta") < tol)
           .set_program_key(("gmm", k, d, float(tol), float(reg), str(dtype),
                             freeze_config(init_means)))
           .exec())
    return (res.get("weights"), res.get("means"), res.get("covs"),
            float(res.get("loglik")), res.step_count)


class GmmTrainBatchOp(DeviceTrainBatchOp, HasVectorCol, HasFeatureCols,
                      HasMaxIterDefaultAs100, HasSeed):
    """reference: batch/clustering/GmmTrainBatchOp. EM on ``device``
    (``cuda`` by default) in ``dtype``."""
    K = ParamInfo("k", int, default=2, validator=RangeValidator(1, None))
    EPSILON = ParamInfo("epsilon", float, default=1e-4)

    def link_from(self, in_op: BatchOperator) -> "GmmTrainBatchOp":
        t = in_op.get_output_table()
        X, feature_cols, vector_col = _table_to_matrix(self, t)
        weights, means, covs, ll, steps = gmm_train(
            X, self.get_k(), self.get_max_iter(), self.get_epsilon(),
            self.get_seed(), env=MLEnvironment(device=self.device),
            dtype=self.dtype)
        self._output = GmmModelDataConverter().save_model({
            "weights": np.asarray(weights), "means": np.asarray(means),
            "covs": np.asarray(covs), "vector_col": vector_col,
            "feature_cols": feature_cols})
        self._steps = steps
        self._loglik = ll
        return self


class GmmModelMapper(ModelMapper):
    """Computes the log densities on ``device`` (``cuda`` by default) in
    float64."""

    def __init__(self, model_schema, data_schema, params=None, device=None,
                 **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.device = resolve_device(device)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = GmmModelDataConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        X = extract_dense_matrix(data, m["feature_cols"], m["vector_col"])
        dev = self.device

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dev)
        lg = _log_gauss(on(X), on(m["means"]), on(m["covs"])).cpu().numpy()
        lg = lg + np.log(np.maximum(m["weights"], 1e-300))[None, :]
        probs = np.exp(lg - lg.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        ids = probs.argmax(1).astype(np.int64)
        vals = [ids]
        if self.params._m.get("prediction_detail_col"):
            vals.append(np.asarray([json.dumps({str(i): float(p)
                                                for i, p in enumerate(row)})
                                    for row in probs], object))
        return self._output(data.schema).build_output(data, vals)

    def _output(self, schema) -> OutputColsHelper:
        cols = [self.params._m.get("prediction_col", "cluster_id")]
        types = [AlinkTypes.LONG]
        if self.params._m.get("prediction_detail_col"):
            cols.append(self.params._m["prediction_detail_col"])
            types.append(AlinkTypes.STRING)
        return OutputColsHelper(schema, cols, types,
                                self.params._m.get("reserved_cols"))

    def get_output_schema(self):
        return self._output(self.data_schema).get_output_schema()


class GmmPredictBatchOp(DeviceModelMapBatchOp, HasPredictionCol,
                        HasPredictionDetailCol, HasReservedCols):
    """Predicts on ``device`` (``cuda`` by default; raises without it)."""
    MAPPER_CLS = GmmModelMapper


# ---------------------------------------------------------------------------
# Bisecting KMeans
# ---------------------------------------------------------------------------

class BisectingKMeansTrainBatchOp(DeviceTrainBatchOp, _KMeansParams):
    """reference: batch/clustering/BisectingKMeansTrainBatchOp.java —
    repeatedly bisect the largest-SSE cluster with k=2 KMeans (its
    ``init_mode``, K_MEANS_PARALLEL by default, as the JAX package's
    ``kmeans_train`` default), on ``device`` in ``dtype``."""

    def link_from(self, in_op: BatchOperator) -> "BisectingKMeansTrainBatchOp":
        t = in_op.get_output_table()
        X, feature_cols, vector_col = _table_to_matrix(self, t)
        Xd = X.astype(self.np_dtype)
        env = MLEnvironment(device=self.device)
        k = self.get_k()
        assign = np.zeros(X.shape[0], np.int64)
        centroids = [X.mean(0)]
        while len(centroids) < k:
            sse = [((X[assign == c] - centroids[c]) ** 2).sum()
                   for c in range(len(centroids))]
            target = int(np.argmax(sse))
            mask = assign == target
            if mask.sum() < 2:
                break
            sub_c, _, _ = kmeans_train(
                Xd[mask], 2, max_iter=self.get_max_iter(),
                tol=self.get_epsilon(), init=self.get_init_mode(),
                seed=self.get_seed() + len(centroids), env=env)
            sub_c = np.asarray(sub_c, np.float64)
            sub_ids, _ = _assign_np(X[mask], sub_c)
            new_id = len(centroids)
            idxs = np.nonzero(mask)[0]
            assign[idxs[sub_ids == 1]] = new_id
            centroids[target] = sub_c[0]
            centroids.append(sub_c[1])
        cents = np.stack(centroids)
        weights = np.asarray([(assign == c).sum() for c in range(len(centroids))],
                             np.float64)
        model = KMeansModelData(cents, weights, self.get_distance_type(),
                                vector_col, feature_cols)
        self._output = KMeansModelDataConverter().save_model(model)
        return self


def _assign_np(X, C):
    D = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    ids = D.argmin(1)
    return ids, D[np.arange(len(X)), ids]


class BisectingKMeansPredictBatchOp(KMeansPredictBatchOp):
    """Assigns on ``device`` (``cuda`` by default; raises without it)."""
    MAPPER_CLS = KMeansModelMapper
