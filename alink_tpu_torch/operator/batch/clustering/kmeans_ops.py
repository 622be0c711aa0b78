"""KMeans batch operators and model.

Counterpart: ``alink_tpu/operator/batch/clustering/kmeans_ops.py`` (the
reference's batch/clustering/KMeansTrainBatchOp.java:60-120,
KMeansPredictBatchOp and common/clustering/kmeans/
KMeansModelDataConverter). The model table is the JAX package's, so a
table saved by either package loads in the other. The train op takes
``device=`` and ``dtype=`` as the linear train ops do; the predict op
and ``KMeansModelMapper`` take ``device=`` (``cuda`` unless the caller
asks for the CPU; raises without it) and assign in float64 there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes, TableSchema
from ....common.vector import SparseBatch
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import (HasFeatureCols, HasMaxIterDefaultAs50,
                               HasPredictionCol, HasReservedCols, HasSeed,
                               HasVectorCol)
from ...base import BatchOperator
from ...common.clustering.kmeans import assign_clusters, kmeans_train
from ...common.dataproc.feature_extract import (extract_design,
                                                resolve_feature_cols)
from ..utils.model_map import DeviceModelMapBatchOp, DeviceTrainBatchOp


class KMeansModelData:
    def __init__(self, centroids: np.ndarray, weights: np.ndarray,
                 distance_type: str, vector_col: Optional[str],
                 feature_cols: Optional[List[str]]):
        self.centroids = centroids
        self.weights = weights
        self.distance_type = distance_type
        self.vector_col = vector_col
        self.feature_cols = feature_cols

    @property
    def k(self):
        return self.centroids.shape[0]


class KMeansModelDataConverter(SimpleModelDataConverter):
    """reference: common/clustering/kmeans/KMeansModelDataConverter.java"""

    def serialize_model(self, m: KMeansModelData):
        meta = Params({"k": int(m.k), "distance_type": m.distance_type,
                       "vector_col": m.vector_col, "feature_cols": m.feature_cols})
        return meta, [encode_array(m.centroids), encode_array(m.weights)]

    def deserialize_model(self, meta: Params, data):
        return KMeansModelData(
            centroids=decode_array(data[0]), weights=decode_array(data[1]),
            distance_type=meta._m.get("distance_type", "EUCLIDEAN"),
            vector_col=meta._m.get("vector_col"),
            feature_cols=meta._m.get("feature_cols"))


def _dense(design, dtype) -> np.ndarray:
    if design["kind"] == "dense":
        return design["X"]
    return SparseBatch(design["idx"], design["val"],
                       design["dim"]).to_dense(dtype)


class _KMeansParams(HasVectorCol, HasFeatureCols, HasMaxIterDefaultAs50, HasSeed):
    K = ParamInfo("k", int, "number of clusters", default=2,
                  validator=RangeValidator(1, None))
    EPSILON = ParamInfo("epsilon", float, "centroid-movement tolerance", default=1e-4)
    DISTANCE_TYPE = ParamInfo("distance_type", str, default="EUCLIDEAN",
                              validator=InValidator(["EUCLIDEAN", "COSINE"]))
    INIT_MODE = ParamInfo("init_mode", str, default="K_MEANS_PARALLEL",
                          validator=InValidator(["RANDOM", "K_MEANS_PARALLEL"]))


class KMeansTrainBatchOp(DeviceTrainBatchOp, _KMeansParams):
    """Trains on a one-worker session on ``device`` (``cuda`` by default)
    in ``dtype`` (``torch.float32`` by default; ``torch.float64`` for
    parity with the JAX package under x64)."""

    def link_from(self, in_op: BatchOperator) -> "KMeansTrainBatchOp":
        t = in_op.get_output_table()
        vector_col = self.params._m.get("vector_col")
        feature_cols = self.params._m.get("feature_cols")
        if not vector_col:
            feature_cols = resolve_feature_cols(t, feature_cols)
        dtype = np.float64 if self.dtype == torch.float64 else np.float32
        X = _dense(extract_design(t, feature_cols, vector_col, dtype), dtype)
        cents, wts, steps = kmeans_train(
            X, k=self.get_k(), max_iter=self.get_max_iter(),
            tol=self.get_epsilon(), distance_type=self.get_distance_type(),
            init=self.get_init_mode(), seed=self.get_seed(),
            env=MLEnvironment(device=self.device))
        model = KMeansModelData(np.asarray(cents, np.float64),
                                np.asarray(wts, np.float64),
                                self.get_distance_type(), vector_col, feature_cols)
        self._output = KMeansModelDataConverter().save_model(model)
        self._side_outputs = [MTable({"cluster_id": np.arange(model.k),
                                      "weight": model.weights})]
        self._steps = steps
        return self


class KMeansModelMapper(ModelMapper):
    """reference: common/clustering/kmeans/KMeansModelMapper.java. Assigns
    on ``device`` in float64."""

    def __init__(self, model_schema, data_schema, params=None, device=None,
                 **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.device = resolve_device(device)
        self.model: Optional[KMeansModelData] = None

    def load_model(self, model_table: MTable):
        self.model = KMeansModelDataConverter().load_model(model_table)

    def get_output_schema(self) -> TableSchema:
        pred_col = self.params._m.get("prediction_col", "cluster_id")
        dist_col = self.params._m.get("prediction_distance_col")
        reserved = self.params._m.get("reserved_cols")
        cols, types = [pred_col], [AlinkTypes.LONG]
        if dist_col:
            cols.append(dist_col)
            types.append(AlinkTypes.DOUBLE)
        return OutputColsHelper(self.data_schema, cols, types, reserved).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        X = _dense(extract_design(data, m.feature_cols, m.vector_col,
                                  np.float64), np.float64)
        ids, dists = assign_clusters(
            torch.from_numpy(np.ascontiguousarray(X)).to(self.device),
            torch.from_numpy(np.asarray(m.centroids, np.float64)).to(
                self.device), m.distance_type)
        ids = ids.cpu().numpy().astype(np.int64)
        dists = dists.cpu().numpy()
        dists = np.sqrt(np.maximum(dists, 0.0)) \
            if m.distance_type == "EUCLIDEAN" else dists
        pred_col = self.params._m.get("prediction_col", "cluster_id")
        dist_col = self.params._m.get("prediction_distance_col")
        reserved = self.params._m.get("reserved_cols")
        cols, types, vals = [pred_col], [AlinkTypes.LONG], [ids]
        if dist_col:
            cols.append(dist_col)
            types.append(AlinkTypes.DOUBLE)
            vals.append(dists)
        return OutputColsHelper(data.schema, cols, types, reserved).build_output(data, vals)


class KMeansPredictBatchOp(DeviceModelMapBatchOp, HasPredictionCol,
                           HasReservedCols):
    """Assigns on ``device`` (``cuda`` by default; raises without it)."""
    MAPPER_CLS = KMeansModelMapper
    PREDICTION_DISTANCE_COL = ParamInfo("prediction_distance_col", str,
                                        "output distance column")
