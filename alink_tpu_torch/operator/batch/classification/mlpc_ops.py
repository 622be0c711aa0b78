"""MultilayerPerceptron batch operators.

Counterpart: ``alink_tpu/operator/batch/classification/mlpc_ops.py`` (the
re-design of the reference's MultilayerPerceptronTrainBatchOp and its
predict op: FeedForwardTrainer over the shared L-BFGS). The model table
and its converter are the JAX package's, so a table saved by either
package loads in the other. The host parts are the JAX package's: the
standardization (numpy mean and standard deviation of the design in the
training dtype) and the start ``RandomState(seed).randn(dim)``.

The train op takes ``device=`` (``cuda`` unless the caller asks for the
CPU; raises without it) and ``dtype=`` (``torch.float32`` by default;
``torch.float64`` for parity with the JAX package under x64), where the
JAX package reads ``jax_enable_x64``; L-BFGS runs there
(``ann/mlp.py::MlpObjFunc``, gradients by autograd). The mapper and the
predict op take ``device=`` and run the forward there in float64.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....common.types import AlinkTypes
from ....mapper.base import ModelMapper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import (HasEpsilonDefaultAs000001, HasFeatureCols,
                               HasL2, HasLabelCol, HasMaxIterDefaultAs100,
                               HasPredictionCol, HasPredictionDetailCol,
                               HasReservedCols, HasSeed, HasVectorCol)
from ...base import BatchOperator
from ...common.ann.mlp import MlpObjFunc, mlp_forward
from ...common.dataproc.feature_extract import (extract_dense_matrix,
                                                resolve_feature_cols)
from ...common.linear.base import index_labels
from ...common.optim.optimizers import OptimParams, optimize
from ..utils.model_map import DeviceModelMapBatchOp, DeviceTrainBatchOp
from .naive_bayes import label_output

class MlpModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model):
        meta = Params({"layer_sizes": model["layer_sizes"],
                       "labels": [str(l) for l in model["labels"]],
                       "label_type": model["label_type"],
                       "feature_cols": model["feature_cols"],
                       "vector_col": model["vector_col"],
                       "standardization": model.get("standardization", True)})
        return meta, [encode_array(model["coef"]), encode_array(model["mean"]),
                      encode_array(model["std"])]

    def deserialize_model(self, meta, data):
        labels = meta._m.get("labels", [])
        lt = meta._m.get("label_type", AlinkTypes.STRING)
        if lt in (AlinkTypes.LONG, AlinkTypes.INT):
            labels = [int(float(v)) for v in labels]
        elif lt in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
            labels = [float(v) for v in labels]
        return {"layer_sizes": [int(x) for x in meta._m["layer_sizes"]],
                "labels": labels, "label_type": lt,
                "feature_cols": meta._m.get("feature_cols"),
                "vector_col": meta._m.get("vector_col"),
                "coef": decode_array(data[0]), "mean": decode_array(data[1]),
                "std": decode_array(data[2])}


class MultilayerPerceptronTrainBatchOp(DeviceTrainBatchOp, HasLabelCol, HasFeatureCols,
                                       HasVectorCol, HasMaxIterDefaultAs100,
                                       HasEpsilonDefaultAs000001, HasL2, HasSeed):
    """Trains on ``device`` (``cuda`` by default) in ``dtype``; the side
    output is the loss curve (``iter``, ``loss``)."""
    LAYERS = ParamInfo("layers", list, "hidden+output sizes, e.g. [8, 3]; "
                       "input size is inferred", optional=False)

    def link_from(self, in_op: BatchOperator):
        t = in_op.get_output_table()
        dtype = self.np_dtype
        vector_col = self.params._m.get("vector_col")
        feature_cols = self.params._m.get("feature_cols")
        label_col = self.get_label_col()
        if not vector_col:
            feature_cols = resolve_feature_cols(t, feature_cols, label_col)
        X = extract_dense_matrix(t, feature_cols, vector_col, dtype)
        labels, y = index_labels(t.col(label_col))
        k = len(labels)
        hidden = [int(h) for h in self.get_layers()]
        if hidden and hidden[-1] == k:
            hidden = hidden[:-1]
        layer_sizes = [X.shape[1]] + hidden + [k]
        mean, std = X.mean(0), X.std(0)
        std = np.where(std < 1e-12, 1.0, std)
        Xs = (X - mean) / std
        obj = MlpObjFunc(layer_sizes, l2=float(self.params._m.get("l2", 0.0) or 0.0))
        rng = np.random.RandomState(self.get_seed())
        w0 = (rng.randn(obj.dim) * 0.5 / np.sqrt(max(layer_sizes[0], 1))).astype(dtype)
        coef, curve, steps = optimize(
            obj, {"X": Xs, "y": y.astype(dtype), "w": np.ones(len(y), dtype)},
            OptimParams(method="LBFGS", max_iter=self.get_max_iter(),
                        epsilon=self.get_epsilon(), seed=self.get_seed()),
            MLEnvironment(device=self.device), warm_start=w0)
        self._output = MlpModelConverter().save_model({
            "layer_sizes": layer_sizes, "labels": labels,
            "label_type": t.schema.type_of(label_col),
            "feature_cols": feature_cols, "vector_col": vector_col,
            "coef": np.asarray(coef, np.float64), "mean": mean.astype(np.float64),
            "std": std.astype(np.float64)})
        self._side_outputs = [MTable({"iter": np.arange(1, len(curve) + 1),
                                      "loss": np.asarray(curve, np.float64)})]
        self._steps = steps
        return self


class MlpModelMapper(ModelMapper):
    """Runs the forward on ``device`` (``cuda`` by default) in float64."""

    def __init__(self, model_schema, data_schema, params=None, device=None,
                 **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.device = resolve_device(device)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = MlpModelConverter().load_model(model_table)

    def logits(self, data: MTable) -> np.ndarray:
        """(n, k) float64 logits of the table's rows."""
        m = self.model
        X = extract_dense_matrix(data, m["feature_cols"], m["vector_col"],
                                 vector_size=m["layer_sizes"][0])
        Xs = (X - m["mean"]) / m["std"]
        dev = self.device
        with torch.no_grad():
            out = mlp_forward(torch.from_numpy(np.asarray(m["coef"])).to(dev),
                              torch.from_numpy(np.ascontiguousarray(Xs)).to(dev),
                              m["layer_sizes"])
        return out.cpu().numpy()

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        logits = self.logits(data)
        e = np.exp(logits - logits.max(1, keepdims=True))
        probs = e / e.sum(1, keepdims=True)
        pick = probs.argmax(1)
        preds = np.empty(len(pick), object)
        preds[:] = [m["labels"][i] for i in pick]
        vals = [preds]
        if self.params._m.get("prediction_detail_col"):
            vals.append(np.asarray(
                [json.dumps({str(l): float(p) for l, p in zip(m["labels"], row)})
                 for row in probs], object))
        return label_output(self, data.schema).build_output(data, vals)

    def get_output_schema(self):
        return label_output(self, self.data_schema).get_output_schema()


class MultilayerPerceptronPredictBatchOp(DeviceModelMapBatchOp, HasPredictionCol,
                                         HasPredictionDetailCol, HasReservedCols):
    """Predicts on ``device`` (``cuda`` by default; raises without it)."""
    MAPPER_CLS = MlpModelMapper
