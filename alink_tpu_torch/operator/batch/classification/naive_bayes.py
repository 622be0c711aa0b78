"""Naive Bayes operators.

Counterpart: ``alink_tpu/operator/batch/classification/naive_bayes.py``
(the re-design of the reference's common/classification/NaiveBayesText*,
multinomial and Bernoulli over vector features, and the mixed
categorical / Gaussian batch/classification/NaiveBayesTrainBatchOp). The
model tables and their converters are the JAX package's, so a table saved
by either package loads in the other.

The text train op and its mapper take ``device=`` (``cuda`` unless the
caller asks for the CPU; raises without it). There the design is dense
float64, built on the device from the vectors' padded indices and values
(``densify_shard``'s ``index_put_``: a cell takes at most one non-zero
term, so the result is the host's ``to_dense`` bit for bit) in blocks of
``design_rows(d)`` rows; the class sums are one product a block (the
weighted one-hot labels against the block) and the scores ``X @
log_prob.T``, both float64. The labels, the class priors, the smoothing
and the JSON details stay on the host, as in the JAX package. The mixed
``NaiveBayes`` is host numpy, as its reference is.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params
from ....common.types import AlinkTypes
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import (HasFeatureCols, HasLabelCol, HasPredictionCol,
                               HasPredictionDetailCol, HasReservedCols,
                               HasVectorCol, HasWeightCol)
from ...base import BatchOperator
from ...common.dataproc.feature_extract import extract_design
from ...common.optim.objfunc import densify_shard
from ..utils.model_map import DeviceModelMapBatchOp, ModelMapBatchOp

DESIGN_BLOCK_BYTES = 1 << 28      # float64 design densified a block at most


def design_rows(d: int) -> int:
    """Rows of a densified float64 block of width ``d``: a function of
    ``d`` alone, so the card and the CPU sum the same blocks."""
    return max(1, DESIGN_BLOCK_BYTES // (8 * max(int(d), 1)))


def design_blocks(design, device, width: Optional[int] = None
                  ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """``(lo, hi, X[lo:hi])`` of ``extract_design``'s design as float64
    blocks on ``device``, ``width`` columns wide (the design's own width,
    zero-padded to ``width`` when it is narrower). A sparse design moves
    its padded indices and values and is densified there."""
    dim = int(design["dim"])
    width = dim if width is None else max(int(width), dim)
    dense = design["kind"] == "dense"
    if dense:
        n = design["X"].shape[0]
    else:
        n = design["idx"].shape[0]
        idx = torch.from_numpy(np.ascontiguousarray(design["idx"])).to(device)
        val = torch.from_numpy(np.ascontiguousarray(
            design["val"], np.float64)).to(device)
    step = design_rows(width)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        if dense:
            Xb = torch.from_numpy(np.ascontiguousarray(
                design["X"][lo:hi], np.float64)).to(device)
            if Xb.shape[1] < width:
                Xb = torch.nn.functional.pad(Xb, (0, width - Xb.shape[1]))
        else:
            Xb = densify_shard({"idx": idx[lo:hi], "val": val[lo:hi]}, width)
        yield lo, hi, Xb


class NaiveBayesTextModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model):
        meta = Params({"model_type": model["model_type"],
                       "vector_col": model["vector_col"],
                       "label_type": model["label_type"],
                       "labels": [str(l) for l in model["labels"]]})
        return meta, [encode_array(model["log_prior"]),
                      encode_array(model["log_prob"])]

    def deserialize_model(self, meta, data):
        return {"model_type": meta._m.get("model_type", "Multinomial"),
                "vector_col": meta._m.get("vector_col"),
                "label_type": meta._m.get("label_type", AlinkTypes.STRING),
                "labels": _typed_labels(meta),
                "log_prior": decode_array(data[0]),
                "log_prob": decode_array(data[1])}


def _typed_labels(meta):
    lt = meta._m.get("label_type", AlinkTypes.STRING)
    return [_typed(v, lt) for v in meta._m.get("labels", [])]


def _typed(v: str, label_type: str):
    if label_type in (AlinkTypes.LONG, AlinkTypes.INT):
        return int(float(v))
    if label_type in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
        return float(v)
    return v


def _label_ids(raw):
    labels = sorted({str(v) for v in raw})
    lookup = {l: i for i, l in enumerate(labels)}
    return labels, np.asarray([lookup[str(v)] for v in raw], np.int64)


def _weights(op, t: MTable, n: int) -> np.ndarray:
    return (np.asarray(t.col(op.params._m["weight_col"]), np.float64)
            if op.params._m.get("weight_col") else np.ones(n))


class NaiveBayesTextTrainBatchOp(BatchOperator, HasLabelCol, HasVectorCol,
                                 HasWeightCol):
    """reference: batch/classification/NaiveBayesTextTrainBatchOp. Sums
    the classes on ``device`` (``cuda`` by default) in float64."""
    MODEL_TYPE = ParamInfo("model_type", str, default="Multinomial",
                           validator=InValidator(["Multinomial", "Bernoulli"]))
    SMOOTHING = ParamInfo("smoothing", float, default=1.0)

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def link_from(self, in_op: BatchOperator) -> "NaiveBayesTextTrainBatchOp":
        t = in_op.get_output_table()
        vec_col = self.params._m.get("vector_col")
        design = extract_design(t, None, vec_col, np.float64)
        label_col = self.get_label_col()
        labels, y = _label_ids(t.col(label_col))
        w = _weights(self, t, len(y))
        k, d = len(labels), int(design["dim"])
        sm = self.get_smoothing()
        bernoulli = self.get_model_type() == "Bernoulli"
        prior = np.asarray([w[y == c].sum() for c in range(k)], np.float64)
        dev = self.device
        yt = torch.from_numpy(y).to(dev)
        wt = torch.from_numpy(w).to(dev)
        counts = torch.zeros((k, d), dtype=torch.float64, device=dev)
        for lo, hi, Xb in design_blocks(design, dev):
            if bernoulli:
                Xb = (Xb != 0).to(torch.float64)
            onehot = torch.nn.functional.one_hot(yt[lo:hi], k).to(
                torch.float64) * wt[lo:hi, None]
            counts += onehot.T @ Xb
        if bernoulli:
            pt = torch.from_numpy(prior).to(dev)
            log_prob = torch.log((counts + sm) / (pt[:, None] + 2 * sm))
        else:
            log_prob = torch.log((counts + sm) /
                                 (counts.sum(1, keepdim=True) + sm * d))
        label_type = t.schema.type_of(label_col)
        self._output = NaiveBayesTextModelConverter().save_model({
            "model_type": self.get_model_type(), "vector_col": vec_col,
            "label_type": label_type,
            "labels": [_typed(l, label_type) for l in labels],
            "log_prior": np.log(prior / prior.sum()),
            "log_prob": log_prob.cpu().numpy()})
        return self


def label_output(mapper, schema) -> OutputColsHelper:
    """The prediction column (the label's type) and, with a detail
    column, its JSON column, after the reserved columns of ``schema``.
    The JAX package's mappers of these families declare no output
    schema, so its stream twins of them cannot open; the port's do."""
    params = mapper.params
    cols, types = [params._m.get("prediction_col", "pred")], \
        [mapper.model["label_type"]]
    if params._m.get("prediction_detail_col"):
        cols.append(params._m["prediction_detail_col"])
        types.append(AlinkTypes.STRING)
    return OutputColsHelper(schema, cols, types,
                            params._m.get("reserved_cols"))


def _predictions(mapper, scores: np.ndarray, data: MTable) -> MTable:
    """The label of each row's top score and, with a detail column, the
    JSON of its softmax (the JAX package's host code)."""
    m = mapper.model
    pick = scores.argmax(1)
    probs = np.exp(scores - scores.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    preds = np.empty(len(pick), object)
    preds[:] = [m["labels"][i] for i in pick]
    vals = [preds]
    if mapper.params._m.get("prediction_detail_col"):
        vals.append(np.asarray(
            [json.dumps({str(l): float(p) for l, p in zip(m["labels"], row)})
             for row in probs], object))
    return label_output(mapper, data.schema).build_output(data, vals)


class NaiveBayesTextModelMapper(ModelMapper):
    """Scores on ``device`` (``cuda`` by default) in float64."""

    def __init__(self, model_schema, data_schema, params=None, device=None,
                 **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.device = resolve_device(device)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = NaiveBayesTextModelConverter().load_model(model_table)

    def scores(self, data: MTable) -> np.ndarray:
        """(n, k) float64 class scores of the table's vectors."""
        m = self.model
        dev = self.device
        d = m["log_prob"].shape[1]
        design = extract_design(data, None, m["vector_col"], np.float64,
                                vector_size=d)
        lp = torch.from_numpy(m["log_prob"]).to(dev)
        prior = torch.from_numpy(m["log_prior"]).to(dev)
        bernoulli = m["model_type"] == "Bernoulli"
        if bernoulli:
            lq = torch.log1p(-torch.exp(torch.clamp(lp, max=-1e-12)))
        out = []
        for _, _, Xb in design_blocks(design, dev, width=d):
            if bernoulli:
                Xb = (Xb != 0).to(torch.float64)
                s = Xb @ lp.T + (1 - Xb) @ lq.T + prior
            else:
                s = Xb @ lp.T + prior
            out.append(s.cpu())
        if not out:
            return np.zeros((0, len(m["labels"])))
        return torch.cat(out).numpy()

    def get_output_schema(self):
        return label_output(self, self.data_schema).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        return _predictions(self, self.scores(data), data)


class NaiveBayesTextPredictBatchOp(DeviceModelMapBatchOp, HasPredictionCol,
                                   HasPredictionDetailCol, HasReservedCols):
    """Scores on ``device`` (``cuda`` by default; raises without it)."""
    MAPPER_CLS = NaiveBayesTextModelMapper


# ---------------------------------------------------------------------------
# Mixed categorical/gaussian NaiveBayes over table columns (host numpy)
# ---------------------------------------------------------------------------

class NaiveBayesModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model):
        meta = Params({"feature_cols": model["feature_cols"],
                       "is_cat": model["is_cat"],
                       "label_type": model["label_type"],
                       "labels": [str(l) for l in model["labels"]]})
        return meta, [json.dumps(model["stats"]), encode_array(model["log_prior"])]

    def deserialize_model(self, meta, data):
        return {"feature_cols": meta._m["feature_cols"],
                "is_cat": meta._m["is_cat"], "labels": _typed_labels(meta),
                "label_type": meta._m.get("label_type", AlinkTypes.STRING),
                "stats": json.loads(data[0]), "log_prior": decode_array(data[1])}


class NaiveBayesTrainBatchOp(BatchOperator, HasLabelCol, HasFeatureCols,
                             HasWeightCol):
    """reference: batch/classification/NaiveBayesTrainBatchOp (categorical
    columns -> smoothed frequency tables, numeric -> gaussians)."""
    SMOOTHING = ParamInfo("smoothing", float, default=1.0)

    def link_from(self, in_op: BatchOperator) -> "NaiveBayesTrainBatchOp":
        t = in_op.get_output_table()
        label_col = self.get_label_col()
        cols = self.params._m.get("feature_cols") or \
            [c for c in t.col_names if c != label_col]
        labels, y = _label_ids(t.col(label_col))
        w = _weights(self, t, len(y))
        sm = self.get_smoothing()
        is_cat = [not AlinkTypes.is_numeric(t.schema.type_of(c)) for c in cols]
        stats = []
        prior = np.asarray([w[y == c].sum() for c in range(len(labels))], np.float64)
        for c, cat in zip(cols, is_cat):
            col = t.col(c)
            if cat:
                values = sorted({str(v) for v in col})
                table = {}
                for ci in range(len(labels)):
                    cnt = {val: 0.0 for val in values}
                    tot = sm * len(values)
                    for v, yy, wt in zip(col, y, w):
                        if yy == ci:
                            cnt[str(v)] += wt
                            tot += wt
                    table[str(ci)] = {val: float(np.log((cnt[val] + sm) / tot))
                                      for val in values}
                stats.append({"kind": "cat", "table": table})
            else:
                v = np.asarray(col, np.float64)
                mu, var = [], []
                for ci in range(len(labels)):
                    sub, sw = v[y == ci], w[y == ci]
                    tot = max(sw.sum(), 1e-12)
                    if sub.size:
                        m_ = float((sub * sw).sum() / tot)
                        mu.append(m_)
                        var.append(float(((sub - m_) ** 2 * sw).sum() / tot + 1e-9))
                    else:
                        mu.append(0.0)
                        var.append(1.0)
                stats.append({"kind": "gauss", "mu": mu, "var": var})
        label_type = t.schema.type_of(label_col)
        self._output = NaiveBayesModelConverter().save_model({
            "feature_cols": cols, "is_cat": is_cat,
            "labels": [_typed(l, label_type) for l in labels],
            "label_type": label_type,
            "stats": stats, "log_prior": np.log(prior / prior.sum())})
        return self


class NaiveBayesModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = NaiveBayesModelConverter().load_model(model_table)

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        k = len(m["labels"])
        n = data.num_rows
        scores = np.tile(m["log_prior"], (n, 1))
        for c, stat in zip(m["feature_cols"], m["stats"]):
            col = data.col(c)
            if stat["kind"] == "cat":
                floor = np.log(1e-12)
                for ci in range(k):
                    table = stat["table"][str(ci)]
                    scores[:, ci] += np.asarray(
                        [table.get(str(v), floor) for v in col])
            else:
                v = np.asarray(col, np.float64)
                mu = np.asarray(stat["mu"])
                var = np.asarray(stat["var"])
                scores += (-0.5 * np.log(2 * np.pi * var)[None, :]
                           - 0.5 * (v[:, None] - mu[None, :]) ** 2 / var[None, :])
        return _predictions(self, scores, data)

    def get_output_schema(self):
        return label_output(self, self.data_schema).get_output_schema()


class NaiveBayesPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                               HasPredictionDetailCol, HasReservedCols):
    MAPPER_CLS = NaiveBayesModelMapper
