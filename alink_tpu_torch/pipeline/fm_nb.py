"""Pipeline wrappers: FM, naive Bayes and OneVsRest.

Counterpart: ``alink_tpu/pipeline/fm_nb.py`` (the reference's
pipeline/classification/FmClassifier, FmRegressor, NaiveBayesTextClassifier,
NaiveBayes and OneVsRest). ``FmClassifier``, ``FmRegressor`` and
``NaiveBayesTextClassifier`` train on their ``device`` (``cuda`` unless
given ``device="cpu"``; ``Trainer.fit``), and a fitted
``NaiveBayesTextModel`` scores there; ``NaiveBayes`` (mixed columns) is
host numpy. ``OneVsRest`` fits a clone of its binary classifier (its
device kept) a class.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from ..common.types import AlinkTypes
from ..mapper.base import OutputColsHelper
from ..operator.base import BatchOperator, TableSourceBatchOp
from ..operator.batch.classification.fm_ops import (FmClassifierTrainBatchOp,
                                                    FmModelMapper,
                                                    FmRegressorTrainBatchOp)
from ..operator.batch.classification.naive_bayes import (
    NaiveBayesModelMapper, NaiveBayesTextModelMapper,
    NaiveBayesTextTrainBatchOp, NaiveBayesTrainBatchOp)
from ..operator.batch.evaluation.eval_ops import parse_detail_probs
from .base import Estimator, MapModel, Model, Trainer, _as_op


def _wrap(name, train_op, mapper):
    from .base import caller_module
    mod = caller_module()
    model_cls = type(name + "Model", (MapModel,),
                     {"MAPPER_CLS": mapper, "__module__": mod})
    cls = type(name, (Trainer,), {"TRAIN_OP_CLS": train_op,
                                  "MODEL_CLS": model_cls, "__module__": mod})
    from ..params.shared import (HasPredictionCol, HasPredictionDetailCol,
                                 HasReservedCols)
    extra = {i.name: i for i in (HasPredictionCol.PREDICTION_COL,
                                 HasPredictionDetailCol.PREDICTION_DETAIL_COL,
                                 HasReservedCols.RESERVED_COLS)}
    cls._PARAM_INFOS = {**train_op._PARAM_INFOS, **extra, **cls._PARAM_INFOS}
    model_cls._PARAM_INFOS = dict(cls._PARAM_INFOS)
    return cls, model_cls


FmClassifier, FmClassifierModel = _wrap("FmClassifier", FmClassifierTrainBatchOp,
                                        FmModelMapper)
FmRegressor, FmRegressorModel = _wrap("FmRegressor", FmRegressorTrainBatchOp,
                                      FmModelMapper)
NaiveBayesTextClassifier, NaiveBayesTextModel = _wrap(
    "NaiveBayesTextClassifier", NaiveBayesTextTrainBatchOp, NaiveBayesTextModelMapper)
NaiveBayes, NaiveBayesModel = _wrap("NaiveBayes", NaiveBayesTrainBatchOp,
                                    NaiveBayesModelMapper)


from ..params.shared import (HasLabelCol, HasPredictionCol,
                             HasPredictionDetailCol, HasReservedCols)


class OneVsRestModel(Model, HasPredictionCol, HasPredictionDetailCol,
                     HasReservedCols):
    """reference: common/classification/OneVsRestModelMapper."""

    def __init__(self, models: Optional[List[Model]] = None,
                 labels: Optional[List] = None, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self.models = models or []
        self.labels = labels or []

    def transform(self, in_op) -> BatchOperator:
        in_op = _as_op(in_op)
        data = in_op.get_output_table()
        probs = np.zeros((data.num_rows, len(self.models)))
        for j, sub in enumerate(self.models):
            sub_params = sub.params.clone()
            sub_params.set("prediction_col", "__ovr_pred")
            sub_params.set("prediction_detail_col", "__ovr_detail")
            sub2 = type(sub)(sub_params, device=sub.device)
            sub2.set_model_data(sub.get_model_data())
            out = sub2.transform(in_op).get_output_table()
            _, p = parse_detail_probs(out.col("__ovr_detail"), "__positive__")
            probs[:, j] = p
        pick = probs.argmax(1)
        norm = probs / np.maximum(probs.sum(1, keepdims=True), 1e-12)
        preds = np.empty(data.num_rows, object)
        preds[:] = [self.labels[i] for i in pick]
        pred_col = self.params._m.get("prediction_col", "pred")
        detail_col = self.params._m.get("prediction_detail_col")
        label_type = self.params._m.get("label_type", AlinkTypes.STRING)
        cols, types, vals = [pred_col], [label_type], [preds]
        if detail_col:
            details = np.asarray(
                [json.dumps({str(l): float(p) for l, p in zip(self.labels, row)})
                 for row in norm], object)
            cols.append(detail_col)
            types.append(AlinkTypes.STRING)
            vals.append(details)
        helper = OutputColsHelper(data.schema, cols, types,
                                  self.params._m.get("reserved_cols"))
        return TableSourceBatchOp(helper.build_output(data, vals))


class OneVsRest(Estimator, HasPredictionCol, HasPredictionDetailCol,
                HasReservedCols):
    """Meta-estimator over any binary classifier (reference pipeline/classification/OneVsRest)."""
    LABEL_COL = HasLabelCol.LABEL_COL

    def __init__(self, classifier: Optional[Estimator] = None, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self.classifier = classifier

    def fit(self, in_op) -> OneVsRestModel:
        in_op = _as_op(in_op)
        data = in_op.get_output_table()
        label_col = (self.params._m.get("label_col")
                     or self.classifier.params._m.get("label_col"))
        raw = data.col(label_col)
        labels = sorted({_canon(v) for v in raw}, key=str)
        models = []
        for c in labels:
            relabeled = data.add_column(
                label_col,
                np.asarray(["__positive__" if _canon(v) == c else "__rest__"
                            for v in raw], object),
                AlinkTypes.STRING)
            sub = self.classifier.clone()
            sub.params.set("positive_label_value_string", "__positive__")
            models.append(sub.fit(TableSourceBatchOp(relabeled)))
        model = OneVsRestModel(models, labels, self.params.clone())
        model.params.set("label_type", data.schema.type_of(label_col))
        if not model.params._m.get("prediction_col"):
            model.params.set("prediction_col",
                             self.classifier.params._m.get("prediction_col", "pred"))
        if self.classifier.params._m.get("prediction_detail_col") and \
                not model.params._m.get("prediction_detail_col"):
            model.params.set("prediction_detail_col",
                             self.classifier.params._m["prediction_detail_col"])
        return model


def _canon(v):
    return v.item() if isinstance(v, np.generic) else v
