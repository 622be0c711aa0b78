"""Pipeline wrappers: feature engineering and the dataproc scalers.

Counterpart: ``alink_tpu/pipeline/feature.py`` (the reference's
pipeline/feature/ and pipeline/dataproc/). Ported:
``BatchOpTransformer``, ``_trainer``, the StandardScaler, MinMaxScaler,
MaxAbsScaler and Imputer estimators with their models, and
``FeatureHasher``. The wrappers over ops the port lacks (OneHotEncoder,
QuantileDiscretizer, StringIndexer, Pca, the vector scalers, Binarizer,
Bucketizer, VectorAssembler, VectorNormalizer, DCT) wait for those ops.
"""

from __future__ import annotations

from typing import Optional, Type

from ..operator.base import BatchOperator
from ..operator.batch.dataproc.scalers import (
    ImputerTrainBatchOp, MaxAbsScalerTrainBatchOp, MinMaxScalerTrainBatchOp,
    StandardScalerTrainBatchOp, _ColScalerMapper)
from ..operator.batch.feature.feature_ops import FeatureHasherBatchOp
from ..params.shared import HasOutputCol, HasOutputCols, HasReservedCols
from .base import MapModel, Trainer, Transformer, _as_op


class BatchOpTransformer(Transformer):
    """Stateless transformer backed by a batch op (reference MapTransformer)."""

    OP_CLS: Optional[Type[BatchOperator]] = None

    def transform(self, in_op) -> BatchOperator:
        return self.OP_CLS(self.params.clone()).link_from(_as_op(in_op))


def _trainer(name, train_op, mapper, extra_bases=()):
    from .base import caller_module
    mod = caller_module()
    model_cls = type(name + "Model", (MapModel,) + tuple(extra_bases),
                     {"MAPPER_CLS": mapper, "__module__": mod})
    cls = type(name, (Trainer,) + tuple(extra_bases),
               {"TRAIN_OP_CLS": train_op, "MODEL_CLS": model_cls,
                "__module__": mod})
    # inherit train-op + mapper params for kwargs validation
    mapper_infos = getattr(mapper, "_PARAM_INFOS", {})
    cls._PARAM_INFOS = {**train_op._PARAM_INFOS, **mapper_infos,
                        **cls._PARAM_INFOS}
    model_cls._PARAM_INFOS = {**train_op._PARAM_INFOS, **mapper_infos,
                              **model_cls._PARAM_INFOS}
    return cls, model_cls


StandardScaler, StandardScalerModel = _trainer(
    "StandardScaler", StandardScalerTrainBatchOp, _ColScalerMapper)
MinMaxScaler, MinMaxScalerModel = _trainer(
    "MinMaxScaler", MinMaxScalerTrainBatchOp, _ColScalerMapper)
MaxAbsScaler, MaxAbsScalerModel = _trainer(
    "MaxAbsScaler", MaxAbsScalerTrainBatchOp, _ColScalerMapper)
Imputer, ImputerModel = _trainer("Imputer", ImputerTrainBatchOp, _ColScalerMapper)

# kwargs validation needs predict params too (output_col etc.)
for _cls in (StandardScaler, StandardScalerModel):
    _cls._PARAM_INFOS = {**_cls._PARAM_INFOS,
                         **{i.name: i for i in (HasOutputCol.OUTPUT_COL,
                                                HasOutputCols.OUTPUT_COLS,
                                                HasReservedCols.RESERVED_COLS)}}


class FeatureHasher(BatchOpTransformer):
    OP_CLS = FeatureHasherBatchOp
    _PARAM_INFOS = FeatureHasherBatchOp._PARAM_INFOS
