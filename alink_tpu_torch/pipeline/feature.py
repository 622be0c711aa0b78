"""Pipeline wrappers: feature engineering and the dataproc scalers.

Counterpart: ``alink_tpu/pipeline/feature.py`` (the reference's
pipeline/feature/ and pipeline/dataproc/), whole: ``BatchOpTransformer``,
``_trainer``, the StandardScaler, MinMaxScaler, MaxAbsScaler, Imputer,
OneHotEncoder, QuantileDiscretizer, StringIndexer, Pca and vector scaler
estimators with their models, and the Binarizer, Bucketizer,
FeatureHasher, VectorAssembler, VectorNormalizer and DCT transformers.
``QuantileDiscretizer`` trains on its ``device`` (its train op's cut
points come from the device above ``DEVICE_BINNING_MIN_CELLS``), ``DCT``
transforms on its own; the rest run on the host.
"""

from __future__ import annotations

import inspect
from typing import Optional, Type

from ..operator.base import BatchOperator
from ..operator.batch.dataproc.indexers import (StringIndexerModelMapper,
                                                StringIndexerPredictBatchOp,
                                                StringIndexerTrainBatchOp)
from ..operator.batch.dataproc.scalers import (
    ImputerTrainBatchOp, MaxAbsScalerTrainBatchOp, MinMaxScalerTrainBatchOp,
    StandardScalerTrainBatchOp, _ColScalerMapper)
from ..operator.batch.dataproc.vector_ops import (
    VectorAssemblerBatchOp, VectorMaxAbsScalerTrainBatchOp,
    VectorMinMaxScalerTrainBatchOp, VectorNormalizeBatchOp,
    VectorScalerModelMapper, VectorStandardScalerTrainBatchOp)
from ..operator.batch.feature.feature_ops import (
    BinarizerBatchOp, BucketizerBatchOp, DCTBatchOp, FeatureHasherBatchOp,
    OneHotModelMapper, OneHotTrainBatchOp, PcaModelMapper, PcaPredictBatchOp,
    PcaTrainBatchOp, QuantileDiscretizerTrainBatchOp, _BucketMapperBase)
from ..params.shared import HasOutputCol, HasOutputCols, HasReservedCols
from .base import MapModel, Trainer, Transformer, _as_op


class BatchOpTransformer(Transformer):
    """Stateless transformer backed by a batch op (reference MapTransformer)."""

    OP_CLS: Optional[Type[BatchOperator]] = None

    def transform(self, in_op) -> BatchOperator:
        takes = inspect.signature(self.OP_CLS.__init__).parameters
        kw = {"device": self.device} if "device" in takes else {}
        return self.OP_CLS(self.params.clone(), **kw).link_from(_as_op(in_op))


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
OneHotEncoder, OneHotEncoderModel = _trainer(
    "OneHotEncoder", OneHotTrainBatchOp, OneHotModelMapper)
QuantileDiscretizer, QuantileDiscretizerModel = _trainer(
    "QuantileDiscretizer", QuantileDiscretizerTrainBatchOp, _BucketMapperBase)
StringIndexer, StringIndexerModel = _trainer(
    "StringIndexer", StringIndexerTrainBatchOp, StringIndexerModelMapper)
Pca, PcaModel = _trainer("Pca", PcaTrainBatchOp, PcaModelMapper)
VectorStandardScaler, VectorStandardScalerModel = _trainer(
    "VectorStandardScaler", VectorStandardScalerTrainBatchOp, VectorScalerModelMapper)
VectorMinMaxScaler, VectorMinMaxScalerModel = _trainer(
    "VectorMinMaxScaler", VectorMinMaxScalerTrainBatchOp, VectorScalerModelMapper)
VectorMaxAbsScaler, VectorMaxAbsScalerModel = _trainer(
    "VectorMaxAbsScaler", VectorMaxAbsScalerTrainBatchOp, VectorScalerModelMapper)

# kwargs validation needs predict params too (output_col etc.)
for _cls in (StringIndexer, StringIndexerModel):
    _cls._PARAM_INFOS = {**_cls._PARAM_INFOS,
                         **StringIndexerPredictBatchOp._PARAM_INFOS}
for _cls in (OneHotEncoder, OneHotEncoderModel, Pca, PcaModel,
             QuantileDiscretizer, QuantileDiscretizerModel,
             StandardScaler, StandardScalerModel,
             VectorStandardScaler, VectorStandardScalerModel):
    _cls._PARAM_INFOS = {**_cls._PARAM_INFOS,
                         **{i.name: i for i in (HasOutputCol.OUTPUT_COL,
                                                HasOutputCols.OUTPUT_COLS,
                                                HasReservedCols.RESERVED_COLS)}}
for _cls in (Pca, PcaModel):
    _cls._PARAM_INFOS = {**_cls._PARAM_INFOS,
                         "prediction_col": PcaPredictBatchOp.PREDICTION_COL}


class Binarizer(BatchOpTransformer):
    OP_CLS = BinarizerBatchOp
    _PARAM_INFOS = BinarizerBatchOp._PARAM_INFOS


class Bucketizer(BatchOpTransformer):
    OP_CLS = BucketizerBatchOp
    _PARAM_INFOS = BucketizerBatchOp._PARAM_INFOS


class FeatureHasher(BatchOpTransformer):
    OP_CLS = FeatureHasherBatchOp
    _PARAM_INFOS = FeatureHasherBatchOp._PARAM_INFOS


class VectorAssembler(BatchOpTransformer):
    OP_CLS = VectorAssemblerBatchOp
    _PARAM_INFOS = VectorAssemblerBatchOp._PARAM_INFOS


class VectorNormalizer(BatchOpTransformer):
    OP_CLS = VectorNormalizeBatchOp
    _PARAM_INFOS = VectorNormalizeBatchOp._PARAM_INFOS


class DCT(BatchOpTransformer):
    OP_CLS = DCTBatchOp
    _PARAM_INFOS = DCTBatchOp._PARAM_INFOS
