"""Linear classifier batch operators.

Counterpart: ``alink_tpu/operator/batch/classification/linear.py``
(the reference's LogisticRegressionTrainBatchOp, LinearSvmTrainBatchOp,
SoftmaxTrainBatchOp, the perceptron and their predict ops), thin shells
over the linear training core (``common/linear/base.py``). A train op
takes ``device=`` (``cuda`` unless the caller asks for the CPU; raises
without it) and ``dtype=`` (``torch.float32`` by default;
``torch.float64`` for parity with the JAX package under x64).
"""

from __future__ import annotations

import torch

from ....params.shared import (HasEpsilonDefaultAs000001, HasFeatureCols,
                               HasL1, HasL2, HasLabelCol, HasLearningRate,
                               HasMaxIterDefaultAs100, HasMiniBatchFraction,
                               HasOptimMethod, HasPositiveLabelValueString,
                               HasPredictionCol, HasPredictionDetailCol,
                               HasReservedCols, HasStandardization,
                               HasVectorCol, HasWeightCol, HasWithIntercept)
from ...base import BatchOperator
from ...common.linear.base import LinearModelType, train_linear_model
from ...common.linear.mapper import LinearModelMapper
from ..utils.model_map import DeviceTrainBatchOp, ModelMapBatchOp


class _LinearTrainParams(HasLabelCol, HasFeatureCols, HasVectorCol, HasWeightCol,
                         HasOptimMethod, HasMaxIterDefaultAs100,
                         HasEpsilonDefaultAs000001, HasL1, HasL2,
                         HasWithIntercept, HasStandardization, HasLearningRate,
                         HasMiniBatchFraction):
    pass


class BaseLinearTrainBatchOp(DeviceTrainBatchOp, _LinearTrainParams):
    MODEL_TYPE = LinearModelType.LR

    def link_from(self, in_op: BatchOperator) -> "BaseLinearTrainBatchOp":
        model, info = train_linear_model(in_op.get_output_table(), self, self.MODEL_TYPE)
        self._output = model
        self._side_outputs = [info]
        return self


class _LinearPredictParams(HasPredictionCol, HasPredictionDetailCol, HasReservedCols,
                           HasVectorCol):
    pass


class LinearModelPredictBatchOp(ModelMapBatchOp, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class LogisticRegressionTrainBatchOp(BaseLinearTrainBatchOp, HasPositiveLabelValueString):
    """reference: batch/classification/LogisticRegressionTrainBatchOp.java"""
    MODEL_TYPE = LinearModelType.LR


class LogisticRegressionPredictBatchOp(LinearModelPredictBatchOp):
    pass


class LinearSvmTrainBatchOp(BaseLinearTrainBatchOp, HasPositiveLabelValueString):
    """reference: batch/classification/LinearSvmTrainBatchOp.java (hinge loss)"""
    MODEL_TYPE = LinearModelType.SVM


class LinearSvmPredictBatchOp(LinearModelPredictBatchOp):
    pass


class SoftmaxTrainBatchOp(BaseLinearTrainBatchOp):
    """reference: batch/classification/SoftmaxTrainBatchOp.java (multinomial LR)"""
    MODEL_TYPE = LinearModelType.Softmax


class SoftmaxPredictBatchOp(LinearModelPredictBatchOp):
    pass


class PerceptronTrainBatchOp(BaseLinearTrainBatchOp):
    """perceptron loss on the same optimizer stack (reference unarylossfunc/PerceptronLossFunc)"""
    MODEL_TYPE = LinearModelType.Perceptron


class PerceptronPredictBatchOp(LinearModelPredictBatchOp):
    pass
