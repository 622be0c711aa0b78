"""Linear regression family batch operators.

Counterpart: ``alink_tpu/operator/batch/regression/linear.py`` (the
reference's LinearRegTrainBatchOp, RidgeRegTrainBatchOp,
LassoRegTrainBatchOp, LinearSvrTrainBatchOp and their predict ops) over
the shared linear core. Ridge sets ``l2`` and Lasso ``l1`` (so OWLQN)
from ``lambda_``. Each train op takes ``device=`` and ``dtype=`` as the
classifiers do.
"""

from __future__ import annotations

from ....common.params import ParamInfo, RangeValidator
from ...base import BatchOperator
from ...common.linear.base import LinearModelType
from ..classification.linear import (BaseLinearTrainBatchOp,
                                     LinearModelPredictBatchOp)


class LinearRegTrainBatchOp(BaseLinearTrainBatchOp):
    """reference: batch/regression/LinearRegTrainBatchOp.java (square loss)"""
    MODEL_TYPE = LinearModelType.LinearReg


class LinearRegPredictBatchOp(LinearModelPredictBatchOp):
    pass


class RidgeRegTrainBatchOp(BaseLinearTrainBatchOp):
    """reference: batch/regression/RidgeRegTrainBatchOp.java (L2 required)"""
    MODEL_TYPE = LinearModelType.LinearReg
    LAMBDA = ParamInfo("lambda_", float, "ridge L2 strength", default=0.1,
                       aliases=("lambda",), validator=RangeValidator(0.0, None))

    def link_from(self, in_op: BatchOperator):
        self.params.set("l2", float(self.get_lambda_()))
        return super().link_from(in_op)


class RidgeRegPredictBatchOp(LinearModelPredictBatchOp):
    pass


class LassoRegTrainBatchOp(BaseLinearTrainBatchOp):
    """reference: batch/regression/LassoRegTrainBatchOp.java (L1 required)"""
    MODEL_TYPE = LinearModelType.LinearReg
    LAMBDA = ParamInfo("lambda_", float, "lasso L1 strength", default=0.1,
                       aliases=("lambda",), validator=RangeValidator(0.0, None))

    def link_from(self, in_op: BatchOperator):
        self.params.set("l1", float(self.get_lambda_()))
        return super().link_from(in_op)


class LassoRegPredictBatchOp(LinearModelPredictBatchOp):
    pass


class LinearSvrTrainBatchOp(BaseLinearTrainBatchOp):
    """reference: batch/regression/LinearSvrTrainBatchOp.java (eps-insensitive)"""
    MODEL_TYPE = LinearModelType.SVR
    TAU = ParamInfo("tau", float, "epsilon-insensitive band", default=0.1)


class LinearSvrPredictBatchOp(LinearModelPredictBatchOp):
    pass
