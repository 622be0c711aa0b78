"""Shared ``Has*`` param mixins.

PyTorch port: a copy of ``alink_tpu/params/shared.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

Python re-design of the reference's 433 param-interface files under
``com/alibaba/alink/params/**`` (e.g. params/shared/iter/HasMaxIterDefaultAs100.java:11-26,
params/shared/colname/HasLabelCol.java, params/validators/RangeValidator.java).
Each mixin is a plain class holding ``ParamInfo`` attributes; the
``WithParams`` metaclass generates fluent ``set_x/get_x`` accessors.
"""

from ..common.params import ParamInfo, RangeValidator, InValidator

__all__ = []


def _mix(name, info_attr, info):
    cls = type(name, (), {info_attr: info, "__module__": __name__})
    globals()[name] = cls
    __all__.append(name)
    return cls


# -- column names ------------------------------------------------------------
_mix("HasLabelCol", "LABEL_COL", ParamInfo("label_col", str, "label column", optional=False))
_mix("HasFeatureCols", "FEATURE_COLS", ParamInfo("feature_cols", list, "feature columns"))
_mix("HasVectorCol", "VECTOR_COL", ParamInfo("vector_col", str, "vector column"))
_mix("HasWeightCol", "WEIGHT_COL", ParamInfo("weight_col", str, "sample weight column"))
_mix("HasPredictionCol", "PREDICTION_COL",
     ParamInfo("prediction_col", str, "prediction column", optional=False))
_mix("HasPredictionDetailCol", "PREDICTION_DETAIL_COL",
     ParamInfo("prediction_detail_col", str, "prediction detail (probability json) column"))
_mix("HasReservedCols", "RESERVED_COLS",
     ParamInfo("reserved_cols", list, "columns kept in output; default all"))
_mix("HasSelectedCol", "SELECTED_COL",
     ParamInfo("selected_col", str, "selected column", optional=False))
_mix("HasSelectedCols", "SELECTED_COLS", ParamInfo("selected_cols", list, "selected columns"))
_mix("HasOutputCol", "OUTPUT_COL", ParamInfo("output_col", str, "output column"))
_mix("HasOutputCols", "OUTPUT_COLS", ParamInfo("output_cols", list, "output columns"))
_mix("HasGroupCols", "GROUP_COLS", ParamInfo("group_cols", list, "group-by columns"))

# -- iteration / optimization ------------------------------------------------
_mix("HasMaxIterDefaultAs100", "MAX_ITER",
     ParamInfo("max_iter", int, "maximum iterations", default=100,
               validator=RangeValidator(1, None)))
_mix("HasMaxIterDefaultAs50", "MAX_ITER",
     ParamInfo("max_iter", int, "maximum iterations", default=50,
               validator=RangeValidator(1, None)))
_mix("HasMaxIterDefaultAs20", "MAX_ITER",
     ParamInfo("max_iter", int, "maximum iterations", default=20,
               validator=RangeValidator(1, None)))
_mix("HasEpsilonDefaultAs000001", "EPSILON",
     ParamInfo("epsilon", float, "convergence tolerance", default=1e-6))
_mix("HasLearningRate", "LEARNING_RATE",
     ParamInfo("learning_rate", float, "learning rate", default=0.1))
_mix("HasOptimMethod", "OPTIM_METHOD",
     ParamInfo("optim_method", str, "optimizer: LBFGS/GD/SGD/Newton/OWLQN",
               validator=InValidator([None, "LBFGS", "GD", "SGD", "Newton", "OWLQN",
                                      "lbfgs", "gd", "sgd", "newton", "owlqn"])))
_mix("HasWithIntercept", "WITH_INTERCEPT",
     ParamInfo("with_intercept", bool, "fit an intercept term", default=True))
_mix("HasStandardization", "STANDARDIZATION",
     ParamInfo("standardization", bool, "standardize features before training", default=True))
_mix("HasL1", "L_1", ParamInfo("l1", float, "L1 regularization", default=0.0))
_mix("HasL2", "L_2", ParamInfo("l2", float, "L2 regularization", default=0.0))
_mix("HasMiniBatchFraction", "MINI_BATCH_FRACTION",
     ParamInfo("mini_batch_fraction", float, "SGD sample fraction per step", default=0.1,
               validator=RangeValidator(0.0, 1.0, left_inclusive=False)))

# -- misc shared -------------------------------------------------------------
_mix("HasSeed", "SEED", ParamInfo("seed", int, "random seed", default=0))
_mix("HasKDefaultAs2", "K", ParamInfo("k", int, "number of clusters/factors", default=2,
                                      validator=RangeValidator(1, None)))
_mix("HasKDefaultAs10", "K", ParamInfo("k", int, "number of clusters/factors", default=10,
                                       validator=RangeValidator(1, None)))
_mix("HasNumThreads", "NUM_THREADS", ParamInfo("num_threads", int, "parallel hint", default=1))
_mix("HasMLEnvironmentId", "ML_ENVIRONMENT_ID",
     ParamInfo("ml_environment_id", int, "session id", default=0))
_mix("HasPositiveLabelValueString", "POS_LABEL_VAL_STR",
     ParamInfo("positive_label_value_string", str, "which label is positive"))
_mix("HasTimeIntervalDefaultAs3", "TIME_INTERVAL",
     ParamInfo("time_interval", float, "stream window seconds", default=3.0))
