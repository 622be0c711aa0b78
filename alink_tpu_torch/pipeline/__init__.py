"""The Pipeline API of the port (counterpart: ``alink_tpu/pipeline``).
Ported: ``base.py``, the feature and scaler wrappers of ``feature.py``
and logistic regression of ``classification.py``. The regression,
tuning and other wrapper modules wait for their ops."""

from .base import (Estimator, LocalPredictor, MapModel, Model, Pipeline,
                   PipelineModel, PipelineStage, Trainer, Transformer)
from . import classification, feature

__all__ = ["Estimator", "LocalPredictor", "MapModel", "Model", "Pipeline",
           "PipelineModel", "PipelineStage", "Trainer", "Transformer",
           "classification", "feature"]
