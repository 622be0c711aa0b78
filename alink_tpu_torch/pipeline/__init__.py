"""The Pipeline API of the port (counterpart: ``alink_tpu/pipeline``).
Ported: ``base.py``, the feature and scaler wrappers of ``feature.py``,
the linear classifiers of ``classification.py``, ``regression.py`` and
KMeans of ``clustering.py``. The tuning and other wrapper modules wait
for their ops."""

from .base import (Estimator, LocalPredictor, MapModel, Model, Pipeline,
                   PipelineModel, PipelineStage, Trainer, Transformer)
from . import classification, clustering, feature, regression

__all__ = ["Estimator", "LocalPredictor", "MapModel", "Model", "Pipeline",
           "PipelineModel", "PipelineStage", "Trainer", "Transformer",
           "classification", "clustering", "feature", "regression"]
