"""The Pipeline API of the port (counterpart: ``alink_tpu/pipeline``).
Ported: ``base.py``, the feature and scaler wrappers of ``feature.py``,
the linear classifiers of ``classification.py``, ``regression.py``,
KMeans of ``clustering.py``, the trees of ``tree.py`` and ALS of
``extras.py``. The tuning and other wrapper modules wait for their
ops."""

from .base import (Estimator, LocalPredictor, MapModel, Model, Pipeline,
                   PipelineModel, PipelineStage, Trainer, Transformer)
from . import classification, clustering, extras, feature, regression, tree
from .extras import ALS, ALSModel

__all__ = ["ALS", "ALSModel", "Estimator", "LocalPredictor", "MapModel", "Model", "Pipeline",
           "PipelineModel", "PipelineStage", "Trainer", "Transformer",
           "classification", "clustering", "extras", "feature", "regression",
           "tree"]
