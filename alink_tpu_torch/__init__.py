"""alink_tpu_torch — the PyTorch / CUDA port of ``alink_tpu`` for one
NVIDIA H100.

The package mirrors ``alink_tpu``'s layout module for module; each
module's docstring names its counterpart there. It imports ``torch``
and numpy and never ``jax`` or any module of ``alink_tpu``. Slice 1 is
the serving path of a binary linear model: the model table
(``operator/common/linear``), ``LinearModelMapper.serving_kernel``,
``serving.CompiledPredictor`` and ``serving.PredictServer``, scored by
the hand-written CUDA kernels of ``kernels/serve.py``. Slice 2 is sparse
online FTRL: ``operator.stream.onlinelearning.FtrlTrainStreamOp`` and
``FtrlPredictStreamOp`` over the stream runtime of ``operator/``, with
the state kernels of ``kernels/ftrl.py``. Slice 3 is tree learning:
the GBDT, random-forest and decision-tree ops of
``operator.batch.classification`` on the one-worker BSP engine
(``engine``), whose level histograms are the kernel of
``kernels/tree_hist.py``, and ``TreeModelMapper`` serving. Slice 7 is
batch logistic regression: ``LogisticRegressionTrainBatchOp`` over the
L-BFGS / OWLQN / GD optimizers of ``operator/common/optim`` on the same
engine, on dense, padded-COO and field-blocked (``ops/fieldblock.py``)
designs, with the ordered gradient kernel of ``kernels/linear.py``.
Slice 9 is the FTRLExample loop: the ``pipeline`` API (feature scalers,
``FeatureHasher``, ``LogisticRegression``), the stream transform runtime
(``operator/stream/core.py``, ``stream/utils``), ``SplitStreamOp``,
``JsonValueStreamOp`` and the windowed binary evaluation. Slice 13 is
the rest of the linear family (linear SVM, perceptron, Softmax, linear,
ridge, lasso and SVR regression, with SGD and Newton beside L-BFGS) and
KMeans, in ``operator.batch.classification``, ``operator.batch.
regression``, ``operator.batch.clustering`` and their pipeline twins.
Slice 15 is ALS (``operator.batch.recommendation``, the float32
training of ``operator/common/recommendation/als.py`` on the engine),
the multiclass, regression and cluster evaluation, and the stream
predict twins of ``operator/stream/predict_ops.py``.
"""

__version__ = "0.1.0"
