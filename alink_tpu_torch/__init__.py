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
the state kernels of ``kernels/ftrl.py``.
"""

__version__ = "0.1.0"
