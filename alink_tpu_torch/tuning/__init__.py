"""Hyperparameter tuning sweeps.

Counterpart: ``alink_tpu/tuning``. The reference platform's tuning
layer (``BaseTuning.findBestCV`` / ``kFoldCv``, ``ParamGrid``) trains
the candidate grid one Flink job at a time; here a grid runs as a sweep:

* :mod:`.plan` — ``SweepPlan`` classifies every swept parameter as
  *carry-resident* (step size, regularization, tolerance, k-means init
  seed — a ``(points,)`` lane inside one group) or *trace-shaping*
  (method, ``max_iter``, k, the seed of the engine — a group of its
  own), and ``AshaConfig`` holds the successive-halving schedule (Li et
  al., MLSys 2020).
* :mod:`.sweep` — the executor: each point runs its serial superstep's
  own ops on its own state, in fixed point order, inside one
  ``IterativeComQueue`` a group, so each point is bitwise its serial
  fit; checkpoints and resume cover the whole population, and ASHA
  pruning flips an alive lane at the engine's boundaries.

``ALINK_TPU_SWEEP=1`` routes ``GridSearchCV`` / ``GridSearchTVSplit``
through this engine when every grid axis is carry-resident for a
supported estimator; every fallback is recorded
(``alink_sweep_fallback_total`` + one RuntimeWarning per reason).
"""

from .plan import (AshaConfig, CARRY_RESIDENT, TRACE_SHAPING, SweepPlan,
                   classify_param)
from .sweep import (FtrlSweepResult, SweepResult, record_sweep_fallback,
                    sweep_enabled, sweep_eta, sweep_ftrl, sweep_kmeans,
                    sweep_optimize, sweep_rung)

__all__ = [
    "AshaConfig", "CARRY_RESIDENT", "TRACE_SHAPING", "SweepPlan",
    "classify_param", "SweepResult", "record_sweep_fallback",
    "sweep_enabled", "sweep_eta", "sweep_ftrl", "sweep_kmeans",
    "sweep_optimize", "sweep_rung", "FtrlSweepResult",
]
