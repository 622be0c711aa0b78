"""alink_tpu_torch.online — the supervised online-learning DAG.

Counterpart: ``alink_tpu/online/``. The whole reference
``FTRLExample.java`` loop — stream ingest -> FTRL training with
checkpoints -> model-snapshot stream -> hot-swap serving -> windowed
stream eval -> health/drift alerts — as ONE fault-tolerant program with
per-stage typed restart policies and an end-to-end
:class:`SloContract` (serve p99, model-swap staleness, final-window
AUC) evaluated live. See :mod:`alink_tpu_torch.online.dag` for the
runtime contract.
"""

from .dag import (DagFailed, DagReport, OnlineDag, RESTART_POLICIES,
                  load_model_table, save_model_table)
from .slo import (SloBurnRate, SloContract, SloVerdict,
                  SwapStalenessTracker)

__all__ = ["DagFailed", "DagReport", "OnlineDag", "RESTART_POLICIES",
           "SloBurnRate", "SloContract", "SloVerdict",
           "SwapStalenessTracker", "load_model_table",
           "save_model_table"]
