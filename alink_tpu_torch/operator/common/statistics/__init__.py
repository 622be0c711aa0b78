"""Statistics of the port (counterpart:
``alink_tpu/operator/common/statistics``). Only the summarizer is
ported; the hypothesis tests and correlation wait for their ops."""
