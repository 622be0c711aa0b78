"""Statistics of the port (counterpart:
``alink_tpu/operator/common/statistics``): the summarizer, and the
hypothesis tests and correlation of ``hypothesis.py``."""
