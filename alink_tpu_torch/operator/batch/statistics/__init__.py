"""Statistics batch operators of the port (counterpart:
``alink_tpu/operator/batch/statistics``); the ops are in
``stat_ops.py``."""
