"""Feature operators of the port (counterpart:
``alink_tpu/operator/batch/feature``); the ops are in
``feature_ops.py``."""
