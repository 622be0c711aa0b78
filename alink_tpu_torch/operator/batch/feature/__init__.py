"""Feature operators of the port (counterpart:
``alink_tpu/operator/batch/feature``). Only ``FeatureHasherBatchOp`` is
ported; the other ops of ``feature_ops.py`` wait for their slices."""
