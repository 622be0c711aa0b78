"""Recommendation internals of the port (counterpart:
``alink_tpu/operator/common/recommendation``): ALS."""
