"""Objectives and optimizers of linear training (counterpart:
``alink_tpu/operator/common/optim``)."""
