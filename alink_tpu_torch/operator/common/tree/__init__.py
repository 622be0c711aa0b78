"""Histogram tree building and the tree trainers (counterpart:
``alink_tpu/operator/common/tree``)."""
