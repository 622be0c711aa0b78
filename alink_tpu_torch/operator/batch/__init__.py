"""Batch operators of the port (counterpart: ``alink_tpu/operator/batch``)."""
