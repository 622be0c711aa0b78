"""Operator layer of the port (counterpart: ``alink_tpu/operator``)."""
