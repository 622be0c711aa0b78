"""Shared operator internals (counterpart: ``alink_tpu/operator/common``)."""
