"""Neural-network objectives (counterpart: ``alink_tpu/operator/common/ann``)."""
