"""Data-layout helpers of the port (counterpart: ``alink_tpu/ops``).
Only ``fieldblock`` is ported."""
