"""Similarity of the port (counterpart:
``alink_tpu/operator/common/similarity``): the string metrics of
``metrics.py`` and the LSH joins of ``lsh.py``."""
