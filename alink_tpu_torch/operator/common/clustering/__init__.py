"""Clustering internals of the port (counterpart:
``alink_tpu/operator/common/clustering``): KMeans. LDA waits for its
slice (ROADMAP A7)."""
