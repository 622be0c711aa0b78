"""Clustering internals of the port (counterpart:
``alink_tpu/operator/common/clustering``): KMeans and LDA."""
