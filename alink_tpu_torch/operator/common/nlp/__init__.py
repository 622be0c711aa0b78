"""NLP internals of the port (counterpart: ``alink_tpu/operator/common/nlp``):
the tokenizers, the vectorizers and Word2Vec. The segmenter waits for
its slice (ROADMAP A7(c))."""
