"""Slice 18 of the port: the text front end and Word2Vec on the CPU
against the JAX package.

The same seeded Zipf corpus (numpy) goes through ``alink_tpu``'s NLP ops
and the port's. Tolerances:

* the tokenizers, ``NGram``, ``StopWordsRemover``, ``WordCount``, the
  two vectorizers' model tables and mapped vectors, ``build_huffman``
  and ``skipgram_pairs``: equal (host code; the dictionary order and
  the heap's tie breaks are the JAX package's);
* ``word2vec_train`` in float32 (the JAX side on a 1-device session):
  within ``W2V_TOL`` of the largest |vector| after 2 epochs. The scatter
  order is the JAX package's (P3's plain version is bitwise to
  ``.at[].add``); what differs is the einsums' association and the
  rounding of ``-lr * d``, which the JAX package forms in float64 under
  the tests' x64 and the port in float32 (measured 1.6e-6 here; the
  prediction was 1e-5);
* the stream twins of the vectorizers and Word2Vec, and the stream
  tokenizers, row for row against their batch ops; the model table both
  ways between the packages; the pipeline stages.
"""

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.common.types import TableSchema as JSchema
from alink_tpu.operator.batch import nlp as jnlp
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.nlp import word2vec as jw
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.model import interop
from alink_tpu_torch.operator.batch import nlp as tnlp
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.nlp import word2vec as tw
from alink_tpu_torch.operator.stream import nlp as tsnlp
from alink_tpu_torch.operator.stream import predict_ops as tpo
from alink_tpu_torch.operator.stream.source import \
    MemSourceStreamOp as TMemStream
from alink_tpu_torch.pipeline import nlp as tpipe

W2V_TOL = 1e-5
SCHEMA = "doc STRING"


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


def _corpus(n=80, vocab=60, seed=0):
    rng = np.random.RandomState(seed)
    words = [f"Tok{i}" for i in range(vocab)] + ["the", "and", "of"]
    p = np.arange(1, len(words) + 1) ** -1.1
    p /= p.sum()
    rows = []
    for _ in range(n):
        k = rng.randint(3, 18)
        rows.append((" ".join(rng.choice(words, k, p=p)),))
    rows[3] = (None,)
    rows[5] = ("",)
    return rows


@pytest.fixture(scope="module")
def rows():
    return _corpus()


def _jt(t):
    return JMTable(t.to_rows(), JSchema(list(t.schema.names),
                                        list(t.schema.types)))


def _jax_w2v(t):
    """The port's Word2Vec table as the JAX package's: its (word, vec)
    rows, each vector's float64 values in the JAX package's vector."""
    return jw.word2vec_model_table(list(t.col("word")), np.stack(
        [v.data for v in t.col("vec")]))


def _cells(table):
    return [tuple(repr(v) for v in r) for r in table.to_rows()]


MAP_OPS = {
    "TokenizerBatchOp": {},
    "RegexTokenizerBatchOp": dict(pattern=r"\d+", gaps=True,
                                  min_token_length=2),
    "NGramBatchOp": dict(n=3),
    "StopWordsRemoverBatchOp": dict(stop_words=["tok1"]),
}


@pytest.mark.parametrize("name", sorted(MAP_OPS))
def test_map_ops_equal_jax(name, rows):
    kw = dict(MAP_OPS[name], selected_col="doc", output_col="out")
    src = rows if name != "StopWordsRemoverBatchOp" else \
        [(None if r[0] is None else r[0].lower(),) for r in rows]
    got = getattr(tnlp, name)(**kw).link_from(TMem(src, SCHEMA))
    want = getattr(jnlp, name)(**kw).link_from(JMem(src, SCHEMA))
    assert _cells(got.get_output_table()) == _cells(want.get_output_table())


def test_word_count_equal_jax(rows):
    got = tnlp.WordCountBatchOp(selected_col="doc").link_from(
        TMem(rows, SCHEMA)).get_output_table()
    want = jnlp.WordCountBatchOp(selected_col="doc").link_from(
        JMem(rows, SCHEMA)).get_output_table()
    assert _cells(got) == _cells(want)


VECTORIZERS = {
    "DocCountVectorizer": [dict(feature_type="WORD_COUNT"),
                           dict(feature_type="TF_IDF", min_df=2.0),
                           dict(feature_type="BINARY", max_df=0.5,
                                vocab_size=20),
                           dict(feature_type="TF", min_tf=0.2)],
    "DocHashCountVectorizer": [dict(num_features=64),
                               dict(num_features=1 << 10,
                                    feature_type="IDF", min_df=2.0)],
}


@pytest.mark.parametrize("name,case", [(n, i) for n, cs in VECTORIZERS.items()
                                       for i in range(len(cs))])
def test_vectorizers_equal_jax(name, case, rows):
    kw = dict(VECTORIZERS[name][case], selected_col="doc")
    ttrain = getattr(tnlp, f"{name}TrainBatchOp")(**kw).link_from(
        TMem(rows, SCHEMA))
    jtrain = getattr(jnlp, f"{name}TrainBatchOp")(**kw).link_from(
        JMem(rows, SCHEMA))
    assert _cells(ttrain.get_output_table()) == \
        _cells(jtrain.get_output_table())
    pkw = dict(selected_col="doc", output_col="vec")
    got = getattr(tnlp, f"{name}PredictBatchOp")(**pkw).link_from(
        ttrain, TMem(rows, SCHEMA)).get_output_table()
    want = getattr(jnlp, f"{name}PredictBatchOp")(**pkw).link_from(
        jtrain, JMem(rows, SCHEMA)).get_output_table()
    assert [str(v) for v in got.col("vec")] == \
        [str(v) for v in want.col("vec")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_huffman_and_skipgrams_equal_jax(seed):
    rng = np.random.RandomState(seed)
    counts = list(np.maximum(1, (1000 * np.arange(1, 41, dtype=float)
                                 ** -1.0).astype(int)))
    counts[10:14] = [7, 7, 7, 7]                 # heap ties
    for a, b in zip(tw.build_huffman(counts), jw.build_huffman(counts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(tw.build_huffman([5])[0], jw.build_huffman([5])[0])
    docs = [list(rng.randint(0, 40, rng.randint(2, 15))) for _ in range(20)]
    a = tw.skipgram_pairs(docs, 5, seed)
    b = jw.skipgram_pairs(docs, 5, seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_word2vec_f32_within_tolerance_of_jax(rows, jenv, tenv):
    p = dict(vector_size=16, min_count=2, num_iter=2, window=4,
             batch_size=32, seed=3)
    t_vocab, t_vec = tw.word2vec_train(TMTable(rows, SCHEMA), "doc",
                                       tw.Word2VecParams(**p), env=tenv)
    j_vocab, j_vec = jw.word2vec_train(JMTable(rows, SCHEMA), "doc",
                                       jw.Word2VecParams(**p), env=jenv)
    assert t_vocab == j_vocab
    assert t_vec.shape == j_vec.shape == (len(j_vocab), 16)
    gap = np.abs(t_vec - j_vec).max() / np.abs(j_vec).max()
    assert gap <= W2V_TOL
    # trained: the vectors moved from their initial values
    rng = np.random.RandomState(3)
    in0 = ((rng.rand(*t_vec.shape) - 0.5) / 16).astype(np.float32)
    assert np.abs(t_vec - in0).max() > 1e-3


def test_word2vec_op_table_and_mapper(rows, tenv):
    kw = dict(selected_col="doc", vector_size=8, min_count=2, num_iter=2,
              window=3, batch_size=16, seed=1)
    op = tnlp.Word2VecTrainBatchOp(device="cpu", **kw).link_from(
        TMem(rows, SCHEMA))
    table = op.get_output_table()
    vocab, vec = tw.word2vec_train(TMTable(rows, SCHEMA), "doc",
                                   tw.Word2VecParams(
                                       vector_size=8, min_count=2,
                                       num_iter=2, window=3, batch_size=16,
                                       seed=1), env=tenv)
    assert list(table.col("word")) == vocab
    assert np.array_equal(np.stack([v.data for v in table.col("vec")]), vec)
    pkw = dict(selected_col="doc", output_col="emb")
    got = tnlp.Word2VecPredictBatchOp(**pkw).link_from(
        op, TMem(rows, SCHEMA)).get_output_table()
    want = jnlp.Word2VecPredictBatchOp(**pkw).link_from(
        JMem(_jax_w2v(table)), JMem(rows, SCHEMA)).get_output_table()
    assert [str(v) for v in got.col("emb")] == \
        [str(v) for v in want.col("emb")]


def test_word2vec_table_interop_both_ways(rows, jenv):
    vocab, vec = jw.word2vec_train(JMTable(rows, SCHEMA), "doc",
                                   jw.Word2VecParams(vector_size=4,
                                                     min_count=2,
                                                     num_iter=1), env=jenv)
    jtable = jw.word2vec_model_table(vocab, vec)
    ttable = interop.word2vec_table_from_reference(jtable.to_rows())
    got = np.stack([v.data for v in ttable.col("vec")])
    assert list(ttable.col("word")) == vocab
    assert np.array_equal(got.view(np.int64), vec.view(np.int64))
    back = _jax_w2v(interop.word2vec_model_from_numpy(vocab, got))
    assert np.array_equal(np.stack([v.data for v in back.col("vec")])
                          .view(np.int64), vec.view(np.int64))


def _stream(op, rows, batch=16):
    out = []
    for mt in op.link_from(TMemStream(rows, SCHEMA,
                                      batch_size=batch)).micro_batches():
        out += mt.to_rows()
    return [tuple(repr(v) for v in r) for r in out]


TWINS = {
    "DocCountVectorizer": (tnlp.DocCountVectorizerTrainBatchOp,
                           dict(feature_type="TF_IDF")),
    "DocHashCountVectorizer": (tnlp.DocHashCountVectorizerTrainBatchOp,
                               dict(num_features=128)),
    "Word2Vec": (tnlp.Word2VecTrainBatchOp,
                 dict(vector_size=4, min_count=2, num_iter=1,
                      device="cpu")),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_nlp_twins_equal_batch_ops(name, rows):
    op_cls, kw = TWINS[name]
    model = op_cls(selected_col="doc", **kw).link_from(TMem(rows, SCHEMA))
    pkw = dict(selected_col="doc", output_col="out")
    twin = getattr(tpo, f"{name}PredictStreamOp")(TMem(
        model.get_output_table()), device="cpu", **pkw)
    batch = twin.BATCH_CLS(**pkw).link_from(model, TMem(rows, SCHEMA))
    assert _stream(twin, rows) == _cells(batch.get_output_table())


@pytest.mark.parametrize("name", ["Tokenizer", "RegexTokenizer", "NGram",
                                  "StopWordsRemover"])
def test_stream_map_ops_equal_batch_ops(name, rows):
    kw = dict(selected_col="doc", output_col="out")
    batch = getattr(tnlp, f"{name}BatchOp")(**kw).link_from(
        TMem(rows, SCHEMA)).get_output_table()
    assert _stream(getattr(tsnlp, f"{name}StreamOp")(**kw), rows) == \
        _cells(batch)


def test_pipeline_nlp_stages(rows):
    from alink_tpu_torch.pipeline import Pipeline
    src = TMem(rows, SCHEMA)
    pipe = Pipeline(
        tpipe.Tokenizer(selected_col="doc", output_col="tok"),
        tpipe.StopWordsRemover(selected_col="tok", output_col="clean"),
        tpipe.DocCountVectorizer(selected_col="clean", output_col="bow"),
        tpipe.Word2Vec(selected_col="clean", output_col="emb", vector_size=4,
                       min_count=1, num_iter=1),
        device="cpu")
    model = pipe.fit(src)
    out = model.transform(src).get_output_table()
    assert {"tok", "clean", "bow", "emb"} <= set(out.col_names)
    assert out.num_rows == len(rows)
    hashed = tpipe.DocHashCountVectorizer(selected_col="doc", output_col="h",
                                          num_features=32).fit(src)
    assert hashed.transform(src).get_output_table().num_rows == len(rows)
    ngram = tpipe.NGram(selected_col="doc", output_col="g", n=2)
    assert ngram.transform(src).get_output_table().num_rows == len(rows)


def test_word2vec_op_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnlp.Word2VecTrainBatchOp(selected_col="doc")
