"""Slice 23 of the port: the segmenter on the CPU against the JAX package.

The segmenter is host code copied whole, with the port's own copy of the
dictionary, so the tolerance is none: the tokens of every sentence equal
the JAX package's exactly, through ``SegmentDict.cut`` (with and
without the HMM, with a user dictionary), ``SegmentBatchOp``,
``SegmentStreamOp`` and the pipeline's ``Segment``. The sentences are
the JAX package's test sentences (``tests/test_nlp.py``) and a seeded
corpus of dictionary words glued into 10-60 character sentences with
latin and digit runs and punctuation between them; the tokens of each,
joined, give the sentence back without its spaces.
"""

import numpy as np
import pytest

from alink_tpu.operator.batch.nlp import SegmentBatchOp as JSegment
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.nlp import segment as jseg
from alink_tpu_torch.operator.batch.nlp import SegmentBatchOp as TSegment
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.nlp import segment as tseg
from alink_tpu_torch.operator.stream.nlp import SegmentStreamOp
from alink_tpu_torch.operator.stream.source import MemSourceStreamOp
from alink_tpu_torch.pipeline import Segment

FIXED = ["我们喜欢机器学习和自然语言处理", "今天天气非常好", "hello 世界 world",
         "我来到北京清华大学", "他来到了网易杭研大厦",
         "小明硕士毕业于中国科学院计算所，后在日本京都大学深造",
         "", "abc123 def", "工信处女干事每月经过下属科室"]


def _corpus(n, seed=0):
    """``n`` sentences of 10-60 characters: dictionary words (and a few
    characters drawn alone), a latin or digit run or a punctuation mark
    now and then."""
    rng = np.random.RandomState(seed)
    words = sorted(tseg._load_builtin())
    out = []
    for _ in range(n):
        target = rng.randint(10, 61)
        s = ""
        while len(s) < target:
            r = rng.rand()
            if r < 0.05:
                s += rng.choice(["abc", "x9", "2024", "，", "。", " "])
            elif r < 0.12:
                w = words[rng.randint(len(words))]
                s += w[rng.randint(len(w))]
            else:
                s += words[rng.randint(len(words))]
        out.append(s[:target])
    return out


@pytest.fixture(scope="module")
def corpus():
    return FIXED + _corpus(400)


def test_dictionary_is_the_ports_own_copy():
    """Same bytes, another file: the port reads nothing under
    ``alink_tpu/``."""
    import os
    assert os.path.dirname(tseg._DICT_PATH) != os.path.dirname(
        jseg._DICT_PATH)
    assert "alink_tpu_torch" in tseg._DICT_PATH
    with open(tseg._DICT_PATH, "rb") as a, open(jseg._DICT_PATH, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("use_hmm", [True, False])
def test_cuts_equal_the_jax_packages(corpus, use_hmm):
    td = tseg.SegmentDict(use_hmm=use_hmm)
    jd = jseg.SegmentDict(use_hmm=use_hmm)
    ts, js = {}, {}
    for s in corpus:
        got = td.cut(s, ts)
        assert got == jd.cut(s, js), s
        assert "".join(got) == "".join(s.split()), s
    assert ts == js and ts["tokens"] > len(corpus)
    if use_hmm:
        assert ts["hmm_tokens"] > 0


def test_hmm_tables_equal_the_jax_packages():
    th = tseg.SegmentDict().hmm
    jh = jseg.SegmentDict().hmm
    np.testing.assert_array_equal(th.log_start, jh.log_start)
    np.testing.assert_array_equal(th.log_trans, jh.log_trans)
    assert th.log_emit == jh.log_emit


def test_ops_equal_the_jax_packages(corpus):
    rows = [(s,) for s in corpus] + [(None,)]
    kw = dict(selected_col="sentence", output_col="tokens",
              user_defined_dict=["天气非常", "杭研大厦"])
    t = TSegment(**kw).link_from(TMem(rows, "sentence STRING")) \
        .get_output_table()
    j = JSegment(**kw).link_from(JMem(rows, "sentence STRING")) \
        .get_output_table()
    assert t.col_names == j.col_names == ["sentence", "tokens"]
    assert list(t.col("tokens")) == list(j.col("tokens"))
    assert "天气非常" in t.col("tokens")[1].split()
    assert t.col("tokens")[-1] is None
    # the stream twin, micro-batch by micro-batch, and the pipeline stage
    parts = list(SegmentStreamOp(**kw).link_from(MemSourceStreamOp(
        rows, "sentence STRING", batch_size=64)).micro_batches())
    assert len(parts) == -(-len(rows) // 64)
    assert [v for p in parts for v in p.col("tokens")] == list(
        t.col("tokens"))
    staged = Segment(**kw).transform(TMem(rows, "sentence STRING")) \
        .get_output_table()
    assert list(staged.col("tokens")) == list(t.col("tokens"))
