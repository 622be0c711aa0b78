"""Slice 18 of the port: the float64 paths that tell float32 rounding
from a fault on the card.

``als_train(..., dtype=torch.float64)`` and ``word2vec_train(...,
dtype=torch.float64)`` run the float32 trainings' ops in float64 from
the same float32 initial draws; ``chip_smoke.py`` holds the card's
float64 runs against the CPU's (phase 18(c)'s implicit ALS, phase
21(c)'s Word2Vec). Here, on the CPU: the float64 factors and vectors
within float32's rounding, amplified by the training, of the float32
ones (ALS explicit 1e-4 of the largest factor, measured 7.4e-6 on this
fixture; Word2Vec 1e-4 of the largest |vector|), in float64, and a
dtype other than float32 or float64 refused.
"""

import numpy as np
import pytest
import torch

from alink_tpu_torch.common.mlenv import MLEnvironment
from alink_tpu_torch.common.mtable import MTable
from alink_tpu_torch.operator.common.nlp.word2vec import (Word2VecParams,
                                                          word2vec_train)
from alink_tpu_torch.operator.common.recommendation.als import (
    AlsTrainParams, als_train)

ENV = MLEnvironment(device="cpu")


def _ratings(seed=0, U=200, I=150, n=5000):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, U, n), rng.randint(0, I, n),
            rng.randint(1, 6, n).astype(float), U, I)


def test_als_float64_path():
    u, i, r, U, I = _ratings()
    p = AlsTrainParams(rank=10, num_iter=3)
    a = als_train(u, i, r, p, env=ENV, num_users=U, num_items=I)
    b = als_train(u, i, r, p, env=ENV, num_users=U, num_items=I,
                  dtype=torch.float64)
    assert a[0].dtype == np.float32 and b[0].dtype == np.float64
    assert b[2].dtype == np.float32 and len(b[2]) == 3
    for x, y in zip(a[:2], b[:2]):
        assert np.abs(x - y).max() <= 1e-4 * np.abs(y).max()
    with pytest.raises(ValueError, match="dtype"):
        als_train(u, i, r, p, env=ENV, dtype=torch.float16)


def test_word2vec_float64_path():
    rng = np.random.RandomState(1)
    words = [f"t{k}" for k in range(30)]
    rows = [(" ".join(rng.choice(words, 12)),) for _ in range(40)]
    t = MTable(rows, "doc STRING")
    p = Word2VecParams(vector_size=8, min_count=1, num_iter=2, window=3,
                       batch_size=16)
    v32, a = word2vec_train(t, "doc", p, env=ENV)
    v64, b = word2vec_train(t, "doc", p, env=ENV, dtype=torch.float64)
    assert v32 == v64 and a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    assert not np.array_equal(a, b)
    with pytest.raises(ValueError, match="dtype"):
        word2vec_train(t, "doc", p, env=ENV, dtype=torch.float16)
