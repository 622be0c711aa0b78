"""LDA batch operators.

Counterpart: ``alink_tpu/operator/batch/clustering/lda_ops.py`` (the
re-design of the reference's LdaTrainBatchOp.java and LdaPredictBatchOp.java
with LdaModelData.java's model: the ``gamma`` word-topic count matrix with
a trailing topic-total row, the alpha vector, beta, the vocabulary). The
model table and its converter are the JAX package's, so a table saved by
either package loads in the other. ``LdaTrainBatchOp`` builds the
DocCountVectorizer vocabulary, encodes the docs as padded bag-of-words
arrays and trains by method ``em``, ``em_gibbs`` (alias ``gibbs``) or
``online`` on ``device`` (``cuda`` unless the caller asks for the CPU;
raises without it) in ``dtype`` (float32 by default, float64 for parity
with the JAX package under x64; Gibbs is float32 in both packages).
``LdaModelMapper`` infers the doc topics on its ``device``.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes, TableSchema
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import (HasPredictionCol, HasPredictionDetailCol,
                               HasReservedCols, HasSeed, HasSelectedCol)
from ...base import BatchOperator
from ...common.clustering.lda import (em_lda_train, encode_corpus,
                                      gibbs_lda_train, lda_infer,
                                      online_lda_train)
from ...common.nlp.vectorizer import (DocCountVectorizerModelConverter,
                                      train_doc_count_vectorizer)
from ..utils.model_map import ModelMapBatchOp


class LdaModelData:
    """reference: operator/common/clustering/LdaModelData.java"""

    def __init__(self, topic_num: int, vocab: List[str], gamma: np.ndarray,
                 alpha: np.ndarray, beta: float, method: str,
                 log_likelihood: float = 0.0, log_perplexity: float = 0.0):
        self.topic_num = topic_num
        self.vocab = vocab
        self.gamma = gamma            # (V+1, k): word-topic counts + topic totals
        self.alpha = np.atleast_1d(np.asarray(alpha, np.float64))
        self.beta = float(beta)
        self.method = method
        self.log_likelihood = log_likelihood
        self.log_perplexity = log_perplexity

    def word_topic_probs(self) -> np.ndarray:
        """(V, k) p(w|z) (LdaModelMapper.java:96-121).

        EM stores raw expected counts -> smooth with beta, exactly the
        beta_hat used during training. Online stores the variational
        lambda, which already contains the beta prior from the
        natural-gradient update — adding it again would double-count.
        """
        V = len(self.vocab)
        wt, tot = self.gamma[:V], self.gamma[V]
        b = 0.0 if self.method == "online" else self.beta
        return (wt + b) / (tot[None, :] + V * b)


class LdaModelDataConverter(SimpleModelDataConverter):
    def serialize_model(self, m: LdaModelData):
        meta = Params({"topic_num": m.topic_num, "method": m.method,
                       "beta": m.beta, "alpha": list(map(float, m.alpha)),
                       "log_likelihood": m.log_likelihood,
                       "log_perplexity": m.log_perplexity})
        return meta, [encode_array(m.gamma), json.dumps(m.vocab)]

    def deserialize_model(self, meta: Params, data):
        return LdaModelData(
            int(meta._m["topic_num"]), json.loads(data[1]),
            decode_array(data[0]), np.asarray(meta._m["alpha"]),
            float(meta._m["beta"]), meta._m.get("method", "em"),
            float(meta._m.get("log_likelihood", 0.0)),
            float(meta._m.get("log_perplexity", 0.0)))


class _LdaTrainParams(HasSelectedCol, HasSeed):
    """params/clustering/LdaTrainParams.java"""
    TOPIC_NUM = ParamInfo("topic_num", int, "number of topics", optional=False,
                          validator=RangeValidator(1, None))
    NUM_ITER = ParamInfo("num_iter", int, "iterations", default=10)
    ALPHA = ParamInfo("alpha", float, "doc-topic Dirichlet prior (-1=auto)",
                      default=-1.0)
    BETA = ParamInfo("beta", float, "topic-word Dirichlet prior (-1=auto)",
                     default=-1.0)
    METHOD = ParamInfo("method", str,
                       "optimizer: em | em_gibbs (alias: gibbs) | online",
                       default="em",
                       aliases=("optimizer",))
    VOCAB_SIZE = ParamInfo("vocab_size", int, "max vocabulary size",
                           default=1 << 18)
    ONLINE_LEARNING_OFFSET = ParamInfo("online_learning_offset", float,
                                       "tau0 downweighting early steps",
                                       default=1024.0)
    LEARNING_DECAY = ParamInfo("learning_decay", float,
                               "kappa in rho_t=(tau0+t)^-kappa", default=0.51)
    SUBSAMPLING_RATE = ParamInfo("subsampling_rate", float,
                                 "minibatch fraction per online step",
                                 default=0.05)
    OPTIMIZE_DOC_CONCENTRATION = ParamInfo(
        "optimize_doc_concentration", bool,
        "learn alpha during online training", default=True)


class LdaTrainBatchOp(BatchOperator, _LdaTrainParams):
    """reference: operator/batch/clustering/LdaTrainBatchOp.java"""

    def __init__(self, params: Optional[Params] = None, device=None,
                 dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(params, **kwargs)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype}: want torch.float32 or "
                             f"torch.float64")
        self.device = resolve_device(device)
        self.dtype = dtype

    def link_from(self, in_op: BatchOperator) -> "LdaTrainBatchOp":
        t = in_op.get_output_table()
        col = self.get_selected_col()
        k = self.get_topic_num()
        method = str(self.get_method()).lower()
        seed = self.get_seed()
        vocab_table = train_doc_count_vectorizer(
            t, col, vocab_size=self.get_vocab_size())
        dcv = DocCountVectorizerModelConverter().load_model(vocab_table)
        V = len(dcv.vocab)
        if V == 0:
            raise ValueError("LDA: empty vocabulary")
        ids, cnts = encode_corpus(t.col(col), dcv.index)
        alpha, beta = self.get_alpha(), self.get_beta()
        if method == "online":
            lam, avec, ll, perp = online_lda_train(
                ids, cnts, k, V, num_iter=self.get_num_iter(),
                alpha=alpha, beta=beta,
                tau0=self.get_online_learning_offset(),
                kappa=self.get_learning_decay(),
                subsample=self.get_subsampling_rate(),
                optimize_alpha=self.get_optimize_doc_concentration(),
                seed=seed, env=MLEnvironment(device=self.device),
                dtype=self.dtype)
            # lambda is the (k, V) variational word-topic pseudo-count matrix;
            # store in the common gamma layout (BuildOnlineLdaModel.java)
            gamma = np.concatenate([lam.T, lam.sum(1)[None, :]], axis=0)
            beta_out = beta if beta > 0 else 1.0 / k
            model = LdaModelData(k, dcv.vocab, gamma, avec, beta_out,
                                 "online", ll, perp)
        elif method in ("em", "gibbs", "em_gibbs"):
            # em = batched variational EM; em_gibbs = the AD-LDA sampler
            # twin of the reference's collapsed Gibbs (EmCorpusStep.java).
            # Both produce the same (V, k)+totals count-matrix model, so
            # they share the model construction. gibbs_lda_train's
            # DEFAULTS already include the reference's +1 prior shift for
            # the collapsed predictive rule (LdaTrainBatchOp.java:118-124);
            # explicitly-set alpha/beta are used as given.
            env = MLEnvironment(device=self.device)
            if method == "em":
                wt, tot, a, b, ll, perp = em_lda_train(
                    ids, cnts, k, V, num_iter=self.get_num_iter(),
                    alpha=alpha, beta=beta, seed=seed, env=env,
                    dtype=self.dtype)
            else:
                wt, tot, a, b, ll, perp = gibbs_lda_train(
                    ids, cnts, k, V, num_iter=self.get_num_iter(),
                    alpha=alpha, beta=beta, seed=seed, env=env)
            gamma = np.concatenate([wt, tot[None, :]], axis=0)
            model = LdaModelData(k, dcv.vocab, gamma, np.full((k,), a),
                                 b, "em", ll, perp)
        else:
            raise ValueError(
                f"LDA method must be em|em_gibbs|online, got {method}")
        self._output = LdaModelDataConverter().save_model(model)
        return self


class LdaModelMapper(ModelMapper):
    """reference: operator/common/clustering/LdaModelMapper.java. Infers on
    ``device`` (``cuda`` by default; raises without it) in float64."""

    def __init__(self, model_schema, data_schema, params=None, device=None,
                 **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.device = resolve_device(device)
        self.model: LdaModelData = None

    def load_model(self, model_table: MTable):
        self.model = LdaModelDataConverter().load_model(model_table)
        self._wt = self.model.word_topic_probs()
        self._index = {w: i for i, w in enumerate(self.model.vocab)}

    def _cols(self):
        p = self.params._m
        out = [p["prediction_col"]]
        types = [AlinkTypes.LONG]
        if p.get("prediction_detail_col"):
            out.append(p["prediction_detail_col"])
            types.append(AlinkTypes.STRING)
        return out, types

    def get_output_schema(self) -> TableSchema:
        out, types = self._cols()
        return OutputColsHelper(self.data_schema, out, types,
                                self.params._m.get("reserved_cols")
                                ).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        col = self.params._m["selected_col"]
        ids, cnts = encode_corpus(data.col(col), self._index)
        theta = lda_infer(ids, cnts, self._wt, self.model.alpha,
                          device=self.device)
        pred = theta.argmax(1).astype(np.int64)
        out, types = self._cols()
        cols = [pred]
        if len(out) > 1:
            cols.append([json.dumps([round(float(v), 6) for v in row])
                         for row in theta])
        helper = OutputColsHelper(self.data_schema, out, types,
                                  self.params._m.get("reserved_cols"))
        return helper.build_output(data, cols)


class LdaPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasPredictionCol,
                        HasPredictionDetailCol, HasReservedCols):
    """reference: operator/batch/clustering/LdaPredictBatchOp.java. Infers
    on ``device`` (``cuda`` by default; raises without it)."""
    MAPPER_CLS = LdaModelMapper

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def link_from(self, model_op: BatchOperator,
                  data_op: BatchOperator) -> "LdaPredictBatchOp":
        mapper = LdaModelMapper(model_op.get_schema(), data_op.get_schema(),
                                self.params, device=self.device)
        mapper.load_model(model_op.get_output_table())
        self._output = mapper.map_table(data_op.get_output_table())
        return self
