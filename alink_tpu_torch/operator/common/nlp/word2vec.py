"""Word2Vec: skip-gram with hierarchical softmax.

Counterpart: ``alink_tpu/operator/common/nlp/word2vec.py`` (the re-design
of the reference's Word2VecTrainBatchOp.java:329-441: Huffman ``point``
and ``code`` per word, a local epoch a superstep, then the embeddings'
all-reduce and average). ``build_huffman`` and ``skipgram_pairs`` are
copied verbatim: the heap's ties and the ``RandomState`` draws give the
JAX package's arrays. The JAX package's ``lax.scan`` over mini-batches
becomes a loop over the batches on the session's device: the centre rows
and the Huffman-path rows gathered, the two einsums batched products,
then the terms ``-lr * d_v`` and ``-lr * d_u`` formed (each rounded on
its own, in the training's dtype) and added into ``in`` and ``out`` by
the ordered row scatter-add (``kernels/rows.py::scatter_rows``, "P3"), in
the JAX package's ``.at[].add`` order. ``AllReduce("emb", mean=True)`` is the
identity at one worker. Against the JAX package (float32 both) the
vectors differ by the einsums' association and the rounding of ``-lr``
(the JAX package under x64 forms it in float64), not by the scatter
order; the tests pin the gap.
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ....common.mlenv import MLEnvironment, MLEnvironmentFactory
from ....common.mtable import MTable
from ....common.params import ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ....common.vector import DenseVector
from ....engine import AllReduce, IterativeComQueue
from ....kernels.rows import scatter_rows
from ....mapper.base import ModelMapper, OutputColsHelper
from .text import _tokens

@dataclass
class Word2VecParams:
    vector_size: int = 100
    window: int = 5
    min_count: int = 5
    num_iter: int = 5
    learning_rate: float = 0.025
    batch_size: int = 256
    seed: int = 0


def build_huffman(counts: List[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Huffman coding over word counts (reference :380-441).

    Returns (points (V,L), codes (V,L), mask (V,L)): for word w,
    points[w] are the inner-node ids on its root path and codes[w] the
    binary branch taken, valid where mask is 1.
    """
    V = len(counts)
    if V == 1:
        return (np.zeros((1, 1), np.int32), np.zeros((1, 1), np.float32),
                np.ones((1, 1), np.float32))
    heap = [(c, i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = {}
    branch = {}
    next_id = V
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1], branch[n1] = next_id, 0
        parent[n2], branch[n2] = next_id, 1
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    root = heap[0][1]
    paths, codes = [], []
    for w in range(V):
        p, c, node = [], [], w
        while node != root:
            c.append(branch[node])
            p.append(parent[node] - V)  # inner-node index 0..V-2
            node = parent[node]
        paths.append(list(reversed(p)))
        codes.append(list(reversed(c)))
    L = max(len(p) for p in paths)
    points = np.zeros((V, L), np.int32)
    code_arr = np.zeros((V, L), np.float32)
    mask = np.zeros((V, L), np.float32)
    for w in range(V):
        k = len(paths[w])
        points[w, :k] = paths[w]
        code_arr[w, :k] = codes[w]
        mask[w, :k] = 1.0
    return points, code_arr, mask


def skipgram_pairs(docs: List[List[int]], window: int, seed: int) -> np.ndarray:
    """(n, 3) int32 rows [center, context, valid] with random window
    shrink (reference's b = random % window)."""
    rng = np.random.RandomState(seed)
    out = []
    for doc in docs:
        n = len(doc)
        for i, c in enumerate(doc):
            b = rng.randint(1, window + 1)
            for j in range(max(0, i - b), min(n, i + b + 1)):
                if j != i:
                    out.append((c, doc[j], 1))
    if not out:
        return np.zeros((0, 3), np.int32)
    return np.asarray(out, np.int32)


def word2vec_train(table: MTable, selected_col: str, p: Word2VecParams,
                   env: Optional[MLEnvironment] = None,
                   dtype: torch.dtype = torch.float32):
    """Returns (vocab_words, vectors (V, D)) as the JAX package's does,
    trained on ``env``'s device. ``dtype``: float32, the JAX package's
    arithmetic; float64 runs the same ops from the same (float32) initial
    vectors, to tell float32 rounding from a fault (card against CPU)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype}: want torch.float32 or "
                         f"torch.float64")
    counter: Counter = Counter()
    tokenized = [_tokens(v) for v in table.col(selected_col)]
    for toks in tokenized:
        counter.update(toks)
    vocab = [w for w, c in sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
             if c >= p.min_count]
    if not vocab:
        raise ValueError("empty vocabulary; lower min_count")
    index = {w: i for i, w in enumerate(vocab)}
    V, D = len(vocab), p.vector_size
    docs = [[index[t] for t in toks if t in index] for toks in tokenized]
    pairs = skipgram_pairs([d for d in docs if len(d) > 1], p.window, p.seed)
    points, codes, mask = build_huffman([counter[w] for w in vocab])

    rng = np.random.RandomState(p.seed)
    in0 = ((rng.rand(V, D) - 0.5) / D).astype(np.float32)
    out0 = np.zeros((max(V - 1, 1), D), np.float32)
    mb = int(p.batch_size)
    lr0 = float(p.learning_rate)
    num_iter = int(p.num_iter)
    env = env or MLEnvironmentFactory.get_default()

    def epoch(ctx):
        if ctx.is_init_step:
            ctx.put_obj("emb", {
                "in": torch.from_numpy(in0).to(ctx.device, dtype),
                "out": torch.from_numpy(out0).to(ctx.device, dtype)})
        if ctx.is_entry_step:
            # the padded batches' columns, once a run (the pairs do not
            # change between supersteps)
            shard = ctx.get_obj("pairs")              # (m, 3) int32
            m = shard.shape[0]
            nb = -(-m // mb)
            padded = shard.new_zeros((nb * mb, 3))
            padded[:m] = shard
            batches = padded.view(nb, mb, 3)
            ctx.put_derived("batches", (
                batches[:, :, 0].contiguous(), batches[:, :, 1].contiguous(),
                batches[:, :, 2].to(dtype)))
        centres, contexts, valids = ctx.get_obj("batches")
        emb = ctx.get_obj("emb")
        e_in, e_out = emb["in"], emb["out"]
        pts, cds, msk = (ctx.get_obj("hs_points"), ctx.get_obj("hs_codes"),
                         ctx.get_obj("hs_mask"))
        lr = lr0 * max(0.05, 1.0 - (ctx.step_no - 1) / max(num_iter, 1))
        for bi in range(centres.shape[0]):
            c, o = centres[bi], contexts[bi]
            v = e_in[c]                                       # (b, D)
            pt, cd = pts[o], cds[o]                           # (b, L)
            mk = msk[o] * valids[bi][:, None]
            u = e_out[pt]                                     # (b, L, D)
            logits = torch.bmm(u, v[:, :, None])[..., 0]      # (b, L)
            g = (torch.sigmoid(logits) - cd) * mk
            d_v = torch.bmm(g[:, None, :], u)[:, 0]           # (b, D)
            d_u = g[..., None] * v[:, None, :]                # (b, L, D)
            scatter_rows(e_in, c, -lr * d_v)
            scatter_rows(e_out, pt.reshape(-1), (-lr * d_u).reshape(-1, D))
        ctx.put_obj("emb", {"in": e_in, "out": e_out})

    q = (IterativeComQueue(env, max_iter=num_iter, seed=p.seed)
         .init_with_partitioned_data("pairs", pairs)
         .init_with_broadcast_data("hs_points", points)
         .init_with_broadcast_data("hs_codes", codes)
         .init_with_broadcast_data("hs_mask", mask)
         .add(epoch)
         .add(AllReduce("emb", mean=True))
         .set_program_key(("w2v", V, D, mb, lr0, num_iter, str(dtype))))
    result = q.exec()
    vectors = np.asarray(result.get("emb")["in"], np.float64)
    return vocab, vectors


# ---------------------------------------------------------------------------
# model rows + mapper
# ---------------------------------------------------------------------------

W2V_MODEL_SCHEMA = TableSchema(["word", "vec"],
                               [AlinkTypes.STRING, AlinkTypes.DENSE_VECTOR])


def word2vec_model_table(vocab: List[str], vectors: np.ndarray) -> MTable:
    col = np.empty(len(vocab), object)
    col[:] = [DenseVector(v) for v in vectors]
    return MTable({"word": vocab, "vec": col}, W2V_MODEL_SCHEMA)


class Word2VecModelMapper(ModelMapper):
    """Doc -> average of its word vectors (reference Word2VecModelMapper;
    predict strategy AVG)."""

    SELECTED_COL = ParamInfo("selected_col", str, optional=False)
    OUTPUT_COL = ParamInfo("output_col", str)

    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.vecs: Dict[str, np.ndarray] = {}
        self.dim = 0

    def load_model(self, model_table: MTable):
        self.vecs = {}
        for w, v in zip(model_table.col("word"), model_table.col("vec")):
            arr = np.asarray(v.data if isinstance(v, DenseVector) else v, np.float64)
            self.vecs[str(w)] = arr
            self.dim = arr.shape[0]

    def _out_col(self):
        return self.params._m.get("output_col") or self.get_selected_col()

    def get_output_schema(self) -> TableSchema:
        return OutputColsHelper(self.data_schema, [self._out_col()],
                                [AlinkTypes.DENSE_VECTOR]).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        col = data.col(self.get_selected_col())
        out = np.empty(len(col), object)
        for i, text in enumerate(col):
            hits = [self.vecs[t] for t in _tokens(text) if t in self.vecs]
            out[i] = DenseVector(np.mean(hits, axis=0) if hits
                                 else np.zeros(self.dim))
        helper = OutputColsHelper(data.schema, [self._out_col()],
                                  [AlinkTypes.DENSE_VECTOR])
        return helper.build_output(data, [out])
