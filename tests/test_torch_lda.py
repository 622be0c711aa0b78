"""Slice 18 of the port: LDA on the CPU against the JAX package.

A seeded corpus with planted topics (numpy) goes through ``alink_tpu``'s
LDA (its JAX side on a 1-device session, float64 under the tests' x64)
and the port's (``device="cpu"``, ``dtype=torch.float64``). Tolerances:

* the E-step: the port's ``_e_step`` against the JAX package's
  module-level one, given the ``gamma0`` the test draws with
  ``jax.random.gamma(key, 100.0, (n, k)) * 0.01`` from the JAX side's
  key: rtol 1e-10 of the largest value on gamma and the sufficient
  statistics (measured about 1e-15: the products' association; the
  ``segment_sum`` through P3's plain version is bitwise);
* the trainers draw from ``torch.Generator``s, not JAX's PRNG, so they
  are held by their properties: the port's final log-perplexity inside
  the JAX package's range over 5 seeds, widened by 3x that range's
  spread (as ALS implicit is gated); every planted topic recovered by
  both packages (its best learned topic at cosine >= 0.9); Gibbs' word-
  topic counts summing to the token count exactly;
* ``lda_infer`` and ``LdaPredictBatchOp``: the same topics as the JAX
  package's predict op on the same model table, away from ties (a gap
  of 1e-6 between the top two topics);
* ``ComQueueResult.concat``, the model table both ways, the pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.common.types import TableSchema as JSchema
from alink_tpu.operator.batch.clustering import lda_ops as jops
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.clustering import lda as jl
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.engine import IterativeComQueue
from alink_tpu_torch.model import interop
from alink_tpu_torch.operator.batch.clustering import lda_ops as tops
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.clustering import lda as tl
from alink_tpu_torch.pipeline import PipelineModel
from alink_tpu_torch.pipeline.clustering import Lda

K, V, N_DOCS, DOC_LEN = 3, 30, 60, 24
ESTEP_RTOL = 1e-10
SEEDS = range(5)


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _planted(seed=0):
    """Word distributions of K planted topics (disjoint blocks of 10
    words) and docs each dominated by one topic (90 % of its tokens)."""
    rng = np.random.RandomState(seed)
    topics = np.zeros((K, V))
    for t in range(K):
        topics[t, t * 10:(t + 1) * 10] = rng.dirichlet(np.ones(10) * 5)
    docs, ids, cnts = [], [], []
    for d in range(N_DOCS):
        mix = np.full(K, 0.05)
        mix[d % K] = 0.9
        words = [rng.choice(V, p=topics[rng.choice(K, p=mix)])
                 for _ in range(DOC_LEN)]
        docs.append(" ".join(f"w{w}" for w in words))
        bag = np.bincount(words, minlength=V)
        nz = np.nonzero(bag)[0]
        ids.append(nz)
        cnts.append(bag[nz])
    L = max(len(i) for i in ids)
    I = np.zeros((N_DOCS, L), np.int32)
    C = np.zeros((N_DOCS, L))
    for r, (i, c) in enumerate(zip(ids, cnts)):
        I[r, :len(i)] = i
        C[r, :len(c)] = c
    return topics, docs, I, C


@pytest.fixture(scope="module")
def corpus():
    return _planted()


def _recovered(planted, word_topic):
    """Each planted topic's best cosine against the learned topics'
    word distributions (columns of ``word_topic`` (V, k))."""
    learned = np.asarray(word_topic, np.float64).T
    learned = learned / np.linalg.norm(learned, axis=1, keepdims=True)
    p = planted / np.linalg.norm(planted, axis=1, keepdims=True)
    return (p @ learned.T).max(1)


def test_e_step_f64_vs_jax(corpus):
    _, _, ids, cnts = corpus
    rng = np.random.RandomState(1)
    eEb = rng.rand(K, V) + 0.1
    alpha = 0.4
    key = jax.random.PRNGKey(7)
    gamma0 = np.asarray(jax.random.gamma(key, 100.0, (N_DOCS, K)) * 0.01)
    jg, js = jl._e_step(jnp.asarray(ids), jnp.asarray(cnts), jnp.asarray(eEb),
                        alpha, key, 30)
    tg, ts = tl._e_step(torch.from_numpy(ids), torch.from_numpy(cnts),
                        torch.from_numpy(eEb), alpha, torch.from_numpy(gamma0),
                        30)
    assert _rel(tg.numpy(), jg) <= ESTEP_RTOL
    assert _rel(ts.numpy(), js) <= ESTEP_RTOL
    g2, none = tl._e_step(torch.from_numpy(ids), torch.from_numpy(cnts),
                          torch.from_numpy(eEb), alpha,
                          torch.from_numpy(gamma0), 30, stats=False)
    assert none is None and torch.equal(g2, tg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_support_sum_is_the_full_segment_sum(corpus, dtype):
    """The statistics summed over the non-padding positions only
    (``corpus_support``) are the full ``segment_sum``'s bits: the padding
    adds +0.0 to sums that start at +0.0."""
    _, _, ids, cnts = corpus
    rng = np.random.RandomState(2)
    i_t = torch.from_numpy(ids)
    c_t = torch.from_numpy(cnts).to(dtype)
    eEb = torch.from_numpy(rng.rand(K, V) + 0.1).to(dtype)
    g0 = torch.from_numpy(rng.gamma(100.0, 0.01, (N_DOCS, K))).to(dtype)
    full = tl._e_step(i_t, c_t, eEb, 0.3, g0, 10)[1]
    pos, keys, plan = tl.corpus_support(i_t, c_t, V)
    assert plan is None and pos.numel() == int((cnts != 0).sum())
    part = tl._e_step(i_t, c_t, eEb, 0.3, g0, 10, (pos, keys, plan))[1]
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(full.view(bits), part.view(bits))


def _wt_online(lam):
    return (lam / lam.sum(1, keepdims=True)).T


METHODS = {
    "online": (tl.online_lda_train, jl.online_lda_train,
               dict(num_iter=20, subsample=0.5, tau0=1.0), True),
    "em": (tl.em_lda_train, jl.em_lda_train, dict(num_iter=15), True),
    "gibbs": (tl.gibbs_lda_train, jl.gibbs_lda_train, dict(num_iter=30),
              False),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_trainer_properties_vs_jax(method, corpus, jenv, tenv):
    planted, _, ids, cnts = corpus
    tfn, jfn, kw, takes_dtype = METHODS[method]
    tkw = dict(kw, dtype=torch.float64) if takes_dtype else dict(kw)
    runs = [jfn(ids, cnts, K, V, seed=s, env=jenv, **kw) for s in SEEDS]
    got = tfn(ids, cnts, K, V, seed=0, env=tenv, **tkw)
    again = tfn(ids, cnts, K, V, seed=0, env=tenv, **tkw)
    for a, b in zip(got, again):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    perps = [r[-1] for r in runs]
    lo, hi = min(perps), max(perps)
    spread = max(hi - lo, 1e-9)
    assert np.isfinite(got[-1])
    assert lo - 3 * spread <= got[-1] <= hi + 3 * spread
    if method == "online":
        wt_t, wt_j = _wt_online(got[0]), _wt_online(runs[0][0])
        assert got[1].shape == (K,) and (got[1] > 0).all()
    else:
        wt_t, wt_j = got[0], runs[0][0]
    assert _recovered(planted, wt_t).min() >= 0.9
    assert _recovered(planted, wt_j).min() >= 0.9
    if method == "gibbs":
        tokens = cnts.sum()
        assert got[0].sum() == tokens and got[1].sum() == tokens
        assert got[0].shape == (V, K)
        assert np.array_equal(got[0], np.round(got[0]))


def test_gibbs_counts_conserved_at_every_seed(corpus, tenv):
    _, _, ids, cnts = corpus
    for s in range(3):
        wt, tot, a, b, _, perp = tl.gibbs_lda_train(ids, cnts, K, V,
                                                    num_iter=3, seed=s,
                                                    env=tenv)
        assert wt.sum() == cnts.sum() == tot.sum()
        assert (a, b) == (50.0 / K + 1.0, 0.01 + 1.0)


def test_gumbel_argmax_follows_the_distribution():
    gen = torch.Generator()
    gen.manual_seed(0)
    p = torch.tensor([0.1, 0.6, 0.3], dtype=torch.float64)
    logp = torch.log(p).expand(20000, 3)
    draws = tl.gumbel_argmax(logp, gen)
    freq = torch.bincount(draws, minlength=3).double() / 20000
    assert torch.allclose(freq, p, atol=0.015)


def test_lda_infer_properties(corpus):
    planted, _, ids, cnts = corpus
    theta = tl.lda_infer(ids, cnts, planted.T, np.full(K, 0.1), n_inner=40)
    assert np.allclose(theta.sum(1), 1.0)
    assert (theta.argmax(1) == np.arange(N_DOCS) % K).mean() > 0.9


def test_concat_takes_the_rows_of_the_partition(tenv):
    def stage(ctx):
        ctx.put_obj("z", ctx.get_obj("x") * 2)
    res = (IterativeComQueue(tenv, max_iter=1)
           .init_with_partitioned_data("x", np.arange(10).reshape(5, 2))
           .add(stage).exec())
    assert res.totals == {"x": 5}
    assert np.array_equal(res.concat("z"), np.arange(10).reshape(5, 2) * 2)
    assert np.array_equal(res.concat("z", total=3),
                          np.arange(6).reshape(3, 2) * 2)


def _jt(t):
    return JMTable(t.to_rows(), JSchema(list(t.schema.names),
                                        list(t.schema.types)))


@pytest.mark.parametrize("method", ["em", "gibbs", "online"])
def test_ops_predict_equal_to_jax_on_the_same_table(method, corpus):
    _, docs, _, _ = corpus
    rows = [(d,) for d in docs]
    kw = dict(selected_col="doc", topic_num=K, method=method, num_iter=10,
              seed=1)
    if method == "online":
        kw.update(subsampling_rate=0.5, online_learning_offset=1.0)
    train = tops.LdaTrainBatchOp(device="cpu", dtype=torch.float64,
                                 **kw).link_from(TMem(rows, "doc STRING"))
    table = train.get_output_table()
    model = tops.LdaModelDataConverter().load_model(table)
    assert model.gamma.shape == (V + 1, K)
    pred = tops.LdaPredictBatchOp(selected_col="doc", prediction_col="t",
                                  prediction_detail_col="p", device="cpu") \
        .link_from(TMem(table), TMem(rows, "doc STRING")).get_output_table()
    want = jops.LdaPredictBatchOp(selected_col="doc", prediction_col="t",
                                  prediction_detail_col="p").link_from(
        JMem(_jt(table)), JMem(rows, "doc STRING")).get_output_table()
    import json
    probs = np.asarray([json.loads(s) for s in want.col("p")])
    top2 = np.sort(probs, 1)[:, -2:]
    away = top2[:, 1] - top2[:, 0] > 1e-6
    assert away.mean() > 0.9
    assert np.array_equal(np.asarray(pred.col("t"))[away],
                          np.asarray(want.col("t"))[away])


def test_model_table_interop_both_ways(corpus, jenv):
    _, docs, ids, cnts = corpus
    wt, tot, a, b, ll, perp = jl.em_lda_train(ids, cnts, K, V, num_iter=3,
                                              env=jenv)
    vocab = [f"w{i}" for i in range(V)]
    jtable = jops.LdaModelDataConverter().save_model(jops.LdaModelData(
        K, vocab, np.concatenate([wt, tot[None]], 0), np.full(K, a), b,
        "em", ll, perp))
    ttable = interop.simple_model_table_from_reference(jtable.to_rows())
    tm = tops.LdaModelDataConverter().load_model(ttable)
    assert np.array_equal(tm.gamma.view(np.int64),
                          np.concatenate([wt, tot[None]], 0).view(np.int64))
    back = interop.lda_model_from_numpy(tm.gamma, tm.alpha, tm.beta,
                                        tm.vocab, tm.method, ll, perp)
    jm = jops.LdaModelDataConverter().load_model(_jt(back))
    assert np.array_equal(np.asarray(jm.gamma).view(np.int64),
                          tm.gamma.view(np.int64))
    assert jm.vocab == vocab and back.to_rows() == ttable.to_rows()


def test_pipeline_lda_fit_transform_save_load(corpus, tmp_path):
    _, docs, _, _ = corpus
    src = TMem([(d,) for d in docs], "doc STRING")
    model = Lda(selected_col="doc", topic_num=K, num_iter=5, seed=2,
                prediction_col="t", device="cpu").fit(src)
    out = model.transform(src).get_output_table()
    path = str(tmp_path / "lda.json")
    from alink_tpu_torch.pipeline import Pipeline
    pm = Pipeline(Lda(selected_col="doc", topic_num=K, num_iter=5, seed=2,
                      prediction_col="t"), device="cpu").fit(src)
    pm.save(path)
    loaded = PipelineModel.load(path)
    for st in loaded.transformers:
        st.device = "cpu"
    again = loaded.transform(src).get_output_table()
    assert list(out.col("t")) == list(again.col("t"))


def test_ops_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.LdaTrainBatchOp(selected_col="doc", topic_num=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.LdaPredictBatchOp(selected_col="doc", prediction_col="t")
