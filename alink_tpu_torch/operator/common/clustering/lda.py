"""LDA: online variational, batched variational EM and collapsed Gibbs.

Counterpart: ``alink_tpu/operator/common/clustering/lda.py`` (the
re-design of the reference's operator/common/clustering/lda/:
OnlineCorpusStep, UpdateLambdaAndAlpha, EmCorpusStep and the model
builders). The corpus is the JAX package's padded ``(n_docs, max_len)``
word-id and count arrays (:func:`encode_corpus` and
:func:`expand_tokens`, copied). The trainers run on the port's engine at
one worker, on the session's device, in ``dtype`` (float32 on the card by
default; float64 for parity with the JAX package under x64):

* the E-step (:func:`_e_step`) is the JAX package's fixed-trip loop of
  batched digamma and softmax updates, its two contractions batched
  products; its ``segment_sum`` of the sufficient statistics (and EM's of
  the expected counts) goes through the ordered row scatter-add
  (``kernels/rows.py::scatter_rows``, "P3", k columns), in the JAX
  package's order, over the corpus' non-padding positions and their plan,
  built once a training (:func:`corpus_support`: the padding adds +0.0). Its initial ``gamma0`` is an argument; the trainers draw it as
  ``Gamma(100) * 0.01`` from ``ComContext.rng()`` where the JAX package
  calls ``jax.random.gamma(key, 100.0) * 0.01``;
* ``digamma`` and ``polygamma(1, .)`` are ``torch.special``'s;
* Gibbs samples every token with the Gumbel-max rule (JAX's own
  ``jax.random.categorical``) from the generator's uniforms.

The random paths differ from JAX's PRNG by design: the tests hold the
E-step bitwise-close given the same ``gamma0`` and the trainers by their
properties (perplexity range, planted topics, conserved counts).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ....common.mlenv import MLEnvironmentFactory
from ....engine import IterativeComQueue
from ....kernels.rows import row_plan, scatter_rows
from ..nlp.text import _tokens
from ..optim.objfunc import check_full_float32

_digamma = torch.special.digamma


def encode_corpus(texts, index: dict, max_len: Optional[int] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Texts -> padded (n, L) word-id and count arrays (bag of words).

    Out-of-vocabulary tokens are dropped (reference Document2Vector via
    DocCountVectorizerModelMapper). Tokenization is the shared ``_tokens``
    (the same one ``train_doc_count_vectorizer`` builds the vocab with).
    Padding has count 0 and id 0.
    """
    docs = []
    for t in texts:
        toks = _tokens(t)
        bag = {}
        for w in toks:
            i = index.get(w)
            if i is not None:
                bag[i] = bag.get(i, 0.0) + 1.0
        docs.append(sorted(bag.items()))
    L = max_len or max((len(d) for d in docs), default=1)
    L = max(L, 1)
    n = len(docs)
    ids = np.zeros((n, L), np.int32)
    cnts = np.zeros((n, L), np.float64)
    for r, d in enumerate(docs):
        for c, (i, v) in enumerate(d[:L]):
            ids[r, c] = i
            cnts[r, c] = v
    return ids, cnts


def draw_gamma0(gen: torch.Generator, n: int, k: int, dtype, device
                ) -> torch.Tensor:
    """The E-step's initial doc-topic matrix: ``Gamma(100) * 0.01`` draws
    from ``gen`` (the JAX package's ``jax.random.gamma(key, 100.0, (n,
    k)) * 0.01``)."""
    shape = torch.full((n, k), 100.0, dtype=dtype, device=device)
    return torch._standard_gamma(shape, generator=gen) * 0.01


def corpus_support(ids: torch.Tensor, cnts: torch.Tensor, V: int):
    """The support of the corpus' sums over word ids: the flat positions
    whose count is not 0 (int64), their word ids (int32) and the row plan
    of those ids (``kernels/rows.py::row_plan``). A padding position (count
    0, id 0) contributes +0.0 to a sum of terms >= 0 that starts at +0.0,
    which never is -0.0, so leaving it out gives the full ``segment_sum``'s
    bits, on a quarter fewer positions and without the run of every
    padding position at id 0 (exact while a padding position's term is
    +0.0, that is unless every topic's weight of word 0 underflows, where
    the JAX package adds 0/0). Built once a training: one host read, the
    count of positions."""
    pos = torch.nonzero(cnts.reshape(-1) != 0).reshape(-1)
    keys = ids.reshape(-1).index_select(0, pos).to(torch.int32).contiguous()
    return pos, keys, row_plan(keys, V)


def _segment_sum(terms, ids, V: int, support=None):
    """``jax.ops.segment_sum(terms (n*L, k), ids.reshape(-1), V)`` through
    the ordered row scatter-add, on ``support``'s positions when given
    (:func:`corpus_support`), else on every position."""
    out = torch.zeros((V, terms.shape[1]), dtype=terms.dtype,
                      device=terms.device)
    if support is None:
        return scatter_rows(out, ids.reshape(-1).to(torch.int32), terms)
    pos, keys, plan = support
    return scatter_rows(out, keys, terms.index_select(0, pos), plan)


def _e_step(ids, cnts, expElogbeta, alpha, gamma0, n_inner: int = 50,
            support=None, stats: bool = True):
    """Batched variational E-step for one doc block.

    Returns (gamma (n, k), sstats (k, V)) where sstats already includes
    the expElogbeta factor (Hoffman'10 eq. 5 trick); sstats is ``None``
    without ``stats`` (EM reads only gamma, and the JAX package's compiler
    drops the unused sum). ``support``: :func:`corpus_support` of the
    block.
    """
    n, L = ids.shape
    k, V = expElogbeta.shape
    eb = expElogbeta.T[ids]                                  # (n, L, k)
    gamma = gamma0

    def exp_elt(g):
        return torch.exp(_digamma(g) - _digamma(g.sum(1, keepdim=True)))

    for _ in range(n_inner):
        expElt = exp_elt(gamma)
        phinorm = torch.einsum("nk,nlk->nl", expElt, eb) + 1e-100
        gamma = alpha + expElt * torch.einsum("nl,nlk->nk", cnts / phinorm, eb)
    if not stats:
        return gamma, None
    expElt = exp_elt(gamma)
    phinorm = torch.einsum("nk,nlk->nl", expElt, eb) + 1e-100
    contrib = (cnts / phinorm)[:, :, None] * expElt[:, None, :]   # (n, L, k)
    sstats = _segment_sum(contrib.reshape(n * L, k), ids, V, support)
    return gamma, sstats.T * expElogbeta


def _bound_score(ids, cnts, gamma, beta_norm):
    """Per-block corpus log-likelihood proxy: sum c * log(theta . beta_w)."""
    theta = gamma / torch.clamp_min(gamma.sum(1, keepdim=True), 1e-100)
    bw = beta_norm.T[ids]                                       # (n, L, k)
    pw = torch.einsum("nk,nlk->nl", theta, bw)
    return (cnts * torch.log(torch.clamp_min(pw, 1e-100))).sum()


def _expElogbeta(lam):
    return torch.exp(_digamma(lam) - _digamma(lam.sum(1, keepdim=True)))


def _as_np(a, dtype: torch.dtype) -> np.ndarray:
    """A host array in the numpy counterpart of ``dtype``."""
    return np.asarray(a, np.float64 if dtype == torch.float64 else np.float32)


def _corpus_support(ctx, V: int):
    """:func:`corpus_support` of the partition, built on the entry
    superstep (the corpus does not change between supersteps), with the
    check that no float32 product on the card runs in TF32."""
    if ctx.is_entry_step:
        check_full_float32({"X": ctx.get_obj("cnts")})
        ctx.put_derived("lda_support", corpus_support(
            ctx.get_obj("ids"), ctx.get_obj("cnts"), V))
    return ctx.get_obj("lda_support")


def online_lda_train(ids: np.ndarray, cnts: np.ndarray, k: int, V: int,
                     num_iter: int = 10, alpha: float = -1.0, beta: float = -1.0,
                     tau0: float = 1024.0, kappa: float = 0.51,
                     subsample: float = 0.05, optimize_alpha: bool = True,
                     seed: int = 0, env=None, n_inner: int = 50,
                     dtype: torch.dtype = torch.float32):
    """Online variational LDA (reference OnlineCorpusStep +
    UpdateLambdaAndAlpha on IterativeComQueue, LdaTrainBatchOp.java:176-190).

    Each superstep samples ``subsample`` of the docs (uniforms from
    ``ComContext.rng()``), runs the batched E-step, and the sufficient
    stats drive one natural-gradient lambda update with rho_t =
    (tau0+t)^-kappa. Returns (lambda (k,V), alpha (k,), loglik,
    log_perplexity).
    """
    if alpha <= 0:
        alpha = 1.0 / k
    if beta <= 0:
        beta = 1.0 / k
    rng = np.random.RandomState(seed)
    lam0 = rng.gamma(100.0, 1.0 / 100.0, (k, V))
    total_words = float(cnts.sum())
    env = env or MLEnvironmentFactory.get_default()

    def stage(ctx):
        dev = ctx.device
        if ctx.is_init_step:
            ctx.put_obj("lambda", torch.as_tensor(lam0, dtype=dtype, device=dev))
            ctx.put_obj("alpha_vec", torch.full((k,), alpha, dtype=dtype,
                                                device=dev))
            ctx.put_obj("score", torch.zeros((), dtype=dtype, device=dev))
        support = _corpus_support(ctx, V)
        ids_b = ctx.get_obj("ids")
        cnt_b = ctx.get_obj("cnts")
        lam = ctx.get_obj("lambda")
        avec = ctx.get_obj("alpha_vec")
        step = ctx.step_no
        gen = ctx.rng()
        sel = torch.rand(ids_b.shape[0], generator=gen, dtype=dtype,
                         device=dev) < subsample
        gamma0 = draw_gamma0(gen, ids_b.shape[0], k, dtype, dev)
        cnt_mb = torch.where(sel[:, None], cnt_b, 0.0)
        eEb = _expElogbeta(lam)
        gamma, sstats = _e_step(ids_b, cnt_mb, eEb, avec[None, :], gamma0,
                                n_inner, support)
        mb_words = ctx.all_reduce_sum(cnt_mb.sum())
        sstats = ctx.all_reduce_sum(sstats)
        # natural-gradient step, rescaled minibatch -> corpus
        rho = (tau0 + step) ** (-kappa)
        scale = total_words / torch.clamp_min(mb_words, 1.0)
        lam_new = (1.0 - rho) * lam + rho * (beta + scale * sstats)
        ctx.put_obj("lambda", lam_new)
        # alpha update: Newton step on the Dirichlet MLE over the minibatch
        # gammas, empty docs masked out (they carry no evidence)
        if optimize_alpha:
            valid = sel & (cnt_b.sum(1) > 0)
            n_sel = ctx.all_reduce_sum(valid.sum().to(dtype))
            elt = _digamma(gamma) - _digamma(gamma.sum(1, keepdim=True))
            logphat_sum = ctx.all_reduce_sum((elt * valid[:, None]).sum(0))
            logphat = logphat_sum / torch.clamp_min(n_sel, 1.0)
            grad = n_sel * (_digamma(avec.sum()) - _digamma(avec) + logphat)
            q = -n_sel * torch.special.polygamma(1, avec)
            z = n_sel * torch.special.polygamma(1, avec.sum())
            b = (grad / q).sum() / (1.0 / z + (1.0 / q).sum())
            # reject the step if a component would go non-positive or the
            # minibatch was empty (n_sel = 0 makes q = -0 and b NaN)
            step_vec = avec - rho * (grad - b) / q
            danger = (step_vec <= 0).any() | (n_sel < 1)
            ctx.put_obj("alpha_vec", torch.where(danger, avec, step_vec))
        # the corpus bound: the fitted minibatch docs scaled to the corpus
        beta_norm = lam_new / torch.clamp_min(lam_new.sum(1, keepdim=True),
                                              1e-100)
        ctx.put_obj("score", ctx.all_reduce_sum(
            _bound_score(ids_b, cnt_mb, gamma, beta_norm)) * scale)

    q = (IterativeComQueue(env=env, max_iter=max(num_iter, 1), seed=seed)
         .init_with_partitioned_data("ids", ids)
         .init_with_partitioned_data("cnts", _as_np(cnts, dtype))
         .add(stage)
         .set_program_key(("lda_online", k, V, float(alpha), float(beta),
                           float(tau0), float(kappa), float(subsample),
                           bool(optimize_alpha), int(n_inner), total_words,
                           str(dtype))))
    res = q.exec()
    score = float(res.get("score"))
    log_perp = -score / max(total_words, 1.0)
    return (np.asarray(res.get("lambda")), np.asarray(res.get("alpha_vec")),
            score, log_perp)


def em_lda_train(ids: np.ndarray, cnts: np.ndarray, k: int, V: int,
                 num_iter: int = 10, alpha: float = -1.0, beta: float = -1.0,
                 seed: int = 0, env=None, n_inner: int = 20,
                 dtype: torch.dtype = torch.float32):
    """Full-batch variational EM (the JAX package's stand-in for the
    reference's collapsed Gibbs EmCorpusStep.java).

    Per superstep: the batched doc E-step against the current word-topic
    counts (from one ``gamma0``, drawn on the init pass and kept in the
    carry, as the JAX package's key does not change between supersteps),
    then the expected counts rebuild ``gamma``. Returns (wordTopicCounts
    (V,k), topicCounts (k,), alpha, beta, loglik, log_perplexity).
    """
    if alpha <= 0:
        alpha = 50.0 / k
    if beta <= 0:
        beta = 0.01
    rng = np.random.RandomState(seed)
    wt0 = rng.gamma(100.0, 1.0 / 100.0, (k, V))
    total_words = float(cnts.sum())
    env = env or MLEnvironmentFactory.get_default()

    def stage(ctx):
        dev = ctx.device
        ids_b = ctx.get_obj("ids")
        cnt_b = ctx.get_obj("cnts")
        if ctx.is_init_step:
            ctx.put_obj("wt", torch.as_tensor(wt0, dtype=dtype, device=dev))
            ctx.put_obj("score", torch.zeros((), dtype=dtype, device=dev))
            ctx.put_obj("gamma0", draw_gamma0(ctx.rng(), ids_b.shape[0], k,
                                              dtype, dev))
        support = _corpus_support(ctx, V)
        wt = ctx.get_obj("wt")
        # point-estimate topics with beta smoothing: the formula
        # LdaModelData.word_topic_probs applies at predict time
        beta_hat = (wt + beta) / (wt.sum(1, keepdim=True) + V * beta)
        gamma, _ = _e_step(ids_b, cnt_b, beta_hat, alpha,
                           ctx.get_obj("gamma0"), n_inner, stats=False)
        # expected word-topic counts: phi ~ theta_k * beta_kw
        theta = gamma / torch.clamp_min(gamma.sum(1, keepdim=True), 1e-100)
        eb = beta_hat.T[ids_b]                                    # (n, L, k)
        phi = theta[:, None, :] * eb
        phi = phi / torch.clamp_min(phi.sum(-1, keepdim=True), 1e-100)
        contrib = cnt_b[:, :, None] * phi
        n, L = ids_b.shape
        wt_new = _segment_sum(contrib.reshape(n * L, k), ids_b, V, support)
        ctx.put_obj("wt", ctx.all_reduce_sum(wt_new.T))
        ctx.put_obj("score", ctx.all_reduce_sum(
            _bound_score(ids_b, cnt_b, gamma, beta_hat)))

    q = (IterativeComQueue(env=env, max_iter=max(num_iter, 1), seed=seed)
         .init_with_partitioned_data("ids", ids)
         .init_with_partitioned_data("cnts", _as_np(cnts, dtype))
         .add(stage)
         .set_program_key(("lda_em", k, V, float(alpha), float(beta),
                           int(n_inner), str(dtype))))
    res = q.exec()
    wt = np.asarray(res.get("wt"))                                # (k, V)
    score = float(res.get("score"))
    log_perp = -score / max(total_words, 1.0)
    return wt.T, wt.sum(1), alpha, beta, score, log_perp


def expand_tokens(ids: np.ndarray, cnts: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Bag-of-words (ids, counts) -> per-OCCURRENCE token arrays.

    Collapsed Gibbs assigns a topic per token occurrence, not per bag
    entry; a count-c entry expands to c slots. Returns (tok (n, T) int32,
    mask (n, T) {0,1} f32) with zero padding, T = longest doc — never
    truncated, so counts are conserved exactly (the Gibbs invariant)."""
    n = ids.shape[0]
    docs = []
    for r in range(n):
        row = np.repeat(ids[r], cnts[r].astype(np.int64))
        docs.append(row)
    T = max(max((len(d) for d in docs), default=1), 1)
    tok = np.zeros((n, T), np.int32)
    mask = np.zeros((n, T), np.float32)
    for r, d in enumerate(docs):
        tok[r, :len(d)] = d
        mask[r, :len(d)] = 1.0
    return tok, mask


def gumbel_argmax(logp: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One categorical draw over the last axis of ``logp`` by the
    Gumbel-max rule (JAX's ``jax.random.categorical``): ``argmax(logp -
    log(-log(u)))`` with ``u`` uniform in ``[tiny, 1)`` from ``gen``."""
    u = torch.rand(logp.shape, generator=gen, dtype=logp.dtype,
                   device=logp.device)
    u.clamp_min_(torch.finfo(logp.dtype).tiny)
    return torch.argmax(logp - torch.log(-torch.log(u)), -1)


def gibbs_lda_train(ids: np.ndarray, cnts: np.ndarray, k: int, V: int,
                    num_iter: int = 50, alpha: float = -1.0,
                    beta: float = -1.0, seed: int = 0, env=None):
    """Collapsed-Gibbs LDA, the JAX package's AD-LDA sampler at one
    worker (the reference's EmCorpusStep, LdaTrainBatchOp.java:135).

    The per-token topic assignments ``z`` stay in the carry; each
    superstep rebuilds the doc-topic counts (a one-hot sum) and the
    word-topic counts, removes each token's own contribution and samples
    every token at once from the collapsed posterior (nd-z+alpha) *
    (nw-z+beta) / (nt-z+V*beta) with :func:`gumbel_argmax`. The count
    arrays are float32 as in the JAX package (the (n, T, k) ones too).
    The word-topic counts add exact small integers in float32 (at most
    the token count, below 2^24), so their sum does not depend on the
    order: ``index_add_`` stays there, on the card too. Default priors
    carry the reference's +1 shift (alpha = 50/k + 1, beta = 0.01 + 1);
    explicit ones are used as given. Returns (wordTopicCounts (V, k),
    topicCounts (k,), alpha, beta, loglik, log_perplexity).
    """
    if alpha <= 0:
        alpha = 50.0 / k + 1.0
    if beta <= 0:
        beta = 0.01 + 1.0
    tok, mask = expand_tokens(ids, cnts)
    n, T = tok.shape
    total_words = float(mask.sum())
    rng = np.random.RandomState(seed)
    z0 = rng.randint(0, k, size=(n, T)).astype(np.int32)
    env = env or MLEnvironmentFactory.get_default()

    def stage(ctx):
        if ctx.is_init_step:
            ctx.put_obj("z", ctx.get_obj("z_init").clone())
        tok_b = ctx.get_obj("tok")
        mask_b = ctx.get_obj("mask")
        z = ctx.get_obj("z")
        oh = torch.nn.functional.one_hot(z.long(), k).to(torch.float32) \
            * mask_b[..., None]
        nd = oh.sum(1)                                         # (n, k)
        # word-topic counts over flat (topic, word) cells
        flat = (z.long() * V + tok_b.long()).reshape(-1)
        nw = torch.zeros(k * V, dtype=torch.float32, device=ctx.device) \
            .index_add_(0, flat, mask_b.reshape(-1)).reshape(k, V)
        nw = ctx.all_reduce_sum(nw)
        nt = nw.sum(1)                                         # (k,)
        # the per-token posterior with the token's own count removed
        nd_m = nd[:, None, :] - oh                             # (n, T, k)
        nw_tok = nw.T[tok_b] - oh                              # (n, T, k)
        nt_m = nt[None, None, :] - oh                          # (n, T, k)
        logp = (torch.log(nd_m + alpha) + torch.log(nw_tok + beta)
                - torch.log(nt_m + V * beta))
        z_new = gumbel_argmax(logp, ctx.rng()).to(torch.int32)
        ctx.put_obj("z", torch.where(mask_b > 0, z_new, 0))

    q = (IterativeComQueue(env=env, max_iter=max(num_iter, 1), seed=seed)
         .init_with_partitioned_data("tok", tok)
         .init_with_partitioned_data("mask", mask)
         .init_with_partitioned_data("z_init", z0)
         .add(stage)
         .set_program_key(("lda_gibbs", k, V, float(alpha), float(beta))))
    res = q.exec()
    # final global counts from the final assignments (all shards)
    z_fin = res.concat("z", total=n)
    nw = np.zeros((k, V), np.float64)
    np.add.at(nw.reshape(-1), (z_fin.astype(np.int64) * V
                               + tok).reshape(-1)[mask.reshape(-1) > 0], 1.0)
    # the score from the FINAL assignments, so the reported perplexity
    # matches the returned counts
    nd = np.zeros((n, k), np.float64)
    np.add.at(nd.reshape(-1), (np.arange(n)[:, None] * k
                               + z_fin).reshape(-1)[mask.reshape(-1) > 0], 1.0)
    theta = (nd + alpha) / (nd.sum(1, keepdims=True) + k * alpha)
    beta_hat = (nw + beta) / (nw.sum(1, keepdims=True) + V * beta)
    # chunk over docs: beta_hat.T[tok] for the whole corpus would be an
    # (n, T, k) float64 allocation
    score = 0.0
    for s0 in range(0, n, 2048):
        sl = slice(s0, min(s0 + 2048, n))
        pw = np.einsum("nk,ntk->nt", theta[sl], beta_hat.T[tok[sl]])
        score += float((mask[sl] * np.log(np.maximum(pw, 1e-100))).sum())
    log_perp = -score / max(total_words, 1.0)
    return nw.T, nw.sum(1), alpha, beta, score, log_perp


def lda_infer(ids: np.ndarray, cnts: np.ndarray, word_topic: np.ndarray,
              alpha, n_inner: int = 50, seed: int = 0, device="cpu",
              dtype: torch.dtype = torch.float64) -> np.ndarray:
    """Doc-topic inference at predict time (reference LdaUtil /
    LdaModelMapper.predictResultDetail) on ``device``. word_topic: (V, k)
    p(w|z) columns (already normalized). ``gamma0`` is drawn on the host
    from a generator seeded with ``seed``, so every device starts from
    the same one. Returns theta (n, k)."""
    dev = torch.device(device)
    eEb = torch.as_tensor(np.asarray(word_topic).T, dtype=dtype, device=dev)
    a = torch.as_tensor(np.asarray(alpha), dtype=dtype, device=dev)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    k = eEb.shape[0]
    gamma0 = draw_gamma0(gen, ids.shape[0], k, dtype, "cpu").to(dev)
    gamma, _ = _e_step(torch.as_tensor(ids, device=dev),
                       torch.as_tensor(cnts, dtype=dtype, device=dev), eEb,
                       a[None, :] if a.dim() == 1 else a, gamma0, n_inner,
                       stats=False)
    gamma = gamma.cpu().numpy()
    return gamma / np.maximum(gamma.sum(1, keepdims=True), 1e-100)
