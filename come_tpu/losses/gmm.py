"""Batched full-covariance GMM EM in XLA.

Replacement for the reference's sklearn dependency (reference
``ADSCModel/community_embeddings.py::Community2Vec.fit`` ->
``sklearn.mixture.GaussianMixture(K, 'full', reg_covar, n_init)`` [R],
SURVEY.md C8, §3.4 hot loop #2): E and M steps are dense linear algebra
(Cholesky log-pdf, responsibility-weighted moments) that XLA maps straight
onto matmuls, ``n_init`` restarts run *simultaneously* via ``vmap`` instead
of sequentially, and the best restart is selected by final log-likelihood —
no host round-trip anywhere.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_LOG_2PI = 1.8378770664093453


def _log_prob(X, means, chol):
    """Gaussian log-pdfs: X [N,d], means [K,d], chol [K,d,d] -> [N,K]."""
    d = X.shape[-1]

    def per_k(mu, L):
        diff = (X - mu).T  # [d, N]
        y = jax.scipy.linalg.solve_triangular(L, diff, lower=True)
        quad = jnp.sum(y * y, axis=0)  # [N]
        logdet = jnp.sum(jnp.log(jnp.diagonal(L)))
        return -0.5 * (d * _LOG_2PI + quad) - logdet

    return jax.vmap(per_k)(means, chol).T  # [N, K]


def _e_step(X, means, chol, log_w):
    """Returns (resp [N,K], mean log-likelihood)."""
    lp = _log_prob(X, means, chol) + log_w[None, :]
    norm = jax.scipy.special.logsumexp(lp, axis=1, keepdims=True)
    return jnp.exp(lp - norm), jnp.mean(norm)


def _m_step(X, resp, reg_covar):
    """Responsibility-weighted moments -> (means, chol, log_weights)."""
    N, d = X.shape
    nk = jnp.sum(resp, axis=0) + 10.0 * jnp.finfo(X.dtype).eps  # [K]
    means = (resp.T @ X) / nk[:, None]
    diff = X[None, :, :] - means[:, None, :]  # [K, N, d]
    cov = jnp.einsum("nk,knd,kne->kde", resp, diff, diff) / nk[:, None, None]
    cov = cov + reg_covar * jnp.eye(d, dtype=X.dtype)[None]
    chol = jax.lax.linalg.cholesky(cov)
    return means, chol, jnp.log(nk / N)


def _kmeans_init(X, K, key, iters: int = 8):
    """k-means-style init (sklearn's default init family): random points as
    centers, a few Lloyd iterations, one-hot responsibilities."""
    N = X.shape[0]
    idx = jax.random.choice(key, N, (K,), replace=False)
    centers = X[idx]

    def lloyd(centers, _):
        d2 = (
            jnp.sum(X * X, 1, keepdims=True)
            - 2.0 * X @ centers.T
            + jnp.sum(centers * centers, 1)[None]
        )
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, K, dtype=X.dtype)
        counts = jnp.sum(onehot, 0)
        new = (onehot.T @ X) / jnp.maximum(counts, 1.0)[:, None]
        new = jnp.where(counts[:, None] > 0, new, centers)
        return new, None

    centers, _ = jax.lax.scan(lloyd, centers, None, length=iters)
    d2 = (
        jnp.sum(X * X, 1, keepdims=True)
        - 2.0 * X @ centers.T
        + jnp.sum(centers * centers, 1)[None]
    )
    return jax.nn.one_hot(jnp.argmin(d2, axis=1), K, dtype=X.dtype)


def _em_while_loop(means, chol, log_w, e_step, m_step, max_iter, tol):
    """Shared tol-rule EM convergence loop (sklearn's rule, which the
    reference inherits [R, SURVEY.md C8]): stop once the mean
    log-likelihood improves by less than ``tol`` between iterations,
    ``max_iter`` the hard cap.  ``it < 2`` keeps the first two iterations
    unconditional (prev_ll/ll start at -inf; -inf - -inf is NaN).
    ``tol <= 0`` statically disables early stop.  One definition serves
    the single-device and sharded fits so the stopping rules can't drift.
    """

    def em_cond(c):
        it, prev_ll, ll = c[0], c[1], c[2]
        if tol <= 0:  # static: early stop disabled
            return it < max_iter
        improving = (it < 2) | (ll - prev_ll > tol)
        return (it < max_iter) & improving

    def em_body(c):
        it, prev_ll, ll, means, chol, log_w = c
        resp, new_ll = e_step(means, chol, log_w)
        return (it + 1, ll, new_ll) + tuple(m_step(resp))

    ninf = jnp.float32(-jnp.inf)
    _, _, _, means, chol, log_w = jax.lax.while_loop(
        em_cond, em_body, (0, ninf, ninf, means, chol, log_w)
    )
    return means, chol, log_w


@partial(
    jax.jit, static_argnames=("num_components", "max_iter", "n_init", "tol")
)
def gmm_em_fit(
    X: jnp.ndarray,
    num_components: int,
    key: jax.Array,
    n_init: int = 1,
    max_iter: int = 60,
    reg_covar: float = 1e-5,
    tol: float = 1e-3,
):
    """Fit a full-covariance GMM; restarts batched via vmap.

    ``tol``: EM stops once the mean log-likelihood improves by less than
    this between iterations (sklearn's ``tol`` convergence rule [R,
    SURVEY.md C8] — the reference inherits tol=1e-3); ``max_iter`` stays
    the hard cap.  tol=0 runs all max_iter iterations.  On BlogCatalog-
    scale fits EM converges in ~10-20 iterations, so the while_loop form
    cuts the dominant full-loop phase ~3x vs a fixed 60-iteration scan.

    Returns dict(means [K,d], chol [K,d,d], inv_cov [K,d,d],
    log_weights [K], resp [N,K], log_likelihood scalar) of the best restart.
    """
    K = num_components
    X = X.astype(jnp.float32)

    def one_fit(k):
        resp0 = _kmeans_init(X, K, k)
        means, chol, log_w = _m_step(X, resp0, reg_covar)
        means, chol, log_w = _em_while_loop(
            means, chol, log_w,
            lambda m, c, w: _e_step(X, m, c, w),
            lambda resp: _m_step(X, resp, reg_covar),
            max_iter, tol,
        )
        resp, ll = _e_step(X, means, chol, log_w)
        return means, chol, log_w, resp, ll

    keys = jax.random.split(key, n_init)
    means, chol, log_w, resp, ll = jax.vmap(one_fit)(keys)
    best = jnp.argmax(ll)
    means, chol, log_w, resp = (
        means[best],
        chol[best],
        log_w[best],
        resp[best],
    )
    eye = jnp.eye(X.shape[1], dtype=X.dtype)
    inv_cov = jax.vmap(lambda L: jax.scipy.linalg.cho_solve((L, True), eye))(chol)
    return dict(
        means=means,
        chol=chol,
        inv_cov=inv_cov,
        log_weights=log_w,
        resp=resp,
        log_likelihood=ll[best],
    )


def gmm_em_fit_sharded(
    x_shard: jnp.ndarray,
    mask_shard: jnp.ndarray,
    num_components: int,
    key: jax.Array,
    axis: str = "model",
    n_init: int = 1,
    max_iter: int = 60,
    reg_covar: float = 1e-5,
    tol: float = 1e-3,
    data_axis: str | None = None,
):
    """Distributed EM, called INSIDE shard_map with rows sharded on ``axis``.

    ``x_shard`` [Vl, d] is this shard's rows (aligned with the row-sharded
    embedding table); ``mask_shard`` [Vl] zeroes padded rows.  E-step is
    local; every M-step moment (nk, means, covariances) and the
    log-likelihood are psum'd over the axis — the sharded replacement for
    sklearn's single-host EM at any V.  Restarts run sequentially in a scan;
    the best by log-likelihood wins (same selection rule as the reference's
    ``n_init``).

    ``data_axis`` (VERDICT r3 item 2): when given, the EM compute is ALSO
    partitioned over that axis — each of the D replicas of a row shard
    works a Vl/D chunk and moments psum over BOTH axes, so the fit divides
    by the whole mesh instead of by the model axis
    alone.  The final responsibilities still cover the full local shard
    (row-wise normalization is local), so the output contract is
    unchanged.

    Returns the same dict as :func:`gmm_em_fit` with ``resp`` holding only
    this shard's rows.
    """
    K = num_components
    X = x_shard.astype(jnp.float32)
    w = mask_shard.astype(jnp.float32)  # [Vl]
    d = X.shape[1]
    vl = X.shape[0]
    axes = (axis,) if data_axis is None else (axis, data_axis)
    if data_axis is not None:
        # compute view: this data replica's chunk of the row shard (zero-
        # padded so chunks are equal — pad rows carry zero weight)
        D = jax.lax.axis_size(data_axis)
        chunk = -(-vl // D)
        di = jax.lax.axis_index(data_axis)
        Xp = jnp.pad(X, ((0, chunk * D - vl), (0, 0)))
        wp = jnp.pad(w, (0, chunk * D - vl))
        Xc = jax.lax.dynamic_slice_in_dim(Xp, di * chunk, chunk)
        wc = jax.lax.dynamic_slice_in_dim(wp, di * chunk, chunk)
    else:
        Xc, wc = X, w
    n_total = jax.lax.psum(jnp.sum(wc), axes)

    def m_step(resp):
        resp = resp * wc[:, None]
        nk = jax.lax.psum(jnp.sum(resp, axis=0), axes) + 10.0 * jnp.finfo(
            jnp.float32
        ).eps
        means = jax.lax.psum(resp.T @ Xc, axes) / nk[:, None]
        diff = Xc[None, :, :] - means[:, None, :]  # [K, chunk, d]
        cov = (
            jax.lax.psum(
                jnp.einsum("nk,knd,kne->kde", resp, diff, diff), axes
            )
            / nk[:, None, None]
        )
        cov = cov + reg_covar * jnp.eye(d, dtype=jnp.float32)[None]
        return means, jax.lax.linalg.cholesky(cov), jnp.log(nk / n_total)

    def e_step(means, chol, log_w):
        lp = _log_prob(Xc, means, chol) + log_w[None, :]
        norm = jax.scipy.special.logsumexp(lp, axis=1, keepdims=True)
        ll = jax.lax.psum(jnp.sum(norm[:, 0] * wc), axes) / n_total
        return jnp.exp(lp - norm), ll

    def init_resp(k):
        # shared-random global center choice: every worker samples the
        # same K global row ids, then contributes its owned rows via psum.
        # Global id space = model-shard-major over the UNCHUNKED rows, so
        # the draw is identical with and without a data axis.
        m = jax.lax.axis_size(axis)
        # stratified draw: one center per stride of rows -> always distinct
        stride = jnp.maximum((vl * m) // K, 1)
        offs = jax.random.randint(k, (K,), 0, stride)
        idx = jnp.minimum(
            jnp.arange(K, dtype=jnp.int32) * stride + offs, vl * m - 1
        )
        my = jax.lax.axis_index(axis)
        local = idx - my * vl
        ok = (local >= 0) & (local < vl)
        if data_axis is not None:
            # ownership narrows to this replica's chunk of the shard
            D = jax.lax.axis_size(data_axis)
            chunk = -(-vl // D)
            di = jax.lax.axis_index(data_axis)
            local = local - di * chunk
            ok = ok & (local >= 0) & (local < chunk)
        centers = jnp.where(
            ok[:, None], Xc[jnp.clip(local, 0, Xc.shape[0] - 1)], 0.0
        )
        centers = jax.lax.psum(centers, axes)

        def lloyd(c, _):
            d2 = (
                jnp.sum(Xc * Xc, 1, keepdims=True)
                - 2.0 * Xc @ c.T
                + jnp.sum(c * c, 1)[None]
            )
            assign = jnp.argmin(d2, axis=1)
            onehot = jax.nn.one_hot(assign, K, dtype=jnp.float32) * wc[:, None]
            counts = jax.lax.psum(jnp.sum(onehot, 0), axes)
            new = jax.lax.psum(onehot.T @ Xc, axes) / jnp.maximum(
                counts, 1.0
            )[:, None]
            return jnp.where(counts[:, None] > 0, new, c), None

        centers, _ = jax.lax.scan(lloyd, centers, None, length=8)
        d2 = (
            jnp.sum(Xc * Xc, 1, keepdims=True)
            - 2.0 * Xc @ centers.T
            + jnp.sum(centers * centers, 1)[None]
        )
        return jax.nn.one_hot(jnp.argmin(d2, axis=1), K, dtype=jnp.float32)

    def full_resp(means, chol, log_w):
        # responsibilities for the FULL local shard (row-wise normalization
        # is local — no communication), regardless of the compute chunking
        lp = _log_prob(X, means, chol) + log_w[None, :]
        norm = jax.scipy.special.logsumexp(lp, axis=1, keepdims=True)
        return jnp.exp(lp - norm)

    def one_fit(carry, k):
        means, chol, log_w = m_step(init_resp(k))
        # shared tol-rule EM loop; the condition is uniform across shards
        # because ll is psum'd inside e_step
        means, chol, log_w = _em_while_loop(
            means, chol, log_w, e_step, m_step, max_iter, tol
        )
        resp, ll = e_step(means, chol, log_w)
        if data_axis is not None:
            # resp above covers only this replica's chunk; the output
            # contract is the FULL local shard (row-local normalization)
            resp = full_resp(means, chol, log_w)
        best_ll, best = carry
        take = ll > best_ll
        best = jax.tree_util.tree_map(
            lambda new, old: jnp.where(take, new, old),
            (means, chol, log_w, resp),
            best,
        )
        return (jnp.maximum(ll, best_ll), best), None

    keys = jax.random.split(key, n_init)
    zero = (
        jnp.zeros((K, d)),
        jnp.eye(d)[None].repeat(K, 0),
        jnp.zeros((K,)),
        jnp.zeros((X.shape[0], K)),
    )
    (ll, (means, chol, log_w, resp)), _ = jax.lax.scan(
        one_fit, (-jnp.inf, zero), keys
    )
    eye = jnp.eye(d, dtype=jnp.float32)
    inv_cov = jax.vmap(lambda L: jax.scipy.linalg.cho_solve((L, True), eye))(chol)
    return dict(
        means=means,
        chol=chol,
        inv_cov=inv_cov,
        log_weights=log_w,
        resp=resp,
        log_likelihood=ll,
    )


def fit_communities(params, key, n_init: int = 1, max_iter: int = 60,
                    reg_covar: float = 1e-5, tol: float = 1e-3):
    """Reference ``Community2Vec.fit`` analog: EM on current node_emb, then
    copy means/covs/inverses/responsibilities into the model state."""
    out = gmm_em_fit(
        params.node_emb,
        params.num_communities,
        key,
        n_init=n_init,
        max_iter=max_iter,
        reg_covar=reg_covar,
        tol=tol,
    )
    return params.replace(
        centroid=out["means"],
        chol_cov=out["chol"],
        inv_cov=out["inv_cov"],
        pi=out["resp"],
    ), out["log_likelihood"]
