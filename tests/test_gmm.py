"""Batched XLA GMM EM vs sklearn's GaussianMixture (the component it replaces)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from come_tpu.losses.gmm import fit_communities, gmm_em_fit
from come_tpu.models import init_params


def _blobs(rng, n_per=100, K=3, d=4, spread=4.0):
    means = rng.normal(size=(K, d)) * spread
    X = np.concatenate(
        [rng.normal(size=(n_per, d)) * 0.5 + means[k] for k in range(K)]
    ).astype(np.float32)
    labels = np.repeat(np.arange(K), n_per)
    return X, labels, means


def test_gmm_recovers_blobs(rng):
    X, labels, _ = _blobs(rng)
    out = gmm_em_fit(jnp.asarray(X), 3, jax.random.key(0), n_init=2,
                     max_iter=40)
    pred = np.asarray(out["resp"]).argmax(1)
    from come_tpu.evaluation import nmi_score

    assert nmi_score(labels, pred) > 0.95
    # responsibilities are a proper distribution
    np.testing.assert_allclose(np.asarray(out["resp"]).sum(1), 1.0, atol=1e-5)


def test_gmm_loglik_close_to_sklearn(rng):
    X, _, _ = _blobs(rng, n_per=150, K=2, d=3)
    out = gmm_em_fit(jnp.asarray(X), 2, jax.random.key(1), n_init=2,
                     max_iter=60, reg_covar=1e-6)
    GaussianMixture = pytest.importorskip("sklearn.mixture").GaussianMixture

    sk = GaussianMixture(2, covariance_type="full", n_init=2, max_iter=60,
                         reg_covar=1e-6, random_state=0).fit(X)
    ours = float(out["log_likelihood"])
    theirs = float(sk.score(X))
    assert ours > theirs - 0.05, (ours, theirs)


def test_gmm_inv_cov_consistency(rng):
    X, _, _ = _blobs(rng, n_per=80, K=2, d=3)
    out = gmm_em_fit(jnp.asarray(X), 2, jax.random.key(2), max_iter=30)
    chol = np.asarray(out["chol"])
    inv = np.asarray(out["inv_cov"])
    for k in range(2):
        cov = chol[k] @ chol[k].T
        np.testing.assert_allclose(cov @ inv[k], np.eye(3), atol=1e-3)


def test_fit_communities_updates_params(rng):
    params = init_params(60, dim=4, num_communities=2, key=jax.random.key(3))
    # give node_emb some structure
    X, labels, _ = _blobs(rng, n_per=30, K=2, d=4)
    params = params.replace(node_emb=jnp.asarray(X))
    params, ll = fit_communities(params, jax.random.key(4), max_iter=30)
    assert params.pi.shape == (60, 2)
    assert np.isfinite(float(ll))
    pred = np.asarray(params.pi).argmax(1)
    from come_tpu.evaluation import nmi_score

    assert nmi_score(labels, pred) > 0.9
