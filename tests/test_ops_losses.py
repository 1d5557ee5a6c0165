"""Kernel + loss parity vs the numpy oracle (BASELINE acceptance gate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from come_tpu.evaluation import oracle
from come_tpu.losses.community import (
    community_grad,
    community_loss,
    community_sgd_step,
)
from come_tpu.losses.sgns import sgns_loss_and_grads, sgns_sgd_step
from come_tpu.ops.sparse import scatter_add_rows, scatter_add_rows_sorted


def _random_batch(rng, V=50, d=16, P=200, K=5):
    emb_in = rng.normal(size=(V, d)).astype(np.float32) * 0.3
    emb_out = rng.normal(size=(V, d)).astype(np.float32) * 0.3
    centers = rng.integers(0, V, P).astype(np.int32)
    contexts = rng.integers(0, V, P).astype(np.int32)
    negatives = rng.integers(0, V, (P, K)).astype(np.int32)
    mask = (rng.random(P) < 0.8)
    return emb_in, emb_out, centers, contexts, negatives, mask


def _dense_grads_from_contrib(V, d, centers, contexts, negatives, contrib):
    d_phi, d_cpos, d_cneg = [np.asarray(x) for x in contrib]
    din = np.zeros((V, d), np.float32)
    dout = np.zeros((V, d), np.float32)
    np.add.at(din, np.asarray(centers), d_phi)
    np.add.at(dout, np.asarray(contexts), d_cpos)
    np.add.at(dout, np.asarray(negatives).reshape(-1),
              d_cneg.reshape(-1, d))
    return din, dout


@pytest.mark.parametrize("max_exp", [None, 6.0])
def test_sgns_grads_match_oracle(rng, max_exp):
    emb_in, emb_out, c, x, n, m = _random_batch(rng)
    loss, npairs, contrib = sgns_loss_and_grads(
        jnp.asarray(emb_in), jnp.asarray(emb_out),
        jnp.asarray(c), jnp.asarray(x), jnp.asarray(n), jnp.asarray(m),
        max_exp=max_exp,
    )
    din, dout = _dense_grads_from_contrib(50, 16, c, x, n, contrib)
    oloss, odin, odout = oracle.sgns_batch_grads(
        emb_in, emb_out, c, x, n, m, max_exp=max_exp
    )
    np.testing.assert_allclose(float(loss), oloss, rtol=1e-4)
    np.testing.assert_allclose(din, odin, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dout, odout, rtol=1e-4, atol=1e-5)


def test_sgns_sgd_step_matches_oracle_update(rng):
    emb_in, emb_out, c, x, n, m = _random_batch(rng)
    lr = 0.05
    new_in, new_out, loss, npairs = sgns_sgd_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out),
        jnp.asarray(c), jnp.asarray(x), jnp.asarray(n), jnp.asarray(m), lr,
    )
    _, odin, odout = oracle.sgns_batch_grads(emb_in, emb_out, c, x, n, m)
    np.testing.assert_allclose(np.asarray(new_in), emb_in - lr * odin,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(new_out), emb_out - lr * odout,
                               rtol=1e-4, atol=1e-6)


def test_sgns_tied_tables_o2_mode(rng):
    emb_in, _, c, x, n, m = _random_batch(rng)
    lr = 0.05
    new1, new2, loss, _ = sgns_sgd_step(
        jnp.asarray(emb_in), jnp.asarray(emb_in),
        jnp.asarray(c), jnp.asarray(x), jnp.asarray(n), jnp.asarray(m), lr,
        tie_tables=True,
    )
    oloss, og = oracle.sgns_batch_grads_tied(emb_in, c, x, n, m)
    np.testing.assert_allclose(float(loss), oloss, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(new1), emb_in - lr * og,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(new1), np.asarray(new2))


def test_scatter_add_variants_agree(rng):
    V, d, P = 30, 8, 500
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, P).astype(np.int32)
    upd = rng.normal(size=(P, d)).astype(np.float32)
    a = scatter_add_rows(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(upd))
    b = scatter_add_rows_sorted(jnp.asarray(table), jnp.asarray(idx),
                                jnp.asarray(upd))
    ref = table.copy()
    np.add.at(ref, idx, upd)
    np.testing.assert_allclose(np.asarray(a), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(b), ref, rtol=1e-4, atol=1e-5)


def test_community_grad_matches_oracle(rng):
    N, d, K = 40, 8, 3
    emb = rng.normal(size=(N, d)).astype(np.float32)
    pi = rng.random((N, K)).astype(np.float32)
    pi /= pi.sum(1, keepdims=True)
    centroid = rng.normal(size=(K, d)).astype(np.float32)
    A = rng.normal(size=(K, d, d)).astype(np.float32) * 0.1
    cov = np.einsum("kde,kfe->kdf", A, A) + np.eye(d, dtype=np.float32)[None]
    inv_cov = np.linalg.inv(cov)
    beta = 0.1

    g = community_grad(jnp.asarray(emb), jnp.asarray(pi),
                       jnp.asarray(centroid), jnp.asarray(inv_cov), beta)
    og = oracle.community_grads(emb, pi, centroid, inv_cov, beta)
    # f32 einsum reassociation (blocked matmuls) vs the oracle's f64 loop
    np.testing.assert_allclose(np.asarray(g), og, rtol=1e-3, atol=5e-4)

    # batch (subset) mode
    nodes = np.array([3, 7, 7, 20], np.int32)  # duplicate on purpose
    stepped = community_sgd_step(
        jnp.asarray(emb), jnp.asarray(pi), jnp.asarray(centroid),
        jnp.asarray(inv_cov), beta, 0.1, nodes=jnp.asarray(nodes),
    )
    expect = emb.copy()
    for i in nodes:
        expect[i] -= 0.1 * og[i]  # duplicates apply twice
    expect[7] = emb[7] - 2 * 0.1 * og[7]
    np.testing.assert_allclose(np.asarray(stepped), expect, rtol=1e-4,
                               atol=1e-5)


def test_community_loss_is_grad_potential(rng):
    """Finite-difference check: community_grad == d(community_loss)/dphi."""
    N, d, K = 6, 4, 2
    emb = rng.normal(size=(N, d)).astype(np.float64)
    pi = rng.random((N, K))
    pi /= pi.sum(1, keepdims=True)
    centroid = rng.normal(size=(K, d))
    A = rng.normal(size=(K, d, d)) * 0.1
    cov = np.einsum("kde,kfe->kdf", A, A) + np.eye(d)[None]
    chol = np.linalg.cholesky(cov)
    inv_cov = np.linalg.inv(cov)
    beta = 0.3

    def loss_at(e):
        return float(
            community_loss(
                jnp.asarray(e, jnp.float32), jnp.asarray(pi, jnp.float32),
                jnp.asarray(centroid, jnp.float32),
                jnp.asarray(chol, jnp.float32),
                jnp.asarray(inv_cov, jnp.float32), beta,
            )
        )

    g = np.asarray(
        community_grad(
            jnp.asarray(emb, jnp.float32), jnp.asarray(pi, jnp.float32),
            jnp.asarray(centroid, jnp.float32),
            jnp.asarray(inv_cov, jnp.float32), beta,
        )
    )
    eps = 1e-2
    for i, j in [(0, 0), (2, 3), (5, 1)]:
        e2 = emb.copy()
        e2[i, j] += eps
        e1 = emb.copy()
        e1[i, j] -= eps
        fd = (loss_at(e2) - loss_at(e1)) / (2 * eps)
        assert abs(fd - g[i, j]) < 5e-3, (i, j, fd, g[i, j])
