"""O3 — GMM community-closure loss and its SGD step.

Replacement for the reference's numpy chunk loop (reference
``ADSCModel/community_embeddings.py::Community2Vec.train`` [R], SURVEY.md C8,
§3.4): the per-node K x d^2 matvec loop becomes two einsums over the whole
node batch, which XLA maps onto matmuls.

With responsibilities pi and covariances held fixed (they are refit by the
EM step between passes), the trained objective for node i is

    L3_i = beta/K * sum_k pi_ik * [ -log N(phi_i ; psi_k, Sigma_k) ]

whose phi-gradient is the paper's Eq. (SURVEY.md C8 [R-high]):

    dL3/dphi_i = beta/K * sum_k pi_ik * Sigma_k^{-1} (phi_i - psi_k)
"""

from __future__ import annotations

import jax.numpy as jnp

from come_tpu.ops.sparse import gather_rows, scatter_add_rows

_LOG_2PI = 1.8378770664093453


def community_grad(
    node_emb: jnp.ndarray,
    pi: jnp.ndarray,
    centroid: jnp.ndarray,
    inv_cov: jnp.ndarray,
    beta: float,
    nodes: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """dL3/dphi for a batch of nodes (all nodes when ``nodes`` is None)."""
    K = centroid.shape[0]
    if nodes is not None:
        phi = gather_rows(node_emb, nodes)
        resp = gather_rows(pi, nodes)
    else:
        phi, resp = node_emb, pi
    diff = phi[:, None, :] - centroid[None]  # [N, K, d]
    mv = jnp.einsum("nkd,kde->nke", diff, inv_cov)  # Sigma^-1 (phi-psi)
    return (beta / K) * jnp.einsum("nk,nke->ne", resp, mv)


def community_loss(
    node_emb: jnp.ndarray,
    pi: jnp.ndarray,
    centroid: jnp.ndarray,
    chol_cov: jnp.ndarray,
    inv_cov: jnp.ndarray,
    beta: float,
) -> jnp.ndarray:
    """Monitored O3 value: responsibility-weighted negative log-pdf."""
    K, d = centroid.shape
    diff = node_emb[:, None, :] - centroid[None]  # [N, K, d]
    quad = jnp.einsum("nkd,kde,nke->nk", diff, inv_cov, diff)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol_cov, axis1=-2, axis2=-1)), axis=-1
    )  # [K]
    neg_logpdf = 0.5 * (d * _LOG_2PI + logdet[None, :] + quad)
    return (beta / K) * jnp.sum(pi * neg_logpdf)


def community_sgd_step(
    node_emb: jnp.ndarray,
    pi: jnp.ndarray,
    centroid: jnp.ndarray,
    inv_cov: jnp.ndarray,
    beta: float,
    lr: jnp.ndarray | float,
    nodes: jnp.ndarray | None = None,
    grad_clip: float | None = None,
) -> jnp.ndarray:
    """phi_i -= lr * dL3/dphi_i, full-table or for a node batch.

    ``grad_clip`` bounds the per-node gradient L2 norm.  The reference has no
    such guard, but when the EM fit turns near-singular (few points per
    component relative to d), ``inv_cov`` eigenvalues approach 1/reg_covar
    and the unclipped step diverges; clipping preserves direction exactly.
    """
    g = community_grad(node_emb, pi, centroid, inv_cov, beta, nodes)
    if grad_clip is not None:
        norm = jnp.linalg.norm(g, axis=-1, keepdims=True)
        g = g * jnp.minimum(1.0, grad_clip / jnp.maximum(norm, 1e-12))
    if nodes is None:
        return node_emb - lr * g
    return scatter_add_rows(node_emb, nodes, -lr * g)
