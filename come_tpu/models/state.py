"""ComE model state: embedding tables + community parameters as one pytree.

Redesign of the reference's ``Model`` class (reference
``ADSCModel/model.py`` [R], SURVEY.md C5).  Where the reference holds shared
mutable numpy arrays that hogwild threads race on, this is an immutable
pytree threaded through pure jitted train steps; "mutation" is functional
replacement, which is what makes sharding (``jax.sharding``) and donation
work.

Shapes (V nodes, d dims, K communities):
  node_emb [V, d]   - the phi table, init U[-0.5/d, 0.5/d] (reference init)
  ctx_emb  [V, d]   - the context/output table, zero init (word2vec style)
  centroid [K, d]   - GMM means psi_k
  chol_cov [K, d, d]- lower-Cholesky factors of the GMM covariances
  inv_cov  [K, d, d]- covariance inverses (used by the O3 gradient)
  pi       [V, K]   - community responsibilities (E-step output)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (every field a child),
    with ``.replace(**changes)`` for functional updates."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class ComEParams:
    node_emb: jnp.ndarray
    ctx_emb: jnp.ndarray
    centroid: jnp.ndarray
    chol_cov: jnp.ndarray
    inv_cov: jnp.ndarray
    pi: jnp.ndarray

    @property
    def num_nodes(self) -> int:
        return self.node_emb.shape[0]

    @property
    def dim(self) -> int:
        return self.node_emb.shape[1]

    @property
    def num_communities(self) -> int:
        return self.centroid.shape[0]


def init_params(
    num_nodes: int,
    dim: int = 128,
    num_communities: int = 2,
    key: jax.Array | None = None,
    dtype=jnp.float32,
) -> ComEParams:
    """Reference-matching init: node_emb ~ U[-0.5/d, 0.5/d], ctx_emb = 0.

    Community params start at the standard-normal GMM (identity covariances,
    uniform responsibilities); they are overwritten by the first
    :func:`come_tpu.losses.gmm.fit_communities` call.
    """
    if key is None:
        key = jax.random.key(0)
    v, d, k = num_nodes, dim, num_communities
    node = jax.random.uniform(key, (v, d), dtype, -0.5 / d, 0.5 / d)
    def eye():
        # distinct buffers: sharing one array between fields breaks donation
        return jnp.tile(jnp.eye(d, dtype=dtype)[None], (k, 1, 1))

    return ComEParams(
        node_emb=node,
        ctx_emb=jnp.zeros((v, d), dtype),
        centroid=jnp.zeros((k, d), dtype),
        chol_cov=eye(),
        inv_cov=eye(),
        pi=jnp.full((v, k), 1.0 / k, dtype),
    )
