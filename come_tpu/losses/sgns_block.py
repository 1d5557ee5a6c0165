"""Block SGNS with batch-shared negatives — the matmul formulation.

The reference's inner loop scores each pair against its own k negatives with
scalar ``sdot``s (SURVEY.md §3.2); an accelerator wants that work as
matmuls.  Sharing one pool of ``num_shared`` negatives across a micro-batch
(the GraphVite trick — PAPERS.md: "GraphVite: CPU-GPU hybrid system", which
shares negatives within a sample block — pattern reference only) makes the
negative term a dense [B, d] x [d, K'] matmul and its gradients two more
matmuls, while keeping the same unigram^0.75 marginal distribution:

  scores  S = Phi_c  @ Cneg^T          [B, K']   (matmul)
  d_Phi  += (sigma(S) * w) @ Cneg      [B, d]    (matmul)
  d_Cneg  = (sigma(S) * w)^T @ Phi_c   [K', d]   (matmul, dense -> K' rows)

Per-pair work is normalized so one trained pair still means "1 positive +
``negative`` noise comparisons" in expectation: each of the K' shared
negatives gets weight ``negative / num_shared`` in the loss and gradients.
Sparse traffic drops from (2+k) rows/pair to 2 rows/pair + K' dense rows
per micro-batch.

Quality is validated end-to-end (karate/BlogCatalog NMI + F1) rather than by
the per-pair numpy oracle, which models the reference's per-pair negatives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from come_tpu.ops.sparse import gather_rows, scatter_add_rows, sddmm_pair_scores


def sgns_block_grads_from_rows(
    phi: jnp.ndarray,
    cpos: jnp.ndarray,
    cneg: jnp.ndarray,
    mask: jnp.ndarray,
    negative_weight: float,
):
    """Core block-SGNS math on pre-gathered rows (shared with the sharded
    path, where gathering goes through collectives).

    phi/cpos [B, d], cneg [K', d], mask [B].
    Returns (loss, n_pairs, (d_phi [B,d], d_cpos [B,d], d_cneg [K',d])).
    """
    m = mask.astype(phi.dtype)
    spos = sddmm_pair_scores(phi, cpos)  # [B]
    sneg = jnp.dot(phi, cneg.T, preferred_element_type=jnp.float32)  # [B, K']

    loss = -(
        jnp.sum(m * jax.nn.log_sigmoid(spos))
        + negative_weight
        * jnp.sum(m[:, None] * jax.nn.log_sigmoid(-sneg))
    )
    n_pairs = jnp.sum(m)

    gpos = (jax.nn.sigmoid(spos) - 1.0) * m  # [B]
    gneg = jax.nn.sigmoid(sneg) * (negative_weight * m[:, None])  # [B, K']

    d_phi = gpos[:, None] * cpos + jnp.dot(
        gneg, cneg, preferred_element_type=jnp.float32
    )
    d_cpos = gpos[:, None] * phi
    d_cneg = jnp.dot(gneg.T, phi, preferred_element_type=jnp.float32)
    return loss, n_pairs, (d_phi, d_cpos, d_cneg)


def sgns_block_loss_and_grads(
    emb_in: jnp.ndarray,
    emb_out: jnp.ndarray,
    centers: jnp.ndarray,
    contexts: jnp.ndarray,
    shared_negs: jnp.ndarray,
    mask: jnp.ndarray,
    negative_weight: float,
):
    """SGNS with a shared negative pool (full-table entry point).

    Args:
      centers, contexts: int32 [B].
      shared_negs: int32 [K'] negative row ids shared by the whole block.
      mask: [B] pair validity.
      negative_weight: k / K' — keeps per-pair noise work calibrated.

    Returns (loss, n_pairs, (d_phi [B,d], d_cpos [B,d], d_cneg [K',d])).
    """
    phi = gather_rows(emb_in, centers)
    cpos = gather_rows(emb_out, contexts)
    cneg = gather_rows(emb_out, shared_negs)
    return sgns_block_grads_from_rows(
        phi, cpos, cneg, mask, negative_weight
    )


def sgns_block_sgd_step(
    emb_in: jnp.ndarray,
    emb_out: jnp.ndarray,
    centers: jnp.ndarray,
    contexts: jnp.ndarray,
    shared_negs: jnp.ndarray,
    mask: jnp.ndarray,
    lr,
    negative_weight: float,
    tie_tables: bool = False,
):
    """One micro-step of block SGNS; mirrors losses.sgns.sgns_sgd_step."""
    loss, n_pairs, (d_phi, d_cpos, d_cneg) = sgns_block_loss_and_grads(
        emb_in, emb_out, centers, contexts, shared_negs, mask,
        negative_weight,
    )
    if tie_tables:
        idx = jnp.concatenate([centers, contexts, shared_negs])
        upd = jnp.concatenate([d_phi, d_cpos, d_cneg]) * (-lr)
        new = scatter_add_rows(emb_in, idx, upd)
        return new, new, loss, n_pairs
    new_in = scatter_add_rows(emb_in, centers, d_phi * (-lr))
    out_idx = jnp.concatenate([contexts, shared_negs])
    out_upd = jnp.concatenate([d_cpos, d_cneg]) * (-lr)
    new_out = scatter_add_rows(emb_out, out_idx, out_upd)
    return new_in, new_out, loss, n_pairs
