"""Skip-gram negative-sampling loss, shared by O1 (walk windows) and O2 (edges).

Replacement for the Cython hot loop (reference
``utils/training_sdg_inner.pyx::train_o1/train_o2`` [R], SURVEY.md C1, §3.2):
the loss over a masked batch of (center, context, K negatives) triples as a
pure function, with hand-written gradients (cheaper and more fusible than
autodiff through the gathers) applied by a deterministic scatter-add.

Loss (descent convention; identical updates to word2vec's ascent form):
    L = -sum_p m_p [ log s(phi_p . c_p) + sum_k log s(-phi_p . n_pk) ]

``max_exp`` emulates the reference's EXP_TABLE clamp (gensim lineage): pairs
whose score magnitude reaches MAX_EXP=6 are *skipped entirely* (the Cython
kernel ``continue``s past them).  ``None`` (default) trains them exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from come_tpu.ops.sparse import (
    gather_rows,
    scatter_add_rows,
    sddmm_neg_scores,
    sddmm_pair_scores,
)


def sgns_grads_from_rows(
    phi: jnp.ndarray,
    cpos: jnp.ndarray,
    cneg: jnp.ndarray,
    mask: jnp.ndarray,
    max_exp: float | None = None,
):
    """Core SGNS math on pre-gathered rows (shared by the local path and the
    sharded path, where gathering itself involves collectives).

    Args:
      phi: [P, d] center rows; cpos: [P, d] context rows; cneg: [P, K, d].
      mask: bool/float [P].

    Returns (loss, n_pairs, (d_phi, d_cpos, d_cneg)).
    """
    spos = sddmm_pair_scores(phi, cpos)  # [P]
    sneg = sddmm_neg_scores(phi, cneg)  # [P, K]

    m = mask.astype(phi.dtype)
    mpos = m
    mneg = m[:, None] * jnp.ones_like(sneg)
    if max_exp is not None:
        mpos = mpos * (jnp.abs(spos) < max_exp).astype(phi.dtype)
        mneg = mneg * (jnp.abs(sneg) < max_exp).astype(phi.dtype)

    loss = -(
        jnp.sum(mpos * jax.nn.log_sigmoid(spos))
        + jnp.sum(mneg * jax.nn.log_sigmoid(-sneg))
    )
    n_pairs = jnp.sum(m)

    gpos = (jax.nn.sigmoid(spos) - 1.0) * mpos  # dL/dspos, [P]
    gneg = jax.nn.sigmoid(sneg) * mneg  # dL/dsneg, [P, K]

    d_phi = gpos[:, None] * cpos + sddmm_neg_scores_t(gneg, cneg)
    d_cpos = gpos[:, None] * phi
    d_cneg = gneg[..., None] * phi[:, None, :]
    return loss, n_pairs, (d_phi, d_cpos, d_cneg)


def sgns_loss_and_grads(
    emb_in: jnp.ndarray,
    emb_out: jnp.ndarray,
    centers: jnp.ndarray,
    contexts: jnp.ndarray,
    negatives: jnp.ndarray,
    mask: jnp.ndarray,
    max_exp: float | None = None,
):
    """Loss + per-row gradient contributions for one batch (full tables).

    Args:
      emb_in:  [V, d] input table (phi / node_emb).
      emb_out: [V, d] output table (ctx_emb for O1; node_emb for O2).
      centers, contexts: int32 [P]; negatives: int32 [P, K].
      mask: bool/float [P]; masked-out pairs contribute nothing.

    Returns (loss, n_pairs, (d_phi [P,d], d_cpos [P,d], d_cneg [P,K,d])),
    the d_* being dL/d(row) contributions to scatter-add at
    centers/contexts/negatives respectively.
    """
    phi = gather_rows(emb_in, centers)
    cpos = gather_rows(emb_out, contexts)
    cneg = gather_rows(emb_out, negatives)
    return sgns_grads_from_rows(phi, cpos, cneg, mask, max_exp)


def sddmm_neg_scores_t(gneg: jnp.ndarray, cneg: jnp.ndarray) -> jnp.ndarray:
    """[P,K] x [P,K,d] -> [P,d]: weighted sum of negative rows."""
    return jnp.einsum("pk,pkd->pd", gneg, cneg)


def sgns_sgd_step(
    emb_in: jnp.ndarray,
    emb_out: jnp.ndarray,
    centers: jnp.ndarray,
    contexts: jnp.ndarray,
    negatives: jnp.ndarray,
    mask: jnp.ndarray,
    lr: jnp.ndarray | float,
    tie_tables: bool = False,
    max_exp: float | None = None,
):
    """One synchronous minibatch SGD step: tables -= lr * dL/dtable.

    ``tie_tables=True`` is the O2 (first-order proximity) mode, where both
    endpoints and negatives live in the *same* table (reference
    ``ADSCModel/node_embeddings.py::Node2Vec.train`` [R], SURVEY.md C7); all
    updates are combined into a single scatter so duplicates sum exactly.

    Returns (emb_in', emb_out', loss, n_pairs); with tied tables both
    returned tables are the same array.
    """
    loss, n_pairs, (d_phi, d_cpos, d_cneg) = sgns_loss_and_grads(
        emb_in, emb_out, centers, contexts, negatives, mask, max_exp
    )
    P, K = negatives.shape
    d = emb_in.shape[1]
    neg_idx = negatives.reshape(P * K)
    d_cneg = d_cneg.reshape(P * K, d)

    if tie_tables:
        idx = jnp.concatenate([centers, contexts, neg_idx])
        upd = jnp.concatenate([d_phi, d_cpos, d_cneg]) * (-lr)
        new = scatter_add_rows(emb_in, idx, upd)
        return new, new, loss, n_pairs

    out_idx = jnp.concatenate([contexts, neg_idx])
    out_upd = jnp.concatenate([d_cpos, d_cneg]) * (-lr)
    new_in = scatter_add_rows(emb_in, centers, d_phi * (-lr))
    new_out = scatter_add_rows(emb_out, out_idx, out_upd)
    return new_in, new_out, loss, n_pairs
