"""Sparse embedding primitives: gather, SDDMM edge scores, scatter-add.

These three ops replace the reference's Cython hogwild inner loop
(``utils/training_sdg_inner.pyx::train_o1/train_o2`` [R], SURVEY.md C1,
§3.2): where the reference does per-pair ``sdot``/``saxpy`` with racy
lock-free writes, we batch the whole minibatch into dense [P, d] tensors —
gather rows, score every pair at once on the VPU, and apply updates with a
*deterministic* duplicate-safe scatter-add (segment-sum, SURVEY.md §2
"hogwild races -> deterministic scatter-add").

Two scatter strategies are provided; both are exact:
  * ``scatter_add_rows`` — XLA variable-length scatter-add (`.at[].add`).
  * ``scatter_add_rows_sorted`` — sort updates by row id and segment-sum
    duplicates first, so the final scatter touches each row once.  On
    power-law graphs the same hub row appears many times per batch
    (SURVEY.md §7 hard part 2); pre-combining turns serialized scatter
    collisions into a parallel sort+reduce.

Everything here is jit-friendly jnp and the numpy-oracle test target.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table [V, d], idx int32 [...] -> rows [..., d]."""
    return jnp.take(table, idx, axis=0)


def sddmm_pair_scores(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise dot products: a [P, d] x b [P, d] -> [P].

    The "sampled dense-dense matmul" restricted to the batch's (i, j) pairs —
    the reference's per-pair ``sdot`` (SURVEY.md §3.2 hot loop #3).
    """
    return jnp.sum(a * b, axis=-1)


def sddmm_neg_scores(a: jnp.ndarray, negs: jnp.ndarray) -> jnp.ndarray:
    """a [P, d] x negs [P, K, d] -> [P, K] scores against K negatives each."""
    return jnp.einsum("pd,pkd->pk", a, negs)


def scatter_add_rows(
    table: jnp.ndarray, idx: jnp.ndarray, updates: jnp.ndarray
) -> jnp.ndarray:
    """table [V, d] += updates [P, d] at rows idx [P] (duplicates sum)."""
    return table.at[idx].add(updates)


def scatter_add_rows_sorted(
    table: jnp.ndarray, idx: jnp.ndarray, updates: jnp.ndarray
) -> jnp.ndarray:
    """Duplicate-combining scatter-add: sort by row, segment-sum, scatter.

    Exactly equal to :func:`scatter_add_rows` (floating-point reassociation
    aside); preferred when ``idx`` has heavy duplication (hub nodes).
    """
    order = jnp.argsort(idx)
    sidx = idx[order]
    supd = updates[order]
    # segment boundaries: first occurrence of each run
    head = jnp.concatenate([jnp.ones(1, bool), sidx[1:] != sidx[:-1]])
    seg = jnp.cumsum(head) - 1  # run id per element
    n = idx.shape[0]
    summed = jax.ops.segment_sum(supd, seg, num_segments=n)
    # every element of a run shares sidx, so max == the run's row id;
    # untouched trailing segments come back as int min -> masked to row 0
    run_rows = jax.ops.segment_max(sidx, seg, num_segments=n)
    valid = run_rows >= 0
    run_rows = jnp.where(valid, run_rows, 0)
    summed = jnp.where(valid[:, None], summed, 0.0)
    return table.at[run_rows].add(summed)
