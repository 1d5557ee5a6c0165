"""Numpy gradient oracle for O1/O2/O3 — the parity harness's ground truth.

BASELINE.json:5 defines acceptance as "allclose on O1/O2/O3 gradients per
iteration".  The reference's hogwild trainer applies pair updates
sequentially and racily, so its trajectory is nondeterministic (SURVEY.md §7
hard part 1); the well-defined parity target is the *expected* (race-free)
gradient of a fixed batch computed from the same initial tables.  This
module computes that in plain numpy loops — deliberately scalar, mirroring
the reference's per-pair Cython arithmetic (``utils/training_sdg_inner.pyx``
[R]) — and the jnp paths must match it to float tolerance.

Semantic note (documented divergence, SURVEY.md §7): the hogwild kernel
applies each pair's update before scoring the next pair; synchronous
minibatch SGD scores every pair against the *initial* tables and sums
duplicate-row updates.  Both are SGD on the same objective; LR scaling is
matched per pair.  The oracle implements the synchronous semantics.
"""

from __future__ import annotations

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def sgns_batch_grads(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    centers: np.ndarray,
    contexts: np.ndarray,
    negatives: np.ndarray,
    mask: np.ndarray,
    max_exp: float | None = None,
):
    """Dense-table gradients dL/demb_in, dL/demb_out for one SGNS batch.

    Pure per-pair loops; returns full [V, d] gradient tables plus the loss.
    """
    d_in = np.zeros_like(emb_in)
    d_out = np.zeros_like(emb_out)
    loss = 0.0
    P = len(centers)
    K = negatives.shape[1]
    for p in range(P):
        if not mask[p]:
            continue
        i, j = int(centers[p]), int(contexts[p])
        phi = emb_in[i]
        # positive pair
        s = float(phi @ emb_out[j])
        if max_exp is None or abs(s) < max_exp:
            g = sigmoid(s) - 1.0  # dL/ds
            loss += -np.log(max(sigmoid(s), 1e-30))
            d_in[i] += g * emb_out[j]
            d_out[j] += g * phi
        # negatives
        for k in range(K):
            n = int(negatives[p, k])
            s = float(phi @ emb_out[n])
            if max_exp is not None and abs(s) >= max_exp:
                continue
            g = sigmoid(s)  # dL/ds for label 0
            loss += -np.log(max(1.0 - sigmoid(s), 1e-30))
            d_in[i] += g * emb_out[n]
            d_out[n] += g * phi
    return loss, d_in, d_out


def sgns_batch_grads_tied(
    emb: np.ndarray, centers, contexts, negatives, mask, max_exp=None
):
    """O2 mode: both sides in one table; gradients summed into one [V,d]."""
    loss, d_in, d_out = sgns_batch_grads(
        emb, emb, centers, contexts, negatives, mask, max_exp
    )
    return loss, d_in + d_out


def sgns_shared_pool_grads(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    centers: np.ndarray,
    contexts: np.ndarray,
    pool: np.ndarray,
    mask: np.ndarray,
    negative_weight: float,
):
    """Oracle for the SHARED-NEGATIVE-POOL fast path (losses/sgns_block.py):
    every valid pair scores all KP pool rows with
    weight ``negative_weight`` (= k / KP, keeping per-pair noise work
    calibrated to the reference's k per-pair draws,
    ``utils/training_sdg_inner.pyx`` [R]).

    Per-pair scalar loops; returns (loss, d_in [V,d], d_out [V,d]).
    """
    d_in = np.zeros_like(emb_in)
    d_out = np.zeros_like(emb_out)
    loss = 0.0
    for p in range(len(centers)):
        if not mask[p]:
            continue
        i, j = int(centers[p]), int(contexts[p])
        phi = emb_in[i]
        s = float(phi @ emb_out[j])
        g = sigmoid(s) - 1.0
        loss += -np.log(max(sigmoid(s), 1e-30))
        d_in[i] += g * emb_out[j]
        d_out[j] += g * phi
        for n in pool:
            n = int(n)
            s = float(phi @ emb_out[n])
            g = sigmoid(s) * negative_weight
            loss += -negative_weight * np.log(max(1.0 - sigmoid(s), 1e-30))
            d_in[i] += g * emb_out[n]
            d_out[n] += g * phi
    return loss, d_in, d_out


def walk_banded_shared_pool_grads(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    walks: np.ndarray,
    pool: np.ndarray,
    wrow: np.ndarray,
    negative_weight: float,
):
    """Oracle for ONE synchronous block of the walk-banded fast path
    (losses/sgns_banded.py): every in-window
    in-walk context of every center is a positive pair (center t trains
    contexts u with 0 < |u-t| <= wrow[t], the reference's reduced-window
    enumeration), and each center with ``n_t`` trained pairs scores all KP
    shared pool rows with weight ``negative_weight * n_t``.

    All gradients are with respect to the tables AS OF block start (the
    block-synchronous semantics); multi-block steps apply blocks
    sequentially — see :func:`walk_banded_sequential`.

    Args:
      walks: int [B, L] node ids.  wrow: int [B, L] per-center window draws.
    Returns (loss, n_pairs, d_in [V,d], d_out [V,d]).
    """
    d_in = np.zeros_like(emb_in)
    d_out = np.zeros_like(emb_out)
    loss = 0.0
    npairs = 0
    B, L = walks.shape
    for b in range(B):
        for t in range(L):
            i = int(walks[b, t])
            w = int(wrow[b, t])
            phi = emb_in[i]
            n_t = 0
            for u in range(max(0, t - w), min(L, t + w + 1)):
                if u == t:
                    continue
                j = int(walks[b, u])
                s = float(phi @ emb_out[j])
                g = sigmoid(s) - 1.0
                loss += -np.log(max(sigmoid(s), 1e-30))
                d_in[i] += g * emb_out[j]
                d_out[j] += g * phi
                n_t += 1
            npairs += n_t
            for n in pool:
                n = int(n)
                s = float(phi @ emb_out[n])
                g = sigmoid(s) * negative_weight * n_t
                loss += (
                    -negative_weight * n_t
                    * np.log(max(1.0 - sigmoid(s), 1e-30))
                )
                d_in[i] += g * emb_out[n]
                d_out[n] += g * phi
    return loss, npairs, d_in, d_out


def walk_banded_sequential(
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    walks: np.ndarray,
    pools: np.ndarray,
    wrow: np.ndarray,
    negative_weight: float,
    lr: float,
    walks_per_block: int,
):
    """Oracle for a MULTI-BLOCK banded step (losses/sgns_banded.py): the
    exact sequential composition of the single-block semantics of
    :func:`walk_banded_shared_pool_grads`.

    Per block of ``walks_per_block`` walks:
      * the block's positive and pool gradients are computed against the
        tables as of block start (walk rows and its negative pool's rows);
      * the walk-row updates apply synchronously (duplicates sum), then the
        pool gradient applies (read-modify-write, so walk updates to pool
        rows within the block are preserved).

    Args:
      walks: int [B, L] with B a multiple of walks_per_block.
      pools: int [n_blocks, KP] (a fresh pool per block) or [KP] (the same
        pool ids for every block, rows still re-read per block).
      wrow:  int [B, L] per-center window draws.
    Returns (emb_in', emb_out', loss, n_pairs).
    """
    ei = emb_in.astype(np.float32).copy()
    eo = emb_out.astype(np.float32).copy()
    B, L = walks.shape
    nw = walks_per_block
    G = B // nw
    pools = np.asarray(pools, np.int64)
    if pools.ndim == 1:
        pools = np.broadcast_to(pools, (G,) + pools.shape)
    loss = 0.0
    npairs = 0
    for g in range(G):
        pool = pools[g]
        staged = eo[pool].copy()  # pool rows as of block start
        dneg = np.zeros_like(staged)
        w = walks[g * nw:(g + 1) * nw]
        wr = wrow[g * nw:(g + 1) * nw]
        d_in = np.zeros_like(ei)
        d_out = np.zeros_like(eo)
        for b in range(nw):
            for t in range(L):
                i = int(w[b, t])
                ww = int(wr[b, t])
                phi = ei[i]
                n_t = 0
                for u in range(max(0, t - ww), min(L, t + ww + 1)):
                    if u == t:
                        continue
                    j = int(w[b, u])
                    s = float(phi @ eo[j])
                    gr = sigmoid(s) - 1.0
                    loss += -np.log(max(sigmoid(s), 1e-30))
                    d_in[i] += gr * eo[j]
                    d_out[j] += gr * phi
                    n_t += 1
                npairs += n_t
                for k in range(len(pool)):
                    s = float(phi @ staged[k])
                    gr = sigmoid(s) * negative_weight * n_t
                    loss += (
                        -negative_weight * n_t
                        * np.log(max(1.0 - sigmoid(s), 1e-30))
                    )
                    d_in[i] += gr * staged[k]
                    dneg[k] += gr * phi
        ei -= lr * d_in
        eo -= lr * d_out
        for k in range(len(pool)):  # pool gradient last (RMW)
            eo[pool[k]] -= lr * dneg[k]
    return ei, eo, loss, npairs


def community_grads(
    node_emb: np.ndarray,
    pi: np.ndarray,
    centroid: np.ndarray,
    inv_cov: np.ndarray,
    beta: float,
):
    """O3 gradient per node: beta/K * sum_k pi_ik Sigma_k^-1 (phi_i - psi_k).

    Mirrors the reference's chunked numpy loop (SURVEY.md §3.4 hot loop #4).
    """
    N, d = node_emb.shape
    K = centroid.shape[0]
    g = np.zeros_like(node_emb)
    for i in range(N):
        acc = np.zeros(d)
        for k in range(K):
            acc += pi[i, k] * inv_cov[k] @ (node_emb[i] - centroid[k])
        g[i] = (beta / K) * acc
    return g


def gmm_log_likelihood(X, means, covs, weights):
    """Mean per-sample GMM log-likelihood (for EM quality comparison)."""
    from scipy.stats import multivariate_normal

    N, K = X.shape[0], means.shape[0]
    lp = np.zeros((N, K))
    for k in range(K):
        lp[:, k] = multivariate_normal.logpdf(X, means[k], covs[k]) + np.log(
            weights[k]
        )
    m = lp.max(axis=1)
    return float(np.mean(m + np.log(np.exp(lp - m[:, None]).sum(axis=1))))


def star_banded_sequential(
    emb: np.ndarray,
    slots: np.ndarray,
    meta: np.ndarray,
    pool: np.ndarray,
    negative_weight: float,
    lr: float,
    block_rows: int,
) -> tuple[np.ndarray, float, float]:
    """Numpy oracle of the banded star O2 step (``losses/star_banded.py``).

    ``slots``/``meta`` are [NR, R] layout rows; blocks of ``block_rows``
    rows run sequentially.  Each block's gradients are computed from the
    TIED table state at block start and applied per slot (duplicates
    sum); the shared pool's rows are read at block start and its gradient
    applies at the block end.  ``pool`` is [KP] (one pool for every
    block) or [G, KP] (block g draws its negatives from ``pool[g]``).  The mask pairs hub<->neighbor slots of each
    row-local segment (``sampling/stars.py`` metadata encoding; pads
    self-mask).

    Returns (emb', total_loss, total_pairs).
    """
    emb = emb.astype(np.float32).copy()
    slots = np.asarray(slots, np.int64)
    meta = np.asarray(meta, np.int64)
    NR, R = slots.shape
    pools = np.asarray(pool, np.int64)
    total_loss = 0.0
    total_pairs = 0.0
    for g, r0 in enumerate(range(0, NR, block_rows)):
        pool = pools if pools.ndim == 1 else pools[g]
        sl = slots[r0 : r0 + block_rows]  # [Br, R]
        mt = meta[r0 : r0 + block_rows]
        cneg0 = emb[pool].copy()
        phi = emb[sl]  # [Br, R, d], block-start rows
        seg = mt >> 1
        hub = mt & 1
        m = (
            (seg[:, :, None] == seg[:, None, :])
            & ((hub[:, :, None] ^ hub[:, None, :]) == 1)
        ).astype(np.float32)  # [Br, R, R]
        s = np.einsum("brd,bsd->brs", phi, phi)
        sg = 1.0 / (1.0 + np.exp(-s))
        gpos = (sg - 1.0) * m
        total_loss += -float(np.sum(m * np.log(np.maximum(sg, 1e-30))))
        n_t = m.sum(2)[..., None]  # [Br, R, 1] source-pairs per slot
        total_pairs += float(n_t.sum())
        # tied: source side + context side land on the same rows
        dphi = np.einsum("brs,bsd->brd", gpos, phi)
        dphi += np.einsum("bsr,bsd->brd", gpos, phi)
        sn = phi @ cneg0.T  # [Br, R, KP]
        sgn = 1.0 / (1.0 + np.exp(-sn))
        gneg = sgn * (negative_weight * n_t)
        total_loss += -negative_weight * float(
            np.sum(n_t * np.log(np.maximum(1.0 - sgn, 1e-30)))
        )
        dphi += gneg @ cneg0
        np.add.at(emb, sl.reshape(-1), -lr * dphi.reshape(-1, emb.shape[1]))
        dneg = np.einsum("brk,brd->kd", gneg, phi)
        np.add.at(emb, pool, -lr * dneg)
    return emb, total_loss, total_pairs
