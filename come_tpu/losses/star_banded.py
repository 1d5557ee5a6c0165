"""Star-SGNS at XLA level — the O2 (edge pass) banded tier.

Arcs grouped by source into hub/fan-out segments packed into 128-slot rows
(``sampling/stars.py``), scored as block-diagonal batched matmuls with a
metadata mask over the tied table in device memory (XLA gather/scatter).
The structural analog of the O1 banded tier (``losses/sgns_banded.py``)
for the reference's first-order edge objective (SURVEY.md C7/§3.3).

Per block of Br layout rows (the synchronous update unit):

  gather   PHI[Br,R,d] = node_emb[slots]   — ONE gather per slot (tied)
  mask     M[Br,R,R] from per-slot metadata: same segment AND exactly
           one endpoint is the hub (both arc directions of every edge)
  scores   S = PHI @ PHI^T per row (masked entries used)       [matmul]
  grads    source side (G @ PHI) + context side (G^T @ PHI) land on the
           same tied rows; shared-pool negatives weighted by the slot's
           source-pair count n_t (hub: fan-out, neighbor: 1)
  scatter  ONE scatter-add per slot; pool rows re-gathered fresh per
           block, pool gradient scattered per block (no staleness)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from come_tpu.ops.sparse import scatter_add_rows, scatter_add_rows_sorted


def star_block_grads(
    phi: jnp.ndarray,
    meta: jnp.ndarray,
    cneg: jnp.ndarray,
    negative_weight,
    mxu_bf16: bool = False,
):
    """Tied star-SGNS math on pre-gathered rows.

    Args:
      phi: [Br, R, d] staged rows of Br star-layout rows (R slots each).
      meta: int32 [Br, R] — seg_id*2 + is_hub per slot, -2 at pads
        (pads self-mask: pad-pad fails the hub xor, pad-real the seg
        match — ``sampling/stars.py`` invariants).
      cneg: [KP, d] shared negative pool rows.
      negative_weight: k / KP.

    Returns (loss, n_pairs, (d_phi [Br,R,d], d_cneg [KP,d])).
    """
    Br, R, d = phi.shape
    mt = jnp.bfloat16 if mxu_bf16 else jnp.float32
    phi_m = phi.astype(mt)
    cneg_m = cneg.astype(mt)

    seg = meta >> 1
    hub = meta & 1
    m = (
        (seg[:, :, None] == seg[:, None, :])
        & ((hub[:, :, None] ^ hub[:, None, :]) == 1)
    ).astype(jnp.float32)  # [Br, R, R]

    s = jax.lax.dot_general(
        phi_m, phi_m,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [Br, R, R]
    g = (jax.nn.sigmoid(s) - 1.0) * m
    loss_pos = -jnp.sum(m * jax.nn.log_sigmoid(s))
    n_t = jnp.sum(m, axis=2)  # [Br, R] source-pairs per slot

    sn = jax.lax.dot_general(
        phi_m, cneg_m,
        dimension_numbers=(((2,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [Br, R, KP]
    negw = jnp.asarray(negative_weight, jnp.float32)
    gn = jax.nn.sigmoid(sn) * (negw * n_t[:, :, None])
    loss_neg = -negw * jnp.sum(n_t[:, :, None] * jax.nn.log_sigmoid(-sn))

    g_m = g.astype(mt)
    gn_m = gn.astype(mt)
    # source side + context side (tied: both land on the same rows)
    d_phi = jax.lax.dot_general(
        g_m, phi_m,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ) + jax.lax.dot_general(
        g_m, phi_m,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ) + jax.lax.dot_general(
        gn_m, cneg_m,
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [Br, R, d]
    d_cneg = jax.lax.dot_general(
        gn_m.reshape(Br * R, -1), phi_m.reshape(Br * R, d),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [KP, d]
    return loss_pos + loss_neg, jnp.sum(n_t), (d_phi, d_cneg)


@functools.partial(
    jax.jit,
    static_argnames=("row_block", "mxu_bf16", "sorted_scatter"),
)
def star_banded_sgns_step(
    emb: jnp.ndarray,
    slots: jnp.ndarray,
    meta: jnp.ndarray,
    shared_negs: jnp.ndarray,
    lr,
    negative_weight,
    row_block: int = 512,
    mxu_bf16: bool = True,
    sorted_scatter: bool = False,
):
    """One O2 macro step over star-layout rows, tied HBM-resident table.

    Args:
      emb: [V, d] f32 tied node table (any V — this is the HBM tier).
      slots/meta: int32 [NR, R] star layout rows (pads meta==-2 are
        inert: zero mask, zero n_t, scatter adds exact zeros to row 0).
      shared_negs: int32 [KP] pool ids shared by all blocks, or [G, KP]
        with a FRESH pool per block (G = ceil(NR / row_block)); pool rows
        are re-gathered per block and their gradient scattered per block.
        Every trained pair adds ~negative_weight of gradient to EVERY pool
        row, so a pool's mass per block is the block's pair count times
        negative_weight (``ComEConfig.banded_pool_mass`` bounds it).
      row_block: layout rows per synchronous block.
      sorted_scatter: duplicate-combining sort+segment-sum scatter (for
        heavy-hub batches; off by default, as in the O1 banded tier).

    Returns (emb', loss, n_pairs).
    """
    NR, R = slots.shape
    Bc = min(row_block, NR)
    G = -(-NR // Bc)
    if G * Bc != NR:
        pad = G * Bc - NR
        slots = jnp.pad(slots, ((0, pad), (0, 0)))
        meta = jnp.pad(meta, ((0, pad), (0, 0)), constant_values=-2)
    slots_g = slots.reshape(G, Bc, R).astype(jnp.int32)
    meta_g = meta.reshape(G, Bc, R).astype(jnp.int32)
    pool_g = shared_negs.astype(jnp.int32)
    if pool_g.ndim == 1:
        pool_g = jnp.broadcast_to(pool_g, (G,) + pool_g.shape)
    elif pool_g.shape[0] != G:
        raise ValueError(
            f"per-block pools: got {pool_g.shape[0]} for {G} blocks"
        )
    scatter = scatter_add_rows_sorted if sorted_scatter else scatter_add_rows
    lr = jnp.asarray(lr, jnp.float32)

    def block(carry, xs):
        e = carry
        w, mt_, pool = xs  # [Bc, R], [Bc, R], [KP]
        flat = w.reshape(Bc * R)
        phi = jnp.take(e, flat, axis=0).reshape(Bc, R, -1)
        cneg = jnp.take(e, pool, axis=0)
        loss, npairs, (d_phi, d_cneg) = star_block_grads(
            phi, mt_, cneg, negative_weight, mxu_bf16=mxu_bf16
        )
        e = scatter(e, flat, d_phi.reshape(Bc * R, -1) * (-lr))
        e = scatter(e, pool, d_cneg * (-lr))
        return e, (loss, npairs)

    emb, (losses, npairs) = jax.lax.scan(
        block, emb, (slots_g, meta_g, pool_g)
    )
    return emb, jnp.sum(losses), jnp.sum(npairs)
