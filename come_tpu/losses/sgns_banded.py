"""Walk-banded SGNS at XLA level — the O1 banded tier.

Every context of a walk position is another position of the SAME walk, so a
block of walks gathers its rows ONCE and scores all its window pairs as
banded batched matmuls over tables in device memory (XLA gather/scatter),
at any V (synthetic-10m, V >= 500k, included).

Per walk block of Bc walks (the synchronous update unit):

  gather   PHI[Bc,L,d] = node_emb[walks], CTX[Bc,L,d] = ctx_emb[walks]
           (2*Bc*L row gathers for ~Bc*L*(W+1) trained pairs — ~0.2 row
           ops per pair, vs 4 in the flat-pair path; the 10x row-traffic
           cut is why this beats the flat XLA path at any V)
  mask     M[Bc,L,L] from offsets + the reduced-window draw w ~ U{1..W}
  scores   S_pos = PHI @ CTX^T per walk (banded entries used)   [matmul]
           S_neg = PHI @ Cneg^T (shared pool, fresh rows per block) [matmul]
  grads    three more batched matmuls; per-center weight n_t keeps the
           noise work per trained pair identical to per-pair counting
  scatter  duplicate-combining sort+segment-sum scatter-add (hub rows
           repeat heavily in a block; pre-combining turns serialized
           scatter collisions into a parallel sort+reduce)

Replaces the reference's Cython hot loop (``utils/training_sdg_inner.pyx``
[R], SURVEY.md C1/§3.2); semantics per block: synchronous block update,
reduced-window U{1..W} marginal, shared-pool negatives with negative/KP
weighting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from come_tpu.ops.sparse import scatter_add_rows, scatter_add_rows_sorted


def banded_block_grads(
    phi: jnp.ndarray,
    ctx: jnp.ndarray,
    cneg: jnp.ndarray,
    wrow: jnp.ndarray,
    negative_weight,
    mxu_bf16: bool = False,
):
    """Banded SGNS math on pre-gathered rows (also the sharded path's core).

    Args:
      phi, ctx: [Bc, L, d] center/context rows of a walk block.
      cneg: [KP, d] shared negative pool rows — or [C, KP, d]: C FRESH
        pools, each serving Bc/C of the block's walks.  Sub-chunked
        pools bound the gradient mass any single pool row absorbs from
        one synchronous application (the stability knob — see the
        pool-divergence note in the step docstring) without shrinking
        the positive pass's block matmuls.
      wrow: int32 [Bc, L] per-center reduced-window draw in {1..W}.
      negative_weight: k / KP, keeps per-pair noise work calibrated.
      mxu_bf16: run the matmuls in bf16 (f32 accumulation).

    Returns (loss, n_pairs, (d_phi [Bc,L,d], d_ctx [Bc,L,d],
    d_cneg shaped like ``cneg``)).
    """
    Bc, L, d = phi.shape
    mt = jnp.bfloat16 if mxu_bf16 else jnp.float32
    phi_m = phi.astype(mt)
    ctx_m = ctx.astype(mt)
    cneg_m = cneg.astype(mt)

    off = (
        jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
        - jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)
    )  # off[l, m] = m - l
    m = ((off != 0) & (jnp.abs(off)[None] <= wrow[:, :, None])).astype(
        jnp.float32
    )  # [Bc, L, L]

    s = jax.lax.dot_general(
        phi_m, ctx_m,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [Bc, L, L]
    g = (jax.nn.sigmoid(s) - 1.0) * m
    loss_pos = -jnp.sum(m * jax.nn.log_sigmoid(s))
    n_t = jnp.sum(m, axis=2)  # [Bc, L] pairs per center

    negw = jnp.asarray(negative_weight, jnp.float32)
    if cneg.ndim == 3:
        # C fresh pools, each serving Bc/C walks (batched over C)
        C, KP, _ = cneg.shape
        if Bc % C:
            raise ValueError(
                f"walk block {Bc} not divisible by {C} pool chunks"
            )
        phi_c = phi_m.reshape(C, (Bc // C) * L, d)
        sneg = jax.lax.dot_general(
            phi_c, cneg_m,
            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # [C, (Bc/C)*L, KP]
        n_t_c = n_t.reshape(C, (Bc // C) * L)
        gneg = jax.nn.sigmoid(sneg) * (negw * n_t_c[..., None])
        loss_neg = -negw * jnp.sum(
            n_t_c[..., None] * jax.nn.log_sigmoid(-sneg)
        )
        gneg_m = gneg.astype(mt)
        d_phi_neg = jax.lax.dot_general(
            gneg_m, cneg_m,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        ).reshape(Bc, L, d)
        d_cneg = jax.lax.dot_general(
            gneg_m, phi_c,
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # [C, KP, d]
    else:
        sneg = jax.lax.dot_general(
            phi_m, cneg_m,
            dimension_numbers=(((2,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [Bc, L, KP]
        gneg = jax.nn.sigmoid(sneg) * (negw * n_t[:, :, None])
        loss_neg = -negw * jnp.sum(
            n_t[:, :, None] * jax.nn.log_sigmoid(-sneg)
        )
        gneg_m = gneg.astype(mt)
        d_phi_neg = jax.lax.dot_general(
            gneg_m, cneg_m,
            dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        d_cneg = jax.lax.dot_general(
            gneg_m.reshape(Bc * L, -1), phi_m.reshape(Bc * L, d),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [KP, d]

    g_m = g.astype(mt)
    d_phi = jax.lax.dot_general(
        g_m, ctx_m,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ) + d_phi_neg  # [Bc, L, d]
    d_ctx = jax.lax.dot_general(
        g_m, phi_m,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [Bc, L, d] (g^T per walk)
    return loss_pos + loss_neg, jnp.sum(n_t), (d_phi, d_ctx, d_cneg)


@functools.partial(
    jax.jit,
    static_argnames=(
        "window", "walk_block", "reduced_window", "mxu_bf16",
        "sorted_scatter",
    ),
)
def banded_walk_sgns_step_packed(
    combo: jnp.ndarray,
    walks: jnp.ndarray,
    shared_negs: jnp.ndarray,
    lr,
    negative_weight,
    key: jax.Array,
    window: int = 10,
    walk_block: int = 1024,
    reduced_window: bool = True,
    mxu_bf16: bool = True,
    sorted_scatter: bool = False,
):
    """One O1 macro step over a batch of walks, banded, PACKED tables in HBM.

    ``combo`` is [V, 2d]: node_emb in columns [:d], ctx_emb in [d:].  The
    packing matters because the row gather/scatter is row-rate bound:
    phi and ctx are always fetched at the SAME indices, so one [V, 2d]
    gather moves both tables for the row cost of one, halving the dominant
    cost of this tier.  Callers pack once per epoch (two [V, d] copies),
    not per step.

    Args:
      combo: [V, 2d] f32 packed tables (any V — this is the HBM tier).
      walks: int32 [B, L].  B is wrapped up to a multiple of ``walk_block``;
        blocks update sequentially (the synchronous unit).
      shared_negs: int32 [KP] pool ids, shared by all blocks; pool ROWS are
        re-gathered fresh per block and the pool gradient scatters per
        block (no staleness across blocks).
      lr, negative_weight: scalars (negative_weight = k / KP).
      key: PRNG key for the reduced-window draws.
      window: W; reduced windows drawn w ~ U{1..W} per center when
        ``reduced_window`` (gensim's `random % window` marginal), else the
        full window trains (the numpy-oracle test config).
      sorted_scatter: duplicate-combining sort+segment-sum scatter (for
        heavy-hub power-law batches); off by default.

    Returns (combo', loss, n_pairs).
    """
    B, L = walks.shape
    Bc = min(walk_block, B)
    G = -(-B // Bc)
    if G * Bc != B:
        walks = jnp.resize(walks, (G * Bc, L))  # wrap tail with real walks
    walks_g = walks.reshape(G, Bc, L).astype(jnp.int32)
    if reduced_window:
        wrows = jax.random.randint(
            key, (G, Bc, L), 1, window + 1, dtype=jnp.int32
        )
    else:
        wrows = jnp.full((G, Bc, L), window, jnp.int32)
    # pools: [KP] (one set of ids for every block — legacy), [G, KP]
    # (a FRESH pool per block), or [G, C, KP] (C fresh pools per block,
    # each serving Bc/C walks).  Fresh pools matter for stability at
    # scale: each trained pair adds ~k/KP of gradient mass to EVERY pool
    # row, so one pool serving a whole macro step concentrates
    # pairs_per_step*k/KP stale unit-gradients per row — measured
    # exponentially divergent at synthetic-10m (~2100 units/row at
    # KP=2048 diverges by step ~850; ~1050 diverges by ~900; ~520 is
    # stable through 2500 steps).  The [G, C, KP] form bounds
    # per-application mass WITHOUT shrinking the positive pass's block
    # matmuls.
    pool_g = shared_negs.astype(jnp.int32)
    if pool_g.ndim == 1:
        pool_g = jnp.broadcast_to(pool_g, (G,) + pool_g.shape)
    elif pool_g.shape[0] != G:
        raise ValueError(
            f"per-block pools: got {pool_g.shape[0]} for {G} blocks"
        )
    scatter = scatter_add_rows_sorted if sorted_scatter else scatter_add_rows
    lr = jnp.asarray(lr, jnp.float32)
    d = combo.shape[1] // 2

    def block(carry, xs):
        cmb = carry
        w, wr, pool = xs  # [Bc, L], [Bc, L], [KP] or [C, KP]
        flat = w.reshape(Bc * L)
        rows = jnp.take(cmb, flat, axis=0).reshape(Bc, L, 2 * d)
        phi = rows[:, :, :d]
        ctx = rows[:, :, d:]
        cneg = jnp.take(cmb, pool, axis=0)[..., d:]
        loss, npairs, (d_phi, d_ctx, d_cneg) = banded_block_grads(
            phi, ctx, cneg, wr, negative_weight, mxu_bf16=mxu_bf16
        )
        upd = jnp.concatenate([d_phi, d_ctx], axis=-1).reshape(
            Bc * L, 2 * d
        )
        cmb = scatter(cmb, flat, upd * (-lr))
        dneg2 = d_cneg.reshape(-1, d)
        pool_upd = jnp.concatenate(
            [jnp.zeros_like(dneg2), dneg2], axis=-1
        )
        cmb = scatter(cmb, pool.reshape(-1), pool_upd * (-lr))
        return cmb, (loss, npairs)

    combo, (losses, npairs) = jax.lax.scan(
        block, combo, (walks_g, wrows, pool_g)
    )
    return combo, jnp.sum(losses), jnp.sum(npairs)


def pack_tables(emb_in: jnp.ndarray, emb_out: jnp.ndarray) -> jnp.ndarray:
    """[V, d] x2 -> [V, 2d] (once per epoch; see step docstring)."""
    return jnp.concatenate([emb_in, emb_out], axis=1)


def unpack_tables(combo: jnp.ndarray):
    d = combo.shape[1] // 2
    return combo[:, :d], combo[:, d:]


def banded_walk_sgns_step(
    emb_in: jnp.ndarray,
    emb_out: jnp.ndarray,
    walks: jnp.ndarray,
    shared_negs: jnp.ndarray,
    lr,
    negative_weight,
    key: jax.Array,
    window: int = 10,
    walk_block: int = 1024,
    reduced_window: bool = True,
    mxu_bf16: bool = True,
    sorted_scatter: bool = False,
):
    """Unpacked-table convenience wrapper (tests / one-shot use).

    Trainers should pack once per EPOCH with :func:`pack_tables` and call
    the packed step per macro batch — packing here costs two [V, d] copies
    per call.
    """
    combo = pack_tables(emb_in, emb_out)
    combo, loss, npairs = banded_walk_sgns_step_packed(
        combo, walks, shared_negs, lr, negative_weight, key,
        window=window, walk_block=walk_block,
        reduced_window=reduced_window, mxu_bf16=mxu_bf16,
        sorted_scatter=sorted_scatter,
    )
    emb_in, emb_out = unpack_tables(combo)
    return emb_in, emb_out, loss, npairs
