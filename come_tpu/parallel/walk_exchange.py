"""Row-sharded (model-parallel) banded walk tier.

Tables stay ROW-SHARDED over the 'model' axis (each device owns V/M rows),
and each banded block materializes only the rows it actually touches:

  1. ids     = the block's walk slots + its negative pool (per worker)
  2. uq      = sorted unique ids (static capacity = the id count — exact)
  3. gather  = bucketed all-to-all row exchange (parallel/exchange.py):
               owners answer requests, ~3*U*d/M bytes per device
  4. compute = the banded SGNS math (losses/sgns_banded.py) over the
               COMPACT [U, 2d] packed rows, walks/pools remapped to compact
               slots (searchsorted)
  5. scatter = delta rows ride the same buckets back to their owners, then
               partial deltas psum over 'data' once per macro step

Ids are param-independent, so steps 1–2 and the id half of step 3 are
HOISTED out of the training loop for every block at once
(``plan_walk_macro_steps`` → ``make_exchange_plans_batched``: one batched
all-to-all instead of one per block).  Each block's row gather reads the
tables as the previous block left them (no stale prefetch: on four
NVLink-joined H100s a one-block-ahead prefetch hid 0.9 ms of a 1.5 s
epoch, see PERF.md).

Bucket overflow (ids beyond an owner's static capacity) leaves those rows
zero and drops their delta — equivalent to skipping the affected pairs for
one block; with the trainer's id interleave
(exchange.interleave_permutation) and the default 2x slack this ~never
fires, and the served fraction is returned for monitoring.

Replaces: the reference's hogwild threads sharing one in-RAM table
(SURVEY.md §3.2) — here the "table" is the union of the mesh's row shards
and the "shared memory" is the all-to-all.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from come_tpu.parallel.exchange import make_exchange_plans_batched


def plan_walk_macro_steps(
    walks_all: jnp.ndarray,  # [S, B_w, L] this worker's walks (GLOBAL ids)
    sneg_all: jnp.ndarray,   # [S, ...]    negative pools (GLOBAL ids)
    rows_per: int,
    capacity_slack: float,
    axis: str = "model",
):
    """Hoisted exchange planning for S macro steps (ONE id all-to-all).

    Returns (plans, rwalks, rneg, served): ``plans`` has a leading S dim on
    every leaf (scan xs); ``rwalks``/``rneg`` are the walks/pools remapped
    to compact row slots; ``served`` [S] is the per-step fraction of real
    unique ids that fit their owner's bucket.
    """
    S = walks_all.shape[0]
    M = jax.lax.axis_size(axis)
    v_pad = rows_per * M
    ids = jnp.concatenate(
        [walks_all.reshape(S, -1), sneg_all.reshape(S, -1)], axis=1
    ).astype(jnp.int32)
    U = ids.shape[1]  # unique count can never exceed this — exact capacity
    # fill = v_pad sorts after every real id (uq stays sorted for the
    # searchsorted remap) and is out of range for every shard, so fill
    # entries are dropped from the exchange without consuming bucket slots
    uq = jax.vmap(lambda i: jnp.unique(i, size=U, fill_value=v_pad))(ids)
    cap = max(1, int(math.ceil(U / M * capacity_slack)))
    plans = make_exchange_plans_batched(uq, rows_per, cap, axis)
    rwalks = (
        jax.vmap(jnp.searchsorted)(uq, walks_all.reshape(S, -1))
        .reshape(walks_all.shape)
        .astype(jnp.int32)
    )
    rneg = (
        jax.vmap(jnp.searchsorted)(uq, sneg_all.reshape(S, -1))
        .reshape(sneg_all.shape)
        .astype(jnp.int32)
    )
    # served over REAL unique ids only: fill entries (uq == v_pad) belong to
    # owner M whose clamped bucket start can mark them "served" and inflate
    # the metric whenever the batch has many duplicate ids
    real = uq < v_pad
    served = jnp.sum(
        (plans.served & real).astype(jnp.float32), axis=1
    ) / jnp.maximum(jnp.sum(real.astype(jnp.float32), axis=1), 1.0)
    return plans, rwalks, rneg, served


def banded_walk_step_rowsharded(
    combo_shard: jnp.ndarray,  # [rows_per, 2d] packed node|ctx row shard
    walks: jnp.ndarray,        # [B_w, L] this worker's walks (GLOBAL ids)
    sneg: jnp.ndarray,         # [KP] or [G, KP] pools (GLOBAL ids)
    lr,
    negative_weight,
    key: jax.Array,
    *,
    window: int,
    walk_block: int = 1024,
    capacity_slack: float = 2.0,
    mxu_bf16: bool = True,
    reduced_window: bool = True,
    axis: str = "model",
    data_axis: str = "data",
):
    """One O1 macro step of the banded-XLA tier on row-sharded PACKED tables.

    Bucketed-a2a row exchange around the XLA banded formulation
    (losses/sgns_banded.py) over compact [U, 2d] row sets: the only
    per-step footprint beyond the shards is the block's own rows.  This is
    the tier that carries BASELINE config 5 (synthetic-10m, V >= 500k)
    under the mesh.  Call inside shard_map.

    Blocks of ``walk_block`` walks run sequentially, each against its own
    row of ``sneg`` when it is [G, KP] (a fresh pool per block: a pool
    shared by all G blocks takes all their gradient mass, see
    ``ComEConfig.banded_pool_mass``); every block's id
    exchange is hoisted and batched before the loop (see the module
    docstring).  Each block accumulates
    its delta LOCALLY (gathers read shard + own accumulated delta, the
    per-worker hogwild envelope); the accumulated delta psums over 'data'
    ONCE per macro step so the full-shard collective amortizes over all
    blocks.

    Returns (combo_shard', loss, n_pairs, served_fraction); loss/n_pairs
    are psum'd over BOTH mesh axes.
    """
    from come_tpu.losses.sgns_banded import banded_block_grads

    rows_per, dd = combo_shard.shape
    d = dd // 2
    B, L = walks.shape
    Bc = min(walk_block, B)
    G = -(-B // Bc)
    if G * Bc != B:
        walks = jnp.resize(walks, (G * Bc, L))  # wrap tail with real walks
    walks_g = walks.reshape(G, Bc, L).astype(jnp.int32)
    kw, _ = jax.random.split(key)
    if reduced_window:
        wrows = jax.random.randint(
            kw, (G, Bc, L), 1, window + 1, dtype=jnp.int32
        )
    else:
        wrows = jnp.full((G, Bc, L), window, jnp.int32)
    pool_g = sneg.astype(jnp.int32)
    if pool_g.ndim == 1:
        pool_g = jnp.broadcast_to(pool_g, (G,) + pool_g.shape)
    elif pool_g.shape[0] != G:
        raise ValueError(
            f"per-block pools: got {pool_g.shape[0]} for {G} blocks"
        )
    KP = pool_g.shape[1]
    lr = jnp.asarray(lr, jnp.float32)
    U = Bc * L + KP

    # hoisted id exchange for every block at once
    plans, rw, rp, served_g = plan_walk_macro_steps(
        walks_g, pool_g, rows_per, capacity_slack, axis
    )

    def compute(rows, rw_k, rp_k, wr):
        prow = jnp.take(rows, rw_k.reshape(-1), axis=0).reshape(
            Bc, L, 2 * d
        )
        phi = prow[:, :, :d]
        ctx = prow[:, :, d:]
        cneg = jnp.take(rows, rp_k, axis=0)[:, d:]
        loss, npairs, (d_phi, d_ctx, d_cneg) = banded_block_grads(
            phi, ctx, cneg, wr, negative_weight, mxu_bf16=mxu_bf16
        )
        # combine duplicate slots per COMPACT row, then route once
        upd = jnp.zeros((U, 2 * d), jnp.float32)
        upd = upd.at[rw_k.reshape(-1)].add(
            jnp.concatenate([d_phi, d_ctx], axis=-1).reshape(
                Bc * L, 2 * d
            )
        )
        upd = upd.at[rp_k].add(
            jnp.concatenate([jnp.zeros_like(d_cneg), d_cneg], axis=-1)
        )
        return upd, loss, npairs

    delta0 = jnp.zeros_like(combo_shard)
    rw_b = rw.reshape(G, Bc, L)

    def block(delta, xs_k):
        plan, rw_k, rp_k, wr = xs_k
        # blocks accumulate their delta LOCALLY: gathers read shard + own
        # accumulated delta (the per-worker hogwild envelope)
        rows = plan.gather(combo_shard + delta)
        upd, loss, npairs = compute(rows, rw_k, rp_k, wr)
        delta = plan.scatter_add(delta, upd * (-lr))
        return delta, (loss, npairs)

    delta, (losses, npairs) = jax.lax.scan(
        block, delta0, (plans, rw_b, rp, wrows)
    )

    combo = combo_shard + jax.lax.psum(delta, data_axis)
    loss = jax.lax.psum(jnp.sum(losses), (data_axis, axis))
    npair = jax.lax.psum(jnp.sum(npairs), (data_axis, axis))
    return combo, loss, npair, jnp.mean(served_g)
