"""Bucketed all-to-all row exchange for row-sharded embedding tables.

The baseline exchange (``sharded.psum_gather``) is a masked local gather +
psum: every device receives the full [B, d] block regardless of mesh size,
so per-device traffic is ~2*B*d and each model shard duplicates the batch's
compute.  This module is the scalable form BASELINE.json:5 calls for
("boundary-row exchange all-to-all"):

  * the pair batch is ALSO sliced over 'model' (each of the D*M devices
    works B/(D*M) pairs — model shards stop duplicating compute),
  * each device sorts its row ids by owning shard, sends the requests with
    one all-to-all, owners gather locally, and a second all-to-all returns
    the rows: per-device traffic ~3*B*d/M (ids are noise),
  * gradient rows ride the same buckets back to their owners
    (``scatter_add``), which then psum partial deltas over 'data' only.

Buckets have a STATIC capacity C (XLA needs static shapes): ids beyond an
owner's C slots in one micro-step are left unserved, reported via the plan's
``served`` mask so the caller drops those pairs from that micro-step (a
stochastic skip, like reduced-window subsampling — monitorable, and ~never
firing at the default slack because the trainer interleave-relabels node ids
so contiguous shards own decorrelated id sets).  Setting
``capacity = B`` makes the exchange exact (tests).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class RowExchangePlan:
    """Bucketed routing for one set of row ids (traced values).

    Registered as a pytree (array fields = leaves) so plans can be built in
    a batch (`make_exchange_plans_batched`) and fed through ``lax.scan`` as
    per-step xs — the hoist that takes the id exchange out of the hot loop.
    """

    order: jnp.ndarray   # [B] argsort of owner
    sowner: jnp.ndarray  # [B] owner of each sorted id
    pos: jnp.ndarray     # [B] slot within the owner's bucket
    ok: jnp.ndarray      # [B] bool, pos < capacity (sorted order)
    served: jnp.ndarray  # [B] bool, in ORIGINAL order
    got: jnp.ndarray     # [M, C] ids this shard must serve (or -1)
    rows_per: int
    capacity: int
    axis: str

    def gather(self, table_shard: jnp.ndarray) -> jnp.ndarray:
        """Fetch rows for the planned ids: [B, d]; unserved rows are 0."""
        my = jax.lax.axis_index(self.axis)
        lidx = self.got - my * self.rows_per
        valid = self.got >= 0
        safe = jnp.clip(lidx, 0, self.rows_per - 1)
        rows = jnp.where(
            valid[..., None], table_shard[safe], 0.0
        )  # [M, C, d]
        rep = jax.lax.all_to_all(
            rows, self.axis, split_axis=0, concat_axis=0, tiled=True
        )  # [M, C, d]: rep[m, c] answers my request (m, c)
        posc = jnp.clip(self.pos, 0, self.capacity - 1)
        mine = jnp.where(
            self.ok[:, None], rep[self.sowner, posc], 0.0
        )  # sorted order
        out = jnp.zeros_like(mine).at[self.order].set(mine)
        return out

    def scatter_add(
        self, delta_shard: jnp.ndarray, upd: jnp.ndarray
    ) -> jnp.ndarray:
        """Route update rows [B, d] back to their owners and add into the
        local [rows_per, d] delta.  Unserved entries are dropped (their
        pairs were masked out of the gradients)."""
        supd = upd[self.order]
        supd = jnp.where(self.ok[:, None], supd, 0.0)
        M, C = self.got.shape
        buf = jnp.zeros((M, C, upd.shape[-1]), upd.dtype)
        buf = buf.at[self.sowner, self.pos].set(supd, mode="drop")
        contrib = jax.lax.all_to_all(
            buf, self.axis, split_axis=0, concat_axis=0, tiled=True
        )  # [M, C, d] updates for rows I own, keyed by self.got
        my = jax.lax.axis_index(self.axis)
        lidx = self.got - my * self.rows_per
        valid = self.got >= 0
        safe = jnp.where(valid, lidx, 0)
        contrib = jnp.where(valid[..., None], contrib, 0.0)
        return delta_shard.at[safe.reshape(-1)].add(
            contrib.reshape(M * C, -1)
        )


jax.tree_util.register_dataclass(
    RowExchangePlan,
    data_fields=["order", "sowner", "pos", "ok", "served", "got"],
    meta_fields=["rows_per", "capacity", "axis"],
)


def make_exchange_plan(
    idx: jnp.ndarray,
    rows_per: int,
    capacity: int,
    axis: str = "model",
) -> RowExchangePlan:
    """Plan one bucketed exchange for local row ids ``idx`` [B].

    ``capacity``: slots per owner bucket (static).  Choose
    ``ceil(B / M * slack)`` (slack ~2 with interleaved ids), or ``B`` for
    an exact exchange.
    """
    idx = idx.astype(jnp.int32)
    B = idx.shape[0]
    M = jax.lax.axis_size(axis)
    owner = idx // rows_per
    order = jnp.argsort(owner, stable=True)
    sowner = owner[order]
    sidx = idx[order]
    start = jnp.searchsorted(sowner, jnp.arange(M, dtype=sowner.dtype))
    pos = jnp.arange(B, dtype=jnp.int32) - start[sowner].astype(jnp.int32)
    ok = pos < capacity
    req = jnp.full((M, capacity), -1, jnp.int32)
    req = req.at[sowner, pos].set(sidx, mode="drop")  # OOB slots dropped
    got = jax.lax.all_to_all(
        req, axis, split_axis=0, concat_axis=0, tiled=True
    )
    served = jnp.zeros((B,), bool).at[order].set(ok)
    return RowExchangePlan(
        order=order, sowner=sowner, pos=pos, ok=ok, served=served,
        got=got, rows_per=rows_per, capacity=capacity, axis=axis,
    )


def make_exchange_plans_batched(
    idx: jnp.ndarray,
    rows_per: int,
    capacity: int,
    axis: str = "model",
) -> RowExchangePlan:
    """Plan G bucketed exchanges with ONE all-to-all.

    ``idx`` is int [G, B]: G independent id sets (e.g. one per scan
    step/block).  Ids are param-independent, so every step's id exchange can
    be hoisted out of the training loop and batched — the returned plan has
    a leading G dim on every array leaf and slices per step through
    ``lax.scan`` xs (RowExchangePlan is a registered pytree).
    """
    idx = idx.astype(jnp.int32)
    G, B = idx.shape
    M = jax.lax.axis_size(axis)
    owner = idx // rows_per
    order = jnp.argsort(owner, axis=1, stable=True)
    sowner = jnp.take_along_axis(owner, order, axis=1)
    sidx = jnp.take_along_axis(idx, order, axis=1)
    shards = jnp.arange(M, dtype=sowner.dtype)
    start = jax.vmap(lambda so: jnp.searchsorted(so, shards))(sowner)
    pos = jnp.arange(B, dtype=jnp.int32)[None, :] - jnp.take_along_axis(
        start, sowner, axis=1
    ).astype(jnp.int32)
    ok = pos < capacity
    gix = jnp.arange(G, dtype=jnp.int32)[:, None]
    req = jnp.full((G, M, capacity), -1, jnp.int32)
    req = req.at[gix, sowner, pos].set(sidx, mode="drop")
    got = jax.lax.all_to_all(
        req, axis, split_axis=1, concat_axis=1, tiled=True
    )
    served = jnp.zeros((G, B), bool).at[gix, order].set(ok)
    return RowExchangePlan(
        order=order, sowner=sowner, pos=pos, ok=ok, served=served,
        got=got, rows_per=rows_per, capacity=capacity, axis=axis,
    )


def interleave_permutation(num_nodes: int, num_shards: int):
    """Node relabeling that decorrelates contiguous row shards.

    Returns int32 ``perm`` with ``perm[old_id] = new_id``: ids are reordered
    by ``old_id % num_shards``, so each contiguous shard of the relabeled
    table owns an id set striped across the original ordering.  Community-
    sorted inputs (SBM generators, .mat files grouped by label) otherwise
    make a walk's rows land on ONE shard and overflow its bucket.
    """
    import numpy as np

    old = np.arange(num_nodes)
    order = np.argsort(old % num_shards, kind="stable")  # new -> old
    perm = np.empty(num_nodes, np.int32)
    perm[order] = old.astype(np.int32)
    return perm
