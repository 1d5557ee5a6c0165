"""Sharded ComE training: data-parallel batches x row-sharded tables.

This is the runtime the reference never had (SURVEY.md §2 parallelism table):
hogwild shared-memory threads become a ``shard_map`` over a
('data','model') mesh, with XLA collectives doing the row exchange
BASELINE.json:5 calls for.

Per SGD micro-step on device (i_d, i_m):
  gather   - each model shard contributes its owned rows for the batch's
             indices (masked local gather), combined by psum over 'model' —
             the boundary-row exchange.
  compute  - SGNS math on the data shard's pairs (losses.sgns core).
  scatter  - updates are scatter-added into a local [V/M, d] delta for rows
             this model shard owns, then psum'd over 'data' so the
             data-replicas of every table shard stay bit-identical.

Semantics match the single-device trainer exactly (same sum-of-duplicates
updates, same micro-batch boundaries) when the global ``batch_pairs`` is
equal — asserted by tests/test_parallel.py on a virtual 8-device CPU mesh.

O3 is embarrassingly row-parallel: pi and node_emb are sharded identically
and centroid/inv_cov are replicated, so the community step needs zero
communication.  The GMM E-step is sharded the same way; M-step moments are
psum'd (distributed EM).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from come_tpu.config import ComEConfig
from come_tpu.graphs.csr import CSRGraph
from come_tpu.losses.community import community_loss, community_sgd_step
from come_tpu.losses.sgns import sgns_grads_from_rows
from come_tpu.models import ComEParams
from come_tpu.parallel.mesh import MeshLayout
from come_tpu.sampling import random_walks, sample_alias, skipgram_pairs
from come_tpu.trainer.come import ComETrainer, TrainState, _decayed_lr


# --------------------------------------------------------------------------
# collective sparse primitives (called inside shard_map)
# --------------------------------------------------------------------------

def psum_gather(table_shard: jnp.ndarray, idx: jnp.ndarray, axis: str = "model"):
    """Gather global rows from a row-sharded table: masked local gather +
    psum over the model axis (the boundary-row exchange)."""
    rows_per = table_shard.shape[0]
    my = jax.lax.axis_index(axis)
    local = idx - my * rows_per
    ok = (local >= 0) & (local < rows_per)
    safe = jnp.clip(local, 0, rows_per - 1)
    rows = jnp.where(ok[..., None], table_shard[safe], 0.0)
    return jax.lax.psum(rows, axis)


def owned_scatter_add(delta_shard, idx, upd, axis: str = "model"):
    """Scatter-add updates for rows owned by this model shard into the local
    delta; other shards' rows are dropped (their owners handle them)."""
    rows_per = delta_shard.shape[0]
    my = jax.lax.axis_index(axis)
    local = idx - my * rows_per
    ok = (local >= 0) & (local < rows_per)
    safe = jnp.where(ok, local, 0)
    upd = jnp.where(ok[..., None], upd, 0.0)
    return delta_shard.at[safe].add(upd)


# --------------------------------------------------------------------------
# sharded trainer
# --------------------------------------------------------------------------

class ShardedComETrainer(ComETrainer):
    """ComE trainer over a ('data','model') mesh.

    Pads V to a multiple of the model axis (dummy rows receive no walks, no
    negative-sampling mass, and hence no updates).  Degenerates to the base
    trainer's semantics at mesh (1, 1).
    """

    def __init__(
        self,
        graph: CSRGraph,
        config: ComEConfig,
        mesh,
        key: jax.Array | None = None,
    ):
        self.layout = MeshLayout(mesh)
        m = self.layout.model_size
        self.v_real = graph.num_nodes
        self.v_pad = math.ceil(graph.num_nodes / m) * m
        self._perm = None  # old node id -> trained row (a2a interleave)
        # resolved exchange: "auto" (the default) means the bucketed a2a
        # whenever the mesh actually has a model axis — BASELINE.json:5's
        # all-to-all boundary-row exchange is what a (D, M>1) user gets
        # with no flags; "psum" remains the explicit debug/fallback
        self.row_exchange = (
            "a2a"
            if config.row_exchange in ("auto", "a2a") and m > 1
            else "psum"
        )
        self._orig_graph = graph  # pre-permutation (for clone diagnostics)
        if self.row_exchange == "a2a":
            from come_tpu.parallel.exchange import interleave_permutation

            # community-sorted inputs cluster a walk's rows on one shard;
            # striping ids across shards keeps the a2a buckets balanced
            self._perm = interleave_permutation(graph.num_nodes, m)
            graph = graph.permute(self._perm)
        super().__init__(graph, config, key)
        # re-init state padded + sharded
        if self.v_pad != self.v_real:
            p = self.state.params
            pad = self.v_pad - self.v_real
            p = p.replace(
                node_emb=jnp.pad(p.node_emb, ((0, pad), (0, 0))),
                ctx_emb=jnp.pad(p.ctx_emb, ((0, pad), (0, 0))),
                pi=jnp.pad(p.pi, ((0, pad), (0, 0))),
            )
            self.state = self.state.replace(params=p)
        self._shard_state()
        self._make_jits()  # replace the base class's unsharded jits

    # ---------------------------------------------------------------- setup

    def _shard_state(self):
        lay = self.layout
        specs = lay.params_specs()
        p = self.state.params
        p = ComEParams(
            node_emb=lay.shard(p.node_emb, specs.node_emb),
            ctx_emb=lay.shard(p.ctx_emb, specs.ctx_emb),
            centroid=lay.shard(p.centroid, specs.centroid),
            chol_cov=lay.shard(p.chol_cov, specs.chol_cov),
            inv_cov=lay.shard(p.inv_cov, specs.inv_cov),
            pi=lay.shard(p.pi, specs.pi),
        )
        # the scalars too: left unplaced, they come back from the first
        # epoch with the mesh's replicated sharding, and the second epoch
        # would compile the whole program again
        key_data = lay.shard(jax.random.key_data(self.state.key), P())
        self.state = TrainState(
            params=p,
            key=jax.random.wrap_key_data(key_data),
            words_seen=lay.shard(self.state.words_seen, P()),
        )

    def _state_specs(self) -> TrainState:
        lay = self.layout
        return TrainState(
            params=lay.params_specs(),
            key=P(),
            words_seen=P(),
        )

    # ------------------------------------------------------- sharded kernels

    def _sgns_microbatched_sharded(
        self, node_emb, ctx_emb, c, x, negs, m, lr, key, tie_tables
    ):
        """Inside shard_map: c/x/negs/m are the LOCAL (data-shard) slices;
        node_emb/ctx_emb are the LOCAL (model-shard) table slices."""
        cfg = self.cfg
        D = self.layout.data_size
        P_local = c.size
        K = cfg.negative
        mb = max(1, min(cfg.batch_pairs // D, P_local))
        n_micro = math.ceil(P_local / mb)
        pad = n_micro * mb - P_local
        one = jnp.float32(1.0)

        c2 = jnp.pad(c.reshape(P_local), (0, pad)).reshape(n_micro, mb)
        x2 = jnp.pad(x.reshape(P_local), (0, pad)).reshape(n_micro, mb)
        m2 = jnp.pad(
            m.reshape(P_local).astype(jnp.float32), (0, pad)
        ).reshape(n_micro, mb)

        dim = node_emb.shape[1]

        if cfg.negative_mode == "shared":
            if self.row_exchange == "a2a" and self.layout.model_size > 1:
                M = self.layout.model_size
                if mb % M:  # model-sliced micro-batches: pad mb up to M
                    extra = M - mb % M
                    c2 = jnp.pad(c2, ((0, 0), (0, extra)))
                    x2 = jnp.pad(x2, ((0, 0), (0, extra)))
                    m2 = jnp.pad(m2, ((0, 0), (0, extra)))
                return self._shared_micro_scan_a2a(
                    node_emb, ctx_emb, c2, x2, m2, key, lr, tie_tables
                )
            return self._shared_micro_scan(
                node_emb, ctx_emb, c2, x2, m2, key, lr, tie_tables
            )

        n2 = jnp.pad(negs.reshape(P_local, K), ((0, pad), (0, 0))).reshape(
            n_micro, mb, K
        )

        def micro(carry, xs):
            emb_in, emb_out = carry
            mc, mx, mn, mm = xs
            phi = psum_gather(emb_in, mc)
            cpos = psum_gather(emb_out, mx)
            cneg = psum_gather(emb_out, mn)
            loss, npairs, (d_phi, d_cpos, d_cneg) = sgns_grads_from_rows(
                phi, cpos, cneg, mm, cfg.max_exp
            )
            mnf = mn.reshape(mb * K)
            d_cneg = d_cneg.reshape(mb * K, dim)
            if tie_tables:
                delta = jnp.zeros_like(emb_in)
                delta = owned_scatter_add(delta, mc, d_phi * (-lr))
                delta = owned_scatter_add(delta, mx, d_cpos * (-lr))
                delta = owned_scatter_add(delta, mnf, d_cneg * (-lr))
                delta = jax.lax.psum(delta, "data")
                emb_in = emb_in + delta
                emb_out = emb_in
            else:
                din = owned_scatter_add(
                    jnp.zeros_like(emb_in), mc, d_phi * (-lr)
                )
                dout = jnp.zeros_like(emb_out)
                dout = owned_scatter_add(dout, mx, d_cpos * (-lr))
                dout = owned_scatter_add(dout, mnf, d_cneg * (-lr))
                din = jax.lax.psum(din, "data")
                dout = jax.lax.psum(dout, "data")
                emb_in = emb_in + din
                emb_out = emb_out + dout
            return (emb_in, emb_out), (loss, npairs)

        (node_emb, ctx_emb), (losses, npairs) = jax.lax.scan(
            micro, (node_emb, ctx_emb), (c2, x2, n2, m2)
        )
        loss = jax.lax.psum(jnp.sum(losses), "data")
        npair = jax.lax.psum(jnp.sum(npairs), "data")
        return node_emb, ctx_emb, loss, npair, one

    def _shared_micro_scan(
        self, node_emb, ctx_emb, c2, x2, m2, key, lr, tie_tables
    ):
        """Shared-negative (matmul) micro-steps inside shard_map: pool rows are
        psum-gathered over 'model', scored as dense matmuls, and the pool
        gradient scatters back through the row owners like any update."""
        from come_tpu.losses.sgns_block import sgns_block_grads_from_rows

        cfg = self.cfg
        KP = cfg.shared_negatives
        nw = cfg.negative / KP
        n_micro = c2.shape[0]
        # per-data-shard pools, fresh per micro-step
        dkey = jax.random.fold_in(key, jax.lax.axis_index("data"))
        keys = jax.random.split(dkey, n_micro)

        def micro(carry, xs):
            emb_in, emb_out = carry
            mc, mx, mm, k = xs
            pool = sample_alias(self.accept, self.alias, k, (KP,))
            phi = psum_gather(emb_in, mc)
            cpos = psum_gather(emb_out, mx)
            cneg = psum_gather(emb_out, pool)
            loss, npairs, (d_phi, d_cpos, d_cneg) = (
                sgns_block_grads_from_rows(phi, cpos, cneg, mm, nw)
            )
            if tie_tables:
                delta = jnp.zeros_like(emb_in)
                delta = owned_scatter_add(delta, mc, d_phi * (-lr))
                delta = owned_scatter_add(delta, mx, d_cpos * (-lr))
                delta = owned_scatter_add(delta, pool, d_cneg * (-lr))
                delta = jax.lax.psum(delta, "data")
                emb_in = emb_in + delta
                emb_out = emb_in
            else:
                din = owned_scatter_add(
                    jnp.zeros_like(emb_in), mc, d_phi * (-lr)
                )
                dout = jnp.zeros_like(emb_out)
                dout = owned_scatter_add(dout, mx, d_cpos * (-lr))
                dout = owned_scatter_add(dout, pool, d_cneg * (-lr))
                emb_in = emb_in + jax.lax.psum(din, "data")
                emb_out = emb_out + jax.lax.psum(dout, "data")
            return (emb_in, emb_out), (loss, npairs)

        (node_emb, ctx_emb), (losses, npairs) = jax.lax.scan(
            micro, (node_emb, ctx_emb), (c2, x2, m2, keys)
        )
        loss = jax.lax.psum(jnp.sum(losses), "data")
        npair = jax.lax.psum(jnp.sum(npairs), "data")
        return node_emb, ctx_emb, loss, npair, jnp.float32(1.0)

    def _shared_micro_scan_a2a(
        self, node_emb, ctx_emb, c2, x2, m2, key, lr, tie_tables
    ):
        """Shared-negative micro-steps with the bucketed all-to-all exchange
        (parallel/exchange.py): the micro-batch is ALSO sliced over 'model'
        (each of the D*M devices trains mb/M pairs — no duplicated compute),
        rows travel owner<->worker in capacity-C buckets, and gradient rows
        ride the same buckets back.  Pairs whose center or context bucket
        overflowed are skipped that micro-step (served mask; ~never at the
        default slack thanks to the id interleave)."""
        from come_tpu.parallel.exchange import make_exchange_plan

        cfg = self.cfg
        M = self.layout.model_size
        KP = cfg.shared_negatives
        nw = cfg.negative / KP
        rows_per = self.v_pad // M
        n_micro, mb = c2.shape
        mbm = mb // M
        cap_pairs = max(1, int(math.ceil(mbm / M * cfg.a2a_capacity_slack)))
        cap_out = max(
            1, int(math.ceil((mbm + KP) / M * cfg.a2a_capacity_slack))
        )
        cap_all = max(
            1, int(math.ceil((2 * mbm + KP) / M * cfg.a2a_capacity_slack))
        )
        from come_tpu.losses.sgns_block import sgns_block_grads_from_rows

        # decorrelate pools/draws across every (data, model) worker
        dkey = jax.random.fold_in(key, jax.lax.axis_index("data"))
        dkey = jax.random.fold_in(dkey, jax.lax.axis_index("model"))
        keys = jax.random.split(dkey, n_micro)
        mi = jax.lax.axis_index("model")

        def micro(carry, xs):
            emb_in, emb_out = carry
            mc, mx, mm, k = xs
            mc = jax.lax.dynamic_slice_in_dim(mc, mi * mbm, mbm)
            mx = jax.lax.dynamic_slice_in_dim(mx, mi * mbm, mbm)
            mm = jax.lax.dynamic_slice_in_dim(mm, mi * mbm, mbm)
            pool = sample_alias(self.accept, self.alias, k, (KP,))
            if tie_tables:
                idx = jnp.concatenate([mc, mx, pool])
                plan = make_exchange_plan(idx, rows_per, cap_all)
                rows = plan.gather(emb_in)
                phi, cpos, cneg = (
                    rows[:mbm], rows[mbm:2 * mbm], rows[2 * mbm:]
                )
                srv = plan.served
                srv_pairs = (srv[:mbm] & srv[mbm:2 * mbm]).astype(
                    jnp.float32
                )
                mm = mm * srv_pairs
            else:
                plan_in = make_exchange_plan(mc, rows_per, cap_pairs)
                plan_out = make_exchange_plan(
                    jnp.concatenate([mx, pool]), rows_per, cap_out
                )
                phi = plan_in.gather(emb_in)
                rows = plan_out.gather(emb_out)
                cpos, cneg = rows[:mbm], rows[mbm:]
                srv_pairs = (
                    plan_in.served & plan_out.served[:mbm]
                ).astype(jnp.float32)
                mm = mm * srv_pairs
            loss, npairs, (d_phi, d_cpos, d_cneg) = (
                sgns_block_grads_from_rows(phi, cpos, cneg, mm, nw)
            )
            if tie_tables:
                upd = jnp.concatenate([d_phi, d_cpos, d_cneg]) * (-lr)
                delta = plan.scatter_add(jnp.zeros_like(emb_in), upd)
                delta = jax.lax.psum(delta, "data")
                emb_in = emb_in + delta
                emb_out = emb_in
            else:
                din = plan_in.scatter_add(
                    jnp.zeros_like(emb_in), d_phi * (-lr)
                )
                dout = plan_out.scatter_add(
                    jnp.zeros_like(emb_out),
                    jnp.concatenate([d_cpos, d_cneg]) * (-lr),
                )
                emb_in = emb_in + jax.lax.psum(din, "data")
                emb_out = emb_out + jax.lax.psum(dout, "data")
            return (emb_in, emb_out), (loss, npairs, jnp.mean(srv_pairs))

        (node_emb, ctx_emb), (losses, npairs, srv) = jax.lax.scan(
            micro, (node_emb, ctx_emb), (c2, x2, m2, keys)
        )
        loss = jax.lax.psum(jnp.sum(losses), ("data", "model"))
        npair = jax.lax.psum(jnp.sum(npairs), ("data", "model"))
        served = jax.lax.pmean(
            jnp.mean(srv), ("data", "model")
        )  # no silent coverage caps: bucket-overflow skips are monitorable
        return node_emb, ctx_emb, loss, npair, served

    def _banded_walks_per_worker(self, b_local: int | None = None) -> int:
        """Walks each of the D*M workers trains per macro step (the
        row-sharded tier also slices each data shard's walks over
        'model')."""
        cfg = self.cfg
        if b_local is None:
            n_starts = len(self.walk_starts) * cfg.walks_per_node
            b_global = max(1, min(cfg.batch_walks, n_starts))
            b_local = max(1, b_global // self.layout.data_size)
        return max(1, b_local // self.layout.model_size)

    def _use_banded_sharded(self, b_local: int | None = None) -> bool:
        """Banded-XLA tier under the mesh.

        model=1: each data shard runs the packed banded step on its walk
        shard against its table replica; deltas psum over 'data' per macro
        step (sum-of-deltas, the dp envelope).

        model>1: row-sharded packed tables + per-block bucketed a2a
        (walk_exchange.banded_walk_step_rowsharded) — the tier that carries
        BASELINE config 5 (multi-host x large-V).  Requires the a2a
        exchange.

        The collision envelope widens by the worker count: all workers'
        blocks land on the table within one synchronous step."""
        if not self._banded_ok():
            return False
        if self.layout.model_size > 1 and self.row_exchange != "a2a":
            return False
        return self._banded_block_sharded(b_local) > 0

    def _banded_block_sharded(self, b_local: int | None = None) -> int:
        """Walks per banded block of each worker (see _banded_block)."""
        workers = self.layout.data_size * self.layout.model_size
        return self._banded_block(
            self._banded_walks_per_worker(b_local), workers
        )

    def _o1_epoch(self, state: TrainState, start_perm: jnp.ndarray):
        """shard_map body: start_perm [S, B] arrives sliced over 'data'."""
        cfg = self.cfg
        # this runs INSIDE shard_map: start_perm is already the local slice
        S, B_local = start_perm.shape
        L = cfg.walk_length
        if S * B_local * L > self._WALK_STREAM_ELEMS:
            # large corpora STREAM per-step generation inside the SGD
            # scan (no epoch corpus in device memory — see the base
            # trainer's _WALK_STREAM_ELEMS note)
            return self._o1_from_walks(
                state, start_perm, gen_from_starts=True
            )
        # whole-epoch walk generation, hoisted but CHUNKED (see the base
        # trainer's _WALK_GEN_CHUNK note); decorrelated across data shards
        kw_all = jax.random.fold_in(
            jax.random.fold_in(state.key, 11), jax.lax.axis_index("data")
        )
        state = state.replace(key=jax.random.fold_in(state.key, 12))
        C = self._WALK_GEN_CHUNK
        flat_starts = start_perm.reshape(S * B_local)
        if S * B_local <= C:
            walks_all = random_walks(
                self.csr, flat_starts, L, kw_all,
                restart_prob=cfg.restart_prob,
            )
        else:
            n = -(-(S * B_local) // C)
            fl = jnp.resize(flat_starts, (n, C))
            keys = jax.random.split(kw_all, n)

            def one(xs):
                k, st = xs
                return random_walks(
                    self.csr, st, L, k, restart_prob=cfg.restart_prob
                )

            walks_all = jax.lax.map(one, (keys, fl)).reshape(n * C, L)[
                : S * B_local
            ]
        return self._o1_from_walks(
            state, walks_all.reshape(S, B_local, L)
        )

    def _o1_from_walks(
        self,
        state: TrainState,
        walks_all: jnp.ndarray,
        gen_from_starts: bool = False,
    ):
        """shard_map body: walks_all [S, B_local, L] is this data shard's
        corpus (device-generated by :meth:`_o1_epoch`, or host-fed by
        :meth:`_o1_epoch_host` one macro batch at a time) — or, with
        ``gen_from_starts``, [S, B_local] per-step walk ORIGINS (the
        large-corpus streaming mode, base trainer's _WALK_STREAM_ELEMS)."""
        cfg = self.cfg
        if gen_from_starts:
            S, B_local = walks_all.shape
        else:
            S, B_local, _L = walks_all.shape
        B_global = B_local * self.layout.data_size
        use_banded = self._use_banded_sharded(B_local)
        if use_banded:
            from come_tpu.losses.sgns_banded import pack_tables

            # pack [V/M, d] x2 -> [V/M, 2d] for the epoch (see
            # losses/sgns_banded.py: the tier is row-rate bound and
            # phi/ctx always share indices)
            p = state.params
            state = state.replace(params=p.replace(
                node_emb=pack_tables(p.node_emb, p.ctx_emb),
                ctx_emb=jnp.zeros((0, 0), p.ctx_emb.dtype),
            ))

        def body(carry, walks):
            params, key, words = carry
            # decorrelate RNG across data shards (negs are local)
            dkey = jax.random.fold_in(key, jax.lax.axis_index("data"))
            key = jax.random.fold_in(key, 7)
            _, kw, kp, kn = jax.random.split(dkey, 4)
            lr = _decayed_lr(words, self.total_words, cfg.lr, cfg.min_lr)
            served = jnp.float32(1.0)
            if gen_from_starts:  # streaming mode: xs rows are origins
                walks = random_walks(
                    self.csr, walks, cfg.walk_length, kw,
                    restart_prob=cfg.restart_prob,
                )
            if use_banded and self.layout.model_size > 1:
                from come_tpu.parallel.walk_exchange import (
                    banded_walk_step_rowsharded,
                )

                M = self.layout.model_size
                mi = jax.lax.axis_index("model")
                B_w = B_local // M
                wk = jax.lax.dynamic_slice_in_dim(walks, mi * B_w, B_w)
                mkey = jax.random.fold_in(dkey, 7919 + mi)
                kpool, kwin = jax.random.split(mkey)
                # a fresh pool per block: the block is split to keep
                # within the pool-stability bound (banded_pool_mass)
                bc = self._banded_block_sharded(B_local)
                bc //= self._pool_chunks(bc)
                sneg = sample_alias(
                    self.accept, self.alias, kpool,
                    (-(-B_w // bc), cfg.shared_negatives),
                )
                ne, loss, npairs, served = banded_walk_step_rowsharded(
                    params.node_emb, wk, sneg, lr,
                    cfg.negative / cfg.shared_negatives, kwin,
                    window=cfg.window,
                    walk_block=bc,
                    capacity_slack=cfg.a2a_capacity_slack,
                    mxu_bf16=cfg.walk_kernel_bf16,
                )
                served = jax.lax.pmean(served, ("data", "model"))
                ce = params.ctx_emb  # zero-size placeholder while packed
            elif use_banded:
                from come_tpu.losses.sgns_banded import (
                    banded_walk_sgns_step_packed,
                )

                kpool, kwin = jax.random.split(
                    jax.random.fold_in(dkey, 7919)
                )
                # full-size blocks with C fresh pool sub-chunks per
                # block — the banded_pool_mass stability bound without
                # shrinking the positive pass
                bc = self._banded_block_sharded(B_local)
                n_blocks = -(-B_local // bc)
                sneg = sample_alias(
                    self.accept, self.alias, kpool,
                    (n_blocks, self._pool_chunks(bc), cfg.shared_negatives),
                )
                cmb0 = params.node_emb  # packed, replicated at model=1
                cmb1, loss, npairs = banded_walk_sgns_step_packed(
                    cmb0, walks, sneg, lr,
                    cfg.negative / cfg.shared_negatives, kwin,
                    window=cfg.window,
                    walk_block=bc,
                    mxu_bf16=cfg.walk_kernel_bf16,
                    sorted_scatter=cfg.banded_sorted_scatter,
                )
                # sum-of-deltas over the data axis (the dp envelope)
                ne = cmb0 + jax.lax.psum(cmb1 - cmb0, "data")
                loss = jax.lax.psum(loss, "data")
                npairs = jax.lax.psum(npairs, "data")
                ce = params.ctx_emb  # zero-size placeholder while packed
            else:
                c, x, m = skipgram_pairs(walks, cfg.window, kp, self.keep)
                negs = None
                if cfg.negative_mode != "shared":
                    negs = sample_alias(
                        self.accept, self.alias, kn,
                        c.shape + (cfg.negative,),
                    )
                ne, ce, loss, npairs, served = (
                    self._sgns_microbatched_sharded(
                        params.node_emb, params.ctx_emb, c, x, negs, m,
                        lr, kn, tie_tables=False,
                    )
                )
            params = params.replace(node_emb=ne, ctx_emb=ce)
            words = words + jnp.float32(B_global * cfg.walk_length)
            return (params, key, words), (loss, npairs, served)

        (params, key, words), (losses, npairs, srv) = jax.lax.scan(
            body, (state.params, state.key, state.words_seen), walks_all
        )
        if use_banded:
            from come_tpu.losses.sgns_banded import unpack_tables

            ne, ce = unpack_tables(params.node_emb)
            params = params.replace(node_emb=ne, ctx_emb=ce)
        state = TrainState(params=params, key=key, words_seen=words)
        npair = jnp.sum(npairs)
        loss = jnp.sum(losses) / jnp.maximum(npair, 1.0)
        return state, jnp.stack([loss, npair, jnp.mean(srv)])

    # --------------------------------------------------- O2 under the mesh

    def o2_tier(self, b_local: int | None = None) -> str:
        """Which O2 path the current config/mesh selects (for logs/tests)."""
        if self.cfg.negative_mode == "shared":
            return (
                "xla-a2a"
                if self.row_exchange == "a2a"
                and self.layout.model_size > 1
                else "xla-psum"
            )
        return "xla-per-pair"

    def _o2_epoch(self, state: TrainState, src: jnp.ndarray, dst: jnp.ndarray):
        cfg = self.cfg
        B_global = src.shape[1] * self.layout.data_size

        def body(carry, arc):
            params, key, words = carry
            s, d = arc
            dkey = jax.random.fold_in(key, jax.lax.axis_index("data"))
            key = jax.random.fold_in(key, 7)
            kn, _ = jax.random.split(dkey)
            lr = _decayed_lr(words, self.total_words, cfg.lr, cfg.min_lr)
            negs = None
            if cfg.negative_mode != "shared":
                negs = sample_alias(
                    self.accept, self.alias, kn, s.shape + (cfg.negative,)
                )
            ne, _, loss, npairs, served = self._sgns_microbatched_sharded(
                params.node_emb,
                params.node_emb,
                s,
                d,
                negs,
                jnp.ones_like(s, jnp.float32),
                lr * cfg.alpha,
                kn,
                tie_tables=True,
            )
            params = params.replace(node_emb=ne)
            words = words + jnp.float32(B_global)
            return (params, key, words), (loss, npairs, served)

        (params, key, words), (losses, npairs, srv) = jax.lax.scan(
            body, (state.params, state.key, state.words_seen), (src, dst)
        )
        state = TrainState(params=params, key=key, words_seen=words)
        npair = jnp.sum(npairs)
        loss = jnp.sum(losses) / jnp.maximum(npair, 1.0)
        return state, jnp.stack([loss, npair, jnp.mean(srv)])

    # ------------------------------------------------------------- jit setup

    def _make_jits(self):
        lay = self.layout
        mesh = lay.mesh
        st = self._state_specs()

        self._o1_epoch_jit = jax.jit(
            shard_map(
                self._o1_epoch,
                mesh=mesh,
                in_specs=(st, P(None, "data")),
                out_specs=(st, P()),
                check_vma=False,
            ),
            donate_argnums=0,
        )
        self._o1_walks_jit = jax.jit(
            shard_map(
                self._o1_from_walks,
                mesh=mesh,
                in_specs=(st, P(None, "data", None)),
                out_specs=(st, P()),
                check_vma=False,
            ),
            donate_argnums=0,
        )
        self._o2_epoch_jit = jax.jit(
            shard_map(
                self._o2_epoch,
                mesh=mesh,
                in_specs=(st, P(None, "data"), P(None, "data")),
                out_specs=(st, P()),
                check_vma=False,
            ),
            donate_argnums=0,
        )
        def o3_step(state):
            # pi/node_emb row-sharded identically, centroid/inv_cov
            # replicated: the community step is communication-free
            cfg = self.cfg
            p = state.params
            lr = _decayed_lr(
                state.words_seen, self.total_words, cfg.lr, cfg.min_lr
            )
            new_emb = community_sgd_step(
                p.node_emb, p.pi, p.centroid, p.inv_cov, cfg.beta, lr,
                grad_clip=cfg.o3_grad_clip,
            )
            loss = community_loss(
                new_emb, p.pi, p.centroid, p.chol_cov, p.inv_cov, cfg.beta
            )
            loss = jax.lax.psum(loss, "model")
            return state.replace(params=p.replace(node_emb=new_emb)), loss

        self._o3_step_jit = jax.jit(
            shard_map(
                o3_step,
                mesh=mesh,
                in_specs=(st,),
                out_specs=(st, P()),
                check_vma=False,
            ),
            donate_argnums=0,
        )

        def gmm_fit(state, key, mask_shard):
            # distributed EM over the WHOLE mesh (VERDICT r3 item 2): rows
            # sharded like the table over 'model', each data replica works
            # a chunk of its shard, moments psum over both axes
            from come_tpu.losses.gmm import gmm_em_fit_sharded

            cfg = self.cfg
            p = state.params
            out = gmm_em_fit_sharded(
                p.node_emb,
                mask_shard,
                cfg.num_communities,
                key,
                axis="model",
                n_init=cfg.gmm_n_init,
                max_iter=cfg.gmm_max_iter,
                reg_covar=cfg.reg_covar,
                tol=cfg.gmm_tol,
                data_axis="data",
            )
            pi = out["resp"] * mask_shard[:, None]  # pad rows: no community
            params = p.replace(
                centroid=out["means"],
                chol_cov=out["chol"],
                inv_cov=out["inv_cov"],
                pi=pi,
            )
            return state.replace(params=params), out["log_likelihood"]

        self._gmm_fit_jit = jax.jit(
            shard_map(
                gmm_fit,
                mesh=mesh,
                in_specs=(st, P(), P("model")),
                out_specs=(st, P()),
                check_vma=False,
            ),
            donate_argnums=0,
        )

    # ------------------------------------------------------------ host driver

    def _data_rows_local(self):
        """(row indices of the 'data' axis with addressable devices,
        total data rows): which slices of a P('data')-sharded batch this
        PROCESS must supply.  Processes that share data rows (model-axis
        splits) see the same row set and must supply identical values."""
        mesh = self.layout.mesh
        pi = jax.process_index()
        local = np.array(
            [[d.process_index == pi for d in row] for row in mesh.devices]
        )
        rows = np.nonzero(local.any(axis=1))[0]
        return rows, mesh.devices.shape[0]

    def _shard_local_batch(self, local: np.ndarray, spec: P):
        """Place a PER-PROCESS host batch block on the mesh (axis of the
        spec's first sharded dim concatenates over processes).  Single
        process: plain shard."""
        if jax.process_count() == 1:
            return self.layout.shard(local, spec)
        from jax.sharding import NamedSharding

        sharding = NamedSharding(self.layout.mesh, spec)
        return jax.make_array_from_process_local_data(sharding, local)

    def _o1_epoch_host(self) -> float:
        """Host-corpus O1 epoch under the mesh (VERDICT r3 item 6): ONE
        C++ feeder per process generates walks for exactly the data rows
        this process owns (reference C3's per-worker walk writers [R] —
        each worker fills its own shard of the corpus), double-buffered
        under the device's training of the previous batch.

        Start-node coverage: the global node range is split over the D
        data rows; each process's feeder permutes its rows' slice, so an
        epoch covers every node ~walks_per_node times like the device
        corpus.  Feeder seeds key off the first owned data row, so
        model-axis process splits (which SHARE data rows and must supply
        identical replica values) generate identical batches.

        Coverage approximation (ADVICE r4 item 4): the device batch must
        be UNIFORM per data row (sharding needs equal shapes), but
        ``np.array_split`` slices differ by up to one node, so nodes in a
        larger slice get up to ``1/slice`` fewer expected walks per epoch
        (< 0.5% at V >= 200/D).  The feeder's own permutation still
        visits every owned node before repeating.  The feeder is built
        once: batch sizing is config-static by design.
        """
        from come_tpu.native import HostWalkFeeder

        cfg = self.cfg
        lay = self.layout
        v = len(self.walk_starts)  # no walks from isolated nodes —
        # epoch sizing must match the feeders' node set and the
        # walk_starts-based LR word budget (round-5 review finding)
        D = lay.data_size
        g = D * lay.model_size
        B = min(cfg.batch_walks, v * cfg.walks_per_node)
        B = max(g, (B // g) * g)
        n_batches = math.ceil(v * cfg.walks_per_node / B)
        rows, _ = self._data_rows_local()
        if self._host_feeder is None:
            # split the NON-ISOLATED starts (walk_starts) over data rows
            splits = np.array_split(self.walk_starts, D)
            nodes = np.concatenate([splits[r] for r in rows])
            if nodes.size == 0:  # more data rows than nodes: walk any
                nodes = self.walk_starts
            self._host_feeder = HostWalkFeeder(
                self.graph,
                batch=(B // D) * len(rows),
                length=cfg.walk_length,
                seed=cfg.seed + 7919 * int(rows[0]),
                restart_prob=cfg.restart_prob,
                nodes=nodes,
            )
        self._log_o1_tier(B // D)
        stats = []
        for _ in range(n_batches):
            walks = next(self._host_feeder)[None]  # [1, B_proc, L]
            wb = self._shard_local_batch(walks, P(None, "data", None))
            self.state, st = self._o1_walks_jit(self.state, wb)
            stats.append(st)  # device values: no per-batch sync
        st = jnp.stack(stats)  # [n_batches, 3]: per-batch [loss, pairs, srv]
        pairs = jnp.sum(st[:, 1])
        # same stats-vector contract as the device-corpus epochs: one
        # [loss, pairs, served] device vector, flushed by o1_sync — so
        # stats_sync(False) chaining works for the host corpus too.  The
        # loss is the PAIR-WEIGHTED global mean (each batch's st[0] is its
        # own per-pair mean), matching the device-epoch contract even when
        # per-batch pair counts differ (ADVICE r4 item 2).
        loss = jnp.sum(st[:, 0] * st[:, 1]) / jnp.maximum(pairs, 1.0)
        return self._finish_o1(
            jnp.stack([loss, pairs, jnp.mean(st[:, 2])])
        )

    def o1_epoch(self) -> float:
        cfg = self.cfg
        lay = self.layout
        if cfg.corpus == "host":
            return self._o1_epoch_host()
        v = self.v_real
        D = lay.data_size
        # walk batches divide over 'data'; the row-sharded banded tier
        # additionally slices each data shard's walks over 'model'
        g = D * lay.model_size
        # starts exclude isolated nodes (reference: degree-0 walks train
        # nothing — see ComETrainer.__init__'s walk_starts note)
        n_starts = len(self.walk_starts) * cfg.walks_per_node
        B = min(cfg.batch_walks, n_starts)
        B = max(g, (B // g) * g)
        S = math.ceil(n_starts / B)
        self.host_key, k = jax.random.split(self.host_key)
        perm = jax.random.permutation(
            k,
            jnp.tile(jnp.asarray(self.walk_starts), cfg.walks_per_node),
        )
        perm = jnp.resize(perm, (S, B))
        perm = lay.shard(perm, P(None, "data"))
        self._log_o1_tier(B // D)
        self.state, stats = self._o1_epoch_jit(self.state, perm)
        return self._finish_o1(stats)

    def o1_sync(self) -> float:
        st = np.asarray(self._o1_stats)
        self.last_o1_pairs = float(st[1])
        self.last_o1_served = float(st[2])
        self._warn_unserved("o1", self.last_o1_served)
        return float(st[0])

    def o1_tier(self, b_local: int | None = None) -> str:
        """Which O1 path the current config/mesh selects (for logs/tests)."""
        if self._use_banded_sharded(b_local):
            return (
                "banded-rowsharded"
                if self.layout.model_size > 1
                else "banded-dp"
            )
        if self.cfg.negative_mode == "shared":
            return (
                "xla-a2a"
                if self.row_exchange == "a2a"
                and self.layout.model_size > 1
                else "xla-psum"
            )
        return "xla-per-pair"

    def _log_o1_tier(self, b_local: int) -> None:
        self._log_tier("o1", self.o1_tier(b_local))

    def _log_tier(self, phase: str, tier: str) -> None:
        attr = f"_tier_logged_{phase}"
        if getattr(self, attr, None) != tier:
            setattr(self, attr, tier)
            import logging

            logging.getLogger(__name__).info(
                "%s tier: %s (mesh %dx%d)", phase, tier,
                self.layout.data_size, self.layout.model_size,
            )

    @staticmethod
    def _warn_unserved(phase: str, served: float) -> None:
        if served < 0.999:
            import logging

            logging.getLogger(__name__).warning(
                "%s a2a bucket overflow: served fraction %.4f < 1 "
                "(raise a2a_capacity_slack)", phase, served,
            )

    def o2_epoch(self) -> float:
        cfg = self.cfg
        lay = self.layout
        D = lay.data_size
        e = self.graph.num_arcs
        B = min(cfg.batch_edges, e)
        B = max(D, (B // D) * D)
        S = math.ceil(e / B)
        self.host_key, k = jax.random.split(self.host_key)
        perm = jax.random.permutation(k, e)
        src = jnp.resize(self.arc_src[perm], (S, B))
        dst = jnp.resize(self.arc_dst[perm], (S, B))
        src = lay.shard(src, P(None, "data"))
        dst = lay.shard(dst, P(None, "data"))
        self._log_tier("o2", self.o2_tier(B // D))
        self.state, stats = self._o2_epoch_jit(self.state, src, dst)
        return self._finish_o2(stats)

    def o2_sync(self) -> float:
        st = np.asarray(self._o2_stats)
        self.last_o2_pairs = float(st[1])
        self.last_o2_served = float(st[2])
        self._warn_unserved("o2", self.last_o2_served)
        return float(st[0])

    def fit_gmm(self) -> float:
        """Distributed EM over the row-sharded table (no host gather):
        E-step local per shard, M-step moments and log-likelihood psum'd
        over the 'model' axis."""
        self.host_key, k = jax.random.split(self.host_key)
        mask = (jnp.arange(self.v_pad) < self.v_real).astype(jnp.float32)
        mask = self.layout.shard(mask, P("model"))
        self.state, ll = self._gmm_fit_jit(self.state, k, mask)
        return float(ll) if self._sync_stats else None

    def save_checkpoint(self, path) -> None:
        """Per-process shard checkpoint (multi-host safe: no gather of
        non-addressable leaves — VERDICT r2 missing #3).  Topology
        metadata (mesh shape, real node count) rides along so a restore
        under a DIFFERENT topology can reshard (VERDICT r3 item 7)."""
        from come_tpu.iohelpers import save_checkpoint_sharded

        save_checkpoint_sharded(
            path, self.state, host_key=self.host_key,
            meta={
                "data": self.layout.data_size,
                "model": self.layout.model_size,
                "v_real": self.v_real,
                # whether the a2a id interleave was applied: rows are in
                # PERMUTED order iff true — psum-exchange trainers at
                # model>1 keep original order, and a loader that guessed
                # from the mesh shape alone would scramble them
                "interleave": int(self._perm is not None),
            },
        )
        if jax.process_count() > 1:
            # all shard files durable before ANY process proceeds: a peer
            # that loads (or merges) right after save must never observe
            # a half-written checkpoint
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(f"ckpt_saved:{path}")

    def load_checkpoint(self, path) -> None:
        from come_tpu.iohelpers import (
            load_checkpoint_meta,
            load_checkpoint_sharded,
            load_host_key,
        )

        lay = self.layout
        # read THIS process's own shard file for the topology metadata —
        # every file carries it, and a peer's file may still be in flight.
        # When restoring onto MORE processes than saved, this process may
        # have no own file at all; post-save sync_global_devices
        # guarantees any EXISTING file set is complete, so falling back to
        # file 0 is race-free at restore time (ADVICE r4 item 1 — the
        # grow direction used to raise 'pre-elastic format').
        meta = load_checkpoint_meta(path, jax.process_index())
        if not meta:
            meta = load_checkpoint_meta(path, 0)
        mine = int(self._perm is not None)
        same = (
            meta.get("process_count") == jax.process_count()
            and meta.get("data", lay.data_size) == lay.data_size
            and meta.get("model", lay.model_size) == lay.model_size
            # same mesh shape but a different row-id layout (a2a
            # interleave vs psum original order) still needs the elastic
            # re-permutation — a direct shard restore would scramble rows
            and meta.get("interleave", mine) == mine
        )
        if not same:
            self._load_checkpoint_elastic(path, meta)
            return
        self.state = load_checkpoint_sharded(path, lay)
        hk = load_host_key(path, process_index=jax.process_index())
        if hk is not None:  # bit-exact resume incl. walk/edge permutations
            self.host_key = hk

    def _load_checkpoint_elastic(self, path, meta: dict) -> None:
        """Reshard-on-restore (VERDICT r3 item 7): merge the saved
        topology's per-process shard files into the LOGICAL
        (original-node-id) state, then lay it out for THIS mesh.

        The saved trainer's a2a interleave (``perm[old] = new``, trained
        row ``perm[j]`` holds original node j) is inverted via the
        deterministic ``interleave_permutation(v_real, M_saved)``; this
        trainer re-pads and re-permutes for its own model-axis size.
        Needs every ``.proc*.npz`` visible on this host (shared fs).
        Bit-exact continuation is NOT promised across a topology change —
        batch slicing and RNG folds differ by construction; parameter
        state transfers exactly.
        """
        from come_tpu.iohelpers import load_checkpoint_global
        from come_tpu.parallel.exchange import interleave_permutation

        if "v_real" not in meta:
            raise ValueError(
                "checkpoint lacks topology metadata (pre-elastic format) "
                "— restore on the topology that saved it"
            )
        leaves, _ = load_checkpoint_global(path)
        vr = int(meta["v_real"])
        if vr != self.v_real:
            raise ValueError(
                f"checkpoint is for a {vr}-node graph, trainer has "
                f"{self.v_real}"
            )
        m_saved = int(meta["model"])
        # rows are in interleaved order only if the SAVING trainer applied
        # the a2a relabel (recorded in meta; psum-exchange trainers at
        # model>1 keep original order — inverting unconditionally would
        # scramble them)
        interleaved = bool(meta.get("interleave", m_saved > 1))

        def to_logical(a):
            a = a[:vr]  # drop the saved layout's pad rows
            if interleaved:
                perm_s = np.asarray(interleave_permutation(vr, m_saved))
                a = a[perm_s]  # logical[j] = trained[perm[j]]
            return a

        def to_mine(a):
            # logical -> this trainer's padded+permuted row space
            out = np.zeros((self.v_pad,) + a.shape[1:], a.dtype)
            if self._perm is not None:
                out[np.asarray(self._perm)] = a
            else:
                out[:vr] = a
            return out

        lay = self.layout
        specs = lay.params_specs()
        row = {k: to_mine(to_logical(leaves[k]))
               for k in ("node_emb", "ctx_emb", "pi")}
        params = ComEParams(
            node_emb=lay.shard(row["node_emb"], specs.node_emb),
            ctx_emb=lay.shard(row["ctx_emb"], specs.ctx_emb),
            centroid=lay.shard(leaves["centroid"], specs.centroid),
            chol_cov=lay.shard(leaves["chol_cov"], specs.chol_cov),
            inv_cov=lay.shard(leaves["inv_cov"], specs.inv_cov),
            pi=lay.shard(row["pi"], specs.pi),
        )
        self.state = TrainState(
            params=params,
            key=jax.random.wrap_key_data(jnp.asarray(leaves["key"])),
            words_seen=lay.shard(leaves["words_seen"], P()),
        )

    def _to_host(self, x) -> np.ndarray:
        """Materialize a (possibly non-fully-addressable) global array on
        every host: replicate via an all-gather-inserting jit when
        multi-host, so np.asarray sees only addressable shards."""
        if jax.process_count() > 1:
            from jax.sharding import NamedSharding

            x = jax.jit(
                lambda a: a,
                out_shardings=NamedSharding(self.layout.mesh, P()),
            )(x)
        return np.asarray(x)

    def embeddings(self) -> np.ndarray:
        emb = self._to_host(self.state.params.node_emb[: self.v_real])
        if self._perm is not None:  # back to original node ids
            emb = emb[self._perm]
        return emb

    def communities(self) -> np.ndarray:
        com = self._to_host(
            jnp.argmax(self.state.params.pi[: self.v_real], axis=1)
        )
        if self._perm is not None:
            com = com[self._perm]
        return com
