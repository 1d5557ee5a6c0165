"""Alternating ComE trainer: pretrain -> [GMM fit -> O1 -> O2 -> O3 -> eval].

Re-design of the reference driver loop (reference ``main.py`` [R],
SURVEY.md C9, §3.1) and of both hogwild learner scaffolds (``ADSCModel/
context_embeddings.py::Context2Vec.train``, ``ADSCModel/node_embeddings.py::
Node2Vec.train`` [R], SURVEY.md C6-C7):

* the producer-thread + Queue + worker-threads + Cython-nogil machinery
  becomes ONE jitted ``lax.scan`` per epoch — walk generation, window-pair
  extraction, negative sampling, SDDMM scoring, and scatter-add updates all
  fused on device with zero host round-trips;
* hogwild's racy writes become deterministic synchronous minibatch updates
  (same expected gradient; SURVEY.md §7 hard part 1);
* the linear LR decay ``alpha = max(min_alpha, lr*(1 - words/total))``
  (gensim lineage, SURVEY.md §3.2) is kept exactly, driven by a device-side
  word counter shared across O1/O2 phases.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from come_tpu.config import ComEConfig
from come_tpu.graphs.csr import CSRGraph
from come_tpu.losses.community import community_loss, community_sgd_step
from come_tpu.losses.gmm import fit_communities
from come_tpu.losses.sgns import sgns_sgd_step
from come_tpu.models import ComEParams, init_params
from come_tpu.models.state import pytree_dataclass
from come_tpu.sampling import (
    build_alias_table,
    random_walks,
    sample_alias,
    skipgram_pairs,
    subsample_keep_probs,
    unigram_weights,
)


@pytree_dataclass
class TrainState:
    params: ComEParams
    key: jax.Array
    words_seen: jnp.ndarray  # f32 scalar, drives the linear LR decay


def _decayed_lr(words_seen, total_words, lr0, min_lr):
    frac = 1.0 - words_seen / jnp.maximum(total_words, 1.0)
    return jnp.maximum(min_lr, lr0 * frac)


class ComETrainer:
    """Single-host trainer; the sharded variant lives in come_tpu.parallel."""

    def __init__(
        self,
        graph: CSRGraph,
        config: ComEConfig,
        key: jax.Array | None = None,
    ):
        self.graph = graph
        self.cfg = config
        self.csr = graph.to_device()
        degrees = graph.degrees
        accept, alias = build_alias_table(unigram_weights(degrees))
        self.accept = jnp.asarray(accept)
        self.alias = jnp.asarray(alias)
        keep = subsample_keep_probs(degrees, config.down_sample)
        self.keep = (
            jnp.asarray(keep) if config.down_sample > 0 else None
        )
        if (
            config.down_sample > 0
            and config.banded != "never"
            and config.negative_mode == "shared"
        ):
            # VERDICT r4 item 6: never a SILENT tier downgrade.  The banded
            # tier's window mask doesn't model word2vec occurrence-dropping;
            # frequent-node subsampling therefore runs on the micro-batched
            # XLA path (which applies the keep-prob mask exactly,
            # sampling/windows.py).  The reference default is sample=0
            # (SURVEY.md C4), so the banded tier covers reference behavior;
            # this warns anyone opting into `sample` > 0.
            import warnings

            warnings.warn(
                f"down_sample={config.down_sample} disables the banded O1 "
                "tier (its window mask does not model occurrence "
                "dropping); O1 will run on the micro-batched XLA path, "
                "which applies the keep-prob mask exactly.  O2 is "
                "unaffected (the edge pass does not subsample, matching "
                "this framework's documented O2 semantics).  Use "
                "down_sample=0 (the reference default) for the banded "
                "O1 tier.",
                stacklevel=2,
            )
        src, dst = graph.arcs()
        self.arc_src = jnp.asarray(src)
        self.arc_dst = jnp.asarray(dst)
        # Walk STARTS exclude isolated nodes.  The reference's
        # ``random_walk`` yields a length-1 walk at a degree-0 node — no
        # trainable pairs (deepwalk lineage [R], SURVEY.md C3) — whereas
        # the static-shape device walker keeps the node in place, which
        # would hand the block-synchronous banded tier a STATIONARY walk:
        # ~L*W copies of the same self-pair summed into one row update
        # per group, which measurably diverges on sparse graphs (the
        # dblp stand-in blew up its 11 isolated nodes' rows to 1e3 norms
        # and NaN'd the GMM — caught by the round-5 EVAL sweep).
        # Isolated nodes can never be REACHED (no in-edges), so start
        # filtering alone restores reference semantics.
        ws = np.flatnonzero(np.asarray(degrees) > 0).astype(np.int32)
        self.walk_starts = (
            ws if ws.size else np.arange(graph.num_nodes, dtype=np.int32)
        )

        key = jax.random.key(config.seed) if key is None else key
        k_init, self.host_key = jax.random.split(key)
        params = init_params(
            graph.num_nodes, config.dim, config.num_communities, k_init
        )
        self.state = TrainState(
            params=params,
            key=jax.random.fold_in(key, 1),
            words_seen=jnp.zeros((), jnp.float32),
        )
        self.total_words = float(self._word_budget())
        self._history: list[dict] = []

        self._o1_epoch_jit = jax.jit(self._o1_epoch, donate_argnums=0)
        self._o2_epoch_jit = jax.jit(self._o2_epoch, donate_argnums=0)
        self._o3_step_jit = jax.jit(self._o3_step, donate_argnums=0)
        self._o1_walks_step_jit = jax.jit(self._o1_walks_step, donate_argnums=0)
        self._o1_from_walks_jit = jax.jit(
            self._o1_epoch_from_walks, donate_argnums=0
        )
        self._gen_walks_jit = jax.jit(self._gen_epoch_walks)
        self._host_feeder = None
        self._walk_cache = None
        self._o1_epochs_done = 0
        self.last_o1_pairs = 0.0  # exact trained-pair counters (bench
        self.last_o2_pairs = 0.0  # uses these, not estimates)
        self._sync_stats = True

    # per-row collision bound of one synchronous update: above ~16 summed
    # duplicate-row updates per row, block-synchronous SGD stops behaving
    # like hogwild's sequential application (SURVEY.md §7 hard part 1)
    _COLLISION_BOUND = 16.0

    def _collisions(self, walks_per_block: int, workers: int = 1) -> float:
        """Expected summed updates per table row from one synchronous
        banded block: 2 rows per pair over ~L*(W+1)/2 pairs per walk,
        times the workers whose blocks land in the same step."""
        cfg = self.cfg
        pairs = walks_per_block * cfg.walk_length * (cfg.window + 1) / 2
        return 2.0 * pairs * workers / max(self.graph.num_nodes, 1)

    def _banded_ok(self) -> bool:
        """Config gates shared by every banded tier: shared negatives and
        no subsampling (the window mask doesn't model occurrence
        dropping)."""
        cfg = self.cfg
        if cfg.banded == "never" or cfg.negative_mode != "shared":
            return False
        return cfg.down_sample == 0

    # smallest auto-chosen banded block: below it the per-block fixed
    # costs of the scan outweigh what the banded formulation saves
    _MIN_BANDED_BLOCK = 8

    def _banded_block(self, walks: int, workers: int = 1) -> int:
        """Walks per banded block for a batch of ``walks`` per worker: at
        most ``banded_walk_block``, halved until one block's synchronous
        update keeps per-row collisions within the envelope.  0 when that
        would take halving below _MIN_BANDED_BLOCK walks (tiny graphs like
        Karate then take the micro-batched path)."""
        cfg = self.cfg
        bc = max(1, min(cfg.banded_walk_block, walks))
        if cfg.banded == "always":
            return bc
        while self._collisions(bc, workers) > self._COLLISION_BOUND:
            bc = -(-bc // 2)
            if bc < self._MIN_BANDED_BLOCK:
                return 0
        return bc

    def _walks_per_pool(self) -> int:
        """Walks one fresh negative pool may serve.  Every trained pair
        adds ~negative/KP of gradient to EVERY pool row, so one pool
        serving n walks hands each of its rows ~n*L*(W+1)*negative/KP
        unit gradients in one synchronous application; ``banded_pool_mass``
        bounds that sum."""
        cfg = self.cfg
        per_walk = cfg.walk_length * (cfg.window + 1) * cfg.negative
        return max(1, cfg.banded_pool_mass * cfg.shared_negatives // per_walk)

    def _pool_chunks(self, bc: int) -> int:
        """Fresh pools per banded block of ``bc`` walks: the fewest that
        divide the block and keep each within _walks_per_pool."""
        c = -(-bc // self._walks_per_pool())
        while bc % c:
            c += 1
        return c

    def _use_banded(self) -> bool:
        """Banded-XLA O1 tier: the walk-banded matmul formulation over
        device-memory tables, chosen when some block size keeps per-row
        collisions bounded (see _banded_block)."""
        if not self._banded_ok():
            return False
        n_starts = len(self.walk_starts) * self.cfg.walks_per_node
        return self._banded_block(min(self.cfg.batch_walks, n_starts)) > 0

    def o1_tier(self) -> str:
        """Which O1 path the current config selects (for logs/tests)."""
        if self._use_banded():
            return "banded"
        if self.cfg.negative_mode == "shared":
            return "xla"
        return "xla-per-pair"

    # ---------------------------------------------------------------- budget

    def _word_budget(self) -> float:
        """Total center-word count for the global linear LR decay."""
        cfg = self.cfg
        v, e = len(self.walk_starts), self.graph.num_arcs
        o1_epochs = cfg.pretrain_epochs + cfg.outer_iters * cfg.o1_epochs_per_iter
        o2_epochs = cfg.outer_iters * cfg.o2_epochs_per_iter
        return (
            o1_epochs * v * cfg.walks_per_node * cfg.walk_length
            + o2_epochs * e
        )

    # ------------------------------------------------------------- O1 (walks)

    def _sgns_microbatched(
        self, node_emb, ctx_emb, c, x, negs, m, lr, key, tie_tables,
        compact=False,
    ):
        """Apply one macro-batch of pairs as sequential micro-step updates.

        Pairs are generated in large device batches (walks/negatives are
        cheap and device-efficient at scale) but *applied* in chunks of
        ``cfg.batch_pairs``: hogwild's sequential per-pair application is
        what keeps word2vec stable, and micro-stepping restores that
        feedback at chunk granularity while duplicate rows within a chunk
        still sum exactly like consecutive hogwild updates.
        """
        cfg = self.cfg
        P = c.size
        K = cfg.negative
        c = c.reshape(P)
        x = x.reshape(P)
        m = m.reshape(P)
        if negs is not None:
            negs = negs.reshape(P, K)

        if compact and cfg.compact_budget and cfg.compact_budget < 1.0:
            # stable partition: valid pairs first, then truncate to the
            # budget — halves SGD slots per trained pair (mask rate ~0.52)
            order = jnp.argsort(~m.astype(bool), stable=True)
            budget = int(P * cfg.compact_budget)
            order = order[:budget]
            c, x, m = c[order], x[order], m[order]
            if negs is not None:
                negs = negs[order]
            P = budget

        mb = min(cfg.batch_pairs, P)
        n_micro = math.ceil(P / mb)
        pad = n_micro * mb - P

        c2 = jnp.pad(c, (0, pad)).reshape(n_micro, mb)
        x2 = jnp.pad(x, (0, pad)).reshape(n_micro, mb)
        m2 = jnp.pad(
            m.astype(jnp.float32), (0, pad)
        ).reshape(n_micro, mb)

        if cfg.negative_mode == "shared":
            from come_tpu.losses.sgns_block import sgns_block_sgd_step

            keys = jax.random.split(key, n_micro)
            nw = cfg.negative / cfg.shared_negatives

            def micro(carry, xs):
                emb_in, emb_out = carry
                mc, mx, mm, k = xs
                sneg = sample_alias(
                    self.accept, self.alias, k, (cfg.shared_negatives,)
                )
                emb_in, emb_out, loss, npairs = sgns_block_sgd_step(
                    emb_in, emb_out, mc, mx, sneg, mm, lr, nw,
                    tie_tables=tie_tables,
                )
                return (emb_in, emb_out), (loss, npairs)

            (node_emb, ctx_emb), (losses, npairs) = jax.lax.scan(
                micro, (node_emb, ctx_emb), (c2, x2, m2, keys)
            )
            return node_emb, ctx_emb, jnp.sum(losses), jnp.sum(npairs)

        n2 = jnp.pad(
            negs.reshape(P, K), ((0, pad), (0, 0))
        ).reshape(n_micro, mb, K)

        def micro(carry, xs):
            emb_in, emb_out = carry
            mc, mx, mn, mm = xs
            emb_in, emb_out, loss, npairs = sgns_sgd_step(
                emb_in,
                emb_out,
                mc,
                mx,
                mn,
                mm,
                lr,
                tie_tables=tie_tables,
                max_exp=cfg.max_exp,
            )
            return (emb_in, emb_out), (loss, npairs)

        (node_emb, ctx_emb), (losses, npairs) = jax.lax.scan(
            micro, (node_emb, ctx_emb), (c2, x2, n2, m2)
        )
        return node_emb, ctx_emb, jnp.sum(losses), jnp.sum(npairs)

    # walker chunk width: one epoch-wide call is fastest for small
    # corpora (the walker is per-step-latency bound, so one S*B-wide
    # scan costs ~one B-wide scan), but its temporaries grow with S*B.
    # Chunking bounds them at multi-million-walk epochs; walks themselves
    # are param-independent so the split is semantics-free.
    _WALK_GEN_CHUNK = 262144

    def _gen_epoch_walks(self, key, start_perm: jnp.ndarray) -> jnp.ndarray:
        """Generate the WHOLE epoch's walks, hoisted out of the SGD scan,
        in bounded-width walker calls (see _WALK_GEN_CHUNK)."""
        S, B = start_perm.shape
        L = self.cfg.walk_length
        C = self._WALK_GEN_CHUNK
        if S * B <= C:
            return random_walks(
                self.csr, start_perm.reshape(S * B), L, key,
                restart_prob=self.cfg.restart_prob,
            ).reshape(S, B, L)
        n = -(-(S * B) // C)
        flat = jnp.resize(start_perm.reshape(S * B), (n, C))
        keys = jax.random.split(key, n)

        def one(xs):
            k, starts = xs
            return random_walks(
                self.csr, starts, L, k,
                restart_prob=self.cfg.restart_prob,
            )

        walks = jax.lax.map(one, (keys, flat))  # [n, C, L]
        return walks.reshape(n * C, L)[: S * B].reshape(S, B, L)

    # corpus elements (S*B*L) beyond which the epoch STREAMS walk
    # generation inside the SGD scan instead of materializing the whole
    # corpus (synthetic-10m at walks_per_node=10 is a 1.6GB corpus):
    # streaming bounds the corpus's device memory at the same math.
    _WALK_STREAM_ELEMS = 1 << 27  # ~512MB of i32

    def _o1_epoch(self, state: TrainState, start_perm: jnp.ndarray):
        """start_perm int32 [S, B]: per-step walk origins."""
        S, B = start_perm.shape
        if S * B * self.cfg.walk_length > self._WALK_STREAM_ELEMS:
            return self._o1_epoch_from_walks(
                state, start_perm, gen_from_starts=True
            )
        key, kw_all = jax.random.split(state.key)
        state = state.replace(key=key)
        walks_all = self._gen_epoch_walks(kw_all, start_perm)
        return self._o1_epoch_from_walks(state, walks_all)

    def _o1_epoch_from_walks(
        self,
        state: TrainState,
        walks_all: jnp.ndarray,
        gen_from_starts: bool = False,
    ):
        """walks_all int32 [S, B, L]: the epoch's corpus (fresh or
        cached) — or, with ``gen_from_starts``, int32 [S, B] per-step
        walk ORIGINS, each step generating its own walks inside the scan
        (the large-corpus streaming mode; see _WALK_STREAM_ELEMS)."""
        cfg = self.cfg
        B = walks_all.shape[1]

        use_banded = self._use_banded()
        if use_banded:
            # pack [V, d] x2 -> [V, 2d] for the epoch: the banded tier is
            # gather/scatter ROW-RATE bound, and phi/ctx share indices —
            # one packed row op moves both tables (see sgns_banded.py)
            from come_tpu.losses.sgns_banded import pack_tables

            p = state.params
            state = state.replace(params=p.replace(
                node_emb=pack_tables(p.node_emb, p.ctx_emb),
                ctx_emb=jnp.zeros((0, 0), p.ctx_emb.dtype),
            ))

        def body(carry, walks):
            params, key, words = carry
            key, kw, kp, kn = jax.random.split(key, 4)
            lr = _decayed_lr(words, self.total_words, cfg.lr, cfg.min_lr)
            if gen_from_starts:  # streaming mode: xs rows are origins
                walks = random_walks(
                    self.csr, walks, cfg.walk_length, kw,
                    restart_prob=cfg.restart_prob,
                )
            if use_banded:
                from come_tpu.losses.sgns_banded import (
                    banded_walk_sgns_step_packed,
                )

                kpool, kwin = jax.random.split(kn)
                # full-size blocks (the fast positive-pass shape) with C
                # fresh pool sub-chunks per block so no pool application
                # exceeds the banded_pool_mass stability budget
                bc = self._banded_block(B)
                n_blocks = -(-B // bc)
                sneg = sample_alias(
                    self.accept, self.alias, kpool,
                    (n_blocks, self._pool_chunks(bc), cfg.shared_negatives),
                )
                ne, loss, npairs = banded_walk_sgns_step_packed(
                    params.node_emb, walks, sneg, lr,
                    cfg.negative / cfg.shared_negatives, kwin,
                    window=cfg.window,
                    walk_block=bc,
                    mxu_bf16=cfg.walk_kernel_bf16,
                    sorted_scatter=cfg.banded_sorted_scatter,
                )
                ce = params.ctx_emb  # zero-size placeholder while packed
            else:
                c, x, m = skipgram_pairs(walks, cfg.window, kp, self.keep)
                negs = None
                if cfg.negative_mode != "shared":
                    negs = sample_alias(
                        self.accept, self.alias, kn,
                        c.shape + (cfg.negative,),
                    )
                ne, ce, loss, npairs = self._sgns_microbatched(
                    params.node_emb, params.ctx_emb, c, x, negs, m, lr, kn,
                    tie_tables=False, compact=True,
                )
            params = params.replace(node_emb=ne, ctx_emb=ce)
            words = words + jnp.float32(B * cfg.walk_length)
            return (params, key, words), (loss, npairs)

        (params, key, words), (losses, npairs) = jax.lax.scan(
            body, (state.params, state.key, state.words_seen), walks_all
        )
        if use_banded:
            from come_tpu.losses.sgns_banded import unpack_tables

            ne, ce = unpack_tables(params.node_emb)
            params = params.replace(node_emb=ne, ctx_emb=ce)
        state = TrainState(params=params, key=key, words_seen=words)
        npair = jnp.sum(npairs)
        loss = jnp.sum(losses) / jnp.maximum(npair, 1.0)
        # ONE stacked stats vector -> ONE host transfer per epoch
        return state, jnp.stack([loss, npair])

    def o1_epoch(self) -> float:
        """One pass of `walks_per_node` walks from every node (SURVEY §3.2)."""
        cfg = self.cfg
        if cfg.corpus == "host":
            return self._o1_epoch_host()
        n_starts = len(self.walk_starts) * cfg.walks_per_node
        B = min(cfg.batch_walks, n_starts)
        S = math.ceil(n_starts / B)
        self.host_key, k = jax.random.split(self.host_key)
        perm = jax.random.permutation(
            k,
            jnp.tile(
                jnp.asarray(self.walk_starts), cfg.walks_per_node
            ),
        )
        perm = jnp.resize(perm, (S, B))  # wraps the tail batch
        if cfg.walk_regen_epochs != 1:
            # cached corpus (reference semantics: deepwalk writes walk
            # files once and every epoch re-streams them, SURVEY.md C3)
            regen = self._walk_cache is None or (
                cfg.walk_regen_epochs > 0
                and self._o1_epochs_done % cfg.walk_regen_epochs == 0
            )
            if regen:
                self.host_key, kw = jax.random.split(self.host_key)
                self._walk_cache = self._gen_walks_jit(kw, perm)
            self._o1_epochs_done += 1
            self.state, stats = self._o1_from_walks_jit(
                self.state, self._walk_cache
            )
            return self._finish_o1(stats)
        self._o1_epochs_done += 1
        self.state, stats = self._o1_epoch_jit(self.state, perm)
        return self._finish_o1(stats)

    def _finish_o1(self, stats):
        self._o1_stats = stats
        if not self._sync_stats:
            return None
        return self.o1_sync()

    def o1_sync(self) -> float:
        """Flush the pending O1 stats to host (one device round trip);
        sets ``last_o1_pairs`` and returns the loss/pair.  With
        ``stats_sync(False)``, epochs return None and callers flush once
        after a run of epochs, so chained epochs queue on the device with
        no host round trip between them (bench.py times them that way)."""
        st = np.asarray(self._o1_stats)
        self.last_o1_pairs = float(st[1])
        return float(st[0])

    def stats_sync(self, sync: bool) -> None:
        """Toggle per-epoch host syncing of the stats vector."""
        self._sync_stats = sync

    def _o1_epoch_host(self) -> float:
        """Host-corpus O1 epoch: C++ feeder generates walks on host threads
        while the device trains the previous batch (reference C3's
        pool-plus-files pipeline, minus the disk): the feeder's threads
        produce batch k+1 while the device trains batch k.  Losses stay
        on device until the epoch ends (one host sync)."""
        from come_tpu.native import HostWalkFeeder

        cfg = self.cfg
        v = len(self.walk_starts)  # no walks from isolated nodes
        B = min(cfg.batch_walks, v)
        n_batches = math.ceil(v * cfg.walks_per_node / B)
        if self._host_feeder is None:
            self._host_feeder = HostWalkFeeder(
                self.graph, batch=B, length=cfg.walk_length, seed=cfg.seed,
                restart_prob=cfg.restart_prob, nodes=self.walk_starts,
            )
        stats = []
        for _ in range(n_batches):
            walks = jnp.asarray(next(self._host_feeder))
            self.state, loss, npairs = self._o1_walks_step_jit(
                self.state, walks
            )
            stats.append((loss, npairs))  # device values: no per-batch sync
        total_loss = float(sum(s[0] for s in stats))
        total_pairs = float(sum(s[1] for s in stats))
        self.last_o1_pairs = total_pairs
        return total_loss / max(total_pairs, 1.0)

    def _o1_walks_step(self, state: TrainState, walks: jnp.ndarray):
        """One O1 macro step from externally provided walks [B, L]."""
        cfg = self.cfg
        key, kp, kn = jax.random.split(state.key, 3)
        lr = _decayed_lr(
            state.words_seen, self.total_words, cfg.lr, cfg.min_lr
        )
        c, x, m = skipgram_pairs(walks, cfg.window, kp, self.keep)
        negs = None
        if cfg.negative_mode != "shared":
            negs = sample_alias(
                self.accept, self.alias, kn, c.shape + (cfg.negative,)
            )
        ne, ce, loss, npairs = self._sgns_microbatched(
            state.params.node_emb, state.params.ctx_emb, c, x, negs, m,
            lr, kn, tie_tables=False, compact=True,
        )
        params = state.params.replace(node_emb=ne, ctx_emb=ce)
        words = state.words_seen + jnp.float32(
            walks.shape[0] * cfg.walk_length
        )
        return TrainState(params=params, key=key, words_seen=words), loss, npairs

    # ------------------------------------------------------------- O2 (edges)

    def _star_layout(self):
        """Build (once) the star slot/meta stream and its row view.  The
        layout is static — the edge list doesn't change — and epochs
        shuffle at ROW granularity, which is exactly the granularity that
        matters under block-synchronous updates (intra-block order is
        irrelevant by construction)."""
        if not hasattr(self, "_star_rows_slots"):
            from come_tpu.sampling.stars import (
                build_star_layout,
                star_layout_stats,
            )

            u, v = self.graph.edges_undirected()
            slots, meta = build_star_layout(u, v, self.graph.num_nodes)
            st = star_layout_stats(slots, meta)
            self._star_pairs = st["pairs"]
            self._star_rows_slots = jnp.asarray(
                slots.reshape(-1, 128), jnp.int32
            )
            self._star_rows_meta = jnp.asarray(
                meta.reshape(-1, 128), jnp.int32
            )
        return self._star_rows_slots, self._star_rows_meta

    def _o2_epoch_star(
        self,
        state: TrainState,
        rows_slots: jnp.ndarray,  # [NR, 128] star layout rows
        rows_meta: jnp.ndarray,  # [NR, 128]
        pairs_per_step: float,
        steps: int,
        rows_per_step: int,
        row_block: int,
    ):
        """Star-layout O2 epoch: permute layout rows on device and scan
        macro steps through the tied banded star step
        (losses/star_banded.py), each of ``rows_per_step // row_block``
        blocks with a fresh negative pool.  Pads with self-masking rows
        (meta -2): exact zero work, no edge is retrained."""
        from come_tpu.losses.star_banded import star_banded_sgns_step

        cfg = self.cfg
        key, kperm = jax.random.split(state.key)
        NR = rows_slots.shape[0]
        perm = jax.random.permutation(kperm, NR)
        pad_rows = steps * rows_per_step - NR
        ps = jnp.pad(rows_slots[perm], ((0, pad_rows), (0, 0)))
        pm = jnp.pad(
            rows_meta[perm], ((0, pad_rows), (0, 0)), constant_values=-2
        )
        slots_all = ps.reshape(steps, rows_per_step, 128)
        meta_all = pm.reshape(steps, rows_per_step, 128)
        negw = cfg.negative / cfg.shared_negatives

        def body(carry, sm):
            params, key, words = carry
            slots_s, meta_s = sm
            key, kn = jax.random.split(key)
            lr = _decayed_lr(words, self.total_words, cfg.lr, cfg.min_lr)
            sneg = sample_alias(
                self.accept, self.alias, kn,
                (rows_per_step // row_block, cfg.shared_negatives),
            )
            ne, loss, npairs = star_banded_sgns_step(
                params.node_emb, slots_s, meta_s, sneg,
                lr * cfg.alpha, negw,
                row_block=row_block,
                mxu_bf16=cfg.walk_kernel_bf16,
                sorted_scatter=cfg.banded_sorted_scatter,
            )
            params = params.replace(node_emb=ne)
            words = words + jnp.float32(pairs_per_step)
            return (params, key, words), (loss, npairs)

        (params, key, words), (losses, npairs) = jax.lax.scan(
            body, (state.params, key, state.words_seen),
            (slots_all, meta_all),
        )
        state = TrainState(params=params, key=key, words_seen=words)
        npair = jnp.sum(npairs)
        loss = jnp.sum(losses) / jnp.maximum(npair, 1.0)
        return state, jnp.stack([loss, npair])

    # most star layout rows per synchronous block (x 128 slots)
    _STAR_ROW_BLOCK = 512

    def _star_row_block(self, rows_per_step: int) -> int:
        """Rows per star block: the fewest blocks that divide the macro
        step and keep each within _STAR_ROW_BLOCK rows and within the
        pool-stability bound.  A block of n rows trains ~n * (pairs per
        row) pairs against its pool, which hands every pool row ~that
        times negative/KP unit gradients (``banded_pool_mass``; the star
        tier's rows hold ~243 pairs each on blogcatalog)."""
        cfg = self.cfg
        per_row = self._star_pairs / max(self._star_rows_slots.shape[0], 1)
        mass_rows = int(
            cfg.banded_pool_mass * cfg.shared_negatives
            // max(cfg.negative * per_row, 1.0)
        )
        most = max(1, min(self._STAR_ROW_BLOCK, mass_rows))
        c = -(-rows_per_step // most)
        while rows_per_step % c:
            c += 1
        return rows_per_step // c

    def _use_banded_star_o2(self) -> bool:
        """Star fan-out O2 tier (losses/star_banded.py): the tied table's
        edge pass as banded matmuls, chosen when one block's synchronous
        update keeps per-row collisions bounded.  ``o2_mode="star"``
        forces it whatever ``banded`` says of O1."""
        cfg = self.cfg
        if cfg.o2_mode not in ("auto", "star", "xla"):
            raise ValueError(
                f"o2_mode must be 'auto', 'star' or 'xla'; got {cfg.o2_mode!r}"
            )
        if cfg.o2_mode == "xla" or cfg.negative_mode != "shared":
            return False
        if cfg.o2_mode == "star" or cfg.banded == "always":
            return True
        if cfg.banded == "never":
            return False
        slots = self._STAR_ROW_BLOCK * 128
        collisions = 2.0 * slots / max(self.graph.num_nodes, 1)
        return collisions <= self._COLLISION_BOUND

    def o2_tier(self) -> str:
        """Which O2 path the current config selects (for logs/tests)."""
        if self._use_banded_star_o2():
            return "banded-star"
        if self.cfg.negative_mode == "shared":
            return "xla"
        return "xla-per-pair"

    def _o2_epoch(self, state: TrainState, src: jnp.ndarray, dst: jnp.ndarray):
        """src/dst int32 [S, B]: per-step arc batches; tied-table SGNS."""
        cfg = self.cfg

        def body(carry, arc):
            params, key, words = carry
            s, d = arc
            key, kn = jax.random.split(key)
            lr = _decayed_lr(words, self.total_words, cfg.lr, cfg.min_lr)
            negs = None
            if cfg.negative_mode != "shared":
                negs = sample_alias(
                    self.accept, self.alias, kn, s.shape + (cfg.negative,)
                )
            ne, _, loss, npairs = self._sgns_microbatched(
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
            words = words + jnp.float32(s.shape[0])
            return (params, key, words), (loss, npairs)

        (params, key, words), (losses, npairs) = jax.lax.scan(
            body, (state.params, state.key, state.words_seen), (src, dst)
        )
        state = TrainState(params=params, key=key, words_seen=words)
        npair = jnp.sum(npairs)
        loss = jnp.sum(losses) / jnp.maximum(npair, 1.0)
        return state, jnp.stack([loss, npair])

    def o2_epoch(self) -> float:
        """One pass over all directed arcs (reference trains the edge list,
        SURVEY.md C7/§3.3).  The banded star tier trains both arc
        directions of every undirected edge from the star layout."""
        cfg = self.cfg
        if self._use_banded_star_o2():
            rs, rm = self._star_layout()
            if not hasattr(self, "_o2_star_jit"):
                self._o2_star_jit = jax.jit(
                    self._o2_epoch_star, donate_argnums=0,
                    static_argnums=(3, 4, 5, 6),
                )
            NR = rs.shape[0]
            # slots per macro step ~ batch_edges
            rps = max(8, min(-(-cfg.batch_edges // 128), NR))
            steps = -(-NR // rps)
            self.state, stats = self._o2_star_jit(
                self.state, rs, rm,
                float(self._star_pairs) / steps, steps, rps,
                self._star_row_block(rps),
            )
            return self._finish_o2(stats)
        e = self.graph.num_arcs
        B = min(cfg.batch_edges, e)
        S = math.ceil(e / B)
        self.host_key, k = jax.random.split(self.host_key)
        perm = jax.random.permutation(k, e)
        src = jnp.resize(self.arc_src[perm], (S, B))
        dst = jnp.resize(self.arc_dst[perm], (S, B))
        self.state, stats = self._o2_epoch_jit(self.state, src, dst)
        return self._finish_o2(stats)

    def _finish_o2(self, stats):
        self._o2_stats = stats
        if not self._sync_stats:
            return None
        return self.o2_sync()

    def o2_sync(self) -> float:
        st = np.asarray(self._o2_stats)
        self.last_o2_pairs = float(st[1])
        return float(st[0])

    # --------------------------------------------------------- O3 (community)

    def _o3_step(self, state: TrainState):
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
        return state.replace(params=p.replace(node_emb=new_emb)), loss

    def o3_pass(self) -> float:
        loss = 0.0
        for _ in range(self.cfg.o3_steps_per_iter):
            self.state, loss = self._o3_step_jit(self.state)
        return float(loss) if self._sync_stats else None

    def fit_gmm(self) -> float:
        self.host_key, k = jax.random.split(self.host_key)
        params, ll = fit_communities(
            self.state.params,
            k,
            n_init=self.cfg.gmm_n_init,
            max_iter=self.cfg.gmm_max_iter,
            reg_covar=self.cfg.reg_covar,
            tol=self.cfg.gmm_tol,
        )
        self.state = self.state.replace(params=params)
        return float(ll) if self._sync_stats else None

    # ----------------------------------------------------------------- driver

    def train(
        self,
        labels: np.ndarray | None = None,
        log: Callable[[str], None] | None = None,
        checkpoint_dir: str | None = None,
        scalar_log=None,
    ) -> list[dict]:
        """Full alternating optimization (reference main.py loop, §3.1).

        ``checkpoint_dir``: saves ``state_iter{N}.npz`` after every outer
        iteration (the reference pickled its Model per iteration, SURVEY.md
        C10).  ``scalar_log``: optional metrics.ScalarLog sink.
        """
        import time as _time

        cfg = self.cfg
        say = log or (lambda s: None)
        for e in range(cfg.pretrain_epochs):
            loss = self.o1_epoch()
            say(f"pretrain O1 epoch {e}: loss/pair {loss:.4f}")

        def timed(rec, name, fn):
            # per-phase wall ms (SURVEY §5 observability: per-step scalars
            # incl. where the iteration time goes); valid because each
            # phase returns a host float when stats_sync is on
            t0 = _time.perf_counter()
            out = fn()
            rec[f"{name}_ms"] = round((_time.perf_counter() - t0) * 1e3, 2)
            return out

        for it in range(cfg.outer_iters):
            rec: dict = {"iter": it}
            rec["gmm_ll"] = timed(rec, "gmm", self.fit_gmm)
            for _ in range(cfg.o1_epochs_per_iter):
                rec["o1_loss"] = timed(rec, "o1", self.o1_epoch)
            for _ in range(cfg.o2_epochs_per_iter):
                rec["o2_loss"] = timed(rec, "o2", self.o2_epoch)
            rec["o3_loss"] = timed(rec, "o3", self.o3_pass)
            if labels is not None:
                from come_tpu.evaluation import nmi_score

                rec["nmi"] = nmi_score(labels, self.communities())
            say(
                f"iter {it}: "
                + ", ".join(
                    f"{k}={v:.4f}" for k, v in rec.items() if k != "iter"
                )
            )
            if scalar_log is not None:
                scalar_log.log(it, **{k: v for k, v in rec.items()})
            if checkpoint_dir:
                from pathlib import Path

                cd = Path(checkpoint_dir)
                cd.mkdir(parents=True, exist_ok=True)
                self.save_checkpoint(cd / f"state_iter{it}.npz")
            self._history.append(rec)
        return self._history

    # ----------------------------------------------------------- persistence

    def save_checkpoint(self, path) -> None:
        from come_tpu.iohelpers import save_checkpoint

        save_checkpoint(path, self.state, host_key=self.host_key)

    def load_checkpoint(self, path) -> None:
        from come_tpu.iohelpers import load_checkpoint, load_host_key

        self.state = load_checkpoint(path)
        hk = load_host_key(path)
        if hk is not None:  # bit-exact resume incl. walk/edge permutations
            self.host_key = hk

    # ------------------------------------------------------------------ views

    def embeddings(self) -> np.ndarray:
        return np.asarray(self.state.params.node_emb)

    def communities(self) -> np.ndarray:
        """argmax responsibilities — the reference's NMI input (§3.5)."""
        return np.asarray(jnp.argmax(self.state.params.pi, axis=1))
