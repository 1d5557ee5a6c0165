"""Banded XLA SGNS (the large-V HBM tier) vs a per-pair numpy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from come_tpu.losses.sgns_banded import (
    banded_block_grads,
    banded_walk_sgns_step,
)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _oracle_block(emb_in, emb_out, walks, pool, wrow, negw):
    """Promoted to evaluation/oracle.py (walk_banded_shared_pool_grads);
    kept as a thin alias so the banded tests and the parity harness share
    ONE definition of the fast path's expected gradients."""
    from come_tpu.evaluation.oracle import walk_banded_shared_pool_grads

    return walk_banded_shared_pool_grads(
        emb_in, emb_out, walks, pool, wrow, negw
    )


@pytest.mark.parametrize(
    "W,d", [(1, 8), (3, 8), (3, 128)], ids=["1", "3", "3-d128"]
)
def test_banded_block_grads_match_oracle(rng, W, d):
    V, B, L, KP = 30, 3, 7, 4
    emb_in = rng.normal(size=(V, d)).astype(np.float32) * 0.3
    emb_out = rng.normal(size=(V, d)).astype(np.float32) * 0.3
    walks = rng.integers(0, V, size=(B, L)).astype(np.int32)
    pool = rng.integers(0, V, size=(KP,)).astype(np.int32)
    wrow = rng.integers(1, W + 1, size=(B, L)).astype(np.int32)
    negw = 5.0 / KP

    phi = jnp.asarray(emb_in)[jnp.asarray(walks)]
    ctx = jnp.asarray(emb_out)[jnp.asarray(walks)]
    cneg = jnp.asarray(emb_out)[jnp.asarray(pool)]
    loss, npairs, (d_phi, d_ctx, d_cneg) = banded_block_grads(
        phi, ctx, cneg, jnp.asarray(wrow), negw
    )

    o_loss, o_npairs, o_din, o_dout = _oracle_block(
        emb_in, emb_out, walks, pool, wrow, negw
    )

    # fold the per-slot/per-pool gradients back to full tables
    d_in = np.zeros_like(emb_in)
    np.add.at(d_in, walks.reshape(-1), np.asarray(d_phi).reshape(-1, d))
    d_out = np.zeros_like(emb_out)
    np.add.at(d_out, walks.reshape(-1), np.asarray(d_ctx).reshape(-1, d))
    np.add.at(d_out, pool, np.asarray(d_cneg))

    assert int(npairs) == o_npairs
    np.testing.assert_allclose(float(loss), o_loss, rtol=2e-5)
    np.testing.assert_allclose(d_in, o_din, atol=2e-5)
    np.testing.assert_allclose(d_out, o_dout, atol=2e-5)


def test_step_blocks_apply_sequentially(rng):
    """A 2-block step == two single-block steps applied in sequence."""
    V, d, L, Bc = 25, 8, 6, 4
    emb_in = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32) * 0.3)
    emb_out = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32) * 0.3)
    walks = jnp.asarray(rng.integers(0, V, size=(2 * Bc, L)), jnp.int32)
    pool = jnp.asarray(rng.integers(0, V, size=(6,)), jnp.int32)
    key = jax.random.key(0)

    a_in, a_out, a_loss, a_np = banded_walk_sgns_step(
        emb_in, emb_out, walks, pool, 0.05, 0.5, key,
        window=2, walk_block=Bc, reduced_window=False, mxu_bf16=False,
    )
    # sequential single blocks (same full-window draw => same math)
    b_in, b_out = emb_in, emb_out
    tot_loss = tot_np = 0.0
    for blk in (walks[:Bc], walks[Bc:]):
        b_in, b_out, ls, n = banded_walk_sgns_step(
            b_in, b_out, blk, pool, 0.05, 0.5, key,
            window=2, walk_block=Bc, reduced_window=False, mxu_bf16=False,
        )
        tot_loss += float(ls)
        tot_np += float(n)
    np.testing.assert_allclose(np.asarray(a_in), np.asarray(b_in), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a_out), np.asarray(b_out), atol=1e-5)
    np.testing.assert_allclose(float(a_loss), tot_loss, rtol=1e-5)
    assert float(a_np) == tot_np


def test_sorted_scatter_matches_plain(rng):
    V, d, L = 20, 8, 6
    emb_in = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32) * 0.3)
    emb_out = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32) * 0.3)
    walks = jnp.asarray(rng.integers(0, V, size=(8, L)), jnp.int32)
    pool = jnp.asarray(rng.integers(0, V, size=(5,)), jnp.int32)
    key = jax.random.key(1)
    outs = []
    for srt in (True, False):
        outs.append(
            banded_walk_sgns_step(
                emb_in, emb_out, walks, pool, 0.05, 1.0, key,
                window=2, walk_block=4, mxu_bf16=False, sorted_scatter=srt,
            )
        )
    np.testing.assert_allclose(
        np.asarray(outs[0][0]), np.asarray(outs[1][0]), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(outs[0][1]), np.asarray(outs[1][1]), atol=1e-5
    )


def test_trainer_banded_path_trains():
    """Force the banded tier through the trainer on an SBM; NMI improves."""
    from come_tpu.config import ComEConfig
    from come_tpu.evaluation import nmi_score
    from come_tpu.graphs import sbm_graph
    from come_tpu.trainer import ComETrainer

    g, labels = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    cfg = ComEConfig(
        dim=32,
        num_communities=4,
        walk_length=16,
        walks_per_node=2,
        window=4,
        negative_mode="shared",
        shared_negatives=128,
        banded="always",
        banded_walk_block=32,
        batch_walks=128,
        batch_edges=1024,
        lr=0.05,
        outer_iters=0,
        pretrain_epochs=8,
        gmm_max_iter=20,
        reg_covar=1e-2,
    )
    t = ComETrainer(g, cfg)
    assert t._use_banded()
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5


def test_chunked_pools_match_composed_oracle(rng):
    """[C, KP] pool sub-chunks per block: each chunk's walks train
    against ONLY their own fresh pool — equivalent to running C smaller
    single-pool blocks from the same table state, with one combined
    scatter.  (The stability form: bounded per-application pool mass at
    full positive-pass block size.)"""
    import jax.numpy as jnp

    from come_tpu.losses.sgns_banded import (
        banded_walk_sgns_step_packed,
        pack_tables,
        unpack_tables,
    )

    V, d, KP, Bc, L, W, C = 120, 16, 8, 8, 10, 3, 2
    ei = rng.normal(size=(V, d)).astype(np.float32) * 0.2
    eo = rng.normal(size=(V, d)).astype(np.float32) * 0.2
    walks = rng.integers(0, V, (Bc, L)).astype(np.int32)
    pools = rng.integers(0, V, (1, C, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    combo, loss, npairs = banded_walk_sgns_step_packed(
        pack_tables(jnp.asarray(ei), jnp.asarray(eo)),
        jnp.asarray(walks), jnp.asarray(pools), lr, negw,
        jax.random.key(0), window=W, walk_block=Bc,
        reduced_window=False, mxu_bf16=False,
    )
    ni, no = unpack_tables(combo)

    # composed oracle: C sub-blocks from the SAME start state, updates
    # summed (one scatter application)
    e_in, e_out = ei.copy(), eo.copy()
    total_loss, total_np = 0.0, 0.0
    d_in = np.zeros_like(ei)
    d_out = np.zeros_like(eo)
    wrow = np.full((Bc, L), W, np.int32)
    for c in range(C):
        sl = slice(c * (Bc // C), (c + 1) * (Bc // C))
        ol, onp_, odin, odout = _oracle_block(
            ei, eo, walks[sl], pools[0, c], wrow[sl], negw
        )
        total_loss += ol
        total_np += onp_
        d_in += odin
        d_out += odout
    e_in -= lr * d_in
    e_out -= lr * d_out
    assert float(npairs) == total_np
    np.testing.assert_allclose(float(loss), total_loss, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ni), e_in, rtol=1e-3, atol=3e-5)
    np.testing.assert_allclose(np.asarray(no), e_out, rtol=1e-3, atol=3e-5)


@pytest.mark.parametrize("d,blocks,per_block_pools", [
    (8, 2, True), (128, 4, True), (128, 3, False),
])
def test_step_matches_sequential_oracle(rng, d, blocks, per_block_pools):
    """Multi-block step (blocks apply in order, each gathering the pool
    rows fresh and applying its pool gradient last) vs the composed
    sequential oracle — with a fresh pool per block or one shared set of
    pool ids."""
    from come_tpu.evaluation.oracle import walk_banded_sequential

    V, L, Bc, KP, W = 60, 10, 4, 16, 3
    ei = rng.normal(size=(V, d)).astype(np.float32) * (0.3 / np.sqrt(d / 8))
    eo = rng.normal(size=(V, d)).astype(np.float32) * (0.3 / np.sqrt(d / 8))
    walks = rng.integers(0, V, (blocks * Bc, L)).astype(np.int32)
    shape = (blocks, KP) if per_block_pools else (KP,)
    pools = rng.integers(0, V, shape).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ni, no, loss, npairs = banded_walk_sgns_step(
        jnp.asarray(ei), jnp.asarray(eo), jnp.asarray(walks),
        jnp.asarray(pools), lr, negw, jax.random.key(0), window=W,
        walk_block=Bc, reduced_window=False, mxu_bf16=False,
    )
    o_i, o_o, o_loss, o_np = walk_banded_sequential(
        ei, eo, walks, pools, np.full(walks.shape, W, np.int32), negw, lr,
        Bc,
    )
    assert float(npairs) == o_np
    np.testing.assert_allclose(float(loss), o_loss, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ni), o_i, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(no), o_o, rtol=1e-4, atol=2e-5)


def test_banded_bf16_close_to_f32(rng):
    """bf16 matmuls (f32 accumulation, f32 tables) stay close to the f32
    step at d=128, and the tables keep their f32 dtype."""
    V, d, L, KP = 200, 128, 20, 64
    ei = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32) * 0.05)
    eo = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32) * 0.05)
    walks = jnp.asarray(rng.integers(0, V, (16, L)), jnp.int32)
    pool = jnp.asarray(rng.integers(0, V, KP), jnp.int32)
    outs = [
        banded_walk_sgns_step(
            ei, eo, walks, pool, 0.025, 5.0 / KP, jax.random.key(0),
            window=5, walk_block=8, mxu_bf16=bf16,
        )
        for bf16 in (False, True)
    ]
    (fi, fo, fl, fn), (bi, bo, bl, bn) = outs
    assert bi.dtype == bo.dtype == jnp.float32
    assert float(fn) == float(bn)
    scale = float(jnp.max(jnp.abs(fi - ei)))
    assert float(jnp.max(jnp.abs(bi - fi))) < 0.05 * scale
    assert float(jnp.max(jnp.abs(bo - fo))) < 0.05 * float(
        jnp.max(jnp.abs(fo - eo))
    )
    np.testing.assert_allclose(float(bl), float(fl), rtol=1e-2)


@pytest.mark.parametrize("d,blocks", [(16, 1), (128, 1), (128, 3)])
def test_rowsharded_step_matches_oracle(rng, d, blocks):
    """The (2,2)-mesh row-sharded banded step (bucketed a2a exchange) vs
    block oracles composed as the mesh applies them — one block, or
    several blocks in order, each with its own fresh pool."""
    from come_tpu.evaluation.parity import rowsharded_parity

    V, L, KP, W, lr = 90, 12, 16, 3, 0.025
    ei = (rng.normal(size=(V, d)) * 0.3 / np.sqrt(d / 16)).astype(np.float32)
    eo = (rng.normal(size=(V, d)) * 0.3 / np.sqrt(d / 16)).astype(np.float32)
    err, scale, loss_rel = rowsharded_parity(
        ei, eo, rng, 4, L, KP, W, lr, 5.0 / KP, blocks=blocks
    )
    assert err < 5e-4 + 1e-3 * scale, (err, scale)
    assert loss_rel < 1e-4
