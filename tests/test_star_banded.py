"""Banded-star O2 tier (HBM tied table) vs a numpy block oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from come_tpu.config import ComEConfig
from come_tpu.graphs import sbm_graph
from come_tpu.losses.star_banded import star_banded_sgns_step
from come_tpu.sampling.stars import PAD_META, build_star_layout
from come_tpu.trainer import ComETrainer


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def ref_block(emb, slots, meta, pool, lr, negw):
    """One block applied via scatter-ADD (duplicates combine — the XLA
    scatter semantics, unlike the fused kernel's sequential RMW); pool
    rows gathered fresh at block start, pool gradient applied second."""
    S = slots.size
    phi = emb[slots.reshape(S)].reshape(slots.shape + (emb.shape[1],))
    cneg = emb[pool].copy()
    seg = meta >> 1
    hub = meta & 1
    m = (
        (seg[:, :, None] == seg[:, None, :])
        & ((hub[:, :, None] ^ hub[:, None, :]) == 1)
    ).astype(np.float32)
    s = np.einsum("brd,bsd->brs", phi, phi)
    g = (_sig(s) - 1.0) * m
    loss = -np.sum(m * np.log(np.maximum(_sig(s), 1e-30)))
    n_t = m.sum(2)
    d_phi = np.einsum("brs,bsd->brd", g, phi)
    d_phi += np.einsum("bsr,bsd->brd", g, phi)  # context side, tied
    sn = np.einsum("brd,kd->brk", phi, cneg)
    gn = _sig(sn) * (negw * n_t[:, :, None])
    loss += -negw * np.sum(n_t[:, :, None] * np.log(np.maximum(_sig(-sn), 1e-30)))
    d_phi += np.einsum("brk,kd->brd", gn, cneg)
    d_cneg = np.einsum("brk,brd->kd", gn, phi)
    np.add.at(emb, slots.reshape(S), -lr * d_phi.reshape(S, -1))
    np.add.at(emb, pool, -lr * d_cneg)
    return loss, float(n_t.sum())


def _layout_rows(rng, V, E):
    seen, u, v = set(), [], []
    while len(u) < E:
        a, b = rng.integers(0, V, 2)
        if a == b or (min(a, b), max(a, b)) in seen:
            continue
        seen.add((min(a, b), max(a, b)))
        u.append(a)
        v.append(b)
    s, m = build_star_layout(
        np.asarray(u, np.int64), np.asarray(v, np.int64), V
    )
    return s.reshape(-1, 128), m.reshape(-1, 128)


def test_star_banded_matches_block_oracle(rng):
    V, d, KP = 90, 32, 16
    emb = rng.normal(size=(V, d)).astype(np.float32) * 0.1
    slots, meta = _layout_rows(rng, V, 300)
    pool = rng.integers(0, V, KP).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    ne, loss, npairs = star_banded_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pool), lr, negw, row_block=slots.shape[0],
        mxu_bf16=False,
    )
    e = emb.copy()
    rloss, rn = ref_block(e, slots, meta, pool, lr, negw)
    assert float(npairs) == rn == 600.0
    np.testing.assert_allclose(float(loss), rloss, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ne), e, rtol=1e-3, atol=2e-5)


def test_star_banded_blocks_sequential(rng):
    """row_block smaller than the input: block 1 must see block 0's
    updates and re-gather the pool fresh."""
    V, d, KP = 90, 32, 8
    emb = rng.normal(size=(V, d)).astype(np.float32) * 0.1
    slots, meta = _layout_rows(rng, V, 600)
    NR = slots.shape[0]
    assert NR >= 4
    Bc = NR // 2
    pool = rng.integers(0, V, KP).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    ne, loss, npairs = star_banded_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pool), lr, negw, row_block=Bc, mxu_bf16=False,
    )
    e = emb.copy()
    total = 0.0
    for b in range(-(-NR // Bc)):
        sl = slots[b * Bc : (b + 1) * Bc]
        mt = meta[b * Bc : (b + 1) * Bc]
        if sl.shape[0] < Bc:  # step pads with inert rows
            pad = Bc - sl.shape[0]
            sl = np.pad(sl, ((0, pad), (0, 0)))
            mt = np.pad(mt, ((0, pad), (0, 0)), constant_values=PAD_META)
        lg, _ = ref_block(e, sl, mt, pool, lr, negw)
        total += lg
    np.testing.assert_allclose(float(loss), total, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ne), e, rtol=1e-3, atol=3e-5)


def test_trainer_selects_banded_star_and_trains():
    """banded='always' routes O2 through the HBM star tier on CPU; exact
    pair counts, finite decreasing loss, proximity quality."""
    g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    cfg = ComEConfig(
        dim=32, num_communities=4, walk_length=16, walks_per_node=2,
        window=4, negative_mode="shared", shared_negatives=128,
        banded="always", batch_walks=32,
        batch_edges=4096, outer_iters=0,
        # non-zero LR-decay word budget (we only drive o2_epoch directly)
        pretrain_epochs=8,
    )
    t = ComETrainer(g, cfg)
    assert t.o2_tier() == "banded-star"
    first = t.o2_epoch()
    e2 = len(g.edges_undirected()[0])
    assert t.last_o2_pairs == 2 * e2, (t.last_o2_pairs, e2)
    losses = [t.o2_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    emb = np.asarray(t.state.params.node_emb)
    assert np.abs(emb).max() < 10.0
    u, v = g.edges_undirected()
    norm = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    r = np.random.default_rng(0)
    ru = r.integers(0, g.num_nodes, len(u))
    rv = r.integers(0, g.num_nodes, len(u))
    edge_sim = float(np.mean(np.sum(norm[u] * norm[v], axis=1)))
    rand_sim = float(np.mean(np.sum(norm[ru] * norm[rv], axis=1)))
    assert edge_sim > rand_sim + 0.1, (edge_sim, rand_sim)


@pytest.mark.parametrize("d,row_block", [(32, 2), (128, 3)])
def test_star_banded_matches_sequential_oracle(rng, d, row_block):
    """Multi-block star step vs the block-sequential oracle at d=128."""
    from come_tpu.evaluation.oracle import star_banded_sequential

    V, KP = 120, 16
    emb = (rng.normal(size=(V, d)) * 0.1 / np.sqrt(d / 32)).astype(
        np.float32
    )
    slots, meta = _layout_rows(rng, V, 900)
    NR = slots.shape[0]
    pad = -NR % row_block  # whole blocks; pad rows self-mask
    slots = np.pad(slots, ((0, pad), (0, 0)))
    meta = np.pad(meta, ((0, pad), (0, 0)), constant_values=PAD_META)
    pool = rng.integers(0, V, KP).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ne, loss, npairs = star_banded_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pool), lr, negw, row_block=row_block, mxu_bf16=False,
    )
    o_e, o_loss, o_np = star_banded_sequential(
        emb, slots, meta, pool, negw, lr, block_rows=row_block
    )
    assert float(npairs) == o_np == 1800.0
    np.testing.assert_allclose(float(loss), o_loss, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ne), o_e, rtol=1e-3, atol=2e-5)


def test_star_banded_bf16_close_to_f32(rng):
    V, d, KP = 150, 128, 32
    emb = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32) * 0.05)
    slots, meta = _layout_rows(rng, V, 600)
    pool = jnp.asarray(rng.integers(0, V, KP), jnp.int32)
    f, b = (
        star_banded_sgns_step(
            emb, jnp.asarray(slots), jnp.asarray(meta), pool, 0.025,
            5.0 / KP, row_block=2, mxu_bf16=bf16,
        )
        for bf16 in (False, True)
    )
    assert b[0].dtype == jnp.float32
    assert float(f[2]) == float(b[2])
    scale = float(jnp.max(jnp.abs(f[0] - emb)))
    assert float(jnp.max(jnp.abs(b[0] - f[0]))) < 0.05 * scale


@pytest.mark.parametrize("d,row_block", [(32, 2), (128, 3)])
def test_star_banded_fresh_pool_per_block(rng, d, row_block):
    """[G, KP] pools: block g draws its negatives from pool g, as the
    trainer's O2 epoch feeds it (one fresh pool per block)."""
    from come_tpu.evaluation.oracle import star_banded_sequential

    V, KP = 120, 16
    emb = (rng.normal(size=(V, d)) * 0.1 / np.sqrt(d / 32)).astype(
        np.float32
    )
    slots, meta = _layout_rows(rng, V, 900)
    G = -(-slots.shape[0] // row_block)
    pools = rng.integers(0, V, (G, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ne, loss, npairs = star_banded_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pools), lr, negw, row_block=row_block, mxu_bf16=False,
    )
    o_e, o_loss, o_np = star_banded_sequential(
        emb, slots, meta, pools, negw, lr, block_rows=row_block
    )
    assert float(npairs) == o_np == 1800.0
    np.testing.assert_allclose(float(loss), o_loss, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ne), o_e, rtol=1e-3, atol=2e-5)
    # one shared pool is a different step
    one, _, _ = star_banded_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pools[0]), lr, negw, row_block=row_block,
        mxu_bf16=False,
    )
    assert float(jnp.max(jnp.abs(one - ne))) > 1e-4
    with pytest.raises(ValueError, match="per-block pools"):
        star_banded_sgns_step(
            jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
            jnp.asarray(pools[:-1]), lr, negw, row_block=row_block,
        )


@pytest.mark.parametrize(
    "kp,mass,rows_per_step",
    [(128, 275, 32), (16, 275, 32), (128, 40, 64), (2048, 275, 2048),
     (4, 1, 24)],
)
def test_star_row_block_bounds_pool_mass(kp, mass, rows_per_step):
    """The star block is the largest divisor of the macro step that keeps
    one pool's gradient mass (pairs x negative / KP) within
    banded_pool_mass and the block within _STAR_ROW_BLOCK rows."""
    g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    cfg = ComEConfig(
        dim=16, num_communities=4, negative_mode="shared",
        shared_negatives=kp, banded_pool_mass=mass,
    )
    t = ComETrainer(g, cfg)
    t._star_layout()
    per_row = t._star_pairs / t._star_rows_slots.shape[0]

    def ok(b):
        fits = b * per_row * cfg.negative / kp <= mass or b == 1
        return rows_per_step % b == 0 and b <= t._STAR_ROW_BLOCK and fits

    rb = t._star_row_block(rows_per_step)
    assert ok(rb)
    assert not any(ok(b) for b in range(rb + 1, rows_per_step + 1))
