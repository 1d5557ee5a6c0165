"""Bucketed all-to-all row exchange (parallel/exchange.py) on the CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from come_tpu.parallel import make_mesh
from come_tpu.parallel.exchange import (
    interleave_permutation,
    make_exchange_plan,
)


def test_exchange_gather_matches_dense(rng):
    """Exact-capacity exchange == plain table[idx], per (data,model) device."""
    mesh = make_mesh(data=2, model=4)
    V, d, B = 32, 8, 24
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, (2, 4, B)).astype(np.int32)

    def body(tab, ix):
        ix = ix.reshape(B)
        plan = make_exchange_plan(ix, V // 4, capacity=B)
        rows = plan.gather(tab)
        return rows[None, None], plan.served.reshape(1, 1, B)

    rows, served = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(P("model", None), P("data", "model", None)),
            out_specs=(
                P("data", "model", None, None), P("data", "model", None)
            ),
            check_vma=False,
        )
    )(jnp.asarray(table), jnp.asarray(idx))
    assert np.asarray(served).all()
    rows = np.asarray(rows)
    for di in range(2):
        for mi in range(4):
            np.testing.assert_allclose(
                rows[di, mi], table[idx[di, mi]], atol=1e-6
            )


def test_exchange_scatter_matches_dense(rng):
    mesh = make_mesh(data=2, model=4)
    V, d, B = 32, 8, 24
    idx = rng.integers(0, V, (2, 4, B)).astype(np.int32)
    upd = rng.normal(size=(2, 4, B, d)).astype(np.float32)

    def body(ix, up):
        ix = ix.reshape(B)
        up = up.reshape(B, d)
        plan = make_exchange_plan(ix, V // 4, capacity=B)
        delta = plan.scatter_add(jnp.zeros((V // 4, d), jnp.float32), up)
        return jax.lax.psum(delta, "data")

    delta = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(P("data", "model", None), P("data", "model", None, None)),
            out_specs=P("model", None),
            check_vma=False,
        )
    )(jnp.asarray(idx), jnp.asarray(upd))
    oracle = np.zeros((V, d), np.float32)
    for di in range(2):
        for mi in range(4):
            np.add.at(oracle, idx[di, mi], upd[di, mi])
    np.testing.assert_allclose(np.asarray(delta), oracle, atol=1e-5)


def test_overflow_reported_not_corrupted(rng):
    """Tiny capacity: unserved ids come back zero + served=False; served
    ids are still exact."""
    mesh = make_mesh(data=2, model=4)
    V, d, B, C = 32, 8, 16, 2
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = np.zeros((2, 4, B), np.int32)  # all ids on shard 0 -> overflow
    idx[..., :] = rng.integers(0, V // 4, (2, 4, B))

    def body(tab, ix):
        ix = ix.reshape(B)
        plan = make_exchange_plan(ix, V // 4, capacity=C)
        rows = plan.gather(tab)
        return rows[None, None], plan.served.reshape(1, 1, B)

    rows, served = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(P("model", None), P("data", "model", None)),
            out_specs=(
                P("data", "model", None, None), P("data", "model", None)
            ),
            check_vma=False,
        )
    )(jnp.asarray(table), jnp.asarray(idx))
    rows, served = np.asarray(rows), np.asarray(served)
    assert served.sum() == 2 * 4 * C  # exactly capacity per device
    for di in range(2):
        for mi in range(4):
            for b in range(B):
                if served[di, mi, b]:
                    np.testing.assert_allclose(
                        rows[di, mi, b], table[idx[di, mi, b]], atol=1e-6
                    )
                else:
                    np.testing.assert_allclose(rows[di, mi, b], 0.0)


def test_interleave_permutation_stripes():
    perm = interleave_permutation(10, 4)
    assert sorted(perm) == list(range(10))
    # ids congruent mod 4 land in one contiguous stripe
    by_new = np.argsort(perm)  # new -> old
    assert list(by_new[:3]) == [0, 4, 8]


def test_csr_permute_roundtrip():
    from come_tpu.graphs import sbm_graph

    g, _ = sbm_graph(48, 4, p_in=0.3, p_out=0.05, seed=0)
    perm = interleave_permutation(48, 4)
    gp = g.permute(perm)
    assert gp.num_nodes == g.num_nodes
    assert gp.num_arcs == g.num_arcs
    np.testing.assert_array_equal(gp.degrees[perm], g.degrees)
    # neighbor sets map through the permutation
    for v in (0, 7, 23):
        np.testing.assert_array_equal(
            np.sort(perm[g.neighbors(v)]), np.sort(gp.neighbors(perm[v]))
        )


def test_sharded_a2a_trains_and_matches_quality():
    """Full sharded trainer with row_exchange='a2a' on a (2,4) mesh."""
    from come_tpu.config import ComEConfig
    from come_tpu.evaluation import nmi_score
    from come_tpu.graphs import sbm_graph
    from come_tpu.parallel import ShardedComETrainer

    g, labels = sbm_graph(256, 4, p_in=0.25, p_out=0.02, seed=1)
    cfg = ComEConfig(
        dim=16,
        num_communities=4,
        walk_length=12,
        walks_per_node=2,
        window=3,
        negative_mode="shared",
        shared_negatives=64,
        row_exchange="a2a",
        banded="never",
        batch_walks=64,
        batch_edges=512,
        batch_pairs=1024,
        lr=0.05,
        outer_iters=1,
        pretrain_epochs=5,
        gmm_max_iter=15,
        reg_covar=1e-2,
    )
    mesh = make_mesh(data=2, model=4)
    t = ShardedComETrainer(g, cfg, mesh)
    assert t._perm is not None
    first = t.o1_epoch()
    for _ in range(4):
        last = t.o1_epoch()
    assert np.isfinite(first) and last < first
    t.o2_epoch()  # tied-table a2a path
    t.fit_gmm()
    t.o3_pass()
    assert nmi_score(labels, t.communities()) > 0.5
    assert t.embeddings().shape == (256, 16)
