"""Banded-XLA tier (HBM tables, large-V) under the ('data','model') mesh.

VERDICT r1 item 2: BASELINE config 5 (edge-partitioned multi-host on the
synthetic 10M-edge graph, V=500k) is multi-chip x large-V, which needs the
banded formulation — not the flat micro-batched path — to run under the
mesh.  These tests pin both sharded banded tiers (data-parallel
sum-of-deltas and row-sharded bucketed-a2a) on the virtual CPU mesh.
"""

import jax
import numpy as np
import pytest

from come_tpu.config import ComEConfig
from come_tpu.evaluation import nmi_score
from come_tpu.graphs import sbm_graph
from come_tpu.parallel import ShardedComETrainer, make_mesh


def _cfg(**kw):
    base = dict(
        dim=32,
        num_communities=4,
        walk_length=16,
        walks_per_node=2,
        window=4,
        negative_mode="shared",
        shared_negatives=128,
        banded="always",
        banded_walk_block=8,
        batch_walks=32,
        batch_edges=1024,
        batch_pairs=4096,
        lr=0.025,
        outer_iters=0,
        pretrain_epochs=8,
        gmm_max_iter=20,
        reg_covar=1e-2,
    )
    base.update(kw)
    return ComEConfig(**base)


@pytest.fixture(scope="module")
def sbm512():
    return sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)


def test_banded_dp_tier_trains(sbm512):
    """model=1: packed banded step per data shard, deltas psum'd."""
    g, labels = sbm512
    mesh = make_mesh(data=4, model=1, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, _cfg(), mesh)
    assert t.o1_tier() == "banded-dp"
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    assert t.last_o1_served == 1.0
    # replicas bit-identical across 'data'
    shards = [
        np.asarray(s.data)
        for s in t.state.params.node_emb.addressable_shards
    ]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5


def test_banded_rowsharded_tier_trains(sbm512):
    """model>1: per-block bucketed a2a over row-sharded packed tables."""
    g, labels = sbm512
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, _cfg(row_exchange="a2a"), mesh)
    assert t.o1_tier() == "banded-rowsharded"
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    assert t.last_o1_served == 1.0
    assert np.abs(t.embeddings()).max() < 10.0
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5


def test_banded_rowsharded_needs_a2a(sbm512):
    """model>1 banded requires the bucketed a2a exchange (psum falls back
    to the flat micro-batched path)."""
    g, _ = sbm512
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, _cfg(row_exchange="psum"), mesh)
    assert t.o1_tier() == "xla-psum"
    assert np.isfinite(t.o1_epoch())


def test_banded_selected_at_large_v():
    """A V=65536 graph selects the banded tier under a (2,2) mesh with
    banded="auto" and executes one epoch (VERDICT r1 item 2's acceptance
    shape, scaled for the CPU-mesh suite)."""
    g, _ = sbm_graph(65536, 8, avg_degree=8.0, seed=5)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    cfg = _cfg(
        dim=128,
        num_communities=8,
        walks_per_node=1,
        walk_length=8,
        window=2,
        batch_walks=8192,  # 8 scan steps over the 65k starts
        banded_walk_block=512,
        pretrain_epochs=1,
        banded="auto",
        row_exchange="a2a",
    )
    t2 = ShardedComETrainer(g, cfg, mesh)
    assert t2.o1_tier() == "banded-rowsharded"
    loss = t2.o1_epoch()
    assert np.isfinite(loss)
    assert t2.last_o1_served == 1.0
