"""Host-corpus (C++ feeder) training mode."""

import numpy as np
import pytest

from come_tpu.config import get_config
from come_tpu.evaluation import nmi_score
from come_tpu.graphs import get_dataset
from come_tpu.native import native_available
from come_tpu.trainer import ComETrainer

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable"
)


def test_host_corpus_o1_trains_karate():
    ds = get_dataset("karate")
    # pretrain_epochs sizes the LR-decay word budget for the manual calls
    cfg = get_config("karate").replace(
        corpus="host", outer_iters=0, pretrain_epochs=6
    )
    t = ComETrainer(ds.graph, cfg)
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(5)]
    assert losses[-1] < first
    t.fit_gmm()
    assert nmi_score(ds.labels, t.communities()) > 0.2
    t._host_feeder.close()


def test_host_corpus_full_loop():
    ds = get_dataset("karate")
    cfg = get_config("karate").replace(
        corpus="host", outer_iters=1, pretrain_epochs=2
    )
    t = ComETrainer(ds.graph, cfg)
    hist = t.train(labels=ds.labels)
    assert np.isfinite(hist[-1]["o1_loss"])
    assert hist[-1]["nmi"] > 0.3
    t._host_feeder.close()


def test_host_corpus_sharded_mesh():
    """corpus='host' under a (2,2) mesh (VERDICT r3 item 6): the
    per-process feeder fills the data shards (single process here: one
    feeder covering all rows), batches train through the sharded
    from-walks path, loss decreases, replicas stay consistent."""
    import jax

    from come_tpu.config import ComEConfig
    from come_tpu.evaluation import nmi_score
    from come_tpu.graphs import sbm_graph
    from come_tpu.parallel import ShardedComETrainer, make_mesh

    g, labels = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    cfg = ComEConfig(
        dim=128, num_communities=4, walk_length=16, walks_per_node=2,
        window=4, negative_mode="shared", shared_negatives=128,
        corpus="host", batch_walks=64, batch_pairs=4096,
        outer_iters=0, pretrain_epochs=8, reg_covar=1e-2, gmm_max_iter=20,
    )
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, cfg, mesh)
    assert t.o1_tier() == "banded-rowsharded"
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    assert t.last_o1_served == 1.0
    # each model shard's replicas bit-identical across 'data'
    by_index: dict = {}
    for s in t.state.params.node_emb.addressable_shards:
        key = str(s.index)
        if key in by_index:
            np.testing.assert_array_equal(by_index[key], np.asarray(s.data))
        else:
            by_index[key] = np.asarray(s.data)
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5
    t._host_feeder.close()


def test_feeder_node_subset_and_determinism():
    """The feeder's `nodes` subset restricts start nodes, and two feeders
    with the same seed/subset produce identical batches (the property the
    mesh trainer relies on for model-axis process splits, which must
    supply identical replica values)."""
    from come_tpu.graphs import sbm_graph
    from come_tpu.native import HostWalkFeeder

    g, _ = sbm_graph(64, 2, p_in=0.3, p_out=0.05, seed=0)
    nodes = np.arange(10, 30, dtype=np.int32)
    f1 = HostWalkFeeder(g, batch=16, length=8, seed=5, nodes=nodes)
    f2 = HostWalkFeeder(g, batch=16, length=8, seed=5, nodes=nodes)
    for _ in range(4):
        b1, b2 = next(f1), next(f2)
        np.testing.assert_array_equal(b1, b2)
        assert set(b1[:, 0]) <= set(nodes.tolist())
    f1.close()
    f2.close()
