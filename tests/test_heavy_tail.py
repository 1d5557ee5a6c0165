"""Heavy-tailed (power-law) degree stress tests.

The plain SBM stand-ins have near-uniform binomial degrees; the reference's
real datasets (BlogCatalog max-degree/mean ~ 60x, Flickr worse — SURVEY.md
C13) are heavy-tailed.  Power-law skew is what stresses negative-sampling
weight skew, walk-occupancy concentration on hubs, and the a2a
bucket-capacity envelopes (VERDICT r2 missing #1's "works on SBM, breaks on
power-law reality" risk).  These tests run every tier on a degree-corrected
SBM whose hubs dominate the walk stream.
"""

import numpy as np

from come_tpu.config import ComEConfig
from come_tpu.evaluation import nmi_score
from come_tpu.graphs import dc_sbm_graph
from come_tpu.trainer import ComETrainer


def _cfg(**kw):
    base = dict(
        dim=128,
        num_communities=4,
        walk_length=16,
        walks_per_node=2,
        window=4,
        negative_mode="shared",
        shared_negatives=128,
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


def _graph(seed=3):
    return dc_sbm_graph(
        512, 4, avg_degree=16.0, exponent=2.2, assortativity=30.0, seed=seed
    )


def test_dc_sbm_is_heavy_tailed():
    g, labels = _graph()
    deg = np.asarray(g.degrees, np.float64)
    assert (deg > 0).all()  # CSR walkable everywhere
    # the tail must be real: hubs an order of magnitude above the median
    assert deg.max() / max(np.median(deg), 1.0) > 8.0
    assert np.bincount(labels).min() > 0


def test_banded_trains_on_heavy_tail():
    """Single-device banded tier: hubs flood the walk stream and the
    shared negative pool is drawn from a very skewed unigram^0.75 table —
    loss must still fall and communities must still separate."""
    g, labels = _graph()
    t = ComETrainer(g, _cfg())
    assert t.o1_tier() == "banded"
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5


def test_rowsharded_a2a_heavy_tail_capacity():
    """Micro-batched a2a tier on the power-law graph: hub rows are
    requested by many workers at once, which is exactly what the bucketed
    a2a's capacity envelope (cap = B/M * slack) must absorb.  With the
    default slack the exchange must serve EVERY pair (served == 1.0, no
    silent drops) and train to finite, decreasing loss."""
    import jax

    from come_tpu.parallel import ShardedComETrainer, make_mesh

    g, labels = _graph()
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, _cfg(banded="never"), mesh)
    assert ComEConfig().a2a_capacity_slack == 2.0  # default envelope
    assert t.o1_tier() == "xla-a2a"
    first = t.o1_epoch()
    assert np.isfinite(first)
    assert t.last_o1_served == 1.0
    losses = [t.o1_epoch() for _ in range(5)]
    assert losses[-1] < first
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5


def test_banded_rowsharded_heavy_tail():
    """Large-V banded tier under the same hub pressure (HBM tables, XLA)."""
    import jax

    from come_tpu.parallel import ShardedComETrainer, make_mesh

    g, _ = _graph()
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(
        g, _cfg(banded="always", banded_walk_block=8), mesh
    )
    assert t.o1_tier() == "banded-rowsharded"
    first = t.o1_epoch()
    assert np.isfinite(first)
    assert t.last_o1_served == 1.0
    losses = [t.o1_epoch() for _ in range(3)]
    assert losses[-1] < first
