"""Tier selection and the walk-banded O1 tier through both trainers.

Tier choice depends only on the input size, the config and the collision
envelope (summed updates per table row from one synchronous block), so the
same rules hold on the CPU as on the GPU.
"""

import jax
import numpy as np
import pytest

from come_tpu.config import ComEConfig
from come_tpu.evaluation import nmi_score
from come_tpu.graphs import sbm_graph
from come_tpu.parallel import ShardedComETrainer, make_mesh
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


def _graph(v, seed=0):
    return sbm_graph(v, 4, avg_degree=6.0, seed=seed)[0]


def test_banded_selected_and_trains():
    g, labels = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    t = ComETrainer(g, _cfg())
    assert t.o1_tier() == "banded"
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5


def test_tiny_graph_falls_back():
    from come_tpu.config import get_config
    from come_tpu.graphs import get_dataset

    ds = get_dataset("karate")
    cfg = get_config("karate").replace(negative_mode="shared")
    t = ComETrainer(ds.graph, cfg)
    assert not t._use_banded()  # collision gate
    assert t.o1_tier() == "xla"


# collisions = 2 * bc * L * (W+1)/2 / V with L=16, W=4: 80 * bc / V; auto
# halves the block until it is <= 16, but not below 8 walks
@pytest.mark.parametrize(
    "v,batch_walks,expected,block",
    [
        (512, 32, "banded", 32),  # 5
        (512, 128, "banded", 64),  # 20 > 16, halved: 10
        (2048, 128, "banded", 128),  # 5
        (640, 128, "banded", 128),  # 16, inclusive bound
        (64, 8, "banded", 8),  # 10
        (64, 32, "banded", 8),  # 40, 20, then 10
        (32, 32, "xla", 0),  # 80, 40, 20; 4 walks is below the floor
    ],
)
def test_o1_tier_selection_single_device(v, batch_walks, expected, block):
    t = ComETrainer(_graph(v), _cfg(batch_walks=batch_walks))
    assert t.o1_tier() == expected
    assert t._banded_block(batch_walks) == block


# walks per pool = mass * KP // (L * (W+1) * negative)
@pytest.mark.parametrize(
    "kw,per_pool,block,chunks",
    [
        # blogcatalog preset widths: 275 * 512 // 4400 = 32 walks, so a
        # 128-walk block draws 4 fresh pools
        (dict(walk_length=80, window=10, shared_negatives=512), 32, 128, 4),
        # synthetic-10m preset widths: 128 walks per pool
        (dict(walk_length=80, window=10, shared_negatives=2048), 128, 1024,
         8),
        # the chunk count rounds up to a divisor of the block
        (dict(shared_negatives=128), 88, 96, 2),
        (dict(shared_negatives=128), 88, 90, 2),
        (dict(shared_negatives=128), 88, 7, 1),
        (dict(shared_negatives=4, banded_pool_mass=1), 1, 12, 12),
    ],
)
def test_pool_chunks_bound_pool_mass(kw, per_pool, block, chunks):
    t = ComETrainer(_graph(512), _cfg(**kw))
    assert t._walks_per_pool() == per_pool
    c = t._pool_chunks(block)
    assert c == chunks and block % c == 0
    assert block // c <= per_pool or c == block


@pytest.mark.parametrize(
    "shape,v,expected",
    [
        ((1, 1), 512, "banded-dp"),  # bc 32: 80*32/512 = 5
        ((4, 1), 512, "banded-dp"),  # bc 8, 4 workers: 5
        ((8, 1), 512, "banded-dp"),  # bc 4, 8 workers: 5
        ((2, 2), 512, "banded-rowsharded"),  # bc 8, 4 workers: 5
        ((2, 2), 64, "xla-a2a"),  # 40 > 16
        ((4, 1), 64, "xla-psum"),  # 40 > 16
    ],
)
def test_o1_tier_selection_mesh(shape, v, expected):
    d, m = shape
    mesh = make_mesh(data=d, model=m, devices=jax.devices()[: d * m])
    t = ShardedComETrainer(_graph(v), _cfg(), mesh)
    assert t.o1_tier() == expected


# star collisions = 2 * 512 rows * 128 slots / V: the bound is V = 8192
@pytest.mark.parametrize(
    "v,kw,expected",
    [
        (8192, {}, "banded-star"),
        (8191, {}, "xla"),
        (8192, {"o2_mode": "xla"}, "xla"),
        (8192, {"banded": "never"}, "xla"),
        (8192, {"negative_mode": "per_pair"}, "xla-per-pair"),
        (64, {"banded": "always"}, "banded-star"),
        # o2_mode forces the O2 tier whatever banded says of O1
        (8192, {"banded": "never", "o2_mode": "star"}, "banded-star"),
        (64, {"o2_mode": "star"}, "banded-star"),
        (8192, {"banded": "always", "o2_mode": "xla"}, "xla"),
    ],
)
def test_o2_tier_selection(v, kw, expected):
    t = ComETrainer(_graph(v), _cfg(**kw))
    assert t.o2_tier() == expected


def test_o2_mode_rejects_unknown():
    t = ComETrainer(_graph(64), _cfg(o2_mode="paired"))
    with pytest.raises(ValueError, match="o2_mode"):
        t.o2_tier()


def test_default_exchange_is_a2a_at_model_gt_1():
    """row_exchange='auto' (the default) resolves to the bucketed a2a on
    any model>1 mesh — the row-sharded banded tier is what a user gets
    with no flags (VERDICT r2 next-round item 1)."""
    g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    assert ComEConfig().row_exchange == "auto"
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, _cfg(), mesh)  # default exchange
    assert t.row_exchange == "a2a"
    assert t.o1_tier() == "banded-rowsharded"
    # model=1 meshes don't need (or build) the exchange machinery
    mesh1 = make_mesh(data=4, model=1, devices=jax.devices()[:4])
    t1 = ShardedComETrainer(g, _cfg(), mesh1)
    assert t1.row_exchange == "psum"
    assert t1._perm is None


def test_collision_envelope_boundary():
    """Pin the stability-envelope threshold: collisions_per_row <= 16 with
    collisions = 2 * Bc * L * (W+1)/2 / V.  At L=16, W=4, Bc=8 the bound
    flips exactly at V = 40."""
    gb, _ = sbm_graph(40, 4, p_in=0.3, p_out=0.05, seed=0)
    tb = ComETrainer(gb, _cfg(banded_walk_block=8))
    assert tb._use_banded()  # collisions == 16.0, inclusive bound
    gs, _ = sbm_graph(39, 3, p_in=0.3, p_out=0.05, seed=0)
    ts = ComETrainer(gs, _cfg(num_communities=3, banded_walk_block=8))
    assert not ts._use_banded()  # 16.4 > 16: rejected


def test_o2_kernel_gate_falls_back():
    """Tiny graphs (collision envelope) and per-pair mode use the flat
    O2 paths, not the banded star tier, and still train."""
    g, _ = sbm_graph(64, 4, p_in=0.3, p_out=0.02, seed=0)
    t = ComETrainer(g, _cfg())
    assert not t._use_banded_star_o2()  # V=64 < collision bound
    assert np.isfinite(t.o2_epoch())
    g2, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    t2 = ComETrainer(g2, _cfg(negative_mode="per_pair", negative=3))
    assert t2.o2_tier() == "xla-per-pair"
    assert np.isfinite(t2.o2_epoch())


def test_o2_kernel_mesh_gates():
    """O2 mesh tiers: the bucketed a2a at model>1, psum when asked for,
    per-pair mode on the per-pair path, psum at model=1."""
    g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, _cfg(row_exchange="psum"), mesh)
    assert t.o2_tier() == "xla-psum"
    assert np.isfinite(t.o2_epoch())
    t2 = ShardedComETrainer(
        g, _cfg(negative_mode="per_pair", negative=3), mesh
    )
    assert t2.o2_tier() == "xla-per-pair"
    t3 = ShardedComETrainer(g, _cfg(o2_mode="xla"), mesh)
    assert t3.o2_tier() == "xla-a2a"
    mesh_dp = make_mesh(data=4, model=1, devices=jax.devices()[:4])
    t4 = ShardedComETrainer(g, _cfg(), mesh_dp)
    assert t4.o2_tier() == "xla-psum"


def test_down_sample_tier_downgrade_warns():
    """down_sample > 0 gates out the banded O1 tier — that must be LOUD
    (VERDICT r4 item 6), and the XLA fallback must still train."""
    import warnings

    g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t = ComETrainer(g, _cfg(down_sample=1e-3, banded="always"))
    assert any("down_sample" in str(x.message) for x in w), [
        str(x.message) for x in w
    ]
    assert not t._use_banded()
    # O2 doesn't subsample (edge pass trains every arc), so its banded
    # tier stays eligible
    assert t._use_banded_star_o2()
    assert np.isfinite(t.o1_epoch())


def test_isolated_nodes_never_walked_or_updated():
    """Graphs with isolated nodes (the dblp stand-in has 11) must not
    blow up: the reference's random_walk yields a length-1 walk there
    (zero trainable pairs), while a static-shape stationary walk would
    sum ~L*W identical self-pair updates per block and measurably
    diverge (norms 1e3+ then GMM NaN — the round-5 EVAL-sweep find).
    Start filtering restores reference semantics; isolated rows carry
    zero unigram mass, so their rows must stay EXACTLY at init."""
    from come_tpu.graphs import CSRGraph

    g0, _ = sbm_graph(496, 4, p_in=0.2, p_out=0.01, seed=3)
    # append 16 isolated nodes
    V = g0.num_nodes + 16
    indptr = np.concatenate(
        [g0.indptr, np.full(16, g0.indptr[-1], g0.indptr.dtype)]
    )
    g = CSRGraph(indptr=indptr, indices=g0.indices)
    assert g.num_nodes == V
    t = ComETrainer(g, _cfg())
    assert len(t.walk_starts) == g0.num_nodes
    assert t._use_banded()
    init = np.asarray(t.state.params.node_emb)[g0.num_nodes:].copy()
    for _ in range(4):
        loss = t.o1_epoch()
        assert np.isfinite(loss)
    t.o2_epoch()
    emb = np.asarray(t.state.params.node_emb)
    ctx = np.asarray(t.state.params.ctx_emb)
    assert np.isfinite(emb).all() and np.isfinite(ctx).all()
    assert np.abs(emb).max() < 10.0 and np.abs(ctx).max() < 10.0
    # isolated rows: no walks, no edges, no negative-sampling mass
    np.testing.assert_array_equal(emb[g0.num_nodes:], init)
    np.testing.assert_array_equal(ctx[g0.num_nodes:], 0.0)
