"""Sharded training on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from come_tpu.config import get_config
from come_tpu.evaluation import nmi_score
from come_tpu.graphs import get_dataset
from come_tpu.parallel import MeshLayout, ShardedComETrainer, make_mesh
from come_tpu.parallel.sharded import owned_scatter_add, psum_gather


@pytest.fixture(scope="module")
def karate():
    return get_dataset("karate")


def test_make_mesh_shapes():
    m = make_mesh(data=4, model=2)
    assert m.shape == {"data": 4, "model": 2}
    m = make_mesh(model=2)
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_mesh(data=3, model=3)


def test_psum_gather_matches_dense(rng):
    """Masked-gather + psum over 'model' == plain table[idx]."""
    mesh = make_mesh(data=2, model=4)
    V, d = 32, 8
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, 40).astype(np.int32)

    def body(tab, ix):
        return psum_gather(tab, ix)

    out = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("model", None), P()),
            out_specs=P(),
            check_vma=False,
        )
    )(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_allclose(np.asarray(out), table[idx], atol=1e-6)


def test_owned_scatter_matches_dense(rng):
    mesh = make_mesh(data=2, model=4)
    V, d = 32, 8
    idx = rng.integers(0, V, 40).astype(np.int32)
    upd = rng.normal(size=(40, d)).astype(np.float32)

    def body(ix, up):
        delta = jnp.zeros((V // 4, d), jnp.float32)
        return owned_scatter_add(delta, ix, up)

    out = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=P("model", None),
            check_vma=False,
        )
    )(jnp.asarray(idx), jnp.asarray(upd))
    ref = np.zeros((V, d), np.float32)
    np.add.at(ref, idx, upd)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_karate_trains(karate, shape):
    mesh = make_mesh(data=shape[0], model=shape[1])
    cfg = get_config("karate").replace(
        outer_iters=1, pretrain_epochs=2, walks_per_node=4
    )
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    first = t.o1_epoch()
    second = t.o1_epoch()
    assert np.isfinite(first) and np.isfinite(second)
    assert second < first
    hist = t.train(labels=karate.labels)
    assert np.isfinite(hist[-1]["o3_loss"])
    assert hist[-1]["nmi"] > 0.3, hist


def test_sharded_shared_negatives_mode(karate):
    """Shared-negative (matmul) path under the (data, model) mesh."""
    mesh = make_mesh(data=2, model=4)
    cfg = get_config("karate").replace(
        outer_iters=1, pretrain_epochs=2, negative_mode="shared",
        shared_negatives=32, walks_per_node=4,
    )
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    first = t.o1_epoch()
    second = t.o1_epoch()
    assert np.isfinite(first) and second < first
    hist = t.train(labels=karate.labels)
    assert np.isfinite(hist[-1]["o2_loss"])
    assert hist[-1]["nmi"] > 0.3, hist
    # pad rows still untouched in shared mode
    assert np.all(np.asarray(t.state.params.node_emb[34:]) == 0)


def test_sharded_padding_rows_untouched(karate):
    """With model=4, V=34 pads to 36; pad rows must receive no updates."""
    mesh = make_mesh(data=2, model=4)
    cfg = get_config("karate").replace(outer_iters=0, pretrain_epochs=1)
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    assert t.v_pad == 36
    before = np.asarray(t.state.params.node_emb[34:])
    t.o1_epoch()
    t.o2_epoch()
    after = np.asarray(t.state.params.node_emb[34:])
    np.testing.assert_array_equal(before, after)


def test_sharded_o2_and_o3(karate):
    mesh = make_mesh(data=4, model=2)
    cfg = get_config("karate").replace(outer_iters=1, pretrain_epochs=1)
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    t.o1_epoch()
    l2 = t.o2_epoch()
    assert np.isfinite(l2)
    t.fit_gmm()
    l3 = t.o3_pass()
    assert np.isfinite(l3)


def test_sharded_determinism_same_seed(karate):
    """Same seed => bitwise-equal tables (SURVEY §5: determinism for free)."""
    mesh = make_mesh(data=4, model=2)
    cfg = get_config("karate").replace(outer_iters=0, pretrain_epochs=2)
    a = ShardedComETrainer(karate.graph, cfg, mesh)
    a.o1_epoch()
    a.o2_epoch()
    b = ShardedComETrainer(karate.graph, cfg, mesh)
    b.o1_epoch()
    b.o2_epoch()
    np.testing.assert_array_equal(a.embeddings(), b.embeddings())


def test_sharded_tables_replicas_consistent(karate):
    """After training, the data-axis replicas of each table shard agree."""
    mesh = make_mesh(data=4, model=2)
    cfg = get_config("karate").replace(outer_iters=0, pretrain_epochs=1)
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    t.o1_epoch()
    emb = t.state.params.node_emb
    # materializing through np.asarray would already fail if replicas
    # disagreed under a fully-addressable sharding; also check shard bufs
    shards = emb.addressable_shards
    by_index: dict = {}
    for s in shards:
        key = str(s.index)
        if key in by_index:
            np.testing.assert_array_equal(by_index[key], np.asarray(s.data))
        else:
            by_index[key] = np.asarray(s.data)
    assert len(by_index) == 2  # two model shards


def test_sharded_checkpoint_roundtrip(tmp_path, karate):
    """save_checkpoint_sharded / load_checkpoint_sharded on a (2,2) mesh:
    per-process shard files, bit-exact restore, resumed epoch runs."""
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    cfg = get_config("karate").replace(outer_iters=0, pretrain_epochs=1)
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    t.o1_epoch()
    t.save_checkpoint(tmp_path / "state")
    assert (tmp_path / "state.proc0.npz").exists()
    t2 = ShardedComETrainer(karate.graph, cfg, mesh)
    t2.load_checkpoint(tmp_path / "state")
    for a, b in zip(
        jax.tree.leaves(t.state.params), jax.tree.leaves(t2.state.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(t.state.words_seen), np.asarray(t2.state.words_seen)
    )
    # restored sharding matches the layout and training continues
    assert (
        t2.state.params.node_emb.sharding == t.state.params.node_emb.sharding
    )
    # host_key is restored from the checkpoint (walk/edge permutation
    # stream) — the continuation is bit-exact with NO manual alignment
    assert t.o1_epoch() == t2.o1_epoch()


@pytest.mark.parametrize("new_shape", [(1, 4), (4, 1), (1, 1)])
def test_elastic_checkpoint_restore(tmp_path, karate, new_shape):
    """ELASTIC restore (VERDICT r3 item 7): save on a (2,2) mesh, restore
    onto a different mesh shape.  The logical (original-node-id) state
    must transfer exactly — embeddings/communities identical — despite
    different model-axis padding and a2a interleave permutations, and
    training must continue finite."""
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    cfg = get_config("karate").replace(outer_iters=0, pretrain_epochs=1)
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    t.o1_epoch()
    t.fit_gmm()
    t.save_checkpoint(tmp_path / "state")

    d, m = new_shape
    mesh2 = make_mesh(data=d, model=m, devices=jax.devices()[: d * m])
    t2 = ShardedComETrainer(karate.graph, cfg, mesh2)
    t2.load_checkpoint(tmp_path / "state")
    # logical state transfers exactly (embeddings() inverts each
    # trainer's own interleave)
    np.testing.assert_array_equal(t.embeddings(), t2.embeddings())
    np.testing.assert_array_equal(t.communities(), t2.communities())
    np.testing.assert_array_equal(
        np.asarray(t.state.words_seen), np.asarray(t2.state.words_seen)
    )
    assert np.isfinite(t2.o1_epoch())


def test_elastic_restore_psum_checkpoint(tmp_path, karate):
    """Round-4 review finding (confirmed): a checkpoint saved with
    row_exchange='psum' at model>1 keeps ORIGINAL row order (no a2a
    interleave); the elastic loader used to invert the interleave
    unconditionally from the mesh shape and silently scrambled the
    embeddings.  The interleave flag now rides the checkpoint metadata."""
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    cfg = get_config("karate").replace(
        outer_iters=0, pretrain_epochs=1, row_exchange="psum"
    )
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    assert t._perm is None
    t.o1_epoch()
    t.save_checkpoint(tmp_path / "state")
    # cross-shape elastic restore: logical state must transfer exactly
    mesh1 = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    t2 = ShardedComETrainer(karate.graph, cfg, mesh1)
    t2.load_checkpoint(tmp_path / "state")
    np.testing.assert_array_equal(t.embeddings(), t2.embeddings())
    # SAME mesh shape but a2a (interleaved) layout: must route through
    # the elastic re-permutation, not the direct shard restore
    cfg_a2a = cfg.replace(row_exchange="a2a")
    t3 = ShardedComETrainer(karate.graph, cfg_a2a, mesh)
    assert t3._perm is not None
    t3.load_checkpoint(tmp_path / "state")
    np.testing.assert_array_equal(t.embeddings(), t3.embeddings())


def test_same_proc_count_mesh_change_refused_without_elastic(
    tmp_path, karate
):
    """The non-elastic loader must REFUSE a same-process-count restore
    onto a different mesh shape (it used to restore silently wrong rows —
    the interleave depends on the model-axis size)."""
    from come_tpu.iohelpers import load_checkpoint_sharded
    from come_tpu.parallel import MeshLayout

    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    cfg = get_config("karate").replace(outer_iters=0, pretrain_epochs=1)
    t = ShardedComETrainer(karate.graph, cfg, mesh)
    t.save_checkpoint(tmp_path / "state")
    mesh2 = make_mesh(data=1, model=4, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="elastic"):
        load_checkpoint_sharded(tmp_path / "state", MeshLayout(mesh2))


def test_train_logs_phase_ms(karate):
    """train() records per-phase wall-ms scalars (SURVEY §5 metrics row)."""
    cfg = get_config("karate").replace(outer_iters=1, pretrain_epochs=0)
    from come_tpu.trainer import ComETrainer

    hist = ComETrainer(karate.graph, cfg).train()
    rec = hist[-1]
    for k in ("gmm_ms", "o1_ms", "o2_ms", "o3_ms"):
        assert rec[k] > 0
