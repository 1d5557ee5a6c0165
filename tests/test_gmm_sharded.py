"""Distributed GMM EM vs the single-device fit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from come_tpu.losses.gmm import gmm_em_fit, gmm_em_fit_sharded
from come_tpu.parallel import make_mesh


def _blobs(rng, n_per=64, K=2, d=4, spread=4.0):
    means = rng.normal(size=(K, d)) * spread
    X = np.concatenate(
        [rng.normal(size=(n_per, d)) * 0.5 + means[k] for k in range(K)]
    ).astype(np.float32)
    labels = np.repeat(np.arange(K), n_per)
    perm = rng.permutation(len(X))
    return X[perm], labels[perm]


def test_sharded_em_recovers_blobs(rng):
    mesh = make_mesh(data=2, model=4)
    X, labels = _blobs(rng)  # 128 rows, divisible by 4
    mask = np.ones(len(X), np.float32)

    def body(x, m, key):
        out = gmm_em_fit_sharded(x, m, 2, key, axis="model", n_init=2,
                                 max_iter=30, reg_covar=1e-4)
        return out["resp"], out["means"], out["log_likelihood"]

    resp, means, ll = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("model", None), P("model"), P()),
            out_specs=(P("model", None), P(), P()),
            check_vma=False,
        )
    )(jnp.asarray(X), jnp.asarray(mask), jax.random.key(0))

    pred = np.asarray(resp).argmax(1)
    from come_tpu.evaluation import nmi_score

    assert nmi_score(labels, pred) > 0.95
    assert np.isfinite(float(ll))
    # close to the single-device fit's likelihood
    ref = gmm_em_fit(jnp.asarray(X), 2, jax.random.key(0), n_init=2,
                     max_iter=30, reg_covar=1e-4)
    assert float(ll) > float(ref["log_likelihood"]) - 0.1


def test_sharded_em_both_axes_recovers_blobs(rng):
    """EM partitioned over BOTH mesh axes (VERDICT r3 item 2): each data
    replica works a chunk of its model shard, moments psum over the whole
    mesh.  Must recover the blobs and match the model-axis-only fit's
    likelihood (same init draw — the global center id space is chunking-
    independent)."""
    mesh = make_mesh(data=4, model=2)
    X, labels = _blobs(rng)  # 128 rows: model shards 64, chunks 16
    mask = np.ones(len(X), np.float32)

    def body(x, m, key):
        out = gmm_em_fit_sharded(x, m, 2, key, axis="model", n_init=2,
                                 max_iter=30, reg_covar=1e-4,
                                 data_axis="data")
        return out["resp"], out["means"], out["log_likelihood"]

    resp, means, ll = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("model", None), P("model"), P()),
            out_specs=(P("model", None), P(), P()),
            check_vma=False,
        )
    )(jnp.asarray(X), jnp.asarray(mask), jax.random.key(0))

    pred = np.asarray(resp).argmax(1)
    from come_tpu.evaluation import nmi_score

    assert nmi_score(labels, pred) > 0.95
    ref = gmm_em_fit(jnp.asarray(X), 2, jax.random.key(0), n_init=2,
                     max_iter=30, reg_covar=1e-4)
    assert float(ll) > float(ref["log_likelihood"]) - 0.1


def test_sharded_em_both_axes_uneven_chunks(rng):
    """Vl not divisible by the data axis: zero-weight chunk padding must
    not perturb the fit (moments identical to the model-axis-only run up
    to reduction order)."""
    mesh = make_mesh(data=4, model=2)
    X, labels = _blobs(rng, n_per=61)  # 122 rows -> model shards of 61,
    mask = np.ones(len(X), np.float32)  # chunks of 16 with 3 pad rows

    def body(dax, x, m, key):
        out = gmm_em_fit_sharded(x, m, 2, key, axis="model", n_init=1,
                                 max_iter=30, reg_covar=1e-4,
                                 data_axis=dax)
        return out["means"], out["log_likelihood"]

    def run(dax):
        import functools

        return jax.jit(
            jax.shard_map(
                functools.partial(body, dax),
                mesh=mesh,
                in_specs=(P("model", None), P("model"), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )
        )(jnp.asarray(X), jnp.asarray(mask), jax.random.key(2))

    means_b, ll_b = run("data")
    means_m, ll_m = run(None)
    np.testing.assert_allclose(
        np.asarray(means_b), np.asarray(means_m), atol=1e-3
    )
    assert abs(float(ll_b) - float(ll_m)) < 1e-3


def test_sharded_em_masks_pad_rows(rng):
    mesh = make_mesh(data=2, model=4)
    X, labels = _blobs(rng, n_per=62)  # 124 rows -> pad 4 to 128
    Xp = np.concatenate([X, 77.0 * np.ones((4, 4), np.float32)])
    mask = np.concatenate([np.ones(124, np.float32), np.zeros(4, np.float32)])

    def body(x, m, key):
        out = gmm_em_fit_sharded(x, m, 2, key, axis="model", n_init=1,
                                 max_iter=30, reg_covar=1e-4)
        return out["means"]

    means = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("model", None), P("model"), P()),
            out_specs=P(),
            check_vma=False,
        )
    )(jnp.asarray(Xp), jnp.asarray(mask), jax.random.key(1))
    # the outlier pad rows at 77 must not pull any mean
    assert float(jnp.abs(means).max()) < 20.0
