"""ComE parameter pytree without flax: jit, donation, functional replace."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from come_tpu.models import ComEParams, init_params
from come_tpu.trainer import TrainState


def _state():
    p = init_params(12, dim=8, num_communities=3, key=jax.random.key(0))
    return TrainState(params=p, key=jax.random.key(1),
                      words_seen=jnp.zeros((), jnp.float32))


def test_params_replace_is_functional():
    p = _state().params
    q = p.replace(pi=p.pi * 2.0)
    assert isinstance(q, ComEParams)
    np.testing.assert_allclose(np.asarray(q.pi), 2.0 * np.asarray(p.pi))
    assert q.node_emb is p.node_emb  # untouched leaves are shared
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.pi = q.pi
    assert (p.num_nodes, p.dim, p.num_communities) == (12, 8, 3)


def test_state_pytree_under_jit():
    st = _state()
    leaves = jax.tree_util.tree_leaves(st)
    assert len(leaves) == 8  # six tables + key + word counter

    @jax.jit
    def step(s):
        p = s.params.replace(node_emb=s.params.node_emb + 1.0)
        return s.replace(params=p, words_seen=s.words_seen + 3.0)

    out = step(st)
    assert isinstance(out, TrainState)
    np.testing.assert_allclose(
        np.asarray(out.params.node_emb), np.asarray(st.params.node_emb) + 1.0
    )
    assert float(out.words_seen) == 3.0


def test_state_donation_consumes_inputs():
    st = _state()
    ref = np.asarray(st.params.ctx_emb) + 2.0
    step = jax.jit(
        lambda s: s.replace(
            params=s.params.replace(ctx_emb=s.params.ctx_emb + 2.0)
        ),
        donate_argnums=0,
    )
    out = step(st)
    np.testing.assert_allclose(np.asarray(out.params.ctx_emb), ref)
    # CPU honours donation: the donated buffers are gone
    assert st.params.ctx_emb.is_deleted()
