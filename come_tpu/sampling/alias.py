"""On-device negative sampling via Walker's alias method.

Replacement for the reference's unigram^0.75 negative-sampling
*table* (reference ``ADSCModel/model.py::make_table`` [R], SURVEY.md C5).
gensim-lineage code materializes an O(10^8)-entry int table and indexes it
with ``random % table_size``; here we build O(V) alias arrays once on the
host and draw exact samples with two gathers + one select per draw — same
distribution, 1000x less memory, fully vectorized.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def unigram_weights(degrees: np.ndarray, power: float = 0.75) -> np.ndarray:
    """The reference's noise distribution: degree^0.75 (word2vec unigram)."""
    w = np.asarray(degrees, np.float64) ** power
    s = w.sum()
    if s <= 0:
        return np.full(len(w), 1.0 / max(len(w), 1))
    return w / s


def build_alias_table(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walker '74 / Vose alias construction. Host-side, O(V).

    Returns (accept f32 [V], alias int32 [V]): draw u ~ U{0..V-1},
    v ~ U[0,1); the sample is ``u if v < accept[u] else alias[u]``.
    """
    probs = np.asarray(probs, np.float64)
    n = len(probs)
    scaled = probs * n / probs.sum()
    accept = np.zeros(n, np.float32)
    alias = np.zeros(n, np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        accept[i] = 1.0
        alias[i] = i
    return accept, alias


def sample_alias(accept, alias, key, shape) -> jnp.ndarray:
    """Draw ``shape`` samples on device: 2 gathers + a select per draw."""
    n = accept.shape[0]
    k1, k2 = jax.random.split(key)
    u = jax.random.randint(k1, shape, 0, n, dtype=jnp.int32)
    v = jax.random.uniform(k2, shape, dtype=jnp.float32)
    return jnp.where(v < accept[u], u, alias[u])
