"""Vectorized skip-gram window-pair extraction.

Replacement for the reference's per-sentence Python/Cython window
loop (reference ``utils/training_sdg_inner.pyx`` center/context iteration
[R], SURVEY.md C1/§3.2).  Walks ``[B, L]`` become dense pair tensors
``centers/contexts/mask [B, L, 2W]`` with static shapes: invalid pairs are
masked, not dropped, so the whole pipeline stays jit-compatible.

Semantics matched to the gensim-lineage kernel:
  * reduced window: per center position draw ``b ~ U{0..W-1}``; only offsets
    with ``|o| <= W - b`` are trained (same marginal distribution as the
    reference's ``random % window`` shrink).
  * frequent-node subsampling: occurrences are dropped i.i.d. with the
    word2vec keep-probability.  NOTE (documented semantic difference,
    SURVEY.md §7 hard part 1): the reference *removes* dropped words from the
    sentence so windows span across them; we *mask* the pair instead, which
    keeps shapes static.  With the default ``sample=0`` both are identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def subsample_keep_probs(degrees: np.ndarray, sample: float) -> np.ndarray:
    """word2vec keep-probability per node (1.0 when sample<=0).

    Reference ``ADSCModel/model.py::precalc_sampling`` analog [R, SURVEY.md
    C5]: p_keep = min(1, sqrt(t/f) + t/f) with f the corpus frequency.
    """
    deg = np.asarray(degrees, np.float64)
    total = deg.sum()
    if sample <= 0 or total == 0:
        return np.ones(len(deg), np.float32)
    f = deg / total
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.sqrt(sample / f) + sample / f
    p = np.where(f > 0, np.minimum(p, 1.0), 1.0)
    return p.astype(np.float32)


def skipgram_pairs(
    walks: jnp.ndarray,
    window: int,
    key: jax.Array,
    keep_probs: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Expand walks into (center, context, mask) pair tensors.

    Args:
      walks: int32 [B, L].
      window: max window W (reference default 10).
      key: PRNG key (reduced-window + subsampling draws).
      keep_probs: optional f32 [V] per-node keep probability.

    Returns:
      centers  int32 [B, L, 2W] (center id broadcast over offsets)
      contexts int32 [B, L, 2W]
      mask     bool  [B, L, 2W]
    """
    B, L = walks.shape
    W = int(window)
    k_red, k_keep = jax.random.split(key)

    # context lookup via a padded shift: padded[:, t + o + W] == walk[t + o]
    padded = jnp.pad(walks, ((0, 0), (W, W)), constant_values=0)
    offsets = [o for o in range(-W, W + 1) if o != 0]
    contexts = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(padded, o + W, L, axis=1) for o in offsets],
        axis=-1,
    )  # [B, L, 2W]

    pos = jnp.arange(L)[None, :, None]  # center position t
    off = jnp.asarray(offsets)[None, None, :]
    in_range = (pos + off >= 0) & (pos + off < L)

    # reduced window: b ~ U{0..W-1}, train offsets |o| <= W - b
    b = jax.random.randint(k_red, (B, L, 1), 0, W, dtype=jnp.int32)
    in_window = jnp.abs(off) <= (W - b)

    mask = in_range & in_window
    centers = jnp.broadcast_to(walks[:, :, None], contexts.shape)

    if keep_probs is not None:
        u = jax.random.uniform(k_keep, (B, L), dtype=jnp.float32)
        kept = u < keep_probs[walks]  # [B, L] per-occurrence keep
        kept_ctx = jnp.stack(
            [
                jax.lax.dynamic_slice_in_dim(
                    jnp.pad(kept, ((0, 0), (W, W)), constant_values=False),
                    o + W,
                    L,
                    axis=1,
                )
                for o in offsets
            ],
            axis=-1,
        )
        mask = mask & kept[:, :, None] & kept_ctx

    return centers, contexts, mask
