"""Fused on-device random-walk generation.

Replacement for the reference's walk-corpus machinery
(``utils/graph_utils.py::random_walk / build_deepwalk_corpus /
write_walks_to_disk / combine_files_iter`` [R], SURVEY.md C3): instead of a
``multiprocessing.Pool`` streaming walk text files to disk, a batch of walks
``[B, L]`` is produced by one ``lax.scan`` of flat CSR gathers directly on
device — no host round-trip, no disk, regenerated fresh every step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from come_tpu.graphs.csr import DeviceCSR


def random_walks(
    csr: DeviceCSR,
    start_nodes: jnp.ndarray,
    length: int,
    key: jax.Array,
    restart_prob: float = 0.0,
) -> jnp.ndarray:
    """Uniform truncated random walks.

    Args:
      csr: device CSR graph.
      start_nodes: int32 [B] walk origins.
      length: walk length L (reference default 80).
      key: PRNG key.
      restart_prob: per-step probability of restarting at the origin
        (the reference ``random_walk``'s ``alpha``; default 0).

    Returns:
      int32 [B, L] node ids; isolated nodes self-loop in place.

    One step is three flat gathers (degree, offset, neighbor) + a uniform
    draw, vectorized over the whole batch — this is exactly the layout CSR
    was chosen for (static shapes, no per-node Python).
    """
    start_nodes = start_nodes.astype(jnp.int32)
    B = start_nodes.shape[0]
    # ALL the epoch's randomness in one vectorized threefry call instead
    # of a split+uniform per step
    ubits = jax.random.bits(key, (length - 1, B), jnp.uint32)
    if restart_prob > 0.0:
        rbits = jax.random.bits(
            jax.random.fold_in(key, 1), (length - 1, B), jnp.uint32
        )
        rthresh = jnp.uint32(min(restart_prob, 1.0) * 4294967295.0)
        xs_all = (ubits, rbits)
    else:
        xs_all = (ubits, ubits)  # unused second stream

    def step(carry, xs):
        v = carry
        bits, rb = xs
        if csr.ptr_deg is not None:
            # one two-lane gather yields (row offset, degree) together —
            # the walker's cost is per-step gather latency, so fusing the
            # two element gathers into one row gather is a direct win
            pd = csr.ptr_deg[v]
            lo, deg = pd[..., 0], pd[..., 1]
        else:
            deg = csr.degrees[v]
            lo = csr.indptr[v]
        # top 24 bits -> u in [0, 1); floor(u * deg) is uniform for
        # deg < 2^24 (f32-exact)
        u = (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
            1.0 / (1 << 24)
        )
        r = jnp.minimum((u * deg.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(deg - 1, 0))
        nxt = csr.indices[lo + r]
        nxt = jnp.where(deg > 0, nxt, v)  # isolated nodes stay put
        if restart_prob > 0.0:
            nxt = jnp.where(rb < rthresh, start_nodes, nxt)
        return nxt, v

    # unroll: each scan step is ~3 tiny gathers whose cost is per-step
    # sequencing latency, not bandwidth; unrolling amortizes it
    last, prefix = jax.lax.scan(step, start_nodes, xs_all, unroll=8)
    walks = jnp.concatenate([prefix, last[None]], axis=0)  # [L, B]
    return walks.T
