"""Per-iteration gradient parity harness — the BASELINE.json:5 acceptance gate.

Checks, for a fixed batch and identical initial tables, that the framework's
O1/O2/O3 gradients match the numpy oracle (evaluation/oracle.py) to float
tolerance.  Runs as a library call or a CLI:

    python -m come_tpu.evaluation.parity --dataset karate --iters 3
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ParityReport:
    o1_max_err: float
    o2_max_err: float
    o3_max_err: float
    loss_rel_err: float
    passed: bool
    # fast-path rows: the SHIPPING steps (banded walk step for O1,
    # shared-pool block step for O2) vs the shared-pool/banded oracle
    # semantics — gradient-level gates, not just end-to-end NMI
    o1_fast_max_err: float = float("nan")
    o2_fast_max_err: float = float("nan")
    # shipping-CONFIG rows: a multi-block banded step vs the composed
    # sequential oracle, and the row-sharded (2,2)-mesh banded step vs the
    # per-worker sum-of-deltas composition
    o1_fast_multi_max_err: float = float("nan")
    o1_fast_rowsharded_max_err: float = float("nan")
    # O2 STAR row (the shipping edge-pass tier): the banded star step
    # (sampling/stars.py layout + losses/star_banded.py) vs the star
    # block-sequential oracle
    o2_star_max_err: float = float("nan")

    def __str__(self):
        s = "PASS" if self.passed else "FAIL"
        return (
            f"parity {s}: o1={self.o1_max_err:.2e} o2={self.o2_max_err:.2e} "
            f"o3={self.o3_max_err:.2e} loss_rel={self.loss_rel_err:.2e} "
            f"o1_fast={self.o1_fast_max_err:.2e} "
            f"o2_fast={self.o2_fast_max_err:.2e} "
            f"o1_fast_multi={self.o1_fast_multi_max_err:.2e} "
            f"o1_fast_rowsharded={self.o1_fast_rowsharded_max_err:.2e} "
            f"o2_star={self.o2_star_max_err:.2e}"
        )


def check_gradient_parity(
    graph,
    dim: int = 32,
    num_communities: int = 2,
    pairs: int = 512,
    negatives: int = 5,
    seed: int = 0,
    atol: float = 5e-4,
    rtol: float = 1e-3,
) -> ParityReport:
    """One iteration of O1/O2/O3 gradient comparison vs the numpy oracle."""
    import jax
    import jax.numpy as jnp

    from come_tpu.evaluation import oracle
    from come_tpu.losses.community import community_grad
    from come_tpu.losses.sgns import sgns_loss_and_grads

    rng = np.random.default_rng(seed)
    V = graph.num_nodes
    emb_in = (rng.normal(size=(V, dim)) * 0.3).astype(np.float32)
    emb_out = (rng.normal(size=(V, dim)) * 0.3).astype(np.float32)

    # O1 batch: random walk-window style pairs
    c = rng.integers(0, V, pairs).astype(np.int32)
    x = rng.integers(0, V, pairs).astype(np.int32)
    negs = rng.integers(0, V, (pairs, negatives)).astype(np.int32)
    m = np.ones(pairs, bool)

    def dense(contrib):
        d_phi, d_cpos, d_cneg = [np.asarray(a) for a in contrib]
        din = np.zeros_like(emb_in)
        dout = np.zeros_like(emb_out)
        np.add.at(din, c, d_phi)
        np.add.at(dout, x, d_cpos)
        np.add.at(dout, negs.reshape(-1), d_cneg.reshape(-1, dim))
        return din, dout

    loss, _, contrib = sgns_loss_and_grads(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(negs), jnp.asarray(m),
    )
    din, dout = dense(contrib)
    oloss, odin, odout = oracle.sgns_batch_grads(emb_in, emb_out, c, x, negs, m)
    o1_err = max(
        float(np.abs(din - odin).max()), float(np.abs(dout - odout).max())
    )
    loss_rel = abs(float(loss) - oloss) / max(abs(oloss), 1e-9)

    # O2: tied tables on real edges
    src, dst = graph.arcs()
    take = rng.choice(len(src), size=min(pairs, len(src)), replace=False)
    s2, d2 = src[take].astype(np.int32), dst[take].astype(np.int32)
    n2 = rng.integers(0, V, (len(take), negatives)).astype(np.int32)
    m2 = np.ones(len(take), bool)
    loss2, _, contrib2 = sgns_loss_and_grads(
        jnp.asarray(emb_in), jnp.asarray(emb_in), jnp.asarray(s2),
        jnp.asarray(d2), jnp.asarray(n2), jnp.asarray(m2),
    )
    d_phi, d_cpos, d_cneg = [np.asarray(a) for a in contrib2]
    dg = np.zeros_like(emb_in)
    np.add.at(dg, s2, d_phi)
    np.add.at(dg, d2, d_cpos)
    np.add.at(dg, n2.reshape(-1), d_cneg.reshape(-1, dim))
    _, odg = oracle.sgns_batch_grads_tied(emb_in, s2, d2, n2, m2)
    o2_err = float(np.abs(dg - odg).max())

    # O3: community gradient on a random GMM state
    K = num_communities
    pi = rng.random((V, K)).astype(np.float32)
    pi /= pi.sum(1, keepdims=True)
    centroid = rng.normal(size=(K, dim)).astype(np.float32)
    A = rng.normal(size=(K, dim, dim)).astype(np.float32) * 0.1
    cov = np.einsum("kde,kfe->kdf", A, A) + np.eye(dim, dtype=np.float32)
    inv_cov = np.linalg.inv(cov)
    beta = 0.1
    g3 = np.asarray(
        community_grad(
            jnp.asarray(emb_in), jnp.asarray(pi), jnp.asarray(centroid),
            jnp.asarray(inv_cov), beta,
        )
    )
    og3 = oracle.community_grads(emb_in, pi, centroid, inv_cov, beta)
    o3_err = float(np.abs(g3 - og3).max())

    # ---- fast-path rows: gradient-level gates on the SHIPPING steps ----
    # O1-fast: one block of the banded walk step (full window, single
    # pool) vs the banded shared-pool oracle.  The step is an SGD *step*;
    # with one synchronous block, new = old - lr * grad(initial tables),
    # so the per-element check is |new - (old - lr*d_oracle)| / lr.
    from come_tpu.losses.sgns_banded import banded_walk_sgns_step
    from come_tpu.losses.sgns_block import sgns_block_sgd_step

    KP = 16
    W, L = 3, 12
    nw = 8  # walks per banded block
    walks = rng.integers(0, V, (nw, L)).astype(np.int32)
    pool = rng.integers(0, V, KP).astype(np.int32)
    negw = negatives / KP
    lr = 0.025
    key = jax.random.key(seed)
    banded = dict(
        window=W, walk_block=nw, reduced_window=False, mxu_bf16=False
    )
    ni, no, floss, _ = banded_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks),
        jnp.asarray(pool), lr, negw, key, **banded,
    )
    wrow = np.full((nw, L), W, np.int32)
    o_floss, _, o_din, o_dout = oracle.walk_banded_shared_pool_grads(
        emb_in, emb_out, walks, pool, wrow, negw
    )
    o1f_err = max(
        float(np.abs(np.asarray(ni) - (emb_in - lr * o_din)).max()),
        float(np.abs(np.asarray(no) - (emb_out - lr * o_dout)).max()),
    ) / lr
    o1f_scale = max(np.abs(o_din).max(), np.abs(o_dout).max())
    loss_rel = max(
        loss_rel, abs(float(floss) - o_floss) / max(abs(o_floss), 1e-9)
    )

    # O2-fast: tied-table shared-pool block step (the flat O2
    # micro-step) vs the shared-pool oracle.
    nt, _, bloss, _ = sgns_block_sgd_step(
        jnp.asarray(emb_in), jnp.asarray(emb_in), jnp.asarray(s2),
        jnp.asarray(d2), jnp.asarray(pool), jnp.asarray(m2), lr, negw,
        tie_tables=True,
    )
    o_bloss, o_bin, o_bout = oracle.sgns_shared_pool_grads(
        emb_in, emb_in, s2, d2, pool, m2, negw
    )
    o_btied = o_bin + o_bout
    o2f_err = float(
        np.abs(np.asarray(nt) - (emb_in - lr * o_btied)).max()
    ) / lr
    o2f_scale = float(np.abs(o_btied).max())
    loss_rel = max(
        loss_rel, abs(float(bloss) - o_bloss) / max(abs(o_bloss), 1e-9)
    )

    # ---- shipping-config rows ----
    # O1-fast-multi: FOUR sequential blocks, a fresh pool per block, vs
    # the composed sequential oracle.
    G = 4
    walks_m = rng.integers(0, V, (G * nw, L)).astype(np.int32)
    pools_m = rng.integers(0, V, (G, KP)).astype(np.int32)
    mi_, mo_, mloss, mnp = banded_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks_m),
        jnp.asarray(pools_m), lr, negw, key, **banded,
    )
    wrow_m = np.full((G * nw, L), W, np.int32)
    o_mi, o_mo, o_mloss, o_mnp = oracle.walk_banded_sequential(
        emb_in, emb_out, walks_m, pools_m, wrow_m, negw, lr, nw
    )
    o1m_err = max(
        float(np.abs(np.asarray(mi_) - o_mi).max()),
        float(np.abs(np.asarray(mo_) - o_mo).max()),
    ) / lr
    o1m_scale = max(
        np.abs((o_mi - emb_in) / lr).max(),
        np.abs((o_mo - emb_out) / lr).max(),
    )
    assert float(mnp) == o_mnp, (float(mnp), o_mnp)
    loss_rel = max(
        loss_rel, abs(float(mloss) - o_mloss) / max(abs(o_mloss), 1e-9)
    )

    # O2-star: the STAR fan-out tier (the shipping edge pass) — layout
    # built from random edges, two sequential row blocks sharing one
    # pool's ids — vs the star block-sequential oracle.
    from come_tpu.losses.star_banded import star_banded_sgns_step
    from come_tpu.sampling.stars import build_star_layout

    eu3 = rng.integers(0, V, 4 * nw).astype(np.int64)
    ev3 = (eu3 + 1 + rng.integers(0, V - 1, 4 * nw)) % V
    s3, m3 = build_star_layout(eu3, ev3, V)
    s3, m3 = s3.reshape(-1, 128), m3.reshape(-1, 128)
    if s3.shape[0] % 2:  # whole blocks of 2 rows; pad rows self-mask
        s3 = np.pad(s3, ((0, 1), (0, 0)))
        m3 = np.pad(m3, ((0, 1), (0, 0)), constant_values=-2)
    si, sloss, snp = star_banded_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(s3), jnp.asarray(m3),
        jnp.asarray(pool), lr, negw, row_block=2, mxu_bf16=False,
    )
    o_si, o_sloss, o_snp = oracle.star_banded_sequential(
        emb_in, s3, m3, pool, negw, lr, block_rows=2
    )
    o2s_err = float(np.abs(np.asarray(si) - o_si).max()) / lr
    o2s_scale = max(float(np.abs((o_si - emb_in) / lr).max()), 1.0)
    assert float(snp) == o_snp, (float(snp), o_snp)
    loss_rel = max(
        loss_rel, abs(float(sloss) - o_sloss) / max(abs(o_sloss), 1e-9)
    )

    # O1-fast-rowsharded: the (2,2)-mesh row-sharded banded step
    # (parallel/walk_exchange.py) vs per-worker oracles composed by
    # sum-of-deltas.  Needs >= 4 local devices (the test suite's virtual
    # CPU mesh); reported as nan otherwise.
    o1r_err = float("nan")
    o1r_scale = 1.0
    if len(jax.devices()) >= 4:
        o1r_err, o1r_scale, rs_loss_rel = rowsharded_parity(
            emb_in, emb_out, rng, nw, L, KP, W, lr, negw
        )
        loss_rel = max(loss_rel, rs_loss_rel)

    passed = (
        o1_err < atol + rtol * float(np.abs(odin).max() + np.abs(odout).max())
        and o2_err < atol + rtol * float(np.abs(odg).max())
        and o3_err < atol + rtol * float(np.abs(og3).max())
        and o1f_err < atol + rtol * o1f_scale
        and o2f_err < atol + rtol * o2f_scale
        and o1m_err < atol + rtol * o1m_scale
        and o2s_err < atol + rtol * o2s_scale
        and not (o1r_err == o1r_err and o1r_err >= atol + rtol * o1r_scale)
        and loss_rel < 1e-3
    )
    return ParityReport(
        o1_err, o2_err, o3_err, loss_rel, passed, o1f_err, o2f_err,
        o1m_err, o1r_err, o2s_err,
    )


def rowsharded_parity(
    emb_in, emb_out, rng, nw, L, KP, W, lr, negw, devices=None,
    mxu_bf16=False, blocks=1,
):
    """Gradient gate for walk_exchange.banded_walk_step_rowsharded on a
    (2,2) mesh.

    Each of the 4 workers trains ``blocks`` blocks of ``nw`` walks in order
    (one pool for all of them when ``blocks`` is 1, else a fresh pool per
    block) on an exact (capacity = U) bucketed exchange; the expected
    result is table + sum over workers of (per-worker sequential oracle -
    table).  Returns (max_err/lr, grad_scale, loss_rel).
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from come_tpu.evaluation import oracle
    from come_tpu.losses.sgns_banded import pack_tables, unpack_tables
    from come_tpu.parallel.walk_exchange import banded_walk_step_rowsharded

    D = M = 2
    V, dim = emb_in.shape
    rows_per = -(-V // M)
    v_pad = rows_per * M
    ei = np.pad(emb_in, ((0, v_pad - V), (0, 0)))
    eo = np.pad(emb_out, ((0, v_pad - V), (0, 0)))
    walks = rng.integers(0, V, (D, M, blocks * nw, L)).astype(np.int32)
    pool_shape = (D, M, KP) if blocks == 1 else (D, M, blocks, KP)
    pools = rng.integers(0, V, pool_shape).astype(np.int32)
    devices = jax.devices()[: D * M] if devices is None else devices
    mesh = Mesh(np.array(devices).reshape(D, M), ("data", "model"))

    def step(cs, wk, sg):
        cs, loss, npairs, srv = banded_walk_step_rowsharded(
            cs, wk[0, 0], sg[0, 0], lr, negw, jax.random.key(0),
            window=W, walk_block=nw, capacity_slack=float(M),
            mxu_bf16=mxu_bf16, reduced_window=False,
        )
        srv = jax.lax.pmean(srv, ("data", "model"))
        return cs, loss, npairs, srv

    combo, loss, npairs, srv = jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P("model"), P("data", "model"), P("data", "model")),
            out_specs=(P("model"), P(), P(), P()),
            check_vma=False,
        )
    )(pack_tables(jnp.asarray(ei), jnp.asarray(eo)), jnp.asarray(walks),
      jnp.asarray(pools))
    assert float(srv) == 1.0, float(srv)
    ne, ce = unpack_tables(combo)

    # the M workers of a data row share their owners' deltas block by block
    # (their gathers read shard + the row's accumulated delta), so a data
    # row's blocks run in order with the M block deltas summed; data rows
    # are summed once at the end
    wrow = np.full((nw, L), W, np.int32)
    pools = pools.reshape(D, M, blocks, KP)
    d_in = np.zeros_like(ei)
    d_out = np.zeros_like(eo)
    o_loss = 0.0
    o_np = 0
    for di in range(D):
        ti, to = ei.copy(), eo.copy()
        for k in range(blocks):
            bi, bo = np.zeros_like(ei), np.zeros_like(eo)
            for mi in range(M):
                wi, wo, wl, wnp = oracle.walk_banded_sequential(
                    ti, to, walks[di, mi, k * nw:(k + 1) * nw],
                    pools[di, mi, k], wrow, negw, lr, nw,
                )
                bi += wi - ti
                bo += wo - to
                o_loss += wl
                o_np += wnp
            ti, to = ti + bi, to + bo
        d_in += ti - ei
        d_out += to - eo
    exp_in, exp_out = ei + d_in, eo + d_out
    err = max(
        float(np.abs(np.asarray(ne) - exp_in).max()),
        float(np.abs(np.asarray(ce) - exp_out).max()),
    ) / lr
    scale = max(
        np.abs(d_in / lr).max(), np.abs(d_out / lr).max()
    )
    assert float(npairs) == o_np, (float(npairs), o_np)
    loss_rel = abs(float(loss) - o_loss) / max(abs(o_loss), 1e-9)
    return err, float(scale), loss_rel


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="gradient parity vs numpy oracle")
    p.add_argument("--dataset", default="karate")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--pairs", type=int, default=512)
    args = p.parse_args(argv)

    from come_tpu.graphs import get_dataset

    ds = get_dataset(args.dataset)
    ok = True
    for i in range(args.iters):
        rep = check_gradient_parity(
            ds.graph, dim=args.dim, pairs=args.pairs, seed=i,
            num_communities=ds.num_communities,
        )
        print(f"iter {i}: {rep}")
        ok &= rep.passed
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
