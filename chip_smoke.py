"""Smoke test of the ComE training system on NVIDIA GPUs.

    python chip_smoke.py                                  # one card
    python chip_smoke.py --four-cards --one-card-nmi X    # the 4-card mesh

One card runs four phases in one process:

1. device    — refuses to go on unless JAX's first device is a GPU; prints
               the card's name and power limit (nvidia-smi) and the compile
               cache directory;
2. parity    — each XLA step of the hot path against the numpy oracle
               (come_tpu/evaluation/oracle.py) at real widths, float32
               matmuls at "highest" precision; also prints the deviation
               at default precision (TF32 on this card) and with bf16
               matmuls;
3. main path — ``come_tpu.main`` on blogcatalog at the preset's full width
               and schedule, with NMI and macro-F1;
4. large V   — synthetic-10m (V=500k, 10M edges) for one outer iteration.

``--four-cards`` runs only the mesh phase: synthetic-10m on a (4,1) and a
(2,2) mesh, cut to two walks per node and one outer iteration, and the
row-sharded banded step against its oracle.  ``--one-card-nmi`` is the NMI
of a one-card run at the same cut
(``python -m come_tpu.main --dataset synthetic-10m --walks-per-node 2
--outer-iters 1``), which the mesh runs must stay near.

Any failed check exits non-zero before the last line.  The last line of
standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# Real widths of the blogcatalog preset: d=128, walks of L=80, window W=10,
# shared pool KP=512, k=5 negatives.
D, L, W, KP, NEG = 128, 80, 10, 512, 5
V_PARITY = 10312  # blogcatalog's node count
BLOCK_WALKS = 128  # one banded block of walks, as blogcatalog trains it
PAIRS = 4096  # one flat shared-pool micro-step
LR = 0.025
# blogcatalog's star O2 block (ComETrainer._star_row_block: ~243 pairs per
# layout row, so 64 rows keep one pool's mass within banded_pool_mass)
STAR_ROW_BLOCK = 64

# Oracle tolerances at "highest" precision: max |step - oracle| <= ATOL +
# RTOL * max |oracle|, in units of gradient (table change / lr).  The card
# sums float32 terms in another order than the oracle (scatter-add through
# atomics, blocked matmuls): at "highest" the worst step lands ~7e-6 of its
# largest entry off the oracle.  Float32 matmuls in TF32 land ~3e-4 off,
# so RTOL = 3e-5 keeps ~4x headroom over the first and fails the second:
# the gate notices when the precision setting is dropped.
ATOL, RTOL = 1e-5, 3e-5
# GMM: mean per-sample log-likelihood of the fitted mixture, float32
# Cholesky on the card vs float64 scipy log-pdfs in the oracle.
GMM_RTOL = 1e-4

NMI_FLOOR = 0.88  # blogcatalog floor, tests/test_eval_regression.py
# mesh runs against the one-card run: another RNG stream per data shard and
# sum-of-deltas across workers, so quality agrees in class, not in bits.
# NMI moves by up to ~0.2 between outer iterations of one run; a broken
# mesh path lands at chance (~0.005 on synthetic-10m).
MESH_NMI_BAND = 0.1


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1


def phase_device(want: int):
    import jax

    devs = jax.devices()
    check(
        devs[0].platform == "gpu",
        f"JAX finds no GPU (first device platform {devs[0].platform!r})",
    )
    check(len(devs) >= want, f"need {want} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed no card")
    for line in smi:
        say(f"card: {line}")
    try:
        from come_tpu.compile_cache import enable_compile_cache
    except ImportError as e:
        raise SmokeFailure(f"the come_tpu package is not importable: {e}")
    say(f"compile cache: {enable_compile_cache()}")
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs


# ------------------------------------------------------------------ phase 2


def _oracle_sum(fn, arg_chunks):
    """Sum ``fn(*args)`` over chunks in worker processes that stay off the
    card (the oracle is scalar numpy loops; its results are sums over
    walks or pairs, so chunks add up)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    saved = {k: os.environ.get(k) for k in ("JAX_PLATFORMS",
                                            "CUDA_VISIBLE_DEVICES")}
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        workers = max(1, min(len(arg_chunks), os.cpu_count() or 1))
        with ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn")
        ) as ex:
            outs = list(ex.map(fn, *zip(*arg_chunks)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return [sum(parts) for parts in zip(*outs)]


def _report(name, errs, scale):
    """errs: {mode: max abs error}; fails unless the 'highest' one is
    within tolerance."""
    bound = ATOL + RTOL * scale
    say(
        f"parity {name}: max|grad| {scale:.4g}; max err highest "
        f"{errs['highest']:.3g} (bound {bound:.3g}), default "
        f"{errs['default']:.3g}"
        + (f", bf16 {errs['bf16']:.3g}" if "bf16" in errs else "")
    )
    check(errs["highest"] <= bound,
          f"{name}: {errs['highest']:.3g} > {bound:.3g} at highest precision")


def _modes(bf16: bool):
    modes = [("highest", "highest", False), ("default", None, False)]
    if bf16:
        modes.append(("bf16", "highest", True))
    return modes


def phase_parity(seed: int = 0, v: int = V_PARITY, block: int = BLOCK_WALKS,
                 pairs: int = PAIRS, star_rows: int = 1024,
                 gmm_points: int = V_PARITY, gmm_k: int = 39):
    import jax
    import jax.numpy as jnp

    from come_tpu.config import get_config
    from come_tpu.evaluation import oracle
    from come_tpu.losses.gmm import gmm_em_fit
    from come_tpu.losses.sgns_banded import banded_walk_sgns_step
    from come_tpu.losses.sgns_block import sgns_block_sgd_step
    from come_tpu.losses.star_banded import star_banded_sgns_step
    from come_tpu.sampling.stars import build_star_layout

    rng = np.random.default_rng(seed)
    ei = (rng.normal(size=(v, D)) * 0.3).astype(np.float32)
    eo = (rng.normal(size=(v, D)) * 0.3).astype(np.float32)
    pool = rng.integers(0, v, KP).astype(np.int32)
    negw = NEG / KP
    key = jax.random.key(seed)
    nchunk = os.cpu_count() or 1

    # --- O1: one banded block vs the banded shared-pool oracle, with the
    # block split into fresh pools as the trainer splits it
    # (ComETrainer._pool_chunks); the pools' gradients all read the
    # block-start tables, so the oracle sums over the pools' walk chunks
    per_pool = (get_config("blogcatalog").banded_pool_mass * KP
                // (L * (W + 1) * NEG))
    n_pools = -(-block // per_pool)
    while block % n_pools:
        n_pools += 1
    pools = rng.integers(0, v, (n_pools, KP)).astype(np.int32)
    walks = rng.integers(0, v, (block, L)).astype(np.int32)
    wrow = np.full((block, L), W, np.int32)
    args = []
    for p, wc in enumerate(np.array_split(np.arange(block), n_pools)):
        for c in np.array_split(wc, max(1, min(len(wc),
                                               nchunk // n_pools))):
            args.append((ei, eo, walks[c], pools[p], wrow[c], negw))
    _, o_np, o_din, o_dout = _oracle_sum(
        oracle.walk_banded_shared_pool_grads, args
    )
    errs = {}
    for mode, prec, bf16 in _modes(True):
        with jax.default_matmul_precision(prec):
            ni, no, _, npairs = banded_walk_sgns_step(
                jnp.asarray(ei), jnp.asarray(eo), jnp.asarray(walks),
                jnp.asarray(pools[None]), LR, negw, key, window=W,
                walk_block=block, reduced_window=False, mxu_bf16=bf16,
            )
        check(float(npairs) == o_np, f"banded pair count {npairs} != {o_np}")
        g_in = (ei - np.asarray(ni)) / LR
        g_out = (eo - np.asarray(no)) / LR
        errs[mode] = max(float(np.abs(g_in - o_din).max()),
                         float(np.abs(g_out - o_dout).max()))
    _report(f"sgns_banded (B={block} walks in {n_pools} pools, L={L}, "
            f"W={W}, KP={KP}, d={D})",
            errs, max(float(np.abs(o_din).max()),
                      float(np.abs(o_dout).max())))

    # --- O1 flat micro-step: shared-pool block SGD vs its oracle
    c = rng.integers(0, v, pairs).astype(np.int32)
    x = rng.integers(0, v, pairs).astype(np.int32)
    m = np.ones(pairs, bool)
    chunks = np.array_split(np.arange(pairs), nchunk)
    _, o_din, o_dout = _oracle_sum(
        oracle.sgns_shared_pool_grads,
        [(ei, eo, c[k], x[k], pool, m[k], negw) for k in chunks],
    )
    errs = {}
    for mode, prec, _bf16 in _modes(False):
        with jax.default_matmul_precision(prec):
            ni, no, _, _ = jax.jit(sgns_block_sgd_step)(
                jnp.asarray(ei), jnp.asarray(eo), jnp.asarray(c),
                jnp.asarray(x), jnp.asarray(pool), jnp.asarray(m), LR, negw,
            )
        g_in = (ei - np.asarray(ni)) / LR
        g_out = (eo - np.asarray(no)) / LR
        errs[mode] = max(float(np.abs(g_in - o_din).max()),
                         float(np.abs(g_out - o_dout).max()))
    _report(f"sgns_block ({pairs} pairs, KP={KP}, d={D})", errs,
            max(float(np.abs(o_din).max()), float(np.abs(o_dout).max())))

    # --- O2: banded star step vs the star oracle, a fresh pool per block
    n_edges = 64 * star_rows
    eu = rng.integers(0, v, n_edges)
    ev = (eu + 1 + rng.integers(0, v - 1, n_edges)) % v
    slots, meta = build_star_layout(eu, ev, v)
    slots = slots.reshape(-1, 128)[:star_rows]
    meta = meta.reshape(-1, 128)[:star_rows]
    row_block = min(STAR_ROW_BLOCK, star_rows)
    spools = rng.integers(0, v, (-(-slots.shape[0] // row_block), KP))
    spools = spools.astype(np.int32)
    o_e, _, o_np = oracle.star_banded_sequential(
        ei, slots, meta, spools, negw, LR, block_rows=row_block
    )
    errs = {}
    for mode, prec, bf16 in _modes(True):
        with jax.default_matmul_precision(prec):
            ne, _, npairs = star_banded_sgns_step(
                jnp.asarray(ei), jnp.asarray(slots), jnp.asarray(meta),
                jnp.asarray(spools), LR, negw, row_block=row_block,
                mxu_bf16=bf16,
            )
        check(float(npairs) == o_np, f"star pair count {npairs} != {o_np}")
        errs[mode] = float(np.abs(np.asarray(ne) - o_e).max()) / LR
    _report(f"star_banded ({slots.shape[0]} rows x 128 slots in blocks of "
            f"{row_block}, KP={KP}, d={D})", errs, float(np.abs(o_e - ei).max()) / LR)

    # --- GMM EM fit: the fitted mixture's log-likelihood vs scipy's
    centers = rng.normal(size=(gmm_k, D)) * 3.0
    lab = rng.integers(0, gmm_k, gmm_points)
    X = (centers[lab] + rng.normal(size=(gmm_points, D))).astype(np.float32)
    lls = {}
    for mode, prec, _bf16 in _modes(False):
        with jax.default_matmul_precision(prec):
            out = gmm_em_fit(jnp.asarray(X), gmm_k, jax.random.key(seed),
                             n_init=1, max_iter=60, reg_covar=1e-5)
        chol = np.asarray(out["chol"], np.float64)
        ref = oracle.gmm_log_likelihood(
            X.astype(np.float64), np.asarray(out["means"], np.float64),
            np.einsum("kde,kfe->kdf", chol, chol),
            np.exp(np.asarray(out["log_weights"], np.float64)),
        )
        lls[mode] = (float(out["log_likelihood"]), ref)
    dev = {k: abs(a - b) for k, (a, b) in lls.items()}
    bound = GMM_RTOL * abs(lls["highest"][1])
    say(f"parity gmm (K={gmm_k}, d={D}, N={gmm_points}): mean loglik "
        f"{lls['highest'][0]:.6g} vs oracle {lls['highest'][1]:.6g}; "
        f"|diff| highest {dev['highest']:.3g} (bound {bound:.3g}), "
        f"default {dev['default']:.3g}")
    check(dev["highest"] <= bound, "gmm log-likelihood off the oracle")


# ------------------------------------------------------------ phases 3 + 4


def _peak_bytes(devs) -> int:
    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in devs)


def _check_history(name, hist):
    for rec in hist:
        for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss"):
            check(math.isfinite(rec[k]), f"{name}: {k} is {rec[k]} "
                  f"in iteration {rec['iter']}")


def _phase_ms(hist):
    """Iteration 0 includes compilation (set-up); later ones are steady."""
    keys = ("gmm_ms", "o1_ms", "o2_ms", "o3_ms")
    setup = {k[:-3]: hist[0][k] for k in keys}
    steady = (
        {k[:-3]: float(np.median([r[k] for r in hist[1:]])) for k in keys}
        if len(hist) > 1 else None
    )
    return setup, steady


def _train(argv):
    from come_tpu.main import run

    t0 = time.perf_counter()
    res = run(argv)
    return res, time.perf_counter() - t0


def phase_main(devs, dataset: str = "blogcatalog"):
    res, secs = _train(["--dataset", dataset, "--eval-f1"])
    tr, hist, f1 = res["trainer"], res["history"], res["f1"]
    _check_history(dataset, hist)
    check(bool(np.isfinite(tr.embeddings()).all()),
          f"{dataset}: non-finite embeddings")
    setup, steady = _phase_ms(hist)
    nmi = hist[-1]["nmi"]
    say(f"main {dataset}: V={tr.graph.num_nodes} d={tr.cfg.dim} "
        f"K={tr.cfg.num_communities} o1_tier={tr.o1_tier()} "
        f"o2_tier={tr.o2_tier()} wall_s={secs:.1f}")
    say(f"main {dataset}: set-up iteration ms {setup}")
    say(f"main {dataset}: steady iteration ms (median of "
        f"{len(hist) - 1}) {steady}")
    say(f"main {dataset}: NMI {nmi:.4f} macro-F1 {f1['macro_f1']:.4f} "
        f"micro-F1 {f1['micro_f1']:.4f} peak_bytes_in_use "
        f"{_peak_bytes(devs)}")
    check(nmi >= NMI_FLOOR, f"{dataset}: NMI {nmi:.4f} < {NMI_FLOOR}")


def _warm_phase_ms(tr):
    """One more call of each phase on the warm (compiled) trainer."""
    out = {}
    for name, fn in (("gmm", tr.fit_gmm), ("o1", tr.o1_epoch),
                     ("o2", tr.o2_epoch), ("o3", tr.o3_pass)):
        t0 = time.perf_counter()
        val = fn()  # returns a host float: the phase has finished
        out[name] = round((time.perf_counter() - t0) * 1e3, 2)
        check(math.isfinite(val), f"warm {name}: {val}")
    return out


def _large_v_argv(walks_per_node=1, mesh=None):
    # cut for run time: one outer iteration and one or two walks per node
    argv = ["--dataset", "synthetic-10m", "--outer-iters", "1",
            "--walks-per-node", str(walks_per_node)]
    return argv + (["--mesh", mesh] if mesh else [])


def phase_large_v(devs, want=("banded", "banded-star")):
    argv = _large_v_argv()
    say(f"large V: {' '.join(argv)} (cut: --outer-iters 1 "
        f"--walks-per-node 1)")
    res, secs = _train(argv)
    tr, hist = res["trainer"], res["history"]
    _check_history("large V", hist)
    tiers = (tr.o1_tier(), tr.o2_tier())
    say(f"large V: V={tr.graph.num_nodes} E={tr.graph.num_edges} "
        f"o1_tier={tiers[0]} o2_tier={tiers[1]} wall_s={secs:.1f}")
    say(f"large V: iteration ms (gmm/o2/o3 include compilation) "
        f"{_phase_ms(hist)[0]}")
    say(f"large V: warm phase ms {_warm_phase_ms(tr)} "
        f"o1_pairs {tr.last_o1_pairs:.0f} o2_pairs {tr.last_o2_pairs:.0f}")
    say(f"large V: NMI {hist[-1].get('nmi', float('nan')):.4f} "
        f"peak_bytes_in_use {_peak_bytes(devs)}")
    check(tiers == tuple(want), f"large V tiers {tiers} != {want}")
    return res


# --------------------------------------------------------------- 4 cards


def _mesh_argv(shape):
    # two walks per node: at one, every run (one card or mesh) ends at
    # chance NMI and the band check below could not tell a broken mesh
    return _large_v_argv(walks_per_node=2, mesh=shape)


def phase_mesh(devs, one_card_nmi: float, argv_for=_mesh_argv):
    import jax

    from come_tpu.evaluation.parity import rowsharded_parity

    say(f"mesh: {' '.join(argv_for('SHAPE'))} (cut: --outer-iters 1 "
        f"--walks-per-node 2)")
    for shape, want in (("4,1", "banded-dp"), ("2,2", "banded-rowsharded")):
        res = tr = None  # one trainer's tables on the cards at a time
        res, secs = _train(argv_for(shape))
        tr, hist = res["trainer"], res["history"]
        _check_history(f"mesh {shape}", hist)
        nmi = hist[-1]["nmi"]
        say(f"mesh ({shape}): o1_tier={tr.o1_tier()} o2_tier="
            f"{tr.o2_tier()} served {tr.last_o1_served} NMI {nmi:.4f} "
            f"(one card {one_card_nmi:.4f}) wall_s={secs:.1f}")
        say(f"mesh ({shape}): warm phase ms {_warm_phase_ms(tr)}")
        check(tr.o1_tier() == want, f"mesh {shape} O1 tier {tr.o1_tier()}")
        check(tr.last_o1_served == 1.0,
              f"mesh {shape}: served {tr.last_o1_served}")
        check(abs(nmi - one_card_nmi) <= MESH_NMI_BAND,
              f"mesh {shape}: NMI {nmi:.4f} off the one-card "
              f"{one_card_nmi:.4f} by more than {MESH_NMI_BAND}")

    rng = np.random.default_rng(0)
    ei = (rng.normal(size=(V_PARITY, D)) * 0.3).astype(np.float32)
    eo = (rng.normal(size=(V_PARITY, D)) * 0.3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        err, scale, loss_rel = rowsharded_parity(
            ei, eo, rng, 8, L, KP, W, LR, NEG / KP, devices=devs[:4],
            blocks=2,
        )
    bound = ATOL + RTOL * scale
    say(f"parity banded rowsharded (2,2) (2 blocks of 8 walks/worker, "
        f"a fresh pool each, L={L}, W={W}, "
        f"KP={KP}, d={D}): max err {err:.3g} (bound {bound:.3g}) "
        f"loss_rel {loss_rel:.2g}")
    check(err <= bound and loss_rel < 1e-3, "row-sharded banded parity")


# ------------------------------------------------------------------ driver


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card mesh phase")
    p.add_argument("--one-card-nmi", type=float,
                   help="NMI of a one-card synthetic-10m run at the mesh "
                        "phase's cut (with --four-cards)")
    args = p.parse_args(argv)
    if args.four_cards and args.one_card_nmi is None:
        p.error("--four-cards needs --one-card-nmi")
    try:
        devs = phase_device(4 if args.four_cards else 1)
        if args.four_cards:
            devs = devs[:4]
            phase_mesh(devs, args.one_card_nmi)
        else:
            devs = devs[:1]
            phase_parity()
            phase_main(devs)
            phase_large_v(devs)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
