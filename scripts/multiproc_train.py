"""Multi-process training worker for the 2-process CPU simulation test.

A CPU-only simulation of multi-host training; it never touches a GPU.

One process per "host" (SURVEY.md §4's multi-process testing requirement;
VERDICT r1 item 3): each process owns 2 virtual CPU devices, the global
('data','model') mesh spans both processes, and the embedding-table model
shards therefore CROSS the process boundary — `MeshLayout.shard` must build
global arrays from per-process addressable shards, and the a2a / psum
collectives ride the cross-process transport.

Run (from tests/test_multiprocess.py, or by hand):

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \
    python scripts/multiproc_train.py --coordinator localhost:PORT \
        --num-processes 2 --process-id {0,1}

Prints one parseable line per process:
    MULTIPROC pid=<i> o1=<loss> o2=<loss> o3=<loss> nmi=<nmi> served=<f>
Losses are psum'd globally, so both processes must print identical values —
the test asserts it.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--tier", default="xla-a2a",
                   choices=["xla-psum", "xla-a2a",
                            "banded-rowsharded", "host-corpus"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="also exercise a sharded checkpoint+resume "
                        "round trip (bit-exact, no host gather)")
    p.add_argument("--elastic-load", default=None,
                   help="restore this checkpoint (saved by FEWER "
                        "processes) before training — exercises the "
                        "elastic GROW direction (ADVICE r4 item 1) — "
                        "and report its logical fingerprint")
    args = p.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2"
        ).strip()

    import jax

    # a CPU-only simulation: stay off any accelerator the host has
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from come_tpu.parallel.distributed import initialize_distributed

    initialize_distributed(
        args.coordinator, args.num_processes, args.process_id
    )
    assert jax.process_count() == args.num_processes
    assert jax.local_device_count() == 2
    n = len(jax.devices())
    assert n == 2 * args.num_processes, n

    import numpy as np

    from come_tpu.config import ComEConfig
    from come_tpu.evaluation import nmi_score
    from come_tpu.graphs import sbm_graph
    from come_tpu.parallel import ShardedComETrainer, make_mesh

    # every process builds the same graph/config deterministically
    g, labels = sbm_graph(256, 4, p_in=0.25, p_out=0.01, seed=7)
    cfg = ComEConfig(
        dim=32,
        num_communities=4,
        walk_length=16,
        walks_per_node=2,
        window=4,
        negative_mode="shared",
        shared_negatives=64,
        banded="never",
        row_exchange="a2a" if "a2a" in args.tier or "rowsharded" in args.tier
        else "psum",
        batch_walks=32,
        batch_edges=1024,
        batch_pairs=2048,
        outer_iters=0,
        pretrain_epochs=10,
        gmm_max_iter=15,
        reg_covar=1e-2,
    )
    if args.tier == "banded-rowsharded":
        cfg = cfg.replace(banded="always", banded_walk_block=8)
    elif args.tier == "host-corpus":
        # per-process C++ feeders fill each process's data shard
        # (VERDICT r3 item 6); xla-a2a compute path underneath
        cfg = cfg.replace(corpus="host", row_exchange="a2a")

    mesh = make_mesh(data=n // 2, model=2)  # model axis crosses processes
    t = ShardedComETrainer(g, cfg, mesh)
    el = ""
    if args.elastic_load:
        # GROW direction: a checkpoint saved by fewer processes than are
        # running now — process ids >= the saved count have no own shard
        # file and must fall back to file 0's topology metadata
        import hashlib

        t.load_checkpoint(args.elastic_load)
        h = hashlib.sha256(
            np.ascontiguousarray(t.embeddings()).tobytes()
        ).hexdigest()[:16]
        el = f" elastichash={h}"
    if args.tier == "banded-rowsharded":
        assert t.o1_tier() == args.tier, t.o1_tier()
    if args.tier == "host-corpus":
        # each process must feed exactly ITS one data row of the (2,2)
        # mesh (per-process feeders, reference C3's per-worker writers)
        rows, n_rows = t._data_rows_local()
        assert n_rows == 2 and list(rows) == [args.process_id], rows
    l1 = last = t.o1_epoch()
    for _ in range(9):
        last = t.o1_epoch()
    assert np.isfinite(last) and last < l1, (l1, last)
    l2 = t.o2_epoch()
    t.fit_gmm()
    l3 = t.o3_pass()
    nmi = nmi_score(labels, t.communities())

    ckpt = ""
    if args.checkpoint_dir:
        # sharded checkpoint + resume round trip across the process
        # boundary: per-process shard files, NO host gather (the old
        # save_checkpoint's np.asarray would raise on the non-addressable
        # model-sharded tables here), bit-exact continuation
        from pathlib import Path

        path = Path(args.checkpoint_dir) / "state"
        t.save_checkpoint(path)
        t2 = ShardedComETrainer(g, cfg, mesh)
        t2.load_checkpoint(path)  # restores host_key too (bit-exact)
        for a, b in zip(
            jax.tree.leaves(t.state.params), jax.tree.leaves(t2.state.params)
        ):
            for sa, sb in zip(a.addressable_shards, b.addressable_shards):
                np.testing.assert_array_equal(
                    np.asarray(sa.data), np.asarray(sb.data)
                )
        # logical-embedding fingerprint of the SAVED state (t2 right
        # after restore == the checkpoint): lets a different-topology
        # loader (the elastic-restore test) verify bit-exact transfer
        import hashlib

        h = hashlib.sha256(
            np.ascontiguousarray(t2.embeddings()).tobytes()
        ).hexdigest()[:16]
        la, lb = t.o1_epoch(), t2.o1_epoch()
        assert la == lb, (la, lb)
        for sa, sb in zip(
            t.state.params.node_emb.addressable_shards,
            t2.state.params.node_emb.addressable_shards,
        ):
            np.testing.assert_array_equal(
                np.asarray(sa.data), np.asarray(sb.data)
            )
        ckpt = f" ckpt=ok embhash={h}"

    print(
        f"MULTIPROC pid={args.process_id} o1={last:.6f} o2={l2:.6f} "
        f"o3={l3:.6f} nmi={nmi:.4f} served={t.last_o1_served:.4f}"
        f"{ckpt}{el}",
        flush=True,
    )
    # align exits: a straggler reaching jax.distributed's shutdown barrier
    # long after its peer trips the coordination-service deadline (flaky
    # under load); one explicit sync bounds the divergence
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("multiproc_train_done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
