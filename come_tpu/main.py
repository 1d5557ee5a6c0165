"""CLI driver — the reference ``main.py`` analog (SURVEY.md C9).

Usage:
    python -m come_tpu.main --dataset karate [--outer-iters 3] [--dim 16] ...

Loads a registered dataset, runs the full alternating ComE optimization, and
prints per-iteration losses + NMI (and node-classification F1 at the end).
:func:`run` is the same driver returning its results, for in-process
callers (``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ComE training")
    p.add_argument("--dataset", default="karate")
    p.add_argument("--dim", type=int)
    p.add_argument("--num-communities", type=int)
    p.add_argument("--window", type=int)
    p.add_argument("--negative", type=int)
    p.add_argument("--walk-length", type=int)
    p.add_argument("--walks-per-node", type=int)
    p.add_argument("--restart-prob", type=float,
                   help="walk restart probability (reference alpha)")
    p.add_argument("--lr", type=float)
    p.add_argument("--alpha", type=float, help="O2 loss weight")
    p.add_argument("--beta", type=float, help="O3 loss weight")
    p.add_argument("--outer-iters", type=int)
    p.add_argument("--pretrain-epochs", type=int)
    p.add_argument("--batch-walks", type=int)
    p.add_argument("--batch-edges", type=int)
    p.add_argument("--o2-mode", choices=["auto", "star", "xla"],
                   help="O2 tier selection (default auto: banded star "
                        "when its collision envelope holds, else xla)")
    p.add_argument("--down-sample", type=float,
                   help="word2vec frequent-node subsampling threshold "
                        "(reference `sample`; 0 = off, the default)")
    p.add_argument("--seed", type=int)
    p.add_argument("--save", help="write embeddings (word2vec text) here")
    p.add_argument("--checkpoint-dir", help="save a checkpoint per iteration")
    p.add_argument("--resume", help="checkpoint .npz to resume from")
    p.add_argument("--profile-dir", help="write a jax.profiler trace here")
    p.add_argument("--plot", help="write embedding-space + graph PNGs here")
    p.add_argument("--eval-f1", action="store_true",
                   help="also run node-classification F1 at the end")
    p.add_argument("--json", action="store_true", help="JSONL record output")
    p.add_argument(
        "--mesh",
        help="train on a ('data','model') device mesh, e.g. --mesh 4,2 "
        "(ShardedComETrainer; needs data*model visible devices)",
    )
    p.add_argument(
        "--distributed",
        help="multi-host launch: COORDINATOR:PORT,NUM_PROCESSES,PROCESS_ID "
        "(jax.distributed; combine with --mesh spanning all hosts' devices)",
    )
    return p


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> dict:
    """Parse ``argv``, train, evaluate; returns ``{"trainer", "history",
    "f1"}`` (``f1`` is None without ``--eval-f1``)."""
    args = build_argparser().parse_args(argv)
    from come_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.distributed:
        # multi-host: initialize BEFORE any backend touch so jax.devices()
        # spans the pod (reference had no multi-host story at all —
        # SURVEY.md §2 parallelism table)
        coord, nproc, pid = args.distributed.rsplit(",", 2)
        from come_tpu.parallel.distributed import initialize_distributed

        initialize_distributed(coord, int(nproc), int(pid))

    from come_tpu.config import PRESETS, ComEConfig
    from come_tpu.graphs import get_dataset
    from come_tpu.trainer import ComETrainer

    ds = get_dataset(args.dataset)
    cfg = PRESETS.get(args.dataset.lower().replace("-synthetic", ""),
                      ComEConfig())
    cfg = cfg.replace(num_communities=ds.num_communities)
    overrides = {
        k: v
        for k, v in vars(args).items()
        if v is not None
        and k in ComEConfig.__dataclass_fields__
    }
    cfg = cfg.replace(**overrides)

    print(f"dataset={ds.name}: V={ds.graph.num_nodes} E={ds.graph.num_edges} "
          f"K={cfg.num_communities} d={cfg.dim}")
    t0 = time.time()
    if args.mesh:
        import jax

        from come_tpu.parallel import ShardedComETrainer, make_mesh

        d, m = (int(x) for x in args.mesh.split(","))
        mesh = make_mesh(data=d, model=m, devices=jax.devices()[: d * m])
        trainer = ShardedComETrainer(ds.graph, cfg, mesh)
        print(f"mesh=({d},{m}) o1_tier={trainer.o1_tier()} "
              f"o2_tier={trainer.o2_tier()}")
    else:
        trainer = ComETrainer(ds.graph, cfg)
        print(f"o1_tier={trainer.o1_tier()} o2_tier={trainer.o2_tier()}")
    if args.resume:
        trainer.load_checkpoint(args.resume)  # restores host_key too
        print(f"resumed from {args.resume} "
              f"(words_seen={float(trainer.state.words_seen):.0f})")
    emit = (lambda s: print(json.dumps({"log": s}))) if args.json else print
    from come_tpu.metrics.profiling import trace

    with trace(args.profile_dir):
        history = trainer.train(
            labels=ds.single_labels,
            log=emit,
            checkpoint_dir=args.checkpoint_dir,
        )
    dt = time.time() - t0
    print(f"trained in {dt:.1f}s")
    if history and "nmi" in history[-1]:
        print(f"final NMI: {history[-1]['nmi']:.4f}")
    f1 = None
    if args.eval_f1 and ds.labels is not None:
        from come_tpu.evaluation import node_classification_f1

        f1 = node_classification_f1(trainer.embeddings(), ds.labels)
        print(f"classification: macro-F1={f1['macro_f1']:.4f} "
              f"micro-F1={f1['micro_f1']:.4f}")
    if args.save:
        from come_tpu.iohelpers import save_embedding_word2vec

        save_embedding_word2vec(args.save, trainer.embeddings(),
                                ds.graph.node_names)
        print(f"embeddings -> {args.save}")
    if args.plot:
        from pathlib import Path

        import numpy as np

        from come_tpu.evaluation.plots import graph_plot, node_space_plot_2d

        out = Path(args.plot)
        out.mkdir(parents=True, exist_ok=True)
        p = trainer.state.params
        chol = np.asarray(p.chol_cov)
        covs = np.einsum("kde,kfe->kdf", chol, chol)
        node_space_plot_2d(
            trainer.embeddings(), trainer.communities(),
            np.asarray(p.centroid), covs,
            path=out / "embedding_space.png",
            title=f"{ds.name}: embedding space + GMM",
        )
        graph_plot(ds.graph, trainer.communities(),
                   path=out / "graph_communities.png",
                   title=f"{ds.name}: detected communities")
        print(f"plots -> {out}")
    return {"trainer": trainer, "history": history, "f1": f1}


if __name__ == "__main__":
    raise SystemExit(main())
