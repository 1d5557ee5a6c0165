"""Multi-host initialization and launch helpers.

The reference is strictly single-process (SURVEY.md §2: no NCCL/MPI/Gloo —
shared memory and walk files were its only "communication").  come_tpu runs
multi-host the JAX way: one process per host, ``jax.distributed.initialize``,
then a single global ('data','model') mesh spanning every chip; XLA
collectives ride the devices' interconnect within a host and the network
across hosts
(BASELINE.json:5).  Nothing else in the trainer changes — ShardedComETrainer
shards global arrays, and each host only materializes its addressable
shards.

Launch (one command per host):

    python -m come_tpu.parallel.distributed \
        --coordinator 10.0.0.1:8476 --num-processes 4 --process-id $ID \
        --dataset synthetic-10m --model-axis 4

"""

from __future__ import annotations

import argparse


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """``jax.distributed.initialize`` with explicit or env-inferred args."""
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs = dict(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="multi-host ComE training")
    p.add_argument("--coordinator", help="host:port of process 0")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--dataset", default="synthetic-10m")
    p.add_argument("--model-axis", type=int, default=1,
                   help="size of the table-sharding mesh axis")
    p.add_argument("--outer-iters", type=int)
    args = p.parse_args(argv)

    initialize_distributed(
        args.coordinator, args.num_processes, args.process_id
    )

    import jax

    from come_tpu.config import PRESETS, ComEConfig
    from come_tpu.graphs import get_dataset
    from come_tpu.parallel import ShardedComETrainer, make_mesh

    ds = get_dataset(args.dataset)
    cfg = PRESETS.get(args.dataset.lower(), ComEConfig()).replace(
        num_communities=ds.num_communities
    )
    if args.outer_iters is not None:
        cfg = cfg.replace(outer_iters=args.outer_iters)
    mesh = make_mesh(model=args.model_axis)
    if jax.process_index() == 0:
        print(
            f"{jax.process_count()} hosts x "
            f"{jax.local_device_count()} chips; mesh "
            f"({mesh.shape['data']},{mesh.shape['model']})"
        )
    trainer = ShardedComETrainer(ds.graph, cfg, mesh)
    log = print if jax.process_index() == 0 else None
    trainer.train(labels=ds.single_labels, log=log)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
