"""True multi-host semantics via a 2-process CPU simulation.

This is a CPU-only simulation: each process owns virtual CPU devices, and
one process per GPU is what a real multi-card run uses.

SURVEY.md §4 requires multi-process testing without a pod; VERDICT r1
item 3 requires `jax.distributed.initialize` + per-process shard
construction to be exercised end-to-end.  Each worker process owns 2
virtual CPU devices; the (2, 2) mesh's model axis spans BOTH processes, so
row shards of the embedding table live on different processes and every
collective crosses the process boundary.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow  # subprocess pairs, ~1-3 min each

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "multiproc_train.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(
    tier: str, timeout: float = 420.0, checkpoint_dir=None,
    elastic_load=None,
):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = os.environ.copy()
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env.pop("JAX_PLATFORMS", None)
        extra = (
            ["--checkpoint-dir", str(checkpoint_dir)]
            if checkpoint_dir
            else []
        )
        if elastic_load:
            extra += ["--elastic-load", str(elastic_load)]
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    str(SCRIPT),
                    "--coordinator", f"localhost:{port}",
                    "--num-processes", "2",
                    "--process-id", str(pid),
                    "--tier", tier,
                ] + extra,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=str(REPO),
                env=env,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return procs, outs


def _result_line(out: str) -> str:
    lines = [l for l in out.splitlines() if l.startswith("MULTIPROC")]
    assert lines, f"no MULTIPROC result line in:\n{out}"
    return lines[-1]


@pytest.mark.parametrize(
    "tier",
    ["xla-a2a", "banded-rowsharded", "host-corpus"],
)
def test_two_process_cpu_training(tier):
    procs, outs = _launch(tier)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-4000:]}"
    r0, r1 = (_result_line(o) for o in outs)
    # losses are globally psum'd: both hosts must report identical values
    assert r0.split("pid=0 ")[1] == r1.split("pid=1 ")[1], (r0, r1)
    nmi = float(r0.split("nmi=")[1].split()[0])
    assert nmi >= 0.95, r0  # all three tiers reach 1.0 on this SBM


def test_two_process_sharded_checkpoint_resume(tmp_path):
    """Sharded checkpoint + bit-exact resume across the process boundary
    (VERDICT r2 next-round item 4): per-process shard files, no host
    gather of the non-addressable model-sharded tables, identical
    continuation after restore (asserted inside multiproc_train.py)."""
    procs, outs = _launch("xla-a2a", checkpoint_dir=tmp_path)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-4000:]}"
    for out in outs:
        assert "ckpt=ok" in _result_line(out), out[-2000:]
    # one shard file per process, none missing
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == ["state.proc0.npz", "state.proc1.npz"], files

    # ELASTIC restore across a real PROCESS-COUNT change (VERDICT r3 item
    # 7): load the 2-process checkpoint in THIS single process (its own
    # (2,2) mesh over virtual devices) — the merged logical state must
    # match the saving run's embedding fingerprint bit-for-bit
    import hashlib

    import jax
    import numpy as np

    from come_tpu.config import ComEConfig
    from come_tpu.graphs import sbm_graph
    from come_tpu.parallel import ShardedComETrainer, make_mesh

    want = _result_line(outs[0]).split("embhash=")[1].split()[0]
    g, _ = sbm_graph(256, 4, p_in=0.25, p_out=0.01, seed=7)
    cfg = ComEConfig(
        dim=32, num_communities=4, walk_length=16, walks_per_node=2,
        window=4, negative_mode="shared", shared_negatives=64,
        banded="never", row_exchange="a2a",
        batch_walks=32, batch_edges=1024, batch_pairs=2048,
        outer_iters=0, pretrain_epochs=10, gmm_max_iter=15, reg_covar=1e-2,
    )
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, cfg, mesh)
    t.load_checkpoint(tmp_path / "state")  # 2-proc files, 1 process now
    got = hashlib.sha256(
        np.ascontiguousarray(t.embeddings()).tobytes()
    ).hexdigest()[:16]
    assert got == want, (got, want)


def test_elastic_restore_grow_direction(tmp_path):
    """Elastic restore onto MORE processes than saved (ADVICE r4 item 1):
    a 1-process checkpoint is loaded by a 2-process run.  Process 1 has
    no own shard file and must fall back to file 0's topology metadata
    instead of raising 'pre-elastic format'; both processes must agree on
    the restored logical-embedding fingerprint, which must equal the
    saving trainer's."""
    import hashlib

    import jax
    import numpy as np

    from come_tpu.config import ComEConfig
    from come_tpu.graphs import sbm_graph
    from come_tpu.parallel import ShardedComETrainer, make_mesh

    # save in THIS single process (a (2,2) mesh over 4 virtual devices)
    g, _ = sbm_graph(256, 4, p_in=0.25, p_out=0.01, seed=7)
    cfg = ComEConfig(
        dim=32, num_communities=4, walk_length=16, walks_per_node=2,
        window=4, negative_mode="shared", shared_negatives=64,
        banded="never", row_exchange="a2a",
        batch_walks=32, batch_edges=1024, batch_pairs=2048,
        outer_iters=0, pretrain_epochs=10, gmm_max_iter=15, reg_covar=1e-2,
    )
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    t = ShardedComETrainer(g, cfg, mesh)
    t.o1_epoch()  # a non-initial state so the fingerprint is non-trivial
    t.save_checkpoint(tmp_path / "state")
    want = hashlib.sha256(
        np.ascontiguousarray(t.embeddings()).tobytes()
    ).hexdigest()[:16]
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == ["state.proc0.npz"], files  # 1-process save

    procs, outs = _launch("xla-a2a", elastic_load=tmp_path / "state")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-4000:]}"
    hashes = [
        _result_line(o).split("elastichash=")[1].split()[0] for o in outs
    ]
    assert hashes == [want, want], (hashes, want)
