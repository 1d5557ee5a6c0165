"""A/B of the surviving O1 and O2 tiers on the blogcatalog preset (GPU).

    python scripts/tier_ab.py [--reps 4] [--seeds 0 1 2]

Speed: O1 through the banded tier as ``auto`` picks it for the preset (the
largest walk block the collision envelope admits at the batch of 256
walks: 128 walks, 2*128*80*5.5/10312 = 10.9 <= 16) against the
micro-batched shared-pool path; O2 through the banded star tier against
the flat shared-pool path.  Each side is compiled and warmed first, then
epochs alternate A B B A ... so drift hits both sides alike.  Every epoch
returns a host float, so each timing ends after the device finished.

Quality: every pairing of the two O1 tiers with the two O2 tiers trains
the full preset schedule once per seed, reporting NMI per outer iteration
and whether every loss stayed finite, since a faster tier must also keep
quality.

Prints one JSON line per measurement; refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _alternate(epoch_a, epoch_b, reps):
    ta, tb = [], []
    for i in range(reps):
        for name in ("ab" if i % 2 == 0 else "ba"):
            fn, out = (epoch_a, ta) if name == "a" else (epoch_b, tb)
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return ta, tb


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = p.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("tier_ab: needs a GPU", file=sys.stderr)
        return 1
    from come_tpu.compile_cache import enable_compile_cache
    from come_tpu.config import get_config
    from come_tpu.graphs import get_dataset
    from come_tpu.trainer import ComETrainer

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    ds = get_dataset("blogcatalog")
    cfg = get_config("blogcatalog").replace(
        num_communities=ds.num_communities
    )
    sides = {
        "o1": (
            ("banded", cfg),
            ("xla", cfg.replace(banded="never")),
        ),
        "o2": (
            ("banded-star", cfg.replace(o2_mode="star")),
            ("xla", cfg.replace(o2_mode="xla")),
        ),
    }
    for phase, ((na, ca), (nb, cb)) in sides.items():
        ta_, tb_ = ComETrainer(ds.graph, ca), ComETrainer(ds.graph, cb)
        ep = "o1_epoch" if phase == "o1" else "o2_epoch"
        for t in (ta_, tb_):
            getattr(t, ep)()  # compile + warm
        ms_a, ms_b = _alternate(
            getattr(ta_, ep), getattr(tb_, ep), args.reps
        )
        pairs = "last_o1_pairs" if phase == "o1" else "last_o2_pairs"
        for name, t, ms in ((na, ta_, ms_a), (nb, tb_, ms_b)):
            med = statistics.median(ms)
            print(json.dumps({
                "phase": phase, "tier": name, "epoch_ms": ms,
                "median_ms": round(med, 3),
                "pairs": getattr(t, pairs),
                "pairs_per_s": round(getattr(t, pairs) / med * 1e3, 1),
                "card": card, "device_kind": jax.devices()[0].device_kind,
            }), flush=True)
        del ta_, tb_
    o1_kw = {"banded": {}, "xla": {"banded": "never"}}
    o2_kw = {"banded-star": {"o2_mode": "star"}, "xla": {"o2_mode": "xla"}}
    for seed in args.seeds:
        for o1, o2 in itertools.product(o1_kw, o2_kw):
            c = cfg.replace(seed=seed, **o1_kw[o1], **o2_kw[o2])
            t = ComETrainer(ds.graph, c)
            assert (t.o1_tier(), t.o2_tier()) == (o1, o2)
            t0 = time.perf_counter()
            hist = t.train(labels=ds.single_labels)
            print(json.dumps({
                "phase": "quality", "seed": seed, "o1_tier": o1,
                "o2_tier": o2, "nmi": [round(r["nmi"], 4) for r in hist],
                "finite": all(math.isfinite(v) for r in hist
                              for k, v in r.items() if k.endswith("_loss")),
                "o1_loss": hist[-1]["o1_loss"],
                "train_s": round(time.perf_counter() - t0, 2),
            }), flush=True)
            del t
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
