"""Assemble EVAL_rNN.json from eval_sweep result files.

Usage:
  python scripts/build_eval_artifact.py --out EVAL_rNN.json \
      --inputs /tmp/eval_small.json /tmp/eval_10m.json /tmp/eval_mesh.json

The artifact is the committed quality-regression baseline (VERDICT r4
item 4): NMI + macro/micro-F1 (+ the deepwalk train-ratio sweep) for
every registered dataset and a sharded-trainer (virtual mesh) run,
captured on the hardware named in `platform`.  tests/test_eval_regression.py
holds the floors each dataset must meet.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)

    results = []
    for f in args.inputs:
        results.extend(json.loads(Path(f).read_text()))
    platform = args.platform
    if platform is None:
        import jax

        platform = (
            f"{jax.default_backend()}:"
            f"{jax.devices()[0].device_kind if jax.devices() else '?'}"
        )
    rev = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"],
        capture_output=True, text=True,
        cwd=Path(__file__).resolve().parents[1],
    ).stdout.strip()
    out = {
        "artifact": Path(args.out).name,
        "protocol": (
            "scripts/eval_sweep.py full presets (+ --fast for mesh "
            "runs); NMI = argmax(pi) vs ground truth; F1 = OvR "
            "logistic, deepwalk top-k multi-label protocol; "
            "f1_by_train_ratio at {0.1,0.3,0.5,0.7,0.9}"
        ),
        "platform": platform,
        "git": rev,
        "results": results,
    }
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(f"wrote {args.out} with {len(results)} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
