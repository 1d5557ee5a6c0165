"""chip_smoke.py and bench.py refuse to report without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("standalone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, standalone):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if standalone:  # only the script, none of the package
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    r = _run(script, cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_bench_refuses_without_gpu():
    r = _run(REPO / "bench.py", REPO)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert "edge_updates" not in r.stdout
