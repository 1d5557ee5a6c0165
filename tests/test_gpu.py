"""Checks that need an NVIDIA GPU; they skip where JAX sees none.

Run them on a machine with a card:

    COME_GPU_TESTS=1 python -m pytest tests/ -q -m gpu
"""

import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.gpu


def test_parity_phase_on_card(gpu):
    """chip_smoke.py's oracle parity at reduced sizes, compiled for the
    card (float32 matmuls at "highest" precision)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    chip_smoke.phase_parity(v=2048, block=32, pairs=1024, star_rows=64,
                            gmm_points=2048, gmm_k=8)
