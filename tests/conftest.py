"""Test harness config: force an 8-virtual-device CPU mesh.

Multi-device sharding semantics are tested without accelerators via
``--xla_force_host_platform_device_count`` (SURVEY.md §4 test-strategy gap).
Before any backend is initialized we (a) inject the virtual-device XLA flag
and (b) point ``jax_platforms`` at cpu only.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them unless a card is visible.  They run on a machine
with a card with ``COME_GPU_TESTS=1``, which leaves the backend alone:

    COME_GPU_TESTS=1 python -m pytest tests/ -q -m gpu
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("COME_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (run with COME_GPU_TESTS=1 -m gpu)",
    )


# Tests measured >= ~9 s on a CPU durations capture: marked slow centrally
# so the DEFAULT `pytest -q` tier (pytest.ini addopts excludes -m slow)
# stays a short edit-test loop.  Subprocess suites mark themselves via
# module-level pytestmark.  Run the FULL suite with `-m ""`.
SLOW_TESTS = {
    "test_banded_trains_on_heavy_tail",
    "test_rowsharded_a2a_heavy_tail_capacity",
    "test_banded_rowsharded_heavy_tail",
    "test_host_corpus_sharded_mesh",
    "test_parity_passes_on_karate",
    "test_sharded_shared_negatives_mode",
    "test_sharded_checkpoint_roundtrip",
    "test_sharded_karate_trains",
    "test_elastic_checkpoint_restore",
    "test_sharded_a2a_trains_and_matches_quality",
    "test_determinism_same_seed",
    "test_checkpoint_resume_bit_exact",
    "test_banded_dp_tier_trains",
    "test_banded_selected_at_large_v",
    "test_banded_rowsharded_tier_trains",
    "test_banded_selected_and_trains",
    "test_isolated_nodes_never_walked_or_updated",
    "test_fixture_trains_end_to_end",
}


def pytest_collection_modifyitems(config, items):
    slow = pytest.mark.slow
    for item in items:
        base = getattr(item, "originalname", None) or item.name
        if base in SLOW_TESTS:
            item.add_marker(slow)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX sees {devices[0].platform}")
    return devices[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)
