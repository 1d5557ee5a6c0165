"""Parity harness self-test (the BASELINE acceptance gate as a module)."""

from come_tpu.evaluation.parity import check_gradient_parity
from come_tpu.graphs import get_dataset


def test_parity_passes_on_karate():
    ds = get_dataset("karate")
    rep = check_gradient_parity(ds.graph, dim=16, pairs=256, seed=0)
    assert rep.passed, str(rep)
    assert rep.o1_max_err < 1e-4
    assert rep.o2_max_err < 1e-4
    assert rep.o3_max_err < 1e-4
    # fast-path (shipping-step) rows: banded walk step + tied shared-pool
    # block step vs the shared-pool oracle (VERDICT r1 item 6)
    assert rep.o1_fast_max_err < 1e-3
    assert rep.o2_fast_max_err < 1e-3
    # shipping-CONFIG rows (VERDICT r2 item 6): multi-block banded step vs
    # the composed sequential oracle, the (2,2)-mesh row-sharded step vs
    # the per-worker sum-of-deltas composition, and the star O2 step
    assert rep.o1_fast_multi_max_err < 1e-3
    assert rep.o1_fast_rowsharded_max_err < 1e-3  # 8-dev CPU suite: not nan
    assert rep.o2_star_max_err < 1e-3
