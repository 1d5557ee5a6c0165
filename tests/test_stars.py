"""Star O2 tier: layout builder invariants.

The banded star step that trains this layout is gated against the numpy
oracle in tests/test_star_banded.py.
"""

import numpy as np

from come_tpu.sampling.stars import (
    PAD_META,
    build_star_layout,
    star_layout_stats,
)


def _rand_edges(rng, V, E):
    """Unique undirected edges, no self loops."""
    seen = set()
    u, v = [], []
    while len(u) < E:
        a, b = rng.integers(0, V, 2)
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        u.append(a)
        v.append(b)
    return np.asarray(u, np.int64), np.asarray(v, np.int64)


# --------------------------------------------------------- layout builder


def test_layout_covers_every_edge_once(rng):
    V, E = 40, 120
    u, v = _rand_edges(rng, V, E)
    slots, meta = build_star_layout(u, v, V)
    assert slots.shape == meta.shape
    assert slots.shape[0] % 128 == 0

    # reconstruct the trained arc set: each neighbor slot trains
    # (hub -> n) and (n -> hub) for its segment's hub.  Seg ids are
    # row-local, so segments are keyed by (row, seg).
    got = []
    seg_hub = {}
    for t in range(slots.shape[0]):
        m = meta[t]
        if m == PAD_META:
            continue
        seg, hub = m >> 1, m & 1
        if hub:
            key = (t // 128, seg)
            assert key not in seg_hub, "duplicate hub for a segment"
            seg_hub[key] = slots[t]
    for t in range(slots.shape[0]):
        m = meta[t]
        if m == PAD_META or (m & 1):
            continue
        got.append((seg_hub[(t // 128, m >> 1)], slots[t]))
    want = sorted(
        (min(a, b), max(a, b)) for a, b in zip(u.tolist(), v.tolist())
    )
    got_norm = sorted((min(a, b), max(a, b)) for a, b in got)
    assert got_norm == want  # every edge exactly once


def test_layout_segments_stay_within_rows(rng):
    V = 30
    # one hub with fan-out >> 128 forces splits
    u = np.zeros(400, np.int64)
    v = (np.arange(400) % (V - 1)) + 1
    slots, meta = build_star_layout(u, v, V)
    segs = {}
    for t in range(slots.shape[0]):
        m = meta[t]
        if m == PAD_META:
            continue
        segs.setdefault((t // 128, m >> 1), []).append(t)
    for seg, ts in segs.items():
        # exactly one hub per (row-local) segment, seg ids f32-exact
        hubs = [t for t in ts if meta[t] & 1]
        assert len(hubs) == 1
        assert 0 <= meta[ts[0]] < 128

    st = star_layout_stats(slots, meta)
    assert st["arcs"] == 400
    assert st["pairs"] == 800


def test_layout_orients_to_higher_degree_hub():
    # path graph 0-1-2: node 1 has degree 2, should hub both edges
    u = np.array([0, 1], np.int64)
    v = np.array([1, 2], np.int64)
    slots, meta = build_star_layout(u, v, 3)
    hubs = [slots[t] for t in range(len(slots)) if meta[t] != PAD_META and meta[t] & 1]
    assert hubs == [1]  # single segment hubbed at node 1
    st = star_layout_stats(slots, meta)
    assert st["hubs"] == 1 and st["arcs"] == 2


def test_layout_pairs_per_slot_beats_paired_tier(rng):
    """On a BlogCatalog-shaped graph the layout must approach 2 pairs per
    slot — the whole point of the tier (one pair per slot sits at 1.0)."""
    from come_tpu.graphs import sbm_graph

    g, _ = sbm_graph(600, 5, p_in=0.1, p_out=0.01, seed=3)
    u, v = g.edges_undirected()
    slots, meta = build_star_layout(u, v, g.num_nodes)
    st = star_layout_stats(slots, meta)
    assert st["pairs_per_slot"] > 1.6


def test_layout_fat_hub_capacity():
    """A single hub whose degree dwarfs the row size: the preallocation
    must budget for max_fanout-induced hub repeats (round-5 review
    finding — degree ~11k overflowed the old row_slots-only budget)."""
    deg = 11000
    u = np.zeros(deg, np.int64)
    v = np.arange(1, deg + 1, dtype=np.int64)
    slots, meta = build_star_layout(u, v, deg + 1)
    st = star_layout_stats(slots, meta)
    assert st["arcs"] == deg and st["pairs"] == 2 * deg
    # every segment still fits a row and carries exactly one hub
    for r in range(slots.shape[0] // 128):
        row = meta[r * 128 : (r + 1) * 128]
        segs = {}
        for t, m in enumerate(row):
            if m != PAD_META:
                segs.setdefault(int(m) >> 1, []).append(int(m) & 1)
        for hubs in segs.values():
            assert sum(hubs) == 1
