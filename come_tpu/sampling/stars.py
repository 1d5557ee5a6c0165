"""Shared-source fan-out ("star") layout for the O2 edge pass.

The reference's O2 learner streams the edge list and trains each edge in
both directions with the per-pair Cython kernel (reference
``ADSCModel/node_embeddings.py::Node2Vec.train`` [R], SURVEY.md C7/§3.3).
Reproducing that shape 1:1 — two gathered slots per edge, one trained pair
per slot — makes the edge pass row-op bound.

This module builds the layout that breaks that ceiling: arcs are grouped
by SOURCE into *segments* (a hub node followed by its fan-out neighbors),
segments are packed back-to-back into 128-slot rows, and the banded star
step (``losses/star_banded.py``) trains every (hub <-> neighbor) pair of a
segment from one gather of the segment's rows.  A segment of fan-out f
occupies f+1 slots and trains 2f pairs, so pairs/slot approaches 2 —
double the one-pair-per-slot layout — while the tied table (O2 reads and
writes only ``node_embedding``, SURVEY.md C7) halves the row-ops per slot.

Layout invariants (asserted by tests/test_stars.py):
  * every undirected edge appears exactly ONCE, as a neighbor slot in a
    segment hubbed by one of its endpoints (the step trains u->v and
    v->u from that single slot);
  * segments never span 128-slot row boundaries (a segment that would
    cross is split, repeating the hub — the step's mask is built from
    per-slot segment ids and only pairs slots within one row);
  * pad slots carry meta == -2 and node 0, and self-mask in the step.
"""

from __future__ import annotations

import numpy as np

ROW = 128  # slots per packed row == the star step's block width

PAD_META = -2  # seg -1 / hub 0 under the meta = seg*2 + is_hub encoding


def build_star_layout(
    u: np.ndarray,
    v: np.ndarray,
    num_nodes: int,
    row_slots: int = ROW,
    max_fanout: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack an undirected edge list into hub/fan-out star rows.

    Args:
      u, v: int arrays [E], one entry per undirected edge.
      num_nodes: V (for degree-based orientation).
      row_slots: slots per row (the star step's block width; 128).

    Returns (slots, meta), both int32 of equal length T (a multiple of
    ``row_slots``):
      slots[t]: node id staged at slot t (0 at pads)
      meta[t]:  seg_id * 2 + is_hub; PAD_META at pads.

    Segment ids are LOCAL TO THEIR ROW (0..row_slots/2-1): the star step
    only compares meta within one row (segments never span rows).

    Each edge is assigned to its HIGHER-degree endpoint as hub (ties to
    the smaller id) — fewer, fatter segments means fewer hub slots and
    pairs/slot closer to 2.

    ``max_fanout`` caps a segment's neighbor count (splitting repeats the
    hub).  It bounds the largest synchronously-applied per-row update (a
    hub's positive gradients and fan-out-scaled negative weight apply
    from block-start state with no sequential sigmoid feedback), and the
    per-epoch row shuffle then scatters a big hub's split segments
    across blocks.  The cap is a nearly-free precaution (slot efficiency
    2f/(f+1) is already 1.94 at f=32) for power-law graphs whose hubs
    dwarf BlogCatalog's.
    """
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    E = u.shape[0]
    if E == 0:
        return (
            np.zeros((row_slots,), np.int32),
            np.full((row_slots,), PAD_META, np.int32),
        )
    deg = np.bincount(
        np.concatenate([u, v]), minlength=num_nodes
    ).astype(np.int64)
    take_u = (deg[u] > deg[v]) | ((deg[u] == deg[v]) & (u < v))
    src = np.where(take_u, u, v)
    dst = np.where(take_u, v, u)

    order = np.argsort(src, kind="stable")
    src_s = src[order]
    dst_s = dst[order].astype(np.int32)
    # per-source group boundaries in the sorted arc list
    starts = np.flatnonzero(np.r_[True, src_s[1:] != src_s[:-1]])
    ends = np.r_[starts[1:], E]
    hubs = src_s[starts].astype(np.int32)

    # worst case: a segment is cut every min(max_fanout, row_slots-1)
    # neighbors (each cut repeats the hub), plus <= row_slots-2 pad slots
    # per forced row break.  The divisor must honor max_fanout — with the
    # old row_slots-only budget, a single hub of degree ~11k overflowed
    # the buffer at the default cap (round-5 review finding, reproduced).
    n_seg0 = starts.shape[0]
    cut = max(1, min(max_fanout, row_slots - 1))
    cap = E + n_seg0 + E // cut + n_seg0 * 2 + 2 * row_slots
    slots = np.zeros((cap,), np.int32)
    meta = np.full((cap,), PAD_META, np.int32)

    c = 0
    for k in range(n_seg0):
        hub = hubs[k]
        lo, hi = starts[k], ends[k]
        while lo < hi:
            space = row_slots - (c % row_slots)
            if space < 2:  # no room for hub + >=1 neighbor: pad out the row
                c += space
                space = row_slots
            m = min(hi - lo, space - 1, max_fanout)
            seg_id = (c % row_slots) // 2  # row-local, collision-free:
            # segments occupy >= 2 slots, so start//2 is unique in a row
            slots[c] = hub
            meta[c] = seg_id * 2 + 1
            slots[c + 1 : c + 1 + m] = dst_s[lo : lo + m]
            meta[c + 1 : c + 1 + m] = seg_id * 2
            c += m + 1
            lo += m

    T = -(-c // row_slots) * row_slots
    return slots[:T].copy(), meta[:T].copy()


def star_layout_stats(slots: np.ndarray, meta: np.ndarray) -> dict:
    """Occupancy accounting for logs/tests: pairs, slots, utilization."""
    meta = np.asarray(meta)
    pads = int(np.sum(meta == PAD_META))
    hubs = int(np.sum((meta != PAD_META) & (meta & 1 == 1)))
    arcs = int(np.sum((meta != PAD_META) & (meta & 1 == 0)))
    return {
        "slots": int(meta.shape[0]),
        "arcs": arcs,
        "hubs": hubs,
        "pads": pads,
        "pairs": 2 * arcs,
        "pairs_per_slot": 2.0 * arcs / max(meta.shape[0], 1),
    }
