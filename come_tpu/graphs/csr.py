"""Immutable CSR graph container, host- and device-side.

Device-first replacement for the reference's dict-of-adjacency ``Graph`` class
(reference ``utils/graph_utils.py::Graph`` [R], SURVEY.md C2).  Instead of a
Python ``defaultdict(list)``, the graph is two flat int32 arrays —
``indptr [V+1]`` and ``indices [E]`` — which is the only layout that supports
static-shape, fully-vectorized neighbor gathers inside ``jit`` (a random-walk
step is one flat gather: ``indices[indptr[v] + r % degree[v]]``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable CSR adjacency. Undirected graphs store both arc directions.

    Attributes:
      indptr:  int32 [V+1], row offsets into ``indices``.
      indices: int32 [E], flattened neighbor lists (E counts directed arcs).
      node_names: optional original node labels, index-aligned; ``None`` means
        node ids are already dense 0..V-1 ints.
    """

    indptr: np.ndarray
    indices: np.ndarray
    node_names: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "indptr", np.asarray(self.indptr, np.int32))
        object.__setattr__(self, "indices", np.asarray(self.indices, np.int32))
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("indptr/indices must be 1-D")
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("inconsistent indptr")

    # -- basic accessors ----------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_arcs(self) -> int:
        """Number of directed arcs stored (2x edges for undirected graphs)."""
        return len(self.indices)

    @property
    def num_edges(self) -> int:
        """Undirected edge count (arcs / 2)."""
        return self.num_arcs // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def arcs(self) -> tuple[np.ndarray, np.ndarray]:
        """All directed arcs as (src [E], dst [E])."""
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int32), self.degrees)
        return src, self.indices

    def edges_undirected(self) -> tuple[np.ndarray, np.ndarray]:
        """Each undirected edge once, as (src, dst) with src < dst."""
        src, dst = self.arcs()
        keep = src < dst
        return src[keep], dst[keep]

    def degree_dict(self) -> dict[int, int]:
        """Node -> degree, the reference Model's vocab input (SURVEY.md C5)."""
        return {int(i): int(d) for i, d in enumerate(self.degrees)}

    def permute(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel nodes: new graph where old node ``i`` becomes ``perm[i]``.

        ``perm`` must be a permutation of 0..V-1.  Used by the sharded
        trainer to stripe community-sorted ids across row shards
        (parallel/exchange.py); embeddings map back via ``emb[perm]``.
        """
        perm = np.asarray(perm, np.int64)
        src, dst = self.arcs()
        names = None
        if self.node_names is not None:
            names = np.empty_like(self.node_names)
            names[perm] = self.node_names
        return CSRGraph.from_arcs(
            perm[src], perm[dst], num_nodes=self.num_nodes,
            symmetrize=False, remove_self_loops=False, node_names=names,
        )

    def subgraph(self, nodes: Sequence[int]) -> "CSRGraph":
        """Induced subgraph with nodes relabeled to 0..len(nodes)-1."""
        nodes = np.asarray(sorted(set(int(n) for n in nodes)), np.int64)
        remap = -np.ones(self.num_nodes, np.int64)
        remap[nodes] = np.arange(len(nodes))
        src, dst = self.arcs()
        keep = (remap[src] >= 0) & (remap[dst] >= 0)
        return CSRGraph.from_arcs(
            remap[src[keep]], remap[dst[keep]], num_nodes=len(nodes), symmetrize=False
        )

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_arcs(
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int | None = None,
        symmetrize: bool = True,
        remove_self_loops: bool = True,
        node_names: np.ndarray | None = None,
    ) -> "CSRGraph":
        """Build from arc lists; dedups; optionally adds reverse arcs.

        ``symmetrize=True`` mirrors the reference's ``make_undirected`` +
        ``make_consistent`` (sorted, deduped adjacency) [R, SURVEY.md C2].
        """
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if remove_self_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        # sort+dedup (make_consistent)
        key = src * np.int64(num_nodes) + dst
        key = np.unique(key)
        src = (key // num_nodes).astype(np.int64)
        dst = (key % num_nodes).astype(np.int64)
        indptr = np.zeros(num_nodes + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr.astype(np.int32), dst.astype(np.int32), node_names)

    @staticmethod
    def from_adjacency(adj: dict[int, Iterable[int]], **kw) -> "CSRGraph":
        src, dst = [], []
        for u, nbrs in adj.items():
            for v in nbrs:
                src.append(u)
                dst.append(v)
        n = kw.pop("num_nodes", None)
        if n is None:
            n = max([int(k) for k in adj] + [int(v) for v in dst] + [0]) + 1
        return CSRGraph.from_arcs(np.array(src), np.array(dst), num_nodes=n, **kw)

    def to_device(self):
        """Move CSR arrays to the default JAX device as a DeviceCSR."""
        import jax.numpy as jnp

        return DeviceCSR(
            indptr=jnp.asarray(self.indptr),
            indices=jnp.asarray(self.indices),
            degrees=jnp.asarray(self.degrees),
            # packed [V, 2] (row offset, degree): the walker reads both per
            # step — one two-lane gather instead of two element gathers
            ptr_deg=jnp.asarray(
                np.stack(
                    [np.asarray(self.indptr[:-1]), np.asarray(self.degrees)],
                    axis=1,
                ).astype(np.int32)
            ),
        )


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """CSR arrays resident on device; a pytree usable inside jit.

    ``degrees`` is pre-materialized so a walk step needs no indptr diff.
    """

    indptr: "object"  # jnp int32 [V+1]
    indices: "object"  # jnp int32 [E]
    degrees: "object"  # jnp int32 [V]
    ptr_deg: "object" = None  # jnp int32 [V, 2]: (indptr[v], degree[v])

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_arcs(self) -> int:
        return self.indices.shape[0]


def _flatten_device_csr(g: DeviceCSR):
    return (g.indptr, g.indices, g.degrees, g.ptr_deg), None


def _unflatten_device_csr(_, children):
    return DeviceCSR(*children)


import jax.tree_util as _tree_util  # noqa: E402

_tree_util.register_pytree_node(
    DeviceCSR, _flatten_device_csr, _unflatten_device_csr
)
