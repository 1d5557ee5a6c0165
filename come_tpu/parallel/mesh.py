"""Device mesh + sharding layout for ComE training.

The reference has no distributed layer at all (SURVEY.md §2: hogwild threads
+ shared memory are its only "backend"); this module is the new
creation called for by BASELINE.json:5: edge/walk shards partitioned over a
``data`` mesh axis, the embedding tables row-sharded over a ``model`` axis,
boundary rows exchanged with XLA collectives.

Layout summary (V nodes, d dims, K communities, D x M mesh):
  node_emb/ctx_emb [V, d]   -> P('model', None)   row-sharded
  pi               [V, K]   -> P('model', None)   aligned with node_emb
  centroid/cov     [K, ...] -> replicated
  walk starts / edge arcs   -> P('data')          batch-sharded
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: int | None = None,
    model: int = 1,
    devices=None,
) -> Mesh:
    """Build a ('data', 'model') mesh; defaults to all devices on data."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, ("data", "model"))


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """PartitionSpecs for every ComE tensor family on a ('data','model') mesh."""

    mesh: Mesh

    @property
    def data_size(self) -> int:
        return self.mesh.shape["data"]

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"]

    # specs ---------------------------------------------------------------
    def table(self) -> P:
        """Embedding tables / responsibilities: row-sharded over model."""
        return P("model", None)

    def community(self) -> P:
        """Centroids / covariances: replicated (K is small)."""
        return P()

    def batch(self) -> P:
        """Walk starts, edge endpoints, pair tensors: sharded over data."""
        return P("data")

    def replicated(self) -> P:
        return P()

    # helpers -------------------------------------------------------------
    def shard(self, x, spec: P):
        """Place a host array on the mesh under ``spec``.

        Single-process: plain ``device_put``.  Multi-process (one process
        per host, ``jax.distributed.initialize``): every process computes
        the same host-global value deterministically (trainer inputs are
        all derived from the config seed), and each contributes only its
        addressable shards via ``make_array_from_callback`` —
        ``device_put`` of a host-global array onto non-addressable devices
        is invalid (VERDICT r1 item 3; tested by tests/test_multiprocess.py
        in a 2-process CPU simulation)."""
        sharding = NamedSharding(self.mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        xnp = np.asarray(x)
        return jax.make_array_from_callback(
            xnp.shape, sharding, lambda idx: xnp[idx]
        )

    def params_specs(self):
        """PartitionSpec pytree matching ComEParams."""
        from come_tpu.models import ComEParams

        return ComEParams(
            node_emb=self.table(),
            ctx_emb=self.table(),
            centroid=self.community(),
            chol_cov=self.community(),
            inv_cov=self.community(),
            pi=self.table(),
        )

    def rows_per_shard(self, v: int) -> int:
        m = self.model_size
        if v % m != 0:
            raise ValueError(
                f"num_nodes {v} must be padded to a multiple of model={m}"
            )
        return v // m
