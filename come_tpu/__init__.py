"""come_tpu — a JAX framework for ComE-family graph embedding training.

A from-scratch JAX/XLA re-design of the capabilities of the reference
repo ``andompesta/nodeembedding-to-communityembedding`` (ComE, CIKM 2017):

* O1 — skip-gram context loss over random-walk windows (negative sampling)
* O2 — first-order edge proximity loss (LINE-1st style, negative sampling)
* O3 — GMM community-closure loss with a batched XLA EM fitter

The reference's Cython hogwild SGD kernel (``utils/training_sdg_inner.pyx``,
see SURVEY.md C1) is replaced by batched, deterministic gather → SDDMM →
sigmoid → segment-sum scatter-add updates as batched matmuls; its
``multiprocessing`` walk writer (SURVEY.md C3) is replaced by a fused
on-device random walker; sklearn's GaussianMixture (SURVEY.md C8) is
replaced by a batched EM step in XLA.

Package layout (SURVEY.md §7 build plan):

* ``graphs/``    — immutable CSR graph container, loaders, generators, registry
* ``sampling/``  — alias-table negative sampling, fused random walks, window pairs
* ``ops/``       — the sparse primitives (gathers, SDDMM scores, scatter-adds)
* ``losses/``    — O1/O2/O3 as pure ``(params, batch, rng) -> grads`` functions; XLA GMM
* ``models/``    — ComE model state (embedding tables + community parameters)
* ``trainer/``   — alternating optimization schedule, LR decay, train steps
* ``parallel/``  — mesh/sharding layout, sharded train steps (dp x model-sharded table)
* ``evaluation/``— NMI, macro/micro-F1, numpy gradient oracle parity harness
* ``iohelpers/`` — word2vec-text / npz checkpoints, resume
* ``config/``    — typed dataclass configs with per-dataset presets
* ``metrics/``   — edges/s meters, JSONL scalar sink
* ``native/``    — C++ host-side corpus feeder (walk generation off the hot path)
"""

__version__ = "0.1.0"

from come_tpu.graphs.csr import CSRGraph  # noqa: F401
