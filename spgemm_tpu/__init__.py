"""spgemm_tpu — a tiled sparse linear-algebra framework in JAX, run on
an NVIDIA H100 (the package keeps its historical name).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of TileSpGEMM
(PPoPP'22; reference fork at for-the-juan/SpGEMM): general sparse matrix-matrix
multiplication C = A*B with sparse A, B, C (C = A^2 and C = A*A^T), built on a
tiled sparse format, plus SpMV/SpMM on the same structure and multi-chip
scaling via jax.sharding meshes.

Architecture (modelled on the reference, not a port of it):
  * models/  — the data model: CSR and the tiled sparse format (`TileMat`).
               Host-side converters (csr2tile / tile2csr / transpose) are
               vectorized NumPy (argsort/reduceat), with an optional C++
               fast path.
  * ops/     — compute: symbolic tile-grid SpGEMM (pair-list construction),
               the numeric tile-pair product pipeline (batched matmuls +
               segment reduction in XLA), the ESC engine for
               unstructured patterns (sorted-run scan; double-double f64),
               the Ozaki-slice engine (exact f64 via int8 matmuls),
               golden reference
               algorithms (SPA / dense-row / ESC), and SpMV/SpMM (incl. a
               gather SpMM for unstructured inputs).
  * parallel/— multi-chip execution: C-tile work partitioning over a
               jax.sharding.Mesh with shard_map, B tile all-gather.
  * utils/   — platform decisions, timing, CSV sinks, roofline
               accounting.
  * io/      — Matrix Market reader/writer.

Reference parity map lives in SURVEY.md; each module's docstring cites the
reference component (file:line in the reference source) it replaces.
"""

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.models.tile import TileMat, csr_to_tiles, tiles_to_csr
from spgemm_tpu.ops.spgemm import spgemm, spgemm_csr, SpGEMMResult
from spgemm_tpu.ops.esc import build_esc_scan_plan, esc_scan_dd, spgemm_esc
from spgemm_tpu.ops.executor import (EscExecutor, OzakiExecutor,
                                     StripExecutor)
from spgemm_tpu.ops.ozaki import build_ozaki_plan, spgemm_ozaki
from spgemm_tpu.ops.spmm import spmm, spmm_gather, spmv
from spgemm_tpu.io.mmio import read_mtx, write_mtx
from spgemm_tpu.io import checkpoint

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "TileMat",
    "csr_to_tiles",
    "tiles_to_csr",
    "spgemm",
    "spgemm_csr",
    "spgemm_esc",
    "build_esc_scan_plan",
    "esc_scan_dd",
    "spmm",
    "spmm_gather",
    "spmv",
    "SpGEMMResult",
    "StripExecutor",
    "read_mtx",
    "write_mtx",
    "checkpoint",
    "__version__",
]
