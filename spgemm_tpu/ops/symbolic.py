"""Symbolic phase: tile-grid SpGEMM and tile-pair schedule construction.

Replaces the reference's step 1 (symbolic tile-grid SpGEMM:
`tile_spgemm_step1_cuda_spa_kernel` / nsparse hash path,
`src/tilespgemm-cuda.h:279-392`, `src/spgemm_nsparse_kernel.h`) and the
pair-matching half of steps 2/3 (warp binary-search set intersection,
`src/tilespgemm-cuda.h:167-277,538-663`).

Reformulation: instead of intersecting A's tile-row with B's
tile-column per C tile (which needs B column-major and per-thread binary
search), we *expand* in Gustavson order — every A tile (i,k) pairs with
every B tile in tile-row k — then sort pairs by C tile key. One vectorized
argsort replaces binning, hashing, and intersection entirely, and the
sorted pair list is exactly the schedule the numeric kernel wants:
contiguous segments per C tile, ascending k inside a segment.

Output sizes (number of C tiles, pair count) are data-dependent, so this
phase runs on host (NumPy) and hands static-shaped arrays to the jitted
numeric phase — mirroring the reference's own device-to-host size syncs
(`tilespgemm-cuda.h:2404,2604`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spgemm_tpu.models.csr import INDEX_DTYPE
from spgemm_tpu.models.tile import TileMat


@dataclasses.dataclass
class PairSchedule:
    """Tile-pair work schedule for C = A @ B.

    num_pairs = total matched (A tile, B tile) products (the tile-grid
    nnzCub); nt_c = number of candidate C tiles (grid-level symbolic —
    some may turn out empty after the intra-tile numeric pass and are
    pruned at compaction).

      pa, pb    : (num_pairs,) int32 — A / B tile ordinals per pair,
                  sorted by owning C tile, ascending k within a C tile
      seg       : (num_pairs,) int32 — owning C tile ordinal per pair
      pair_ptr  : (nt_c+1,) int32    — pair range per C tile
      ctrow/ctcol : (nt_c,) int32    — C tile coordinates, sorted row-major
      c_tptr    : (c_gm+1,) int32    — C tile-row pointer
    """

    pa: np.ndarray
    pb: np.ndarray
    seg: np.ndarray
    pair_ptr: np.ndarray
    ctrow: np.ndarray
    ctcol: np.ndarray
    c_tptr: np.ndarray
    c_grid_shape: tuple[int, int]

    @property
    def num_pairs(self) -> int:
        return int(self.pa.size)

    @property
    def nt_c(self) -> int:
        return int(self.ctrow.size)


def build_pair_schedule(a: TileMat, b: TileMat) -> PairSchedule:
    """Enumerate and sort all tile-pair products of C = A @ B."""
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if a.tn != b.tm:
        raise ValueError(
            f"inner tile dims must match: A is {a.tm}x{a.tn}, B is {b.tm}x{b.tn}"
        )
    c_gm, c_gn = a.gm, b.gn

    # Expand: A tile (i,k) x every B tile of tile-row k.
    k = a.tcol.astype(np.int64)
    bptr = b.tptr.astype(np.int64)
    cnt = bptr[k + 1] - bptr[k]
    total = int(cnt.sum())
    if total == 0:
        return PairSchedule(
            pa=np.zeros(0, INDEX_DTYPE),
            pb=np.zeros(0, INDEX_DTYPE),
            seg=np.zeros(0, INDEX_DTYPE),
            pair_ptr=np.zeros(1, INDEX_DTYPE),
            ctrow=np.zeros(0, INDEX_DTYPE),
            ctcol=np.zeros(0, INDEX_DTYPE),
            c_tptr=np.zeros(c_gm + 1, INDEX_DTYPE),
            c_grid_shape=(c_gm, c_gn),
        )
    pa = np.repeat(np.arange(a.nt, dtype=np.int64), cnt)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(cnt) - cnt, cnt
    )
    pb = np.repeat(bptr[k], cnt) + offs

    # Group by C tile: stable sort keeps ascending (pa, pb) order within a
    # C tile, i.e. ascending k — deterministic accumulation order.
    ckey = a.trow[pa].astype(np.int64) * c_gn + b.tcol[pb]
    order = np.argsort(ckey, kind="stable")
    pa, pb, ckey = pa[order], pb[order], ckey[order]

    new_seg = np.empty(total, dtype=bool)
    new_seg[0] = True
    np.not_equal(ckey[1:], ckey[:-1], out=new_seg[1:])
    seg = (np.cumsum(new_seg) - 1).astype(INDEX_DTYPE)
    starts = np.flatnonzero(new_seg)
    nt_c = starts.size

    ukey = ckey[starts]
    ctrow = (ukey // c_gn).astype(INDEX_DTYPE)
    ctcol = (ukey % c_gn).astype(INDEX_DTYPE)
    pair_ptr = np.append(starts, total).astype(INDEX_DTYPE)
    c_tptr = np.zeros(c_gm + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(ctrow, minlength=c_gm), out=c_tptr[1:])

    return PairSchedule(
        pa=pa.astype(INDEX_DTYPE),
        pb=pb.astype(INDEX_DTYPE),
        seg=seg,
        pair_ptr=pair_ptr,
        ctrow=ctrow,
        ctcol=ctcol,
        c_tptr=c_tptr,
        c_grid_shape=(c_gm, c_gn),
    )


def grid_symbolic_nnz(a: TileMat, b: TileMat) -> int:
    """Number of candidate C tiles only (the reference's step-1 count
    kernel, `tilespgemm-cuda.h:279-322`) — cheaper than a full schedule
    when only sizing is needed."""
    return build_pair_schedule(a, b).nt_c
