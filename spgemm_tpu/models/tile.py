"""The tiled sparse format (`TileMat`) and CSR <-> tile converters.

A redesign of the reference's tiled `SMatrix` half
(`src/common.h:150-172`) and its converters `csr2tile_row_major`
(`src/csr2tile.h:205-277`), `csr2tile_col_major` (`src/csr2tile.h:279-506`)
and `tile2csr` (`src/tile2csr.h:8-140`).

Design deltas vs. the reference (deliberate):

* One canonical tile ordering. The reference stores A's tiles row-major
  with intra-tile CSR and B's tiles column-major with intra-tile CSC
  (two separate converters). Here every `TileMat` stores tiles sorted
  row-major (tile_row, tile_col) with row-major intra-tile order, and the
  column-major view needed by the engine is a cheap permutation
  (`csc_view()`), while B = A^T for the AAT path is produced directly in
  tile space (`transpose_tiles()`) without a CSR round-trip.

* 32-bit mask words, LSB-first. The reference packs per-row bitmasks into
  uint16 words with MSB = lowest column (`csr2tile.h:186-195`,
  `UnitTest/CSR2TILE/show_bitmask.py`). Vector units handle 32-bit words
  natively, so masks here are uint32 words with bit (c % 32) of word (c // 32) set for
  an occupied intra-tile column c. Bit-order is an internal convention;
  tests check semantics (occupancy), not byte layout.

* Intra-tile addressing is a single int32 code r*tn + c (the reference
  uses the same encoding in uint16, `csr2tile.h:192`); int32 lifts the
  uint16 ceiling on tile sizes.

* A dense per-tile materialization `dense()` -> (nt, tm, tn) feeds the
  dense numeric paths; occupancy `occ()` is unpacked from masks (so explicit
  stored zeros keep their structural slot, matching sparse semantics).

Converters are vectorized NumPy (argsort + reduceat), replacing the
reference's OpenMP three-step kernels; an optional C++ fast path can
override them (see spgemm_tpu/utils/native.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from spgemm_tpu.models.csr import CSR, INDEX_DTYPE

MASK_BITS = 32
MASK_DTYPE = np.uint32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class TileMat:
    """Tiled sparse matrix.

    Grid: the m x n matrix is cut into a gm x gn grid of tm x tn tiles
    (gm = ceil(m/tm), gn = ceil(n/tn); edge tiles are logically
    zero-padded). Only non-empty tiles are stored, sorted by
    (tile_row, tile_col).

    Fields (nt = number of non-empty tiles, nnz = stored nonzeros):
      trow, tcol : (nt,)  int32   tile coordinates (CSR-of-tiles COO)
      tptr       : (gm+1,) int32  tile-row pointer over the sorted tiles
      tnnz_ptr   : (nt+1,) int32  exclusive scan of per-tile nnz
      rc         : (nnz,) int32   intra-tile code r*tn + c, row-major
                                  within each tile
      val        : (nnz,) float   values, same order as rc
      mask       : (nt, tm, mw) uint32  per-row occupancy bitmask words,
                                  mw = ceil(tn/32), LSB-first
      rowptr     : (nt, tm+1) int32  per-tile intra CSR row pointer
    """

    shape: tuple[int, int]
    tm: int
    tn: int
    trow: np.ndarray
    tcol: np.ndarray
    tptr: np.ndarray
    tnnz_ptr: np.ndarray
    rc: np.ndarray
    val: np.ndarray
    mask: np.ndarray
    rowptr: np.ndarray

    # -- geometry ----------------------------------------------------------

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def gm(self) -> int:
        return cdiv(self.m, self.tm)

    @property
    def gn(self) -> int:
        return cdiv(self.n, self.tn)

    @property
    def nt(self) -> int:
        return int(self.trow.size)

    @property
    def nnz(self) -> int:
        return int(self.val.size)

    @property
    def mask_words(self) -> int:
        return cdiv(self.tn, MASK_BITS)

    def tile_nnz(self) -> np.ndarray:
        return self.tnnz_ptr[1:] - self.tnnz_ptr[:-1]

    # -- derived views -----------------------------------------------------

    def tile_ids_expanded(self) -> np.ndarray:
        """Per-nonzero tile ordinal, (nnz,) int64."""
        return np.repeat(
            np.arange(self.nt, dtype=np.int64), self.tile_nnz().astype(np.int64)
        )

    def dense(self, dtype=None) -> np.ndarray:
        """Materialize per-tile dense blocks, (nt, tm, tn).

        This is the array the dense numeric paths consume. Note: a stored
        explicit zero is indistinguishable from padding here — structural
        information lives in `mask`/`occ()`.
        """
        dtype = dtype or self.val.dtype
        out = np.zeros(self.nt * self.tm * self.tn, dtype=dtype)
        out[self.tile_ids_expanded() * (self.tm * self.tn) + self.rc] = self.val
        return out.reshape(self.nt, self.tm, self.tn)

    def occ(self) -> np.ndarray:
        """Dense occupancy, (nt, tm, tn) uint8 (1 where a nonzero is
        stored — structurally identical to the bitmask, scatter-built
        because it is ~400x faster than unpacking mask words)."""
        out = np.zeros(self.nt * self.tm * self.tn, dtype=np.uint8)
        out[self.tile_ids_expanded().astype(np.int64)
            * (self.tm * self.tn) + self.rc] = 1
        return out.reshape(self.nt, self.tm, self.tn)

    def to_dense_padded(self, dtype=None) -> np.ndarray:
        """Full dense matrix padded to the tile grid, (gm*tm, gn*tn) —
        operand layout for the dense backend."""
        dtype = dtype or self.val.dtype
        t = self.tile_ids_expanded()
        rows = self.trow[t].astype(np.int64) * self.tm + self.rc // self.tn
        cols = self.tcol[t].astype(np.int64) * self.tn + self.rc % self.tn
        out = np.zeros((self.gm * self.tm, self.gn * self.tn), dtype=dtype)
        out[rows, cols] = self.val
        return out

    def occ_dense_padded(self) -> np.ndarray:
        """Full dense structural-occupancy matrix padded to the tile grid,
        (gm*tm, gn*tn) uint8 — 1 wherever a value is STORED (explicit
        zeros included; pattern must not depend on values)."""
        t = self.tile_ids_expanded()
        rows = self.trow[t].astype(np.int64) * self.tm + self.rc // self.tn
        cols = self.tcol[t].astype(np.int64) * self.tn + self.rc % self.tn
        out = np.zeros((self.gm * self.tm, self.gn * self.tn), dtype=np.uint8)
        out[rows, cols] = 1
        return out

    def occ_from_mask(self) -> np.ndarray:
        """occ() recomputed from the packed bitmask words (reference
        semantics check; used by tests to validate mask construction)."""
        shifts = np.arange(MASK_BITS, dtype=MASK_DTYPE)
        bits = (self.mask[..., None] >> shifts) & MASK_DTYPE(1)
        return (
            bits.reshape(self.nt, self.tm, self.mask_words * MASK_BITS)[
                ..., : self.tn
            ]
        ).astype(np.uint8)

    @functools.cached_property
    def _csc_view(self) -> tuple[np.ndarray, np.ndarray]:
        perm = np.lexsort((self.trow, self.tcol)).astype(INDEX_DTYPE)
        cptr = np.zeros(self.gn + 1, dtype=INDEX_DTYPE)
        np.cumsum(np.bincount(self.tcol, minlength=self.gn), out=cptr[1:])
        return cptr, perm

    def csc_view(self) -> tuple[np.ndarray, np.ndarray]:
        """CSC-of-tiles view: (csc_ptr (gn+1,), csc_perm (nt,)).

        csc_perm[csc_ptr[j]:csc_ptr[j+1]] are tile ordinals of tile-column
        j in ascending tile-row order — the reference's
        `csc_tile_ptr`/`csc_tile_rowidx` (`common.h:168-169`) as a
        permutation instead of a second materialized matrix.
        """
        return self._csc_view

    # -- transforms --------------------------------------------------------

    def transpose_tiles(self) -> "TileMat":
        """Tiled form of A^T, built directly in tile space.

        Swaps tile coordinates and intra-tile (r, c); used by the AAT path
        in place of the reference's host CSR transpose + col-major
        reconversion (`src/main.cu:114-142`, `csr2tile.h:279-506`).
        Requires the result's tile dims (tn, tm) — i.e. tiles transpose too.
        """
        n, m = self.n, self.m
        r = self.rc // self.tn
        c = self.rc % self.tn
        t_rc = c.astype(np.int64) * self.tm + r
        rows = self.tcol[self.tile_ids_expanded()].astype(np.int64) * self.tn + c
        # sort nonzeros by (new tile key, new intra-tile row-major code)
        tile_key = (
            self.tcol[self.tile_ids_expanded()].astype(np.int64) * self.gm
            + self.trow[self.tile_ids_expanded()]
        )
        order = np.lexsort((t_rc, tile_key))
        del rows
        return _build_tilemat(
            shape=(n, m),
            tm=self.tn,
            tn=self.tm,
            tile_key=tile_key[order],
            rc=t_rc[order].astype(INDEX_DTYPE),
            val=self.val[order],
            gm=self.gn,
            gn=self.gm,
        )

    def slice_tile_rows(self, r0: int, r1: int) -> "TileMat":
        """Sub-matrix of tile-rows [r0, r1), rebased to tile-row 0 — the
        building block for row-partitioned distribution (each device gets
        a contiguous tile-row slab of A)."""
        lo, hi = int(self.tptr[r0]), int(self.tptr[r1])
        nlo, nhi = int(self.tnnz_ptr[lo]), int(self.tnnz_ptr[hi])
        rows = min((r1 - r0) * self.tm, self.m - r0 * self.tm)
        return TileMat(
            shape=(max(rows, 0), self.n),
            tm=self.tm,
            tn=self.tn,
            trow=self.trow[lo:hi] - r0,
            tcol=self.tcol[lo:hi],
            tptr=(self.tptr[r0 : r1 + 1] - self.tptr[r0]).astype(INDEX_DTYPE),
            tnnz_ptr=(self.tnnz_ptr[lo : hi + 1] - nlo).astype(INDEX_DTYPE),
            rc=self.rc[nlo:nhi],
            val=self.val[nlo:nhi],
            mask=self.mask[lo:hi],
            rowptr=self.rowptr[lo:hi],
        )

    def to_csr(self) -> CSR:
        return tiles_to_csr(self)

    def memory_bytes(self) -> dict[str, int]:
        """Tiled-format footprint model, the analogue of the reference's
        tile-vs-CSR byte accounting (`src/main.cu:176-188`)."""
        return {
            "tile_coo": self.trow.nbytes + self.tcol.nbytes,
            "tptr": self.tptr.nbytes,
            "tnnz_ptr": self.tnnz_ptr.nbytes,
            "rc": self.rc.nbytes,
            "val": self.val.nbytes,
            "mask": self.mask.nbytes,
            "rowptr": self.rowptr.nbytes,
        }

    def total_bytes(self) -> int:
        return sum(self.memory_bytes().values())


def _build_tilemat(
    shape: tuple[int, int],
    tm: int,
    tn: int,
    tile_key: np.ndarray,
    rc: np.ndarray,
    val: np.ndarray,
    gm: int,
    gn: int,
) -> TileMat:
    """Assemble a TileMat from nonzeros already sorted by
    (tile_key = trow*gn + tcol, intra-tile row-major code)."""
    nnz = tile_key.size
    mw = cdiv(tn, MASK_BITS)

    if nnz == 0:
        return TileMat(
            shape=shape,
            tm=tm,
            tn=tn,
            trow=np.zeros(0, INDEX_DTYPE),
            tcol=np.zeros(0, INDEX_DTYPE),
            tptr=np.zeros(gm + 1, INDEX_DTYPE),
            tnnz_ptr=np.zeros(1, INDEX_DTYPE),
            rc=np.zeros(0, INDEX_DTYPE),
            val=val,
            mask=np.zeros((0, tm, mw), MASK_DTYPE),
            rowptr=np.zeros((0, tm + 1), INDEX_DTYPE),
        )

    # nnz-proportional temporaries go through the process buffer pool
    # (utils/native.py): numpy munmaps big arrays on free, so fresh
    # allocations would re-pay this host's ~11 s/GB first-touch cost on
    # EVERY call — at cant-scale nnzC (12M) that made the host
    # compaction 20 s. int32 ordinals (valid while nnz and nt*tm*mw fit
    # int32 — checked) halve the traffic on top.
    from spgemm_tpu.utils.native import pool_array

    # int32 ordinals need nt*tm*mw (the largest derived key) in range;
    # nt <= nnz bounds it without knowing nt yet
    wide = nnz * tm * mw >= 2 ** 31 - 1
    odt = np.int64 if wide else np.int32

    new_tile = pool_array((nnz,), bool)
    new_tile[0] = True
    np.not_equal(tile_key[1:], tile_key[:-1], out=new_tile[1:])
    starts = np.flatnonzero(new_tile)
    nt = starts.size
    tile_id = pool_array((nnz,), odt)
    np.cumsum(new_tile, out=tile_id)
    tile_id -= 1                       # (nnz,) ordinal per nonzero

    keys = tile_key[starts]
    trow = (keys // gn).astype(INDEX_DTYPE)
    tcol = (keys % gn).astype(INDEX_DTYPE)

    tptr = np.zeros(gm + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(trow, minlength=gm), out=tptr[1:])

    tnnz_ptr = np.zeros(nt + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.diff(np.append(starts, nnz)), out=tnnz_ptr[1:])

    ri = rc // tn
    ci = rc % tn

    # Per-row bitmasks: OR the bit contributions within runs of equal
    # (tile, row, word) — nonzeros are sorted, so runs are contiguous and a
    # single bitwise_or.reduceat covers the whole matrix.
    rowkey = pool_array((nnz,), odt)
    np.multiply(tile_id, tm, out=rowkey)
    rowkey += ri.astype(odt, copy=False)
    flat_word = pool_array((nnz,), odt)
    np.multiply(rowkey, mw, out=flat_word)
    flat_word += (ci // MASK_BITS).astype(odt, copy=False)
    bits = (MASK_DTYPE(1) << (ci % MASK_BITS).astype(MASK_DTYPE)).astype(MASK_DTYPE)
    word_start = pool_array((nnz,), bool)
    word_start[0] = True
    np.not_equal(flat_word[1:], flat_word[:-1], out=word_start[1:])
    wstarts = np.flatnonzero(word_start)
    mask = np.zeros(nt * tm * mw, dtype=MASK_DTYPE)
    mask[flat_word[wstarts]] = np.bitwise_or.reduceat(bits, wstarts)
    mask = mask.reshape(nt, tm, mw)

    row_counts = np.bincount(rowkey, minlength=nt * tm).reshape(nt, tm)
    rowptr = np.zeros((nt, tm + 1), dtype=INDEX_DTYPE)
    np.cumsum(row_counts, axis=1, out=rowptr[:, 1:])

    return TileMat(
        shape=shape,
        tm=tm,
        tn=tn,
        trow=trow,
        tcol=tcol,
        tptr=tptr,
        tnnz_ptr=tnnz_ptr,
        rc=rc.astype(INDEX_DTYPE),
        val=val,
        mask=mask,
        rowptr=rowptr,
    )


def csr_to_tiles(csr: CSR, tm: int = 16, tn: int = 16,
                 use_native: bool = True) -> TileMat:
    """CSR -> tiled format (the reference's `csr2tile_row_major`,
    `src/csr2tile.h:205-277`).

    Uses the native C++ converter when available (utils/native.py; the
    analogue of the reference's OpenMP hot loop), falling back to one
    vectorized NumPy pass: a stable argsort by tile key preserves the
    CSR's (row, col) order inside each tile, so intra-tile nonzeros come
    out row-major for free.
    """
    if tm < 1 or tn < 1:
        raise ValueError("tile dims must be >= 1")
    if use_native:
        from spgemm_tpu.utils.native import csr_to_tiles_native

        orig_dtype = csr.data.dtype
        t = csr_to_tiles_native(csr, tm, tn)
        if t is not None:
            if orig_dtype != np.float64:
                t = dataclasses.replace(t, val=t.val.astype(orig_dtype))
            return t
    m, n = csr.shape
    gm, gn = cdiv(m, tm), cdiv(n, tn)
    rows = csr.rows_expanded()
    cols = csr.indices.astype(np.int64)
    tile_key = (rows // tm) * gn + cols // tn
    order = np.argsort(tile_key, kind="stable")
    rc = ((rows % tm) * tn + cols % tn).astype(INDEX_DTYPE)
    return _build_tilemat(
        shape=(m, n),
        tm=tm,
        tn=tn,
        tile_key=tile_key[order],
        rc=rc[order],
        val=csr.data[order],
        gm=gm,
        gn=gn,
    )


def tiles_to_csr(t: TileMat, use_native: bool = True) -> CSR:
    """Tiled format -> CSR (the reference's `tile2csr`,
    `src/tile2csr.h:8-140`).

    Native C++ when available; NumPy fallback: a stable argsort by global
    row keeps tiles of one tile-row in ascending tile-column order, so
    column indices come out sorted.
    """
    if use_native:
        from spgemm_tpu.utils.native import tiles_to_csr_native

        orig_dtype = t.val.dtype
        c = tiles_to_csr_native(t)
        if c is not None:
            if orig_dtype != np.float64:
                c = CSR(c.indptr, c.indices, c.data.astype(orig_dtype),
                        c.shape)
            return c
    tid = t.tile_ids_expanded()
    grow = t.trow[tid].astype(np.int64) * t.tm + t.rc // t.tn
    gcol = t.tcol[tid].astype(np.int64) * t.tn + t.rc % t.tn
    order = np.argsort(grow, kind="stable")
    indptr = np.zeros(t.m + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(grow, minlength=t.m), out=indptr[1:])
    return CSR(indptr, gcol[order].astype(INDEX_DTYPE), t.val[order], t.shape)
