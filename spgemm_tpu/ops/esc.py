"""Device ESC engine for unstructured matrices — the replacement for the
reference's nsparse hash-table symbolic + size-binned sparse-accumulator
numeric path (`src/spgemm_nsparse_kernel.h:1171-1438`,
`src/tilespgemm-cuda.h:1273-2218`).

The engine restructures expand-sort-compress so the device touches data
only through streaming elementwise work and lane-local gathers, with no
hash tables, scatter or sort on the device:

* Host symbolic (pattern-static, reusable across calls): expand the
  nnzCub partial products in Gustavson/A-order, compute each product's
  destination position in C's value array (one vectorized searchsorted
  against C's sorted keys), partition C's value array into contiguous
  slot *groups* of S=2048 positions, and materialize per-group expanded
  operand streams (a-value, b-value, slot id) padded to a 256-granular
  width class in [W_MIN, W_MAX] (pow2 classes were rejected: up to 2x
  padding waste right where interval counts sit just above a power of
  two — see _sibling_layout).

* Device numeric — two formulations, both gather/scatter/sort-free:

  - **scan mode (production, f32)**: the host counting-sorts each
    128-slot window's products by destination into (R, 128) lane rows;
    the device runs a log-doubling segmented suffix-scan along lanes
    (plain f32 adds, jnp.roll) and extracts each run's sum with one
    lane-local gather (take_along_axis). 6 bytes of device traffic per
    product (f32 value + int16 meta). A double-double variant (f32 hi/lo
    planes + branch-free 2Sum) delivers f64-accurate results in f32
    arithmetic.

  - **digit mode (portable)**: q = AV * BV elementwise, split each slot
    id into digits (hi = slot >> 5, lo = slot & 31), and contract
    ``out[g, h, a] = sum_w (hi==h) * (lo==a) * q`` as a batched one-hot
    matmul — the matmul performs the segmented scatter-add. Padding
    products carry av = 0 and contribute exactly 0 wherever they land.

Results come out in final CSR order in both modes — no device-side
reordering ever happens; sibling groups/rows (flop splits, window
overflow) are summed by the trim pass.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from spgemm_tpu.models.csr import CSR, INDEX_DTYPE

S_SLOTS = 2048            # slot positions per group (64 * 32 digit space)
HI_W, LO_W = 64, 32
W_MIN, W_MAX = 256, 4096  # product-stream width classes (pow2 buckets)


@dataclasses.dataclass
class EscPlan:
    """Pattern-static plan: everything the numeric phase needs except the
    input values. Rebuilding AV/BV for new values is a cheap host gather
    (`refresh_values`); the symbolic structure is fully reusable — the
    analogue of the reference's symbolic/numeric split
    (`tilespgemm-cuda.h:2379-2604` vs `:2649-2728`)."""

    shape: tuple[int, int]
    c_indptr: np.ndarray          # C pattern (structural, sorted cols)
    c_indices: np.ndarray
    nnz_c: int
    num_products: int             # nnzCub
    # per width class: device operand streams
    classes: list[dict]           # {w, av, bv, slot, base, glen}
    # host gather indices to refresh AV/BV from new a.data / b.data
    a_src: list[np.ndarray]       # per class: (G*W,) int64 into a.data, -1 pad
    b_src: list[np.ndarray]       # per class: (G*W,) int64 into b.data
    s_slots: int = S_SLOTS        # slot positions per group
    symbolic_ms: float = 0.0

    def device_arrays(self, dtype=np.float32):
        """Upload per-class operand streams; returns list of dicts of
        jnp arrays (av, bv, slot)."""
        out = []
        for cls in self.classes:
            out.append(dict(
                av=jnp.asarray(cls["av"].astype(dtype)),
                bv=jnp.asarray(cls["bv"].astype(dtype)),
                slot=jnp.asarray(cls["slot"]),
            ))
        return out

    def refresh_values(self, a_data: np.ndarray, b_data: np.ndarray):
        """Rebuild the expanded value streams for new input values under
        the same pattern (host gather, vectorized)."""
        for cls, asrc, bsrc in zip(self.classes, self.a_src, self.b_src):
            g, w = cls["slot"].shape
            av = np.zeros(g * w, np.float64)
            bv = np.zeros(g * w, np.float64)
            ok = asrc >= 0
            av[ok] = a_data[asrc[ok]]
            bv[ok] = b_data[bsrc[ok]]
            cls["av"] = av.reshape(g, w)
            cls["bv"] = bv.reshape(g, w)


def _expand_products(a: CSR, b: CSR):
    """All nnzCub partial products in A-order: returns (a_idx, b_idx,
    rows, cols) int64 arrays. Mirrors the reference's intermediate-product
    enumeration (`spgemm_nsparse_kernel.h:135-166` set_intprod_num)."""
    blen = (b.indptr[1:] - b.indptr[:-1]).astype(np.int64)
    counts = blen[a.indices]
    total = int(counts.sum())
    if total == 0:
        e = np.zeros(0, np.int64)
        return e, e, e, e
    a_idx = np.repeat(np.arange(a.nnz, dtype=np.int64), counts)
    rows = np.repeat(a.rows_expanded().astype(np.int64), counts)
    reps = np.repeat(b.indptr[a.indices].astype(np.int64), counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    b_idx = reps + offs
    cols = b.indices[b_idx].astype(np.int64)
    return a_idx, b_idx, rows, cols


def _structural_pattern(a: CSR, b: CSR) -> tuple[np.ndarray, np.ndarray]:
    """C's structural pattern (an entry exists iff any a_ik*b_kj term
    exists, regardless of value cancellation) — sorted CSR."""
    import scipy.sparse as sp

    sa = sp.csr_matrix(
        (np.ones(a.nnz, np.float64), a.indices, a.indptr), shape=a.shape)
    sb = sp.csr_matrix(
        (np.ones(b.nnz, np.float64), b.indices, b.indptr), shape=b.shape)
    sc = (sa @ sb).tocsr()
    sc.sort_indices()
    return sc.indptr.astype(np.int64), sc.indices.astype(np.int64)


def _sibling_layout(prod_cnt: np.ndarray, nnz_c: int, s_slots: int,
                    f_max: int, w_min: int = W_MIN) -> dict:
    """Group layout over fixed S-slot intervals of C's value array.
    Interval g (slots [g*S, (g+1)*S)) receives prod_cnt[g] products; if
    that exceeds f_max it splits into *sibling* groups over the same
    interval (the trim pass sums them). Each sibling lands in a pow2
    width class; returns flat offsets for the operand-stream fill.

    Fixed intervals need no row alignment: a product's group is simply
    dest // S and its slot dest % S — wide C rows and dup-heavy rows
    fall out of the same arithmetic (the analogue of nsparse's
    set_max_bin/set_min_bin size binning,
    `spgemm_nsparse_kernel.h:221-311`)."""
    n_int = prod_cnt.size
    n_sib = np.maximum(1, -(-prod_cnt // f_max)).astype(np.int64)
    sib_ptr = np.zeros(n_int + 1, np.int64)
    np.cumsum(n_sib, out=sib_ptr[1:])
    total = int(sib_ptr[-1])
    sib_int = np.repeat(np.arange(n_int, dtype=np.int64), n_sib)
    sib_rank = np.arange(total, dtype=np.int64) - sib_ptr[sib_int]
    sib_cnt = np.maximum(
        np.minimum(prod_cnt[sib_int] - sib_rank * f_max, f_max), 1)
    # width classes at 256 granularity (<= f_max/256 classes): pow2
    # classes waste up to 2x padding exactly at the common case where an
    # interval's product count sits just above a power of two
    w = np.maximum(w_min, -(-sib_cnt // 256) * 256)
    sib_base = np.zeros(total, np.int64)
    classes = []
    flat_total = 0
    for wv in sorted(set(w.tolist())):
        ids = np.flatnonzero(w == wv)
        sib_base[ids] = flat_total + np.arange(ids.size, dtype=np.int64) * wv
        base = sib_int[ids] * s_slots
        glen = np.minimum(s_slots, nnz_c - base)
        classes.append(dict(w=int(wv), g=int(ids.size),
                            flat_ofs=int(flat_total), base=base, glen=glen))
        flat_total += ids.size * int(wv)
    return dict(classes=classes, sib_ptr=sib_ptr, sib_base=sib_base,
                flat_total=int(flat_total))


def _esc_symbolic_numpy(a: CSR, b: CSR, s_slots: int, f_max: int):
    """NumPy fallback for the native symbolic (same outputs as
    utils.native.esc_symbolic_native): pattern via scipy, destinations
    via one global searchsorted, counting sort into the padded layout."""
    c_indptr, c_indices = _structural_pattern(a, b)
    nnz_c = int(c_indptr[-1])
    n = b.n
    a_idx, b_idx, rows, cols = _expand_products(a, b)
    total = a_idx.size
    n_int = max(1, -(-nnz_c // s_slots))
    prod_cnt = np.zeros(n_int, np.int64)
    dest = gidx = None
    if total:
        c_rows = np.repeat(np.arange(a.m, dtype=np.int64),
                           np.diff(c_indptr).astype(np.int64))
        c_keys = c_rows * n + c_indices
        dest = np.searchsorted(c_keys, rows * n + cols)
        del c_keys, c_rows, rows, cols
        gidx = dest // s_slots
        prod_cnt = np.bincount(gidx, minlength=n_int).astype(np.int64)
    layout = _sibling_layout(prod_cnt, nnz_c, s_slots, f_max)
    asrc = np.full(layout["flat_total"], -1, np.int32)
    bsrc = np.zeros(layout["flat_total"], np.int32)
    slot = np.zeros(layout["flat_total"], np.int32)
    av = np.zeros(layout["flat_total"], np.float64)
    bv = np.zeros(layout["flat_total"], np.float64)
    if total:
        order = np.argsort(gidx, kind="stable")
        gs = gidx[order]
        start = np.zeros(n_int + 1, np.int64)
        np.cumsum(prod_cnt, out=start[1:])
        rank = np.arange(total, dtype=np.int64) - start[gs]
        sib = layout["sib_ptr"][gs] + rank // f_max
        off = layout["sib_base"][sib] + rank % f_max
        asrc[off] = a_idx[order]
        bsrc[off] = b_idx[order]
        slot[off] = (dest[order] - gs * s_slots).astype(np.int32)
        av[off] = a.data[a_idx[order]]
        bv[off] = b.data[b_idx[order]]
    return (c_indptr, c_indices.astype(np.int32), total, prod_cnt,
            asrc, bsrc, slot, layout, av, bv)


def build_esc_plan(a: CSR, b: CSR, *, s_slots: int = S_SLOTS,
                   f_max: int = W_MAX) -> EscPlan:
    """Host symbolic phase. Replaces the reference's nsparse binning +
    hash-table symbolic (`spgemm_nsparse_kernel.h:221-263,1171-1314`)
    with an O(flops) position assignment: products -> (group, slot).
    Native C++ (native/csr2tile.cpp esc_* passes) with a vectorized
    NumPy fallback."""
    t0 = time.perf_counter()
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    from spgemm_tpu.utils.native import esc_symbolic_native

    res = esc_symbolic_native(a, b, s_slots, f_max, W_MIN)
    if res is None:
        res = _esc_symbolic_numpy(a, b, s_slots, f_max)
    (c_indptr, c_indices, total, prod_cnt, asrc, bsrc, slot, layout,
     av, bv) = res
    nnz_c = int(c_indptr[-1])

    plan = EscPlan(
        shape=(a.m, b.n), c_indptr=np.asarray(c_indptr, np.int64),
        c_indices=c_indices.astype(INDEX_DTYPE, copy=False), nnz_c=nnz_c,
        num_products=int(total), classes=[], a_src=[], b_src=[],
        s_slots=s_slots,
    )
    for cls in layout["classes"]:
        g, w, o = cls["g"], cls["w"], cls["flat_ofs"]
        plan.classes.append(dict(
            w=w, av=av[o : o + g * w].reshape(g, w),
            bv=bv[o : o + g * w].reshape(g, w),
            slot=slot[o : o + g * w].reshape(g, w),
            base=cls["base"], glen=cls["glen"],
        ))
        plan.a_src.append(asrc[o : o + g * w])
        plan.b_src.append(bsrc[o : o + g * w])

    plan.symbolic_ms = (time.perf_counter() - t0) * 1e3
    return plan


@functools.partial(jax.jit, static_argnames=("s_slots", "precision"))
def esc_digit_reduce(av, bv, slot, *, s_slots: int = S_SLOTS,
                     precision=jax.lax.Precision.HIGHEST):
    """The numeric kernel: batched one-hot digit contraction.
    out[g, slot] = sum over products w of av*bv where slot matches.
    Padding products have av == 0 and add exactly zero. No scatter,
    gather, or sort anywhere.

    Precision: HIGHEST is the default — values must match the oracle at
    f32 precision (the values correctness bar); a lower precision may
    multiply in TF32 or bf16 and keep about three decimal digits."""
    lo_w = min(LO_W, s_slots)
    hi_w = s_slots // lo_w
    shift = lo_w.bit_length() - 1
    q = av * bv                                    # (G, W)
    lo = slot & (lo_w - 1)
    hi = slot >> shift
    lo_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, lo_w), 2)
    hi_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, hi_w), 2)
    u = jnp.where(lo[:, :, None] == lo_iota, q[:, :, None], 0)  # (G,W,lo)
    ohh = (hi[:, :, None] == hi_iota).astype(av.dtype)          # (G,W,hi)
    out = jax.lax.dot_general(
        ohh, u,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32 if av.dtype != jnp.float64
        else jnp.float64,
        precision=precision,
    )                                              # (G, hi, lo)
    return out.reshape(out.shape[0], s_slots)


def esc_numeric(plan: EscPlan, dev_arrays=None, *, dtype=np.float32,
                sync: bool = True,
                precision=jax.lax.Precision.HIGHEST):
    """Run the numeric phase; returns the list of padded per-class
    outputs (device arrays, in final CSR slot order)."""
    if np.dtype(dtype) == np.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "digit-mode f64 requires jax_enable_x64 (jnp.asarray would "
            "silently truncate the operand streams to f32); use the "
            "double-double scan path (esc_scan_dd / spgemm_esc "
            "mode='scan') for f64 accuracy on f32 hardware")
    if dev_arrays is None:
        dev_arrays = plan.device_arrays(dtype)
    outs = [esc_digit_reduce(d["av"], d["bv"], d["slot"],
                             s_slots=plan.s_slots, precision=precision)
            for d in dev_arrays]
    if sync:
        jax.block_until_ready(outs)
    return outs


def esc_trim(plan: EscPlan, outs) -> CSR:
    """Assemble C from the padded group outputs: slice each group's
    [0, len) slots into its contiguous CSR interval; sibling groups over
    the same interval (flop splits) accumulate. Host-side, vectorized
    per group (group count ~ nnzCub / 4096)."""
    c_val = np.zeros(plan.nnz_c, np.float64)
    for cls, out in zip(plan.classes, outs):
        arr = np.asarray(out, dtype=np.float64)
        base, glen = cls["base"], cls["glen"]
        for gi in range(base.size):
            lo, ln = int(base[gi]), int(glen[gi])
            c_val[lo : lo + ln] += arr[gi, :ln]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


# --- scan mode: sorted-run suffix-scan kernel ------------------------------
# The faster formulation for f32: the host counting-sorts each 128-slot
# window's products by destination and lays them out as (R, 128) lane
# rows; the device runs a log-doubling segmented suffix-scan along lanes
# (plain f32 adds) and extracts each run's sum with a lane-local gather
# (take_along_axis axis=1). No one-hot masks, no matmuls.
# This replaces the role of the reference's size-binned numeric kernels
# (`tilespgemm-cuda.h:1273-2218`): runs longer than a row simply spill
# into sibling rows whose partial sums the trim pass adds.

SCAN_WIN = 128
ROW_ALIGN = 8     # plans pad R to a multiple of the largest group_rows

# The kernels consume only meta bits 7-21 (idx 7 + present 1 + dist 7 =
# 15 bits): shipping the plane as int16 cuts the scan's device traffic
# from 8 to 6 B/product and the double-double scan's from 12 to 10 — a
# streaming computation, so traffic is the runtime. Packed layout (after >>7): bits 0-6 idx, bit 7 present,
# bits 8-14 dist. Values are <= 0x7FFF so the int16 stays non-negative
# and the in-kernel widen back to i32 is a plain sign extension.
META16 = os.environ.get("SPGEMM_META16", "1") != "0"

# Device-side window combine (sibling-row reduction on device; D2H then
# carries ~4*nnzC bytes instead of the full product-row planes). See
# esc_scan_numeric_combined below. SPGEMM_DEVICE_COMBINE=0 reverts to
# the host reduceat trim.
DEVICE_COMBINE = os.environ.get("SPGEMM_DEVICE_COMBINE", "1") != "0"


def meta16_plane(meta: np.ndarray, cache_on=None) -> np.ndarray:
    """Compress the int32 meta plane to the kernels' int16 form.
    With cache_on (a ScanPlan), the converted plane is memoized — the
    shift+mask pass over an rmat-scale plane costs ~0.5 s."""
    if cache_on is not None:
        cached = getattr(cache_on, "_meta16_cache", None)
        if cached is not None and cached.shape == meta.shape:
            return cached
    m16 = ((meta >> 7) & 0x7FFF).astype(np.int16)
    if cache_on is not None:
        cache_on._meta16_cache = m16
    return m16


def _meta_fields(mt):
    """Decode (idx, present, dist) from a meta block of either dtype.

    dtype is static at trace time, so this compiles to exactly one
    layout's shifts; int16 planes are widened once to i32."""
    if mt.dtype == jnp.int16:
        m = mt.astype(jnp.int32)
        return m & 127, ((m >> 7) & 1).astype(jnp.float32), m >> 8
    return (mt >> 7) & 127, ((mt >> 14) & 1).astype(jnp.float32), mt >> 15


@dataclasses.dataclass
class ScanPlan:
    """Pattern-static plan for the scan kernel. Rows are (R, 128): row r
    holds 128 consecutive dest-sorted products of one 128-slot window of
    C's value array; win_rowptr[w] is the first row of window w.

    qv carries the host-premultiplied products (f64 multiply rounded
    once to f32 — strictly tighter than a device f32*f32). meta packs
    per lane: bits 0-6 slot (dest & 127), bits 7-13 the run-start lane
    this slot gathers from, bit 14 slot-present, bits 15-21 distance to
    the end of this lane's in-row run (the kernels' doubling mask)."""

    shape: tuple[int, int]
    c_indptr: np.ndarray
    c_indices: np.ndarray
    nnz_c: int
    num_products: int
    qv: np.ndarray               # (R, 128) f32
    meta: np.ndarray             # (R, 128) int32 packed
    win_rowptr: np.ndarray       # (n_win + 1,) int64
    a_src: np.ndarray | None     # (R, 128) int32, -1 padding
    b_src: np.ndarray | None     # (None when keep_sources=False)
    passes: int                  # ceil(log2(max in-row run length))
    group_rows: int = 1          # in-kernel G-row window reduction factor
    symbolic_ms: float = 0.0

    def device_arrays(self):
        mt = meta16_plane(self.meta, cache_on=self) if META16 else self.meta
        return dict(
            qv=jnp.asarray(self.qv),
            meta=jnp.asarray(mt),
        )

    def refresh_values(self, a_data: np.ndarray, b_data: np.ndarray):
        """Pattern-fixed value refresh (the reference's step-4-only
        re-run, `tilespgemm-cuda.h:2649-2728`): native fused
        gather-multiply at stream bandwidth, NumPy fallback."""
        if self.a_src is None:
            raise ValueError(
                "plan built with keep_sources=False cannot refresh")
        from spgemm_tpu.utils.native import esc_refresh_qv_native

        out = esc_refresh_qv_native(self.a_src, self.b_src,
                                    a_data, b_data, out=self.qv)
        if out is not None:
            self.qv = out
            return
        ok = self.a_src >= 0
        self.qv = (np.where(ok, a_data[np.maximum(self.a_src, 0)], 0.0)
                   * np.where(ok, b_data[np.maximum(self.b_src, 0)], 0.0)
                   ).astype(np.float32)


def build_esc_scan_plan(a: CSR, b: CSR, *,
                        keep_sources: bool = True,
                        group_rows: int = 1) -> ScanPlan:
    """Host symbolic for scan mode. Native C++ fast path
    (native/csr2tile.cpp:esc_scan_build) with a vectorized NumPy
    fallback (argsort by destination = the counting sort).
    keep_sources=False skips the a_src/b_src maps (faster fill; the
    plan then cannot refresh_values or run the double-double path).

    group_rows=G pads every window's row count to a multiple of G; the
    kernels then emit per-G-row-group sums, cutting output HBM traffic
    by G. The scan is memory-bound, so traffic is the runtime. Worth it when windows average >= ~2G rows
    (dup-heavy structured inputs: cant-like windows average ~23 rows);
    harmful when windows are thin (rmat ~3 rows -> padding blow-up) —
    see choose_group_rows."""
    t0 = time.perf_counter()
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if group_rows not in (1, 2, 4, 8):
        raise ValueError(f"group_rows must be 1, 2, 4 or 8: {group_rows}")
    from spgemm_tpu.utils.native import esc_scan_symbolic_native

    res = esc_scan_symbolic_native(a, b, keep_sources=keep_sources,
                                   group_rows=group_rows)
    if res is None:
        res = _esc_scan_symbolic_numpy(a, b, group_rows=group_rows)
    (c_indptr, c_indices, total, qv, meta,
     win_rowptr, asrc, bsrc, max_run) = res
    plan = ScanPlan(
        shape=(a.m, b.n), c_indptr=np.asarray(c_indptr, np.int64),
        c_indices=c_indices.astype(INDEX_DTYPE, copy=False),
        nnz_c=int(c_indptr[-1]), num_products=int(total),
        qv=qv, meta=meta,
        win_rowptr=win_rowptr, a_src=asrc, b_src=bsrc,
        passes=max(0, int(max_run - 1).bit_length()),
        group_rows=group_rows,
    )
    plan.symbolic_ms = (time.perf_counter() - t0) * 1e3
    return plan


def _esc_scan_symbolic_numpy(a: CSR, b: CSR, group_rows: int = 1):
    """NumPy scan-mode symbolic: global stable argsort by destination is
    the counting sort; everything else is layout arithmetic."""
    c_indptr, c_indices = _structural_pattern(a, b)
    nnz_c = int(c_indptr[-1])
    n = b.n
    a_idx, b_idx, rows, cols = _expand_products(a, b)
    total = a_idx.size
    n_win = max(1, -(-nnz_c // SCAN_WIN))
    if total == 0:
        # keep the all-plans-are-ROW_ALIGN-padded invariant (the
        # native path pads too)
        zf = np.zeros((ROW_ALIGN, SCAN_WIN), np.float32)
        zi = np.zeros((ROW_ALIGN, SCAN_WIN), np.int32)
        return (c_indptr, c_indices.astype(np.int32), 0, zf, zi,
                np.zeros(n_win + 1, np.int64), zi, zi, 1)
    c_rows = np.repeat(np.arange(a.m, dtype=np.int64),
                       np.diff(c_indptr).astype(np.int64))
    c_keys = c_rows * n + c_indices
    dest = np.searchsorted(c_keys, rows * n + cols)
    del c_keys, c_rows, rows, cols

    order = np.argsort(dest, kind="stable")
    ds = dest[order]
    win = ds >> 7
    wcnt = np.bincount(win, minlength=n_win).astype(np.int64)
    wrows = np.maximum(1, -(-wcnt // SCAN_WIN))
    wrows = -(-wrows // group_rows) * group_rows
    win_rowptr = np.zeros(n_win + 1, np.int64)
    np.cumsum(wrows, out=win_rowptr[1:])
    r_total = -(-int(win_rowptr[-1]) // ROW_ALIGN) * ROW_ALIGN
    padbase = win_rowptr[:-1] * SCAN_WIN
    start = np.zeros(n_win + 1, np.int64)
    np.cumsum(wcnt, out=start[1:])
    pos = padbase[win] + (np.arange(total, dtype=np.int64) - start[win])
    prow, plane = pos >> 7, (pos & 127).astype(np.int64)

    qv = np.zeros((r_total, SCAN_WIN), np.float32)
    meta = np.zeros((r_total, SCAN_WIN), np.int32)
    asrc = np.full((r_total, SCAN_WIN), -1, np.int32)
    bsrc = np.zeros((r_total, SCAN_WIN), np.int32)
    # in-row run segments: first product of each (row, dest) pair
    fir = np.concatenate(([True], (ds[1:] != ds[:-1])
                          | (prow[1:] != prow[:-1])))
    starts_pos = np.flatnonzero(fir)
    runlen = np.diff(np.append(starts_pos, total))
    run_id = np.cumsum(fir) - 1
    rel = np.arange(total, dtype=np.int64) - starts_pos[run_id]
    # distance to the end of this lane's in-row run (meta bits 15-21) —
    # lets the kernels mask each doubling pass with ONE compare instead
    # of rolling the slot tags (see _run_suffix_scan)
    dist = np.minimum(runlen[run_id] - 1 - rel, 127 - plane)
    qv[prow, plane] = (a.data[a_idx[order]]
                       * b.data[b_idx[order]]).astype(np.float32)
    meta[prow, plane] = ((ds & 127) | (dist << 15)).astype(np.int32)
    asrc[prow, plane] = a_idx[order].astype(np.int32)
    bsrc[prow, plane] = b_idx[order].astype(np.int32)
    meta[prow[fir], (ds[fir] & 127)] |= (
        (plane[fir].astype(np.int32) << 7) | (1 << 14))
    max_run = int(runlen.max()) if runlen.size else 1
    return (c_indptr, c_indices.astype(np.int32), total, qv, meta,
            win_rowptr, asrc, bsrc, max_run)


def _two_sum(a, b):
    """Branch-free 2Sum: s = fl(a + b) and its exact rounding error."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _run_suffix_scan(q, dist, passes):
    """Log-doubling segmented suffix-scan along the 128 lanes. The host
    precomputed each lane's distance to the end of its in-row run, so
    one compare masks each pass (dist >= d implies lane + d is in the
    same run and in the same row)."""
    for k in range(passes):
        d = 1 << k
        q = q + jnp.where(dist >= d, jnp.roll(q, -d, axis=1), 0.0)
    return q


def _extract(q, meta, passes):
    idx, val, dist = _meta_fields(meta)
    q = _run_suffix_scan(q, dist, passes)
    return jnp.take_along_axis(q, idx, axis=1) * val


def _group_sum(y, g):
    """Sum each run of g consecutive rows (plans pad every window's row
    count to a multiple of g): output traffic drops by g."""
    if g == 1:
        return y
    return y.reshape(-1, g, y.shape[1]).sum(axis=1)


@functools.partial(jax.jit, static_argnames=("passes", "group_rows"))
def esc_scan_reduce(qv, meta, *, passes: int = 7, group_rows: int = 1):
    """The scan numeric: segmented suffix-scan of the premultiplied
    products along lanes (equal adjacent slots = one run, rows sorted by
    the host), one lane-local gather (take_along_axis) pulls each run's
    total to its slot lane. 6 bytes of device traffic per product (f32
    value + int16 meta); plain f32 adds. Returns (R / group_rows, 128)
    window-major partial sums."""
    return _group_sum(_extract(qv, meta, passes), group_rows)


@functools.partial(jax.jit, static_argnames=("passes", "group_rows"))
def esc_scan_reduce_mul(av, bv, meta, *, passes: int = 7,
                        group_rows: int = 1):
    """esc_scan_reduce with the multiply on the device: operands arrive
    as separate (av, bv) planes (10 B/product), so the device performs
    the products and its time counts them like the tiled kernels do."""
    return _group_sum(_extract(av * bv, meta, passes), group_rows)


@functools.partial(jax.jit, static_argnames=("passes", "group_rows"))
def esc_scan_reduce_dd(qh, ql, meta, *, passes: int = 7,
                       group_rows: int = 1):
    """Double-double (f32x2) scan: the host splits each exactly computed
    f64 product into hi = f32(p), lo = f32(p - hi); the suffix scan
    carries a compensated (sum, err) pair combined with 2Sum, ~2^-48
    relative accuracy after the host adds f64(sum) + f64(err). The
    f64 check of the tests and of the card run catches a compiler that
    reassociates the compensation away. Returns (s, e) planes."""
    idx, val, dist = _meta_fields(meta)
    s, e = qh, ql
    zero = jnp.float32(0)
    for k in range(passes):
        d = 1 << k
        ok = dist >= d
        sr = jnp.where(ok, jnp.roll(s, -d, axis=1), zero)
        er = jnp.where(ok, jnp.roll(e, -d, axis=1), zero)
        s, err = _two_sum(s, sr)
        e = e + er + err
    ys = jnp.take_along_axis(s, idx, axis=1) * val
    ye = jnp.take_along_axis(e, idx, axis=1) * val
    g = group_rows
    if g > 1:
        # compensated g-row reduction keeps the double-double bound
        ys = ys.reshape(-1, g, ys.shape[1])
        ye = ye.reshape(-1, g, ye.shape[1])
        sa, ea = ys[:, 0], ye[:, 0]
        for j in range(1, g):
            sa, err = _two_sum(sa, ys[:, j])
            ea = ea + ye[:, j] + err
        ys, ye = sa, ea
    return ys, ye


def scan_dd_planes(plan: ScanPlan, a_data=None, b_data=None):
    """Host: exact f64 products split into (hi, lo) f32 planes for the
    double-double kernel. Uses the plan's source indices."""
    if plan.a_src is None:
        raise ValueError(
            "double-double needs a plan built with keep_sources=True")
    if a_data is None:
        # qv was rounded to f32 at build; rebuild exactly requires the
        # sources — callers pass a.data/b.data
        raise ValueError("scan_dd_planes needs a_data and b_data")
    from spgemm_tpu.utils.native import esc_refresh_dd_native

    res = esc_refresh_dd_native(plan.a_src, plan.b_src, a_data, b_data)
    if res is not None:
        return res
    ok = plan.a_src >= 0
    p = np.where(ok, a_data[np.maximum(plan.a_src, 0)]
                 * b_data[np.maximum(plan.b_src, 0)], 0.0)
    hi = p.astype(np.float32)
    lo = (p - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def esc_scan_dd(plan: ScanPlan, a_data: np.ndarray, b_data: np.ndarray,
                *, device=None) -> CSR:
    """f64-accurate SpGEMM through the double-double scan kernel;
    returns C with values accurate to ~1e-14 relative."""
    hi, lo = scan_dd_planes(plan, a_data, b_data)
    mt = meta16_plane(plan.meta, cache_on=plan) if META16 else plan.meta
    arrs = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(mt))
    if device is not None:
        arrs = jax.device_put(arrs, device)
    s, e = esc_scan_reduce_dd(
        *arrs, passes=plan.passes, group_rows=plan.group_rows)
    if DEVICE_COMBINE:
        res, tail = _combine_apply_dd(plan, s, e)
        jax.block_until_ready(res)
        return esc_scan_trim_combined_dd(plan, res, tail)
    jax.block_until_ready((s, e))
    c_val = np.zeros(plan.nnz_c, np.float64)
    if plan.nnz_c:
        total = (np.asarray(s, np.float64) + np.asarray(e, np.float64))
        sums = np.add.reduceat(
            total, plan.win_rowptr[:-1] // plan.group_rows, axis=0)
        c_val[:] = sums.reshape(-1)[: plan.nnz_c]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


def time_esc_scan_dd(plan: ScanPlan, a_data, b_data, *, loop: int = 20,
                     repeats: int = 2) -> float:
    """Amortized device time of the double-double scan kernel."""
    from spgemm_tpu.utils.timing import chained_device_ms

    hi, lo = scan_dd_planes(plan, a_data, b_data)
    qh = jax.device_put(jnp.asarray(hi))
    ql = jax.device_put(jnp.asarray(lo))
    mt = meta16_plane(plan.meta, cache_on=plan) if META16 else plan.meta
    meta = jax.device_put(jnp.asarray(mt))
    jax.block_until_ready((qh, ql, meta))

    @jax.jit
    def chain(qh, ql, meta):
        def body(i, acc):
            s, e = esc_scan_reduce_dd(qh + acc * 1e-30, ql, meta,
                                      passes=plan.passes,
                                      group_rows=plan.group_rows)
            return acc + jnp.sum(s) + jnp.sum(e)

        return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

    return chained_device_ms(chain, qh, ql, meta,
                             repeats=repeats, loop=loop)


def esc_scan_numeric(plan: ScanPlan, dev=None, *, sync: bool = True):
    if dev is None:
        dev = plan.device_arrays()
    out = esc_scan_reduce(dev["qv"], dev["meta"], passes=plan.passes,
                          group_rows=plan.group_rows)
    if sync:
        jax.block_until_ready(out)
    return out


def esc_scan_trim(plan: ScanPlan, out) -> CSR:
    """Rows of one window are siblings: one reduceat sums them; the
    window-major flattening is exactly C's value order. With
    group_rows=G the kernel already reduced G-row groups, so the
    reduceat runs over R/G rows."""
    c_val = np.zeros(plan.nnz_c, np.float64)
    if plan.nnz_c:
        arr = np.asarray(out, np.float64)
        sums = np.add.reduceat(
            arr, plan.win_rowptr[:-1] // plan.group_rows, axis=0)
        c_val[:] = sums.reshape(-1)[: plan.nnz_c]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


# --- device-side window combine --------------------------------------------
# The host trim downloads the full (R/G, 128) kernel output and reduceats
# sibling rows — R/G is F/(128*G*fill) rows, i.e. dup/fill times more
# data than C itself. The combine below performs the sibling reduction ON
# DEVICE with 128-wide row gathers and adds: windows are grouped into
# row-count classes, each class is one
# take(axis=0) + reshape + sum; a final row-gather assembles window
# order. D2H then carries ~4*nnzC bytes instead of ~4*F/fill (cant A2:
# 48 MB vs 1.09 GB). Windows taller than COMBINE_K rows (only hub-heavy
# tails, <3% of rows on rmat65536) are chunk-reduced on device and
# finished on the host in f64.

COMBINE_K = 32


def _combine_layout(plan: ScanPlan):
    """Plan-static gather layout for the device combine (cached)."""
    cached = getattr(plan, "_combine_cache", None)
    if cached is not None:
        return cached
    g = plan.group_rows
    start = (plan.win_rowptr[:-1] // g).astype(np.int64)
    wr = (np.diff(plan.win_rowptr) // g).astype(np.int64)
    n_win = wr.size
    main = wr <= COMBINE_K
    classes = []
    perm = np.empty(n_win, np.int64)
    base = 0
    for k in np.unique(wr[main]) if main.any() else []:
        if k == 0:
            continue  # empty-plan windows: resolved to the zero row below
        wsel = np.flatnonzero(wr == k)
        rows = (start[wsel][:, None]
                + np.arange(k, dtype=np.int64)[None, :]).reshape(-1)
        classes.append((int(k), rows.astype(np.int32)))
        perm[wsel] = base + np.arange(wsel.size)
        base += wsel.size
    perm[wr == 0] = base  # empty windows read the appended zero row
    tsel = np.flatnonzero(~main)
    tail_idx = np.zeros(0, np.int32)
    tail_ptr = np.zeros(1, np.int64)
    if tsel.size:
        # chunk each tall window into COMBINE_K-row pieces, padding the
        # last piece with a sentinel row (index R_out = appended zeros)
        n_chunks = -(-wr[tsel] // COMBINE_K)
        tail_ptr = np.zeros(tsel.size + 1, np.int64)
        np.cumsum(n_chunks, out=tail_ptr[1:])
        rows = []
        for w, nc in zip(tsel, n_chunks):
            r = np.arange(nc * COMBINE_K, dtype=np.int64) + start[w]
            r[wr[w]:] = -1  # sentinel, resolved below
            rows.append(r)
        tail_idx = np.concatenate(rows).astype(np.int32)
        perm[tsel] = base  # points at the appended zero row of cat
    # sentinel rows resolve to the appended zero row at index R_out
    r_out = plan.qv.shape[0] // g
    sent = np.where(tail_idx < 0, r_out, tail_idx).astype(np.int32)
    # device-resident index arrays, uploaded ONCE per plan: inlining
    # them as trace-time constants would bloat the HLO with hundred-MB
    # literals, and eager re-upload per call would pay the transfer
    # every run
    dev_idx = tuple(jnp.asarray(idx) for _, idx in classes)
    dev_perm = jnp.asarray(perm.astype(np.int32))
    dev_sent = jnp.asarray(sent) if tail_idx.size else None
    layout = (classes, dev_idx, dev_perm, dev_sent, tsel, tail_ptr)
    plan._combine_cache = layout
    return layout


def _combine_apply(plan: ScanPlan, out):
    """(R/G, 128) kernel output -> ((n_win, 128) window sums with tall
    windows zeroed, (n_tail_chunks, 128) tail partials). Plain eager
    XLA ops (row gathers + reshape-sums) over plan-resident indices."""
    classes, dev_idx, dev_perm, dev_sent, _, _ = _combine_layout(plan)
    zero = jnp.zeros((1, out.shape[1]), out.dtype)
    parts = [
        jnp.take(out, ii, axis=0).reshape(-1, k, out.shape[1]).sum(axis=1)
        for (k, _), ii in zip(classes, dev_idx)
    ]
    cat = jnp.concatenate(parts + [zero], axis=0)
    res = jnp.take(cat, dev_perm, axis=0)
    tail = None
    if dev_sent is not None:
        outz = jnp.concatenate([out, zero], axis=0)
        tail = (jnp.take(outz, dev_sent, axis=0)
                .reshape(-1, COMBINE_K, out.shape[1]).sum(axis=1))
    return res, tail


def _combine_apply_dd(plan: ScanPlan, s, e):
    """Compensated device combine for the double-double planes: sibling
    rows are reduced with the same branch-free 2Sum the kernel uses, so
    the ~2^-48 error bound survives the window reduction (a plain f32
    sum here would throw away the compensation)."""
    classes, dev_idx, dev_perm, dev_sent, _, _ = _combine_layout(plan)
    wn = s.shape[1]
    zero = jnp.zeros((1, wn), s.dtype)

    def red(ss, ee):
        sa, ea = ss[:, 0], ee[:, 0]
        for j in range(1, ss.shape[1]):
            sj = ss[:, j]
            t = sa + sj
            bp = t - sa
            err = (sa - (t - bp)) + (sj - bp)
            sa = t
            ea = ea + ee[:, j] + err
        return sa, ea

    parts_s, parts_e = [], []
    for (k, _), ii in zip(classes, dev_idx):
        sa, ea = red(jnp.take(s, ii, axis=0).reshape(-1, k, wn),
                     jnp.take(e, ii, axis=0).reshape(-1, k, wn))
        parts_s.append(sa)
        parts_e.append(ea)
    cat_s = jnp.concatenate(parts_s + [zero], axis=0)
    cat_e = jnp.concatenate(parts_e + [zero], axis=0)
    res = (jnp.take(cat_s, dev_perm, axis=0),
           jnp.take(cat_e, dev_perm, axis=0))
    tail = None
    if dev_sent is not None:
        sz = jnp.concatenate([s, zero], axis=0)
        ez = jnp.concatenate([e, zero], axis=0)
        tail = red(jnp.take(sz, dev_sent, axis=0)
                   .reshape(-1, COMBINE_K, wn),
                   jnp.take(ez, dev_sent, axis=0)
                   .reshape(-1, COMBINE_K, wn))
    return res, tail


def esc_scan_trim_combined_dd(plan: ScanPlan, res, tail) -> CSR:
    """Host epilogue of the DD device combine: f64(s) + f64(e) per
    window, tall windows finished from their compensated chunk pairs."""
    c_val = np.zeros(plan.nnz_c, np.float64)
    if plan.nnz_c:
        arr = (np.asarray(res[0], np.float64)
               + np.asarray(res[1], np.float64))
        _, _, _, _, tsel, tail_ptr = _combine_layout(plan)
        if tsel.size:
            tp = (np.asarray(tail[0], np.float64)
                  + np.asarray(tail[1], np.float64))
            arr[tsel] = np.add.reduceat(tp, tail_ptr[:-1], axis=0)
        c_val[:] = arr.reshape(-1)[: plan.nnz_c]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


def esc_scan_numeric_combined(plan: ScanPlan, dev=None, *,
                              sync: bool = True):
    """Scan kernel + device-side window combine. The combine runs as
    eager (async-dispatched) XLA ops over plan-resident index arrays —
    wrapping it in a jit would either inline those indices as
    hundred-MB HLO literals or force a retrace per call.
    Returns (res, tail) device arrays for esc_scan_trim_combined."""
    if dev is None:
        dev = plan.device_arrays()
    out = esc_scan_reduce(dev["qv"], dev["meta"], passes=plan.passes,
                          group_rows=plan.group_rows)
    res, tail = _combine_apply(plan, out)
    if sync:
        jax.block_until_ready(res)
    return res, tail


def esc_scan_trim_combined(plan: ScanPlan, res, tail) -> CSR:
    """Host epilogue of the device combine: download the (n_win, 128)
    window sums (~4*nnzC bytes), finish tall windows in f64."""
    c_val = np.zeros(plan.nnz_c, np.float64)
    if plan.nnz_c:
        arr = np.asarray(res, np.float64)
        _, _, _, _, tsel, tail_ptr = _combine_layout(plan)
        if tsel.size:
            tp = np.asarray(tail, np.float64)
            arr[tsel] = np.add.reduceat(tp, tail_ptr[:-1], axis=0)
        c_val[:] = arr.reshape(-1)[: plan.nnz_c]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


def time_esc_scan(plan: ScanPlan, *, loop: int = 20,
                  repeats: int = 2) -> float:
    """Amortized device time of the scan kernel (chained)."""
    from spgemm_tpu.utils.timing import chained_device_ms

    dev = plan.device_arrays()
    jax.block_until_ready(dev["qv"])

    @jax.jit
    def chain(qv, meta):
        def body(i, acc):
            out = esc_scan_reduce(qv + acc * 1e-30, meta,
                                  passes=plan.passes,
                                  group_rows=plan.group_rows)
            return acc + jnp.sum(out)

        return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

    return chained_device_ms(chain, dev["qv"], dev["meta"],
                             repeats=repeats, loop=loop)


def choose_group_rows(a: CSR, b: CSR, sample_rows: int = 2048) -> int:
    """Pick the scan plan's in-kernel window-reduction factor from a
    cheap sampled duplication estimate: windows average ~dup rows, so
    G=8 pays when dup is large (structured, e.g. cant-like dup ~22:
    output traffic /8 for ~6% row padding) and G=1 when windows are
    thin (rmat ~2.4: padding would blow the layout up)."""
    m = a.m
    if m == 0 or a.nnz == 0 or b.nnz == 0:
        return 1
    lo = max(0, m // 2 - sample_rows // 2)
    hi = min(m, lo + sample_rows)
    sub = CSR(a.indptr[lo : hi + 1] - a.indptr[lo],
              a.indices[a.indptr[lo] : a.indptr[hi]],
              a.data[a.indptr[lo] : a.indptr[hi]], (hi - lo, a.n))
    c_ip, _ = _structural_pattern(sub, b)
    nnz_sample = int(c_ip[-1])
    if nnz_sample == 0:
        return 1
    blen = (b.indptr[1:] - b.indptr[:-1]).astype(np.int64)
    f_sample = int(blen[sub.indices].sum())
    dup = f_sample / nnz_sample
    if dup >= 16.0:
        return 8
    if dup >= 8.0:
        return 4
    if dup >= 4.0:
        return 2
    return 1


def spgemm_esc(a: CSR, b: CSR, *, dtype=np.float32,
               plan: "EscPlan | ScanPlan | None" = None,
               mode: str = "auto", device=None):
    """End-to-end unstructured SpGEMM: C = A @ B through the ESC engine.
    Returns (CSR, timings dict, plan). The plan is reusable for new
    values of the same pattern (plan.refresh_values).

    mode="scan" (f32 default) runs the sorted-run suffix-scan Pallas
    kernel; f64 runs its double-double variant (esc_scan_dd — f64
    accuracy from f32 hardware); mode="digit" runs the one-hot digit
    contraction (XLA einsum, any dtype)."""
    f64 = np.dtype(dtype) == np.float64
    if plan is not None:
        plan_mode = "scan" if isinstance(plan, ScanPlan) else "digit"
        if mode not in ("auto", plan_mode):
            raise ValueError(
                f"plan is a {type(plan).__name__} but mode={mode!r}")
        mode = plan_mode
    elif mode == "auto":
        mode = "scan"
    timings: dict[str, float] = {}

    if mode == "scan":
        if plan is None:
            plan = build_esc_scan_plan(a, b, keep_sources=f64,
                                       group_rows=choose_group_rows(a, b))
        timings["symbolic_ms"] = plan.symbolic_ms
        if f64:
            t0 = time.perf_counter()
            c = esc_scan_dd(plan, a.data, b.data, device=device)
            timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3
            timings["upload_ms"] = 0.0
            timings["compact_ms"] = 0.0
            return c, timings, plan
        t0 = time.perf_counter()
        dev = plan.device_arrays()
        if device is not None:
            dev = {k: jax.device_put(v, device) for k, v in dev.items()}
        jax.block_until_ready(dev["qv"])
        timings["upload_ms"] = (time.perf_counter() - t0) * 1e3
        if DEVICE_COMBINE:
            t0 = time.perf_counter()
            res, tail = esc_scan_numeric_combined(plan, dev)
            timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            c = esc_scan_trim_combined(plan, res, tail)
            timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
            return c, timings, plan
        t0 = time.perf_counter()
        out = esc_scan_numeric(plan, dev)
        timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        c = esc_scan_trim(plan, out)
        timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
        return c, timings, plan

    if plan is None:
        plan = build_esc_plan(a, b)
    timings["symbolic_ms"] = plan.symbolic_ms

    t0 = time.perf_counter()
    dev = plan.device_arrays(dtype)
    if device is not None:
        dev = [{k: jax.device_put(v, device) for k, v in d.items()}
               for d in dev]
    jax.block_until_ready([d["av"] for d in dev])
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    outs = esc_numeric(plan, dev, dtype=dtype)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c = esc_trim(plan, outs)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
    return c, timings, plan


def time_esc_any(plan, **kw) -> float:
    """Dispatch amortized device timing by plan type."""
    if isinstance(plan, ScanPlan):
        return time_esc_scan(plan, **kw)
    return time_esc(plan, **kw)


def time_esc(plan: EscPlan, *, dtype=np.float32, loop: int = 20,
             repeats: int = 2,
             precision=jax.lax.Precision.HIGHEST) -> float:
    """Amortized per-call device time of the numeric phase (all width
    classes chained), resident operands — same methodology as
    StripExecutor.time_numeric."""
    from spgemm_tpu.utils.timing import chained_device_ms

    dev = plan.device_arrays(dtype)
    jax.block_until_ready([d["av"] for d in dev])
    prec = precision

    @jax.jit
    def chain(*flat):
        arrs = [(flat[3 * i], flat[3 * i + 1], flat[3 * i + 2])
                for i in range(len(flat) // 3)]

        def body(i, acc):
            s = acc
            for av, bv, slot in arrs:
                out = esc_digit_reduce(av + acc * 1e-30, bv, slot,
                                       s_slots=plan.s_slots,
                                       precision=prec)
                s = s + jnp.sum(out)
            return s

        return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

    flat = []
    for d in dev:
        flat += [d["av"], d["bv"], d["slot"]]
    return chained_device_ms(chain, *flat, repeats=repeats,
                             loop=loop)
