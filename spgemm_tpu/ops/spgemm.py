"""SpGEMM orchestrator: C = A @ B on the tiled format, end to end.

The counterpart of the reference's `tilespgemm()` host orchestrator
(`src/tilespgemm-cuda.h:2220-2844`): runs the symbolic phase (pair
schedule, host), the numeric phase (device, jitted), and compaction back
to the tiled format, with per-phase timing matching the reference's
step-time reporting
(`tilespgemm-cuda.h:2360-2372,2407-2411,2606-2615,2730-2741`).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from spgemm_tpu.models.csr import CSR, INDEX_DTYPE, flop_count_spgemm
from spgemm_tpu.models.tile import TileMat, cdiv, csr_to_tiles
from spgemm_tpu.ops import numeric as num_ops
from spgemm_tpu.ops.gustavson import build_gustavson_plan, gustavson_numeric
from spgemm_tpu.ops.symbolic import build_pair_schedule
from spgemm_tpu.utils import platform as plat

DEFAULT_CHUNK = num_ops.DEFAULT_CHUNK


@dataclasses.dataclass
class SpGEMMResult:
    c: TileMat | None  # None on the CSR-level ESC route (no tile grid)
    schedule: object  # PairSchedule or GustavsonPlan
    timings_ms: dict[str, float]
    stats: dict[str, float]


def _compact_to_tilemat(
    ctrow: np.ndarray,
    ctcol: np.ndarray,
    c_val: np.ndarray,   # (ntC, tm, tn)
    c_cnt: np.ndarray,   # (ntC, tm, tn) structural product counts
    shape: tuple[int, int],
    tm: int,
    tn: int,
) -> TileMat:
    """Dense per-tile accumulators -> TileMat; prunes structurally empty
    candidate tiles (grid-level false positives, the analogue of the
    reference's zero-nnz tiles after step 3)."""
    from spgemm_tpu.models.tile import _build_tilemat

    occ = c_cnt > 0
    keep = occ.any(axis=(1, 2))
    ctrow, ctcol = ctrow[keep], ctcol[keep]
    occ, c_val = occ[keep], c_val[keep]
    ntk = ctrow.size
    gm, gn = cdiv(shape[0], tm), cdiv(shape[1], tn)

    tid, rcflat = np.nonzero(occ.reshape(ntk, tm * tn))
    vals = c_val.reshape(ntk, tm * tn)[tid, rcflat].astype(np.float64)
    tile_key = ctrow[tid].astype(np.int64) * gn + ctcol[tid]
    # (tid ascending, rcflat row-major ascending) is already the canonical
    # order _build_tilemat expects.
    return _build_tilemat(
        shape=shape,
        tm=tm,
        tn=tn,
        tile_key=tile_key,
        rc=rcflat.astype(INDEX_DTYPE),
        val=vals,
        gm=gm,
        gn=gn,
    )


def _verify_against(sched, c_val, c_cnt, ref) -> None:
    """SPGEMM_TPU_SELFCHECK=1: compare a strip-backend result against the
    independently-scheduled XLA pair backend; raises on mismatch.
    Compares PER-TILE arrays — O(nnz + nt*tm*tn) memory, usable at the
    large scales where a selfcheck matters (round 1 densified to m x n)."""
    ref_sched = ref.schedule
    # both candidate lists are sorted (row, col); align by key
    key_a = sched.ctrow.astype(np.int64) * (2**32) + sched.ctcol
    key_b = ref_sched.ctrow.astype(np.int64) * (2**32) + ref_sched.ctcol
    # ref may have fewer candidates (no k-padding); every ref candidate
    # must exist here
    pos = np.searchsorted(key_a, key_b)
    if pos.size and (int(pos.max()) >= key_a.size
                     or not np.array_equal(key_a[pos], key_b)):
        raise AssertionError("selfcheck: C tile dictionaries disagree")
    ref_c = ref.c
    got_val = np.asarray(c_val)
    nt, tm, tn = got_val.shape
    # dense tiles of the reference result straight from TileMat arrays
    ref_tiles = np.zeros((ref_c.nt, tm * tn))
    ref_tiles[ref_c.tile_ids_expanded(), ref_c.rc] = ref_c.val
    # map ref tiles -> aligned candidates (ref_c may have pruned
    # structurally-empty candidates; align by coordinates again)
    rkey = ref_c.trow.astype(np.int64) * (2**32) + ref_c.tcol
    rpos = pos[np.searchsorted(key_b, rkey)]
    if not np.allclose(got_val[rpos].reshape(ref_c.nt, -1), ref_tiles,
                       rtol=1e-4, atol=1e-6):
        raise AssertionError(
            "selfcheck: strip values diverge from XLA pair backend")
    # every candidate NOT in the reference tile set must be ~zero
    extra = np.ones(nt, bool)
    extra[rpos] = False
    if np.any(np.abs(got_val[extra]) > 1e-6):
        raise AssertionError(
            "selfcheck: strip produced nonzeros outside the reference "
            "tile set")


def _resolve_backend(a: TileMat, b: TileMat, backend: str,
                     compute_dtype=jnp.float32,
                     platform: str | None = None) -> tuple[str, str]:
    """Pick a feasible tiled backend from cheap tile-pointer stats (no
    slabs built). Returns (backend, note). `platform` defaults to the
    process's own (utils/platform.py).

    Feasibility gates:
      strip     — f32, packed operands and pair products that fit the
                  device budget; auto takes it first where
                  utils/platform.prefers_strip says so (a GPU).
      dense     — three padded dense operands fit the device budget.
      gustavson — padded pair-product buffer fits a sane device budget
                  (it is materialized before the scatter).
      xla       — always feasible (chunked pair gather).
    """
    acsc_ptr, _ = a.csc_view()
    cnt_a = np.diff(acsc_ptr).astype(np.int64)
    cnt_b = np.diff(b.tptr).astype(np.int64)
    max_a = max(1, int(cnt_a.max())) if a.nt else 1
    max_b = max(1, int(cnt_b.max())) if b.nt else 1
    gk = a.gn
    tm, tk, tn = a.tm, a.tn, b.tn

    f64 = jnp.dtype(compute_dtype) == jnp.dtype(jnp.float64)
    # dense tiles (f32 + bf16 occupancy) in, one (tm, tn) value + count
    # tile per pair at most out
    num_pairs = int(cnt_b[a.tcol].sum()) if a.nt else 0
    strip_bytes = ((a.nt * tm * tk + b.nt * tk * tn) * 6
                   + num_pairs * tm * tn * 8)
    strip_ok = not f64 and strip_bytes <= 16 << 30
    # slab backend materializes (gk*max_a*max_b, tm, tn) x2 pair products
    slab_bytes = gk * max_a * max_b * tm * tn * 8
    slab_ok = slab_bytes <= 4 << 30

    # when tiling is defeated (unstructured patterns), a plain dense
    # matmul beats sparse gathering up to a surprisingly large n — three
    # padded dense operands must fit device memory
    dense_ok = _dense_bytes(a, b) <= 6 << 30

    if backend == "auto":
        if strip_ok and plat.prefers_strip(platform):
            return "strip", ""
        if dense_ok and not f64:
            return "dense", ""
        if slab_ok:
            return "gustavson", ""
        return "xla", ""
    if backend == "strip" and not strip_ok:
        note = "strip-fallback: needs f32 and operands within budget"
        if slab_ok:
            return "gustavson", note
        return "xla", note
    if backend == "gustavson" and not slab_ok:
        return "xla", "gustavson-fallback: pair products exceed budget"
    return backend, ""


def _dense_bytes(a: TileMat, b: TileMat) -> int:
    """Peak HBM bytes the dense backend needs: A/B values f32 + bf16
    occupancy (6 B/elt), C values AND counts both f32 (8 B/elt), plus
    the reshape/transpose temporaries of the tile cut (~another C)."""
    m_pad, k_pad = a.gm * a.tm, a.gn * a.tn
    n_pad = b.gn * b.tn
    return (m_pad * k_pad + k_pad * n_pad) * 6 + m_pad * n_pad * 16


def spgemm(
    a: TileMat,
    b: TileMat,
    *,
    compute_dtype=jnp.float32,
    acc_dtype=None,
    chunk: int = DEFAULT_CHUNK,
    backend: str = "auto",
    device=None,
    sync: bool = True,
) -> SpGEMMResult:
    """Sparse C = A @ B on the tiled format.

    backend:
      "auto" (default) — "strip" on a GPU when its operands fit, else
          "dense" when three padded operands fit, else "gustavson",
          else "xla".
      "strip"  — packed tiles + pair schedule, XLA pair products, a
          bit-packed occupancy download (ops/strip.py). Falls back to
          "gustavson" for f64 or operands over budget.
      "gustavson" — gather-free batched slab matmuls grouped by the
          inner tile dimension + one fused scatter (ops/gustavson.py).
      "dense"  — padded dense matmul + device-side tile selection; the
          unstructured-pattern path when the three padded operands fit.
      "xla"    — pair-gather + batched einsum + scatter-add; no k-group
          padding, the always-feasible fallback.
      "ozaki"  — f64 via exact int8 slice-pair matmuls (ops/ozaki.py);
          no x64 needed.
    """
    acc_dtype = acc_dtype or compute_dtype
    if backend == "ozaki":
        # Ozaki-slice f64 engine: exact int8 slice-pair matmuls, no x64
        # needed (ops/ozaki.py)
        from spgemm_tpu.ops.ozaki import spgemm_ozaki

        return spgemm_ozaki(a, b, device=device, sync=sync)
    if (jnp.dtype(compute_dtype) == jnp.float64
            and not jax.config.jax_enable_x64 and backend != "esc"):
        # the ESC route runs f64 through the double-double scan (f32
        # device arithmetic) and the ozaki route through exact int8
        # slice matmuls — neither needs x64
        raise ValueError(
            "float64 SpGEMM needs jax_enable_x64=True "
            "(jax.config.update('jax_enable_x64', True)), or use "
            "backend='ozaki' / backend='esc'"
        )
    timings: dict[str, float] = {}

    note = ""
    if backend in ("auto", "strip", "gustavson"):
        backend, note = _resolve_backend(a, b, backend, compute_dtype)

    if backend == "strip":
        return _spgemm_strip(a, b, device=device, note=note)
    if backend == "gustavson":
        return _spgemm_gustavson(
            a, b, compute_dtype=compute_dtype, acc_dtype=acc_dtype,
            device=device, sync=sync, note=note,
        )
    if backend == "dense":
        return _spgemm_dense(
            a, b, compute_dtype=compute_dtype, acc_dtype=acc_dtype,
            device=device, note=note,
        )
    if backend == "esc":
        # the ESC engine works on raw CSR; round-trip through the tiled
        # format (spgemm_csr routes there directly without tiling)
        from spgemm_tpu.models.tile import csr_to_tiles
        from spgemm_tpu.ops.esc import spgemm_esc

        np_dt = (np.float64
                 if jnp.dtype(compute_dtype) == jnp.dtype(jnp.float64)
                 else np.float32)
        c, timings, plan = spgemm_esc(a.to_csr(), b.to_csr(), dtype=np_dt,
                                      device=device)
        c_tiles = csr_to_tiles(c, a.tm, b.tn)
        stats = {
            "num_pairs": float(plan.num_products),
            "numblkC_candidate": float(c_tiles.nt),
            "numblkC": float(c_tiles.nt),
            "nnzC": float(c.nnz),
            "backend": "esc",
        }
        return SpGEMMResult(c=c_tiles, schedule=plan,
                            timings_ms=timings, stats=stats)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")

    t0 = time.perf_counter()
    sched = build_pair_schedule(a, b)
    timings["symbolic_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    a_val = jnp.asarray(a.dense(np.float32 if compute_dtype == jnp.float32
                                else np.float64), dtype=compute_dtype)
    b_val = jnp.asarray(b.dense(np.float32 if compute_dtype == jnp.float32
                                else np.float64), dtype=compute_dtype)
    a_occ = jnp.asarray(a.occ(), dtype=jnp.float32)
    b_occ = jnp.asarray(b.occ(), dtype=jnp.float32)
    if device is not None:
        a_val, b_val, a_occ, b_occ = jax.device_put(
            (a_val, b_val, a_occ, b_occ), device
        )
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    pa, pb, seg = num_ops.pad_pairs(
        sched.pa, sched.pb, sched.seg, sched.nt_c, chunk
    )
    c_val_d, c_cnt_d = num_ops.pair_accumulate(
        a_val, a_occ, b_val, b_occ,
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(seg),
        num_segments=sched.nt_c,
        chunk=chunk,
        acc_dtype=acc_dtype,
    )
    if sync:
        jax.block_until_ready((c_val_d, c_cnt_d))
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c_val = np.asarray(c_val_d, dtype=np.float64)
    c_cnt = np.asarray(c_cnt_d)
    c = _compact_to_tilemat(
        sched.ctrow, sched.ctcol, c_val, c_cnt,
        (a.m, b.n), a.tm, b.tn,
    )
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3

    stats = {
        "num_pairs": float(sched.num_pairs),
        "numblkC_candidate": float(sched.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
    }
    return SpGEMMResult(c=c, schedule=sched, timings_ms=timings, stats=stats)


def _spgemm_strip(a: TileMat, b: TileMat, *, device=None,
                  note: str = "") -> SpGEMMResult:
    """The structured fast path: pair schedule + packed dense tiles, the
    XLA pair products, packed-occupancy download, compaction."""
    from spgemm_tpu.ops.strip import build_strip_plan, download_tiles, run_strip
    from spgemm_tpu.utils.timing import device_trace

    timings: dict[str, float] = {}
    plan = build_strip_plan(a, b)
    timings["prep_ms"] = plan.prep_ms
    timings["symbolic_ms"] = plan.symbolic_ms

    t0 = time.perf_counter()
    dev = jax.device_put(plan.device_args(), device)
    jax.block_until_ready(dev)
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with device_trace("spgemm-strip"):
        c_val_d, c_cnt_d = run_strip(dev, plan.nt_c)
        jax.block_until_ready((c_val_d, c_cnt_d))
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c_val, c_occ = download_tiles(c_val_d, c_cnt_d)
    timings["download_ms"] = (time.perf_counter() - t0) * 1e3

    # cross-backend self-check (the framework's answer to the reference's
    # missing race detection, SURVEY.md §5): re-run through the XLA pair
    # backend and compare accumulators.
    import os as _os

    if _os.environ.get("SPGEMM_TPU_SELFCHECK") == "1":
        ref = spgemm(a, b, backend="xla", sync=True)
        _verify_against(plan.sched, c_val, c_occ, ref)

    t0 = time.perf_counter()
    c = _compact_to_tilemat(plan.ctrow, plan.ctcol,
                            c_val.astype(np.float64), c_occ,
                            (a.m, b.n), a.tm, b.tn)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
    stats = {
        "num_pairs": float(plan.num_pairs),
        "numblkC_candidate": float(plan.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": f"strip({note})" if note else "strip",
    }
    return SpGEMMResult(c=c, schedule=plan, timings_ms=timings, stats=stats)


def _spgemm_gustavson(
    a: TileMat,
    b: TileMat,
    *,
    compute_dtype=jnp.float32,
    acc_dtype=None,
    device=None,
    sync: bool = True,
    note: str = "",
) -> SpGEMMResult:
    acc_dtype = acc_dtype or compute_dtype
    np_dtype = np.float64 if jnp.dtype(compute_dtype) == jnp.float64 else np.float32
    timings: dict[str, float] = {}
    backend_used = f"gustavson({note})" if note else "gustavson"

    t0 = time.perf_counter()
    plan = build_gustavson_plan(a, b, dtype=np_dtype)
    timings["prep_ms"] = plan.prep_ms
    timings["symbolic_ms"] = (time.perf_counter() - t0) * 1e3 - plan.prep_ms

    t0 = time.perf_counter()
    arrs = jax.device_put(
        (plan.a3_val, plan.a3_occ, plan.b3_val, plan.b3_occ, plan.seg),
        device,
    )
    jax.block_until_ready(arrs)
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c_val_d, c_cnt_d = gustavson_numeric(
        *arrs,
        gk=plan.gk, max_a=plan.max_a, max_b=plan.max_b,
        tm=plan.tm, tn=plan.tn, nt_c=plan.nt_c,
        acc_dtype=acc_dtype,
    )
    if sync:
        jax.block_until_ready((c_val_d, c_cnt_d))
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c = _compact_to_tilemat(
        plan.ctrow, plan.ctcol,
        np.asarray(c_val_d, dtype=np.float64), np.asarray(c_cnt_d),
        (a.m, b.n), a.tm, b.tn,
    )
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3

    stats = {
        "num_pairs": float(plan.num_pairs),
        "numblkC_candidate": float(plan.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": backend_used,
        "padding_ratio": plan.padding_ratio(),
    }
    return SpGEMMResult(c=c, schedule=plan, timings_ms=timings, stats=stats)


def tile_occupancy_estimate(a: CSR, tm: int = 16, tn: int = 128) -> float:
    """Mean nnz per occupied tile, computed without tiling (one vectorized
    unique over tile coordinates). Low values mean the tiled formulation
    is defeated (unstructured pattern — the regime the reference routes
    to nsparse, `tilespgemm-cuda.h:2379`); high values favour the strip
    kernel."""
    if a.nnz == 0:
        return 0.0
    keys = ((a.rows_expanded().astype(np.int64) // tm) * cdiv(a.n, tn)
            + a.indices.astype(np.int64) // tn)
    return a.nnz / max(1, np.unique(keys).size)


# tiles sparser than this route "auto" to the ESC engine (products per
# occupied 16x128 tile; dense-ish bands are hundreds, random is ~1-4)
ESC_OCCUPANCY_TH = 8.0

# Second routing signal: tile reuse = products per A-nonzero = the mean
# B-row length met by each a_ik. The tiled path amortizes each tile
# pair's load and writeback over the dense products it contributes;
# when reuse is low the writeback dominates, while the scan engine moves
# only ~6 B per product. Patterns with BOTH moderate occupancy and low
# reuse therefore route to ESC. These thresholds decide from the pattern
# alone; they have not yet been calibrated on the GPU.
ESC_STRUCTURED_OCC_TH = 384.0
ESC_REUSE_TH = 32.0


def _tile_reuse(a: CSR, b: CSR | None, aat: bool) -> float:
    """Products per A-nonzero (mean partner-row length), vectorized."""
    if a.nnz == 0:
        return 0.0
    if aat:
        cnt = np.bincount(a.indices, minlength=a.n)
        f = int(cnt[a.indices].sum())
    else:
        bb = a if b is None else b
        f = int(np.diff(bb.indptr).astype(np.int64)[a.indices].sum())
    return f / a.nnz


def csr_route(a: CSR, b: CSR | None = None, *, aat: bool = False,
              tm: int = 16, tn: int = 128, compute_dtype=jnp.float32,
              platform: str | None = None) -> str:
    """The CSR-level auto route of spgemm_csr, decided from the pattern,
    the values (f64 only) and the platform, without touching a device:

      "esc"           — unstructured pattern: the ESC scan engine;
      "tiled"         — structured f32: tile, then _resolve_backend;
      "f64-exact-int" — integer data whose f32 sums are provably exact;
      "f64-native"    — structured f64 on a GPU: the XLA slab in x64;
      "ozaki"         — structured f64 elsewhere: int8 slice matmuls;
      "esc-dd"        — unstructured f64: the double-double scan.
    """
    f64 = jnp.dtype(compute_dtype) == jnp.dtype(jnp.float64)
    occ = tile_occupancy_estimate(a, tm, tn)
    structured = occ >= ESC_OCCUPANCY_TH and not (
        occ < ESC_STRUCTURED_OCC_TH and _tile_reuse(a, b, aat) < ESC_REUSE_TH)
    if not f64:
        return "tiled" if structured else "esc"
    if _f32_exact_for(a, b, aat):
        return "f64-exact-int"
    if occ < ESC_OCCUPANCY_TH:
        return "esc-dd"
    return "f64-native" if plat.f64_native(platform) else "ozaki"


def spgemm_csr(
    a: CSR,
    b: CSR | None = None,
    *,
    tm: int = 16,
    tn: int = 128,
    aat: bool = False,
    **kw,
) -> tuple[CSR, SpGEMMResult]:
    """CSR-level convenience API, the analogue of the reference driver's
    flow (`src/main.cu:97-350`): tile A (row-major role), derive B as A,
    A^T (aat), or an explicit matrix, multiply, and return CSR C.

    Default tiles are 16x128, which the GPU tile-pair kernel takes; the
    reference's 16x16 works too.

    backend="auto" follows csr_route: unstructured patterns bypass tiling
    and run the ESC engine (ops/esc.py, the nsparse-replacement path),
    structured ones are tiled and go to _resolve_backend. f64 data runs,
    best path first: the f32 pipeline when integer values make it
    provably exact; native x64 through the XLA slab on a GPU; the
    Ozaki-slice engine elsewhere (exact int8 matmuls, no x64 needed);
    and the double-double scan for unstructured patterns and for data
    the Ozaki bound rejects.

    With aat=True, B = A^T is produced directly in tile space
    (TileMat.transpose_tiles) — no CSR transpose round-trip.
    """
    backend = kw.get("backend", "auto")
    f64 = jnp.dtype(kw.get("compute_dtype", jnp.float32)) == jnp.float64
    import os as _os

    if backend == "esc" or (backend == "auto" and f64 and _os.environ.get(
            "SPGEMM_F64_ROUTE") == "dd"):
        # SPGEMM_F64_ROUTE=dd pins the f64 auto route to the double-double
        # scan without code edits (a triage switch)
        return _spgemm_csr_esc(a, b, aat=aat, **kw)
    if backend == "auto":
        route = csr_route(a, b, aat=aat, tm=tm, tn=tn,
                          compute_dtype=kw.get("compute_dtype", jnp.float32))
        if route in ("esc", "esc-dd"):
            return _spgemm_csr_esc(a, b, aat=aat, **kw)
        if route == "f64-exact-int":
            kw2 = dict(kw, compute_dtype=jnp.float32)
            c, res = spgemm_csr(a, b, aat=aat, tm=tm, tn=tn, **kw2)
            res.stats["backend"] = (
                f"{res.stats.get('backend', 'auto')}(f64-exact-int)")
            return c, res
        if route == "f64-native":
            kw2 = {k: v for k, v in kw.items() if k != "backend"}
            return _spgemm_csr_native_f64(a, b, aat=aat, tm=tm, tn=tn,
                                          **kw2)
        if route == "ozaki":
            from spgemm_tpu.ops.ozaki import OzakiOverflow

            kw2 = {k: v for k, v in kw.items() if k != "backend"}
            try:
                return _spgemm_csr_tiled_f64(a, b, aat=aat, tm=tm,
                                             tn=tn, **kw2)
            except OzakiOverflow:
                return _spgemm_csr_esc(a, b, aat=aat, **kw)
    at = csr_to_tiles(a, tm, tn)
    # Inner blocking must agree: A tiles are (tm, tn), so the B-role matrix
    # is tiled (tn, tn) and C comes out (tm, tn).
    bt = _tile_b_role(a, b, at, aat, tm, tn)
    res = spgemm(at, bt, **kw)
    return _csr_result_tail(res, a, b, aat)


def _tile_b_role(a: CSR, b: CSR | None, at: TileMat, aat: bool,
                 tm: int, tn: int) -> TileMat:
    """Derive the tiled B-role matrix (A, A^T, or explicit B) with the
    inner-blocking agreement rule (A tiles (tm, tn) -> B tiles (tn, tn))."""
    if aat:
        if b is not None:
            raise ValueError("pass either b or aat=True, not both")
        return at.transpose_tiles() if tm == tn else csr_to_tiles(
            a.transpose(), tn, tn)
    if b is None:
        if a.m != a.n:
            raise ValueError(
                "C = A^2 requires square A (reference main.cu:102-106)")
        return at if tm == tn else csr_to_tiles(a, tn, tn)
    return csr_to_tiles(b, tn, tn)


def _csr_result_tail(res: SpGEMMResult, a: CSR, b: CSR | None,
                     aat: bool) -> tuple[CSR, SpGEMMResult]:
    """Shared spgemm_csr epilogue: CSR extraction + reference-contract
    stats (nnzCub base, compression, GFLOPS — main.cu:155-162)."""
    c_csr = res.c.to_csr()
    nnz_cub = flop_count_spgemm(a, b if b is not None else
                                (a.transpose() if aat else a))
    res.stats["nnzCub"] = float(nnz_cub)
    if res.stats["nnzC"] > 0:
        res.stats["compression"] = nnz_cub / res.stats["nnzC"]
    total_device_ms = res.timings_ms["numeric_ms"]
    if total_device_ms > 0:
        res.stats["gflops"] = 2.0 * nnz_cub / (total_device_ms * 1e6)
    return c_csr, res


def _f32_exact_for(a: CSR, b: CSR | None, aat: bool) -> bool:
    """True when the f32 pipeline is PROVABLY exact for this f64 data:
    all values are integers and |C| partial sums stay below 2^24 (f32
    represents every integer up to 2^24; products and partial sums that
    never leave that range incur zero rounding in an f32 matmul at
    HIGHEST precision). Bound: each C element
    accumulates at most max-row-nnz(A) products of magnitude
    <= Vmax_A * Vmax_B. The reference's synthetic i%10 value model
    (main.cu:111-112) passes with orders of magnitude to spare."""
    av = a.data
    if av.size == 0:
        return True
    if not np.array_equal(np.trunc(av), av):
        return False
    vmax_a = float(np.abs(av).max())
    if b is None:
        vmax_b = vmax_a          # A^2 or AAT: same values
        bd = None
    else:
        bd = b.data
        if bd.size and not np.array_equal(np.trunc(bd), bd):
            return False
        vmax_b = float(np.abs(bd).max()) if bd.size else 0.0
    kmax = int(np.diff(a.indptr).max()) if a.nnz else 0
    return vmax_a * vmax_b * max(kmax, 1) < 2 ** 24


def _spgemm_csr_tiled_f64(a: CSR, b: CSR | None, *, aat: bool = False,
                          tm: int = 16, tn: int = 128, compute_dtype=None,
                          device=None, sync: bool = True,
                          **_ignored) -> tuple[CSR, SpGEMMResult]:
    """Structured-f64 branch of spgemm_csr off the GPU: tile + the
    Ozaki-slice engine (exact int8 slice-pair matmuls in the XLA slab
    form, ops/ozaki.py). Raises OzakiOverflow (caught by the caller,
    which falls back to the double-double scan) when the int32
    accumulation bound fails."""
    from spgemm_tpu.ops.ozaki import spgemm_ozaki

    at = csr_to_tiles(a, tm, tn)
    bt = _tile_b_role(a, b, at, aat, tm, tn)
    # strict=True: when the data's per-row significand span exceeds the
    # slice window (blocked-accuracy regime), raise so the auto router
    # falls back to the double-double scan's per-product accuracy
    res = spgemm_ozaki(at, bt, device=device, sync=sync, strict=True)
    return _csr_result_tail(res, a, b, aat)


def _spgemm_csr_native_f64(a: CSR, b: CSR | None, *, aat: bool = False,
                           tm: int = 16, tn: int = 128, compute_dtype=None,
                           device=None, **_ignored
                           ) -> tuple[CSR, SpGEMMResult]:
    """Structured-f64 branch of spgemm_csr on a GPU: the tiled multiply
    in native float64 (the XLA slab, or the pair backend when the slab
    does not fit), with 64-bit types enabled for this call only."""
    with jax.enable_x64(True):
        at = csr_to_tiles(a, tm, tn)
        bt = _tile_b_role(a, b, at, aat, tm, tn)
        res = spgemm(at, bt, compute_dtype=jnp.float64, backend="gustavson",
                     device=device)
    res.stats["backend"] = f"{res.stats['backend']}(f64-native)"
    return _csr_result_tail(res, a, b, aat)


def _spgemm_csr_esc(a: CSR, b: CSR | None, *, aat: bool = False,
                    backend: str = "auto", compute_dtype=jnp.float32,
                    device=None, **_ignored) -> tuple[CSR, SpGEMMResult]:
    """ESC-backend branch of spgemm_csr: no tiling, CSR in / CSR out.

    The returned SpGEMMResult carries ``c=None``: the ESC engine never
    builds a TileMat (there is no tile grid on this route — tiling the
    output of an unstructured multiply would cost more than the multiply).
    Generic consumers must use the returned CSR; ``res.c`` is only
    populated by the tiled backends (ADVICE r2)."""
    from spgemm_tpu.ops.esc import spgemm_esc

    if aat:
        if b is not None:
            raise ValueError("pass either b or aat=True, not both")
        b = a.transpose()
    elif b is None:
        if a.m != a.n:
            raise ValueError(
                "C = A^2 requires square A (reference main.cu:102-106)")
        b = a
    np_dt = (np.float64
             if jnp.dtype(compute_dtype) == jnp.dtype(jnp.float64)
             else np.float32)
    # f64 runs the double-double scan kernel: f32 device arithmetic with
    # compensated accumulation — no jax_enable_x64 needed (unlike the
    # emulated-f64 XLA paths)
    c, timings, plan = spgemm_esc(a, b, dtype=np_dt, device=device)
    nnz_cub = flop_count_spgemm(a, b)
    stats = {
        "num_pairs": float(plan.num_products),
        "numblkC_candidate": 0.0,
        "numblkC": 0.0,
        "nnzC": float(c.nnz),
        "nnzCub": float(nnz_cub),
        "backend": "esc",
    }
    if c.nnz:
        stats["compression"] = nnz_cub / c.nnz
    if timings["numeric_ms"] > 0:
        stats["gflops"] = 2.0 * nnz_cub / (timings["numeric_ms"] * 1e6)
    res = SpGEMMResult(c=None, schedule=plan, timings_ms=timings,
                       stats=stats)
    return c, res


# --- dense backend ----------------------------------------------------------
# When tiling is defeated (the strip gate fails), a plain padded dense
# matmul can beat sparse gathering up to a surprisingly large n: the
# dense product costs milliseconds where per-pair gathers cost far more.
# It stands in for the reference's nsparse hash path
# (`src/spgemm_nsparse_kernel.h`) where the three operands fit.


@dataclasses.dataclass
class _DenseSched:
    """Minimal schedule view (ctrow/ctcol/counts) for compaction/stats."""

    ctrow: np.ndarray
    ctcol: np.ndarray
    nt_c: int
    num_pairs: int


import functools as _functools


@_functools.partial(
    jax.jit, static_argnames=("gm", "gn", "tm", "tn", "acc_dtype")
)
def _dense_spgemm_kernel(ad, ao, bd, bo, *, gm, gn, tm, tn,
                         acc_dtype=jnp.float32):
    """One fused dense pass: values (f32 HIGHEST) + structural counts
    (bf16 occupancy, exact 0/1 math), cut into the tile grid, plus the
    per-tile nonzero mask used to select which tiles to download."""
    cv = jnp.dot(ad, bd, preferred_element_type=acc_dtype,
                 precision=jax.lax.Precision.HIGHEST)
    cc = jnp.dot(ao, bo, preferred_element_type=jnp.float32)
    cv4 = cv.reshape(gm, tm, gn, tn).transpose(0, 2, 1, 3).reshape(
        gm * gn, tm, tn)
    cc4 = cc.reshape(gm, tm, gn, tn).transpose(0, 2, 1, 3).reshape(
        gm * gn, tm, tn)
    tile_occ = (cc4 > 0).any(axis=(1, 2))
    return cv4, cc4, tile_occ


def _spgemm_dense(
    a: TileMat,
    b: TileMat,
    *,
    compute_dtype=jnp.float32,
    acc_dtype=None,
    device=None,
    note: str = "",
) -> SpGEMMResult:
    acc_dtype = acc_dtype or compute_dtype
    timings: dict[str, float] = {}
    backend_used = f"dense({note})" if note else "dense"
    gm, gn = a.gm, b.gn
    tm, tn = a.tm, b.tn

    t0 = time.perf_counter()
    # densify in the compute precision — an explicit backend="dense" call
    # with float64 must not truncate inputs through f32 (ADVICE r1)
    np_dt = (np.float64 if jnp.dtype(compute_dtype) == jnp.dtype(jnp.float64)
             else np.float32)
    ad = jnp.asarray(a.to_dense_padded(np_dt), dtype=compute_dtype)
    bd = jnp.asarray(b.to_dense_padded(np_dt), dtype=compute_dtype)
    # occupancy from the STORED pattern, not values — explicit zeros are
    # structural (the reference's synthetic i%10 values include zeros)
    ao = jnp.asarray(a.occ_dense_padded(), dtype=jnp.bfloat16)
    bo = jnp.asarray(b.occ_dense_padded(), dtype=jnp.bfloat16)
    if device is not None:
        ad, bd, ao, bo = jax.device_put((ad, bd, ao, bo), device)
    jax.block_until_ready((ad, bd, ao, bo))
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3
    timings["symbolic_ms"] = 0.0  # pattern rides the occupancy matmul

    t0 = time.perf_counter()
    cv4, cc4, tile_occ = _dense_spgemm_kernel(
        ad, ao, bd, bo, gm=gm, gn=gn, tm=tm, tn=tn, acc_dtype=acc_dtype)
    mask = np.asarray(tile_occ)       # host sync: which tiles exist
    flat = np.flatnonzero(mask)
    idx = jnp.asarray(flat.astype(np.int32))
    c_val = np.asarray(jnp.take(cv4, idx, axis=0), dtype=np.float64)
    c_cnt = np.asarray(jnp.take(cc4, idx, axis=0))
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    ctrow = (flat // gn).astype(INDEX_DTYPE)
    ctcol = (flat % gn).astype(INDEX_DTYPE)
    t0 = time.perf_counter()
    c = _compact_to_tilemat(ctrow, ctcol, c_val, c_cnt,
                            (a.m, b.n), tm, tn)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3

    bptr = b.tptr.astype(np.int64)
    num_pairs = int((bptr[a.tcol + 1] - bptr[a.tcol]).sum()) if a.nt else 0
    sched = _DenseSched(ctrow=ctrow, ctcol=ctcol, nt_c=int(flat.size),
                        num_pairs=num_pairs)
    stats = {
        "num_pairs": float(num_pairs),
        "numblkC_candidate": float(flat.size),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": backend_used,
    }
    return SpGEMMResult(c=c, schedule=sched, timings_ms=timings, stats=stats)


def time_dense(a: TileMat, b: TileMat, *, loop: int = 10, repeats: int = 2,
               compute_dtype=jnp.float32) -> float:
    """Amortized per-dispatch device time (ms) for the dense backend's
    fused kernel (values + counts + tile mask), chained like
    StripExecutor.time_numeric."""
    gm, gn = a.gm, b.gn
    tm, tn = a.tm, b.tn
    ad_h = a.to_dense_padded(np.float32)
    bd_h = b.to_dense_padded(np.float32)
    ad = jax.device_put(jnp.asarray(ad_h, dtype=compute_dtype))
    bd = jax.device_put(jnp.asarray(bd_h, dtype=compute_dtype))
    # occupancy from the STORED pattern like _spgemm_dense — a values
    # test would miscount matrices with explicit zeros (VERDICT r3 #10)
    ao = jax.device_put(jnp.asarray(a.occ_dense_padded(), jnp.bfloat16))
    bo = jax.device_put(jnp.asarray(b.occ_dense_padded(), jnp.bfloat16))
    jax.block_until_ready((ad, bd, ao, bo))

    from spgemm_tpu.utils.timing import chained_device_ms

    @jax.jit
    def chain(ad, ao, bd, bo):
        def body(i, acc):
            cv4, _, _ = _dense_spgemm_kernel(
                ad + acc * 1e-30, ao, bd, bo,
                gm=gm, gn=gn, tm=tm, tn=tn)
            return acc + jnp.sum(cv4).astype(jnp.float32)
        return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

    return chained_device_ms(chain, ad, ao, bd, bo,
                             repeats=repeats, loop=loop)
