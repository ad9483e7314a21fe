"""Ozaki-slice f64 SpGEMM engine — exact double-precision products from
int8 matmuls, for STRUCTURED matrices (the tiled/slab formulation).

The reference computes all of SpGEMM in double (`src/common.h:22`;
step-4 numeric `tilespgemm-cuda.h:2649-2728` accumulates `double` in
shared memory). For hardware without fast f64 arithmetic this engine
splits each f64 value into S signed 7-bit integer slices against a
per-row (A) / per-column (B) power-of-two scale:

    a[r, k] = 2^(Ea_r - 7)  * sum_s  qa_s[r, k] * 2^(-7 s)
    b[k, c] = 2^(Eb_c - 7)  * sum_t  qb_t[k, c] * 2^(-7 t)

with |qa|, |qb| <= 127 (int8). Every slice-pair product then runs as an
int8 x int8 -> int32 `dot_general` — EXACT: products are
< 2^14 and the int32 accumulation never rounds (the per-tile-dictionary
scatter keeps accumulating in int32; a host-side bound check guarantees
no overflow, see build_ozaki_plan). Pair groups p = s + t are combined
on device into a triple-float (h, m, l) via exact int32 splits and
cascaded TwoSum compensation (~70 effective significand bits — every
<= 53-bit result reconstructs exactly in f64), and the host applies the
2^(Ea_r + Eb_c - 14) scales in f64 — full f64 exponent range, no device
overflow.

S adapts to the data (_span_slices): the reference's synthetic benchmark
values are small integers (`main.cu:111-112`, i % 10 style), which need
S = 1 — ONE int8 matmul per slab pair, cheaper than the f32 path.
General f64 significands need S = 8 (7 * 8 = 56 >= 53 bits), i.e.
Sa * Sb = 64 slice-pair matmuls. Accuracy model: within each A row /
B column, significand bits more than 7*S below the row/column maximum
are truncated (the standard Ozaki-scheme blocked bound); when S covers
the true bit span — any data whose per-row dynamic range fits 56 bits,
including every integer-valued model — the result is BIT-EXACT f64.

Geometry (k-group slabs, C-tile dictionary, occupancy counts) is shared
with the Gustavson slab backend (ops/gustavson.py:build_gustavson_plan);
only the value planes differ (int8 slice stacks instead of f32 slabs).

The slicing idea is the Ozaki error-free matrix-product transformation
(Ozaki, Ogita, Oishi, Rump 2012) in its integer-unit form (cf. Ootomo,
Ozaki, Yokota 2024's DGEMM on int8 tensor cores); the formulation here
(per-row/column scales, value-adaptive S, int32 scatter accumulation
into a sparse C-tile dictionary, triple-float device combine) is
original to this engine.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from spgemm_tpu.models.tile import TileMat
from spgemm_tpu.ops.gustavson import GustavsonPlan, build_gustavson_plan

MAX_SLICES = 8          # 7 bits/slice * 8 = 56 >= f64's 53 significand bits
_INT32_HEADROOM = 2     # require bound * HEADROOM < 2^31


class OzakiOverflow(ValueError):
    """The int32 accumulation bound cannot be guaranteed for this
    problem (too many products per C element for the slice width).
    Callers fall back to the double-double scan engine."""


# --- host-side slicing ------------------------------------------------------

def _span_slices(dense: np.ndarray, exp_of: np.ndarray) -> tuple[int, int]:
    """(S, raw bit span): S = min(MAX_SLICES, ceil(span / 7)); the bit
    span of value v in a group with scale exponent E is
    E - lsb_exponent(v). span > 7*MAX_SLICES means the capped slicing
    truncates (the Ozaki blocked-accuracy regime)."""
    nz = dense != 0.0
    if not nz.any():
        return 1, 0
    v = dense[nz]
    e_scale = exp_of[nz]
    mant, e = np.frexp(v)
    mi = np.abs(np.ldexp(mant, 53)).astype(np.int64)
    tz = np.zeros(mi.shape, np.int64)
    m = mi.copy()
    for step in (32, 16, 8, 4, 2, 1):
        z = (m & ((1 << step) - 1)) == 0
        tz[z] += step
        m[z] >>= step
    lsb = e.astype(np.int64) - 53 + tz
    span = int((e_scale - lsb).max())
    return min(MAX_SLICES, max(1, -(-span // 7))), span


def _slice_int8(dense: np.ndarray, exp_of: np.ndarray, s: int) -> np.ndarray:
    """(S, *dense.shape) int8 slices: x0 = v * 2^(7 - E); q_i = trunc;
    x_{i+1} = (x_i - q_i) * 128. All steps are exact in f64."""
    x = np.ldexp(dense, 7 - exp_of)
    out = np.empty((s,) + dense.shape, np.int8)
    for i in range(s):
        q = np.trunc(x)
        out[i] = q.astype(np.int8)
        if i + 1 < s:
            x = (x - q) * 128.0
    return out


# --- plan -------------------------------------------------------------------

@dataclasses.dataclass
class OzakiPlan:
    base: GustavsonPlan          # geometry + C-tile dictionary
    a_occ: np.ndarray            # (gk, max_a*tm, tk) int8 0/1 occupancy
    b_occ: np.ndarray            # (gk, tk, max_b*tn) int8
    a_sl: np.ndarray             # (Sa, gk, max_a*tm, tk) int8
    b_sl: np.ndarray             # (Sb, gk, tk, max_b*tn) int8
    ea: np.ndarray               # (gm*tm,) int64 per-row scale exponents
    eb: np.ndarray               # (gn*tn,) int64 per-col scale exponents
    perm: np.ndarray             # (n_slots,) int32 pair order sorted by seg
    bounds: np.ndarray           # (nt_c+1,) int32 segment boundaries in perm
    sa: int
    sb: int
    prep_ms: float
    symbolic_ms: float

    @property
    def num_pairs(self) -> int:
        return self.base.num_pairs

    @property
    def ctrow(self):
        return self.base.ctrow

    @property
    def ctcol(self):
        return self.base.ctcol

    @property
    def nt_c(self) -> int:
        return self.base.nt_c

    def padding_ratio(self) -> float:
        return self.base.padding_ratio()


def build_ozaki_plan(a: TileMat, b: TileMat,
                     strict: bool = False) -> OzakiPlan:
    """Slice the f64 tile values and pack them into the Gustavson slab
    layout (same slot formulas as build_gustavson_plan; the occupancy
    slabs and C-tile dictionary are reused from the base plan).

    Raises OzakiOverflow when the int32 accumulation bound cannot be
    guaranteed: per C element the scatter accumulates at most
    (pairs hitting that C tile) * tk * min(Sa, Sb) products of
    magnitude <= 127^2 — verified against 2^31 with headroom."""
    # cheap tile-pointer feasibility BEFORE the base plan builds its occ
    # slabs (pathological k-column skew can blow gk*max_a padding)
    acsc_ptr, _ = a.csc_view()
    max_a0 = max(1, int(np.diff(acsc_ptr).max())) if a.nt else 1
    max_b0 = max(1, int(np.diff(b.tptr).max())) if b.nt else 1
    occ_bytes = a.gn * (max_a0 * a.tm * a.tn
                        + max_b0 * b.tm * b.tn) * 4
    if occ_bytes > (4 << 30):
        raise OzakiOverflow(
            f"k-group padding explodes (occ slabs {occ_bytes/1e9:.1f} "
            "GB) — unstructured pattern; use the double-double scan "
            "engine")
    base = build_gustavson_plan(a, b, dtype=np.float32, values=False)

    t_prep = time.perf_counter()
    a_sl, b_sl, ea, eb, sa, sb = slice_and_pack(a, b, base, strict=strict)
    # int8 occupancy: the count matmul is exact in int32 (0/1 inputs,
    # per-element count <= pairs * tk << 2^31) and the upload shrinks 4x
    # vs the f32 occ slabs — at cant scale the occ planes would
    # otherwise dominate the H2D traffic (160 MB vs 40 MB of slices)
    a_occ = base.a3_occ.astype(np.int8)
    b_occ = base.b3_occ.astype(np.int8)
    base.a3_occ = base.b3_occ = None  # drop the f32 copies

    # scatter-free combine support (combine_mode 'cumsum'): pair order
    # sorted by destination segment + segment boundaries; sentinel
    # (padding) pairs sort past bounds[nt_c]
    perm = np.argsort(base.seg, kind="stable").astype(np.int32)
    bounds = np.searchsorted(
        base.seg[perm], np.arange(base.nt_c + 1)).astype(np.int32)

    prep_ms = (time.perf_counter() - t_prep) * 1e3
    return OzakiPlan(
        base=base, a_occ=a_occ, b_occ=b_occ, a_sl=a_sl, b_sl=b_sl,
        ea=ea, eb=eb, perm=perm, bounds=bounds, sa=sa, sb=sb,
        prep_ms=prep_ms + base.prep_ms,
        symbolic_ms=base.symbolic_ms,
    )


def slice_and_pack(a: TileMat, b: TileMat, base: GustavsonPlan,
                   strict: bool = False):
    """Value-dependent half of the plan build: scales, adaptive slice
    counts, int8 slicing, slab packing, feasibility checks. Reused by
    OzakiExecutor.update_values (pattern-fixed value refresh: the
    geometry/base plan is reused, only this function reruns)."""
    gk, max_a, max_b = base.gk, base.max_a, base.max_b
    tm, tk, tn = base.tm, base.tk, base.tn

    # geometry-only feasibility FIRST — before materializing the f64
    # dense tile cubes (an unstructured 65536^2 matrix has ~800k tiles:
    # its dense cube alone is ~13 GB and must never be allocated on the
    # way to a fallback)
    slab_bytes = gk * max_a * max_b * tm * tn * 4
    dense_bytes = (a.nt * tm * tk + b.nt * tk * tn) * 8
    slice_ub = MAX_SLICES * (gk * max_a * tm * tk + gk * max_b * tk * tn)
    if (slab_bytes > (4 << 30) or dense_bytes > (4 << 30)
            or slice_ub > (8 << 30)):
        raise OzakiOverflow(
            f"slab padding explodes (pair buffer {slab_bytes/1e9:.1f} GB, "
            f"dense cubes {dense_bytes/1e9:.1f} GB) — unstructured "
            "pattern; use the double-double scan engine")

    ad, bd, ea, eb, sa, sb, _span = _scales_and_slices_prep(
        a, b, strict=strict)

    # int32 accumulation bound (per C element, per pair group)
    seg_real = base.seg[base.seg < base.nt_c]
    max_pairs = int(np.bincount(seg_real).max()) if seg_real.size else 1
    _check_int32_bound(max_pairs, tk, sa, sb)
    exp_a = ea.reshape(a.gm, tm)[a.trow.astype(np.int64)][:, :, None]
    exp_b = eb.reshape(b.gn, tn)[b.tcol.astype(np.int64)][:, None, :]
    a_slices = _slice_int8(ad, exp_a, sa)                   # (Sa, nt, tm, tk)
    b_slices = _slice_int8(bd, exp_b, sb)                   # (Sb, nt, tk, tn)

    # pack into the slab layout (same slot formulas as
    # build_gustavson_plan, gustavson.py:101-132)
    acsc_ptr, acsc_perm = a.csc_view()
    cnt_a = np.diff(acsc_ptr).astype(np.int64)
    rank_a = np.arange(a.nt, dtype=np.int64) - np.repeat(
        acsc_ptr[:-1].astype(np.int64), cnt_a)
    ka = np.repeat(np.arange(gk, dtype=np.int64), cnt_a)
    slot_a = ka * max_a + rank_a
    from spgemm_tpu.utils.native import pool_array

    a_sl = pool_array((sa, gk * max_a, tm, tk), np.int8, zero=True)
    a_sl[:, slot_a] = a_slices[:, acsc_perm]
    a_sl = a_sl.reshape(sa, gk, max_a * tm, tk)

    bptr = b.tptr.astype(np.int64)
    cnt_b = np.diff(bptr)
    rank_b = np.arange(b.nt, dtype=np.int64) - np.repeat(bptr[:-1], cnt_b)
    kb = np.repeat(np.arange(gk, dtype=np.int64), cnt_b)
    slot_b = kb * max_b + rank_b
    b_pack = pool_array((sb, gk * max_b, tk, tn), np.int8, zero=True)
    b_pack[:, slot_b] = b_slices
    # the horizontal-stack transpose materializes a fresh layout; land
    # it in a pooled buffer too (these slabs are the plan's largest
    # resident arrays and repeated builds re-pay first-touch otherwise)
    b_sl = pool_array((sb, gk, tk, max_b * tn), np.int8)
    np.copyto(b_sl, b_pack.reshape(sb, gk, max_b, tk, tn).transpose(
        0, 1, 3, 2, 4).reshape(sb, gk, tk, max_b * tn))

    return a_sl, b_sl, ea, eb, sa, sb


def _check_int32_bound(max_pairs: int, tk: int, sa: int, sb: int) -> None:
    """Per-C-element, per-pair-group int32 accumulation bound: at most
    max_pairs * tk * min(Sa, Sb) products of magnitude <= 127^2."""
    bound = max_pairs * tk * min(sa, sb) * 127 * 127
    if bound * _INT32_HEADROOM >= 2 ** 31:
        raise OzakiOverflow(
            f"int32 bound {bound:.3g} (pairs/tile={max_pairs}, tk={tk}, "
            f"g={min(sa, sb)}) too close to 2^31 — use the double-double "
            "scan engine for this problem")


def _scales_and_slices_prep(a: TileMat, b: TileMat, *,
                            strict: bool = False):
    """Value-model half shared by the XLA slab engine (slice_and_pack)
    and the fused strip kernel (build_ozaki_strip): dense f64 cubes,
    per-row/per-column pow2 scales, adaptive slice counts, and the
    strict extreme-span routing check. Returns (ad, bd, ea, eb, sa, sb)."""
    tm, tn = a.tm, b.tn
    ad = a.dense(np.float64)
    bd = b.dense(np.float64)
    if not (np.isfinite(ad).all() and np.isfinite(bd).all()):
        raise ValueError("ozaki engine requires finite values")

    # per-row scales for A (rows of C), per-column scales for B:
    # per-tile row/col maxima -> global owner scatter-max, then frexp
    # (mx = m * 2^e with 0.5 <= |m| < 1  =>  every |v| <= mx < 2^e,
    # except mx == 2^k exactly -> e = k + 1: still |v| < 2^E)
    a_rowmax = np.abs(ad).max(axis=2)                       # (nt_a, tm)
    ea = np.zeros(a.gm * tm, np.float64)
    np.maximum.at(ea.reshape(a.gm, tm), a.trow.astype(np.int64), a_rowmax)
    _, ea_e = np.frexp(ea)
    ea_e[ea == 0.0] = 0
    ea = ea_e.astype(np.int64)                              # (gm*tm,)

    b_colmax = np.abs(bd).max(axis=1)                       # (nt_b, tn)
    eb = np.zeros(b.gn * tn, np.float64)
    np.maximum.at(eb.reshape(b.gn, tn), b.tcol.astype(np.int64), b_colmax)
    _, eb_e = np.frexp(eb)
    eb_e[eb == 0.0] = 0
    eb = eb_e.astype(np.int64)                              # (gn*tn,)

    exp_a = ea.reshape(a.gm, tm)[a.trow.astype(np.int64)][:, :, None]
    exp_b = eb.reshape(b.gn, tn)[b.tcol.astype(np.int64)][:, None, :]
    sa, span_a = _span_slices(ad, np.broadcast_to(exp_a, ad.shape))
    sb, span_b = _span_slices(bd, np.broadcast_to(exp_b, bd.shape))
    # Typical f64 data exceeds the 56-bit window by its value spread
    # (span ~ 53 + log2(dynamic range)) and the capped slicing there is
    # still f64-eps-class relative to the row/col scales — the same
    # error model as any blocked Ozaki DGEMM. Only EXTREME multi-scale
    # rows (spread beyond ~2^64 in one row) get whole entries truncated;
    # the auto router (strict=True) prefers the double-double scan's
    # per-product accuracy for those — but ONLY when the DD scan can
    # actually represent the products (its hi/lo planes are f32: the
    # product range must fit f32's exponent field; this engine's
    # per-row/col scaling has no such limit). Explicit backend='ozaki'
    # callers keep the documented blocked bound.
    if strict and max(span_a, span_b) > 7 * MAX_SLICES + 64:
        nza = np.abs(ad[ad != 0.0])
        nzb = np.abs(bd[bd != 0.0])
        pmax = (float(nza.max()) * float(nzb.max())
                if nza.size and nzb.size else 0.0)
        pmin = (float(nza.min()) * float(nzb.min())
                if nza.size and nzb.size else 0.0)
        _extreme_span_check(max(span_a, span_b), pmax, pmin)
    return ad, bd, ea, eb, sa, sb, max(span_a, span_b)


def _extreme_span_check(span: int, pmax: float, pmin: float) -> None:
    """strict=True routing: prefer the DD scan for extreme multi-scale
    data when the DD planes can represent the products (see
    _scales_and_slices_prep's comment for the full rationale)."""
    dd_viable = (pmax < 2.0 ** 120) and (pmin == 0.0
                                         or pmin > 2.0 ** -120)
    if dd_viable:
        raise OzakiOverflow(
            f"per-row/col significand span {span} bits is far beyond "
            f"the {7 * MAX_SLICES}-bit slice window — extreme "
            "multi-scale data; routing prefers the double-double scan")


# --- device numeric ---------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _acc3(h, m, l, x):
    """Add the exact f32 term x into the triple-float accumulator
    (h, m, l): cascaded TwoSum compensation — only l's own accumulation
    rounds, so the triple carries ~70 effective significand bits, enough
    to reconstruct every <= 53-bit result exactly in f64 (a double-float
    pair held only ~48 bits and rounded e.g. a 1e30 entry)."""
    h, e = _two_sum(h, x)
    m, e2 = _two_sum(m, e)
    return h, m, l + e2


def combine_mode() -> str:
    """Pair-tile combine strategy, runtime-selectable for hardware A/B:
    'scatter' (default) accumulates per-group int32 pair tiles with
    .at[seg].add; 'cumsum' is the scatter-FREE formulation — pair tiles
    permuted into seg order (128-wide row gathers), an int32
    cumulative sum along the pair axis (wrapping
    two's-complement adds: each SEGMENT's true sum fits int32 by the
    plan's bound, so boundary differences are exact even though the
    running sum wraps), and one boundary-row gather per C tile.
    Which one XLA runs faster on a device is what the A/B decides.
    Env knob: SPGEMM_OZAKI_COMBINE."""
    import os

    return os.environ.get("SPGEMM_OZAKI_COMBINE", "scatter")


def ozaki_core(a_sl, b_sl, a3_occ, b3_occ, seg, perm, bounds, *,
               gk, max_a, max_b, tm, tn, nt_c, sa, sb,
               combine: str = "scatter"):
    """Traceable core: Sa*Sb exact int8->int32 slab matmuls, per-group
    int32 combine into the C-tile dictionary (scatter or the
    scatter-free permute+cumsum formulation — see combine_mode), device
    triple-float accumulation. Returns (c_h, c_m, c_l, c_cnt) —
    (h, m, l) are the UNSCALED triple-float sums sum_p M_p * 2^(-7p);
    the host applies the 2^(Ea_r + Eb_c - 14) scales in f64."""

    def slab_mm(x, y, acc):
        return jax.lax.dot_general(
            x, y, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=acc,
            precision=jax.lax.Precision.HIGHEST)

    def to_pairs(p):
        return (p.reshape(gk, max_a, tm, max_b, tn)
                 .transpose(0, 1, 3, 2, 4).reshape(-1, tm, tn))

    stride = nt_c + 1

    def seg_sum(pairs):
        if combine == "scatter":
            acc = jnp.zeros((stride, tm, tn), jnp.int32)
            return acc.at[seg].add(pairs)[:nt_c]
        # scatter-free: permute into seg order, wrapping int32 cumsum,
        # exact boundary differences (sentinel/padding pairs sort past
        # bounds[nt_c] and never enter a difference)
        ps = pairs[perm]
        cs = jnp.cumsum(ps, axis=0, dtype=jnp.int32)
        csz = jnp.concatenate(
            [jnp.zeros((1, tm, tn), jnp.int32), cs], axis=0)
        return csz[bounds[1:]] - csz[bounds[:-1]]

    c_h = jnp.zeros((nt_c, tm, tn), jnp.float32)
    c_m = jnp.zeros((nt_c, tm, tn), jnp.float32)
    c_l = jnp.zeros((nt_c, tm, tn), jnp.float32)
    for p in range(sa + sb - 1):
        m = None
        for s in range(max(0, p - sb + 1), min(sa - 1, p) + 1):
            d = slab_mm(a_sl[s], b_sl[p - s], jnp.int32)
            m = d if m is None else m + d
        mp = seg_sum(to_pairs(m))
        # exact int32 -> double-float split, scaled by 2^(-7p) (exact:
        # power-of-two multiply), then triple-float accumulate
        mh = mp.astype(jnp.float32)
        ml = (mp - mh.astype(jnp.int32)).astype(jnp.float32)
        scale = jnp.float32(2.0 ** (-7 * p))
        c_h, c_m, c_l = _acc3(c_h, c_m, c_l, mh * scale)
        c_h, c_m, c_l = _acc3(c_h, c_m, c_l, ml * scale)

    po = slab_mm(a3_occ, b3_occ, jnp.int32)
    cnt = seg_sum(to_pairs(po))
    return c_h, c_m, c_l, cnt


_ozaki_jit = jax.jit(
    ozaki_core,
    static_argnames=("gk", "max_a", "max_b", "tm", "tn", "nt_c",
                     "sa", "sb", "combine"))


def ozaki_numeric(plan: OzakiPlan, device=None, sync: bool = True):
    """Upload + run; returns device (c_h, c_m, c_l, c_cnt) and a timing
    dict."""
    base = plan.base
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    arrs = jax.device_put(
        (plan.a_sl, plan.b_sl, plan.a_occ, plan.b_occ, base.seg,
         plan.perm, plan.bounds), device)
    jax.block_until_ready(arrs)
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = _ozaki_jit(*arrs, gk=base.gk, max_a=base.max_a, max_b=base.max_b,
                     tm=base.tm, tn=base.tn, nt_c=base.nt_c,
                     sa=plan.sa, sb=plan.sb, combine=combine_mode())
    if sync:
        jax.block_until_ready(out)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3
    return out, timings


def time_ozaki(plan: OzakiPlan, *, loop: int = 20, repeats: int = 2,
               device=None) -> float:
    """Amortized per-dispatch device time (ms) for the ozaki core
    (chained dispatches, utils/timing.chained_device_ms)."""
    from spgemm_tpu.utils.timing import chained_device_ms

    base = plan.base
    put = (lambda x: jax.device_put(x, device)) if device \
        else jax.device_put
    arrs = [put(x) for x in (plan.a_sl, plan.b_sl, plan.a_occ,
                             plan.b_occ, jnp.asarray(base.seg),
                             jnp.asarray(plan.perm),
                             jnp.asarray(plan.bounds))]
    jax.block_until_ready(arrs)
    kw = dict(gk=base.gk, max_a=base.max_a, max_b=base.max_b,
              tm=base.tm, tn=base.tn, nt_c=base.nt_c,
              sa=plan.sa, sb=plan.sb, combine=combine_mode())

    @jax.jit
    def chain(a_sl, b_sl, ao, bo, seg, perm, bounds):
        # all operands are integer: the loop-carried f32 acc casts to an
        # int8 zero added to the slice plane for the data dependency
        def body(i, acc):
            dep = (acc * jnp.float32(1e-30)).astype(jnp.int8)
            h, _m, _l, c = ozaki_core(a_sl + dep, b_sl, ao, bo, seg,
                                      perm, bounds, **kw)
            return (acc + jnp.sum(h)
                    + jnp.sum(c).astype(jnp.float32))
        return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

    return chained_device_ms(chain, *arrs, repeats=repeats,
                             loop=loop)


def spgemm_ozaki(a: TileMat, b: TileMat, *, device=None, sync: bool = True,
                 strict: bool = False, note: str = ""):
    """Full f64 multiply through the Ozaki-slice engine (the XLA slab
    form); returns a SpGEMMResult (TileMat C, f64 values) shaped like the
    other tiled backends (ops/spgemm.py). Raises OzakiOverflow when the
    int32 accumulation bound fails — callers fall back to the
    double-double scan engine."""
    from spgemm_tpu.ops.spgemm import SpGEMMResult, _compact_to_tilemat

    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    plan = build_ozaki_plan(a, b, strict=strict)
    # prep (slab/slice packing) vs symbolic (pair expansion + C-tile
    # dictionary + bound checks) split, like the other tiled backends
    timings["symbolic_ms"] = max(
        0.0, (time.perf_counter() - t0) * 1e3 - plan.prep_ms)
    timings["prep_ms"] = plan.prep_ms
    base = plan.base

    if base.nt_c == 0:
        c = _compact_to_tilemat(
            base.ctrow, base.ctcol,
            np.zeros((0, base.tm, base.tn), np.float64),
            np.zeros((0, base.tm, base.tn), np.float32),
            (a.m, b.n), a.tm, b.tn)
        return SpGEMMResult(c=c, schedule=plan,
                            timings_ms={**timings, "upload_ms": 0.0,
                                        "numeric_ms": 0.0,
                                        "compact_ms": 0.0},
                            stats={"backend": "ozaki", "num_pairs": 0.0,
                                   "numblkC_candidate": 0.0,
                                   "numblkC": 0.0, "nnzC": 0.0})

    (c_h, c_m, c_l, c_cnt), t_num = ozaki_numeric(plan, device=device,
                                                  sync=sync)
    timings.update(t_num)

    t0 = time.perf_counter()
    c = ozaki_compact(plan, c_h, c_m, c_l, c_cnt, (a.m, b.n))
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3

    backend_used = f"ozaki(S={plan.sa}x{plan.sb})"
    if note:
        backend_used += f"({note})"
    stats = {
        "num_pairs": float(base.num_pairs),
        "numblkC_candidate": float(base.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": backend_used,
        "padding_ratio": base.padding_ratio(),
        "slices": float(plan.sa * plan.sb),
    }
    return SpGEMMResult(c=c, schedule=plan, timings_ms=timings, stats=stats)


def ozaki_assemble(plan: OzakiPlan, c_h, c_m, c_l, c_cnt,
                   shape: tuple[int, int]) -> np.ndarray:
    """Host epilogue: f64 = (h + m + l) * 2^(Ea_r + Eb_c - 14), applied
    with np.ldexp (exact, full f64 exponent range). Returns the per-tile
    f64 value cube (nt_c, tm, tn). (Full-cube form — production goes
    through ozaki_compact, which scales only the kept nonzeros.)"""
    base = plan.base
    v = (np.asarray(c_h, np.float64) + np.asarray(c_m, np.float64)
         + np.asarray(c_l, np.float64))
    er = plan.ea.reshape(-1, base.tm)[np.asarray(base.ctrow, np.int64)]
    ec = plan.eb.reshape(-1, base.tn)[np.asarray(base.ctcol, np.int64)]
    ex = (er[:, :, None] + ec[:, None, :] - 14).astype(np.int64)
    return np.ldexp(v, ex)


def ozaki_compact(plan: OzakiPlan, c_h, c_m, c_l, c_cnt,
                  shape: tuple[int, int]) -> TileMat:
    """Fused scale + compact: select the structural nonzeros FIRST
    (nnzC of nt_c*tm*tn positions), then add hi+lo in f64 and apply the
    2^(Ea_r + Eb_c - 14) scales only on those — at cant scale this
    avoids ~1 GB of full-cube f64 temporaries (this host backs fresh
    pages at ~90 MB/s, so the full-cube epilogue cost 20+ s)."""
    from spgemm_tpu.models.csr import INDEX_DTYPE
    from spgemm_tpu.models.tile import _build_tilemat, cdiv

    base = plan.base
    tm, tn = base.tm, base.tn
    cnt = np.asarray(c_cnt)
    occ = cnt > 0
    keep = occ.any(axis=(1, 2))
    ctrow = np.asarray(base.ctrow)[keep]
    ctcol = np.asarray(base.ctcol)[keep]
    occ = occ[keep]
    h = np.asarray(c_h)[keep]
    m_ = np.asarray(c_m)[keep]
    l_ = np.asarray(c_l)[keep]
    ntk = ctrow.size
    gm, gn = cdiv(shape[0], tm), cdiv(shape[1], tn)

    tid, rcflat = np.nonzero(occ.reshape(ntk, tm * tn))
    vals = (h.reshape(ntk, tm * tn)[tid, rcflat].astype(np.float64)
            + m_.reshape(ntk, tm * tn)[tid, rcflat]
            + l_.reshape(ntk, tm * tn)[tid, rcflat])
    r = rcflat // tn
    c = rcflat % tn
    ex = (plan.ea.reshape(-1, tm)[ctrow[tid].astype(np.int64), r]
          + plan.eb.reshape(-1, tn)[ctcol[tid].astype(np.int64), c] - 14)
    vals = np.ldexp(vals, ex)
    tile_key = ctrow[tid].astype(np.int64) * gn + ctcol[tid]
    return _build_tilemat(
        shape=shape, tm=tm, tn=tn, tile_key=tile_key,
        rc=rcflat.astype(INDEX_DTYPE), val=vals, gm=gm, gn=gn)
