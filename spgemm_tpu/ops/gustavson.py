"""Gather-free Gustavson-by-k SpGEMM numeric path (plain XLA).

An alternative to the pair-gather formulation (ops/numeric.py): instead
of gathering (A, B) tiles per matched pair, group by the inner tile
dimension k (Gustavson's ordering):

    C += A[:, k] (outer) B[k, :]        for each k

* A tiles of column k are contiguous in the CSC-of-tiles view;
* B tiles of row k are contiguous in row-major storage;
* stacking A's k-group vertically (maxA*tm, tk) and B's k-group
  horizontally (tk, maxB*tn) makes ALL pairwise tile products of one k a
  single dense matmul -> one batched dot_general over all k;
* every A and B tile is touched exactly once (speed of light on input
  traffic); the only irregular op left is the scatter-add of pair
  products into C tiles.

Values and structural counts ride one fused scatter (concatenated along
the segment axis), halving scatter launches. k-groups are zero-padded to
(maxA, maxB); matrices where padding explodes (max >> mean tile counts
per k) should use the pair backend instead — `padding_ratio()` reports
this.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from spgemm_tpu.models.csr import INDEX_DTYPE
from spgemm_tpu.models.tile import TileMat


@dataclasses.dataclass
class GustavsonPlan:
    """Host-side plan: padded k-group slabs + scatter segment map."""

    gk: int              # inner grid dimension (A tile-cols == B tile-rows)
    max_a: int           # max A tiles in any column k
    max_b: int           # max B tiles in any row k
    tm: int
    tk: int
    tn: int
    nt_c: int            # candidate C tiles
    ctrow: np.ndarray    # (nt_c,)
    ctcol: np.ndarray
    num_pairs: int
    a3_val: np.ndarray   # (gk, max_a*tm, tk) stacked A slabs (None if
    a3_occ: np.ndarray   #   built with a_slabs=False — strip path)
    b3_val: np.ndarray   # (gk, tk, max_b*tn) stacked B slabs
    b3_occ: np.ndarray
    seg: np.ndarray      # (gk*max_a*max_b,) int32; padding -> nt_c
    dtype: np.dtype = np.float32
    prep_ms: float = 0.0       # slab layout build (conversion-like, one-time)
    symbolic_ms: float = 0.0   # pair expansion + C-tile dictionary (per-run)

    def padding_ratio(self) -> float:
        """Padded pair slots / real pairs (1.0 = no waste)."""
        return (self.gk * self.max_a * self.max_b) / max(1, self.num_pairs)


def build_gustavson_plan(a: TileMat, b: TileMat, dtype=np.float32,
                         a_slabs: bool = True,
                         values: bool = True) -> GustavsonPlan:
    """Build the Gustavson k-group plan. With a_slabs=False the stacked A
    slabs are skipped (the strip route packs its own tiles).
    With values=False only the occupancy slabs are packed (the Ozaki f64
    engine supplies its own int8 slice planes, ops/ozaki.py — and casting
    wide-exponent f64 values to f32 would warn/overflow pointlessly)."""
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if a.tn != b.tm:
        raise ValueError(
            f"inner tile dims must match: A is {a.tm}x{a.tn}, B is {b.tm}x{b.tn}"
        )
    gk = a.gn
    tm, tk, tn = a.tm, a.tn, b.tn
    c_gn = b.gn

    t_prep = time.perf_counter()
    acsc_ptr, acsc_perm = a.csc_view()
    bptr = b.tptr.astype(np.int64)
    cnt_a = np.diff(acsc_ptr).astype(np.int64)
    cnt_b = np.diff(bptr)
    max_a = max(1, int(cnt_a.max()) if a.nt else 1)
    max_b = max(1, int(cnt_b.max()) if b.nt else 1)

    # --- slabs (vectorized fills) ---
    bd = b.dense(dtype) if values else None
    bo = b.occ().astype(dtype)

    if a_slabs:
        ad = a.dense(dtype) if values else None
        ao = a.occ().astype(dtype)
        # A slot for the r-th tile of column k (csc order): k*max_a + rank
        rank_a = np.arange(a.nt, dtype=np.int64) - np.repeat(
            acsc_ptr[:-1].astype(np.int64), cnt_a
        )
        ka = np.repeat(np.arange(gk, dtype=np.int64), cnt_a)
        slot_a = ka * max_a + rank_a
        a3_occ = np.zeros((gk * max_a, tm, tk), dtype=dtype)
        a3_occ[slot_a] = ao[acsc_perm]
        a3_occ = a3_occ.reshape(gk, max_a * tm, tk)
        if values:
            a3_val = np.zeros((gk * max_a, tm, tk), dtype=dtype)
            a3_val[slot_a] = ad[acsc_perm]
            # vertical stack: (gk, max_a*tm, tk)
            a3_val = a3_val.reshape(gk, max_a * tm, tk)
        else:
            a3_val = None
    else:
        a3_val = a3_occ = None

    rank_b = np.arange(b.nt, dtype=np.int64) - np.repeat(bptr[:-1], cnt_b)
    kb = np.repeat(np.arange(gk, dtype=np.int64), cnt_b)
    slot_b = kb * max_b + rank_b
    b3_occ = np.zeros((gk * max_b, tk, tn), dtype=dtype)
    b3_occ[slot_b] = bo
    # horizontal stack: (gk, tk, max_b*tn)
    b3_occ = b3_occ.reshape(gk, max_b, tk, tn).transpose(0, 2, 1, 3).reshape(
        gk, tk, max_b * tn
    )
    if values:
        b3_val = np.zeros((gk * max_b, tk, tn), dtype=dtype)
        b3_val[slot_b] = bd
        b3_val = b3_val.reshape(gk, max_b, tk, tn).transpose(
            0, 2, 1, 3).reshape(gk, tk, max_b * tn)
    else:
        b3_val = None

    prep_ms = (time.perf_counter() - t_prep) * 1e3

    # --- pair expansion + C tile dictionary (the symbolic step) ---
    t_sym = time.perf_counter()
    pairs_per_k = cnt_a * cnt_b
    total = int(pairs_per_k.sum())
    if total == 0:
        return GustavsonPlan(
            gk=gk, max_a=max_a, max_b=max_b, tm=tm, tk=tk, tn=tn,
            nt_c=0,
            ctrow=np.zeros(0, INDEX_DTYPE), ctcol=np.zeros(0, INDEX_DTYPE),
            num_pairs=0,
            a3_val=a3_val, a3_occ=a3_occ, b3_val=b3_val, b3_occ=b3_occ,
            seg=np.zeros(gk * max_a * max_b, INDEX_DTYPE),
            dtype=np.dtype(dtype),
            prep_ms=prep_ms,
        )
    kk = np.repeat(np.arange(gk, dtype=np.int64), pairs_per_k)
    off = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(pairs_per_k) - pairs_per_k, pairs_per_k
    )
    x = off // cnt_b[kk]
    y = off % cnt_b[kk]
    ia = acsc_perm[acsc_ptr[kk] + x]
    ib = bptr[kk] + y
    ckey = a.trow[ia].astype(np.int64) * c_gn + b.tcol[ib]
    ukey = np.unique(ckey)
    nt_c = ukey.size
    seg_of_pair = np.searchsorted(ukey, ckey).astype(INDEX_DTYPE)

    seg = np.full(gk * max_a * max_b, nt_c, dtype=INDEX_DTYPE)
    seg[(kk * max_a + x) * max_b + y] = seg_of_pair

    return GustavsonPlan(
        gk=gk, max_a=max_a, max_b=max_b, tm=tm, tk=tk, tn=tn,
        nt_c=nt_c,
        ctrow=(ukey // c_gn).astype(INDEX_DTYPE),
        ctcol=(ukey % c_gn).astype(INDEX_DTYPE),
        num_pairs=total,
        a3_val=a3_val, a3_occ=a3_occ, b3_val=b3_val, b3_occ=b3_occ,
        seg=seg,
        dtype=np.dtype(dtype),
        prep_ms=prep_ms,
        symbolic_ms=(time.perf_counter() - t_sym) * 1e3,
    )


@functools.partial(
    jax.jit,
    static_argnames=("gk", "max_a", "max_b", "tm", "tn", "nt_c", "acc_dtype"),
)
def gustavson_numeric(
    a3_val: jax.Array,   # (gk, max_a*tm, tk)
    a3_occ: jax.Array,
    b3_val: jax.Array,   # (gk, tk, max_b*tn)
    b3_occ: jax.Array,
    seg: jax.Array,      # (gk*max_a*max_b,)
    *,
    gk: int,
    max_a: int,
    max_b: int,
    tm: int,
    tn: int,
    nt_c: int,
    acc_dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array]:
    """Batched slab matmuls + one fused scatter. Returns
    (c_val, c_cnt): (nt_c, tm, tn) each."""
    return gustavson_core(
        a3_val, a3_occ, b3_val, b3_occ, seg,
        gk=gk, max_a=max_a, max_b=max_b, tm=tm, tn=tn, nt_c=nt_c,
        acc_dtype=acc_dtype,
    )


def gustavson_core(
    a3_val, a3_occ, b3_val, b3_occ, seg,
    *, gk, max_a, max_b, tm, tn, nt_c, acc_dtype=jnp.float32,
):
    """Traceable core (also used inside shard_map by parallel/dist.py)."""

    def slab_mm(a3, b3):
        return jax.lax.dot_general(
            a3, b3,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=acc_dtype,
            precision=jax.lax.Precision.HIGHEST,
        )

    def to_pairs(p):
        # (gk, max_a*tm, max_b*tn) -> (gk*max_a*max_b, tm, tn)
        return (
            p.reshape(gk, max_a, tm, max_b, tn)
            .transpose(0, 1, 3, 2, 4)
            .reshape(-1, tm, tn)
        )

    pv = to_pairs(slab_mm(a3_val, b3_val))
    po = to_pairs(slab_mm(a3_occ, b3_occ))

    # one scatter for values and counts: counts live at seg + (nt_c+1)
    stride = nt_c + 1
    seg2 = jnp.concatenate([seg, seg + stride])
    c = jnp.zeros((2 * stride, tm, tn), dtype=acc_dtype)
    c = c.at[seg2].add(jnp.concatenate([pv, po]))
    return c[:nt_c], c[stride : stride + nt_c]
