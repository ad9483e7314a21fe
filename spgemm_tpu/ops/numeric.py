"""Numeric phase: batched tile-pair products (jitted XLA path).

Replaces the reference's steps 2/3 (per-tile symbolic mask-OR,
`src/tilespgemm-cuda.h:394-1271`) and step 4 (numeric accumulation with
sparse/dense accumulators and 5 size-binned kernels on 5 streams,
`src/tilespgemm-cuda.h:1273-2218,2649-2728`).

Reformulation: every matched tile pair is one small dense matmul. The
pipeline gathers dense A/B tiles by pair index, runs a batched (chunked)
einsum, and scatter-adds into per-C-tile dense
accumulators — values and structural counts in the same pass:

    Cval[seg]  += Aden[pa] @ Bden[pb]          (numeric)
    Ccnt[seg]  += Aocc[pa] @ Bocc[pb]          (structural, step-2/3 analog)

Structural occupancy is an *integer-valued* matmul (counts of contributing
products), so C's pattern is exact even when numeric sums cancel or stored
values are zero — this replaces the bitmask-OR + popcount symbolic step
with a dense matmul. There is no sparse
accumulator, no binary search, no atomics: each C tile's accumulator is
private to its segment (the reference fork's shared-scratch race,
SURVEY.md section 2.3, is impossible by construction).

All shapes are static: pair lists are padded to a chunk multiple, padding
pairs target a dummy trailing segment that is sliced off. fp32 is the
default compute type (exact for the reference's synthetic integer values);
fp64 is supported end-to-end for accuracy-critical runs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MASK_BITS = 32
DEFAULT_CHUNK = 32768  # pairs per scan step of pair_accumulate


def unpack_mask(mask: jax.Array, tn: int) -> jax.Array:
    """(nt, tm, mw) uint32 bitmask words -> (nt, tm, tn) float32 occupancy.

    Shift-and-mask bit unpack; the device-side inverse of
    TileMat.occ().
    """
    nt, tm, mw = mask.shape
    shifts = jnp.arange(MASK_BITS, dtype=jnp.uint32)
    bits = (mask[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(nt, tm, mw * MASK_BITS)[..., :tn].astype(jnp.float32)


def pack_mask(occ: jax.Array, tn: int) -> jax.Array:
    """(nt, tm, tn) bool/int occupancy -> (nt, tm, mw) uint32 mask words."""
    nt, tm, _ = occ.shape
    mw = -(-tn // MASK_BITS)
    pad = mw * MASK_BITS - tn
    occ_p = jnp.pad(occ.astype(jnp.uint32), ((0, 0), (0, 0), (0, pad)))
    occ_p = occ_p.reshape(nt, tm, mw, MASK_BITS)
    shifts = jnp.arange(MASK_BITS, dtype=jnp.uint32)
    return jnp.sum(occ_p << shifts, axis=-1, dtype=jnp.uint32)


def _pair_matmuls(a_val, a_occ, b_val, b_occ, acc_dtype):
    """Batched per-pair products: values and structural counts.

    Precision.HIGHEST: the default precision may multiply f32 inputs in
    TF32 or bf16, which keeps about three decimal digits — unacceptable
    for a numerics library. HIGHEST asks for full f32.
    """
    prod = jax.lax.dot_general(
        a_val,
        b_val,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=acc_dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    cnt = jax.lax.dot_general(
        a_occ,
        b_occ,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return prod, cnt


@functools.partial(
    jax.jit, static_argnames=("num_segments", "chunk", "acc_dtype")
)
def pair_accumulate(
    a_val: jax.Array,   # (ntA, tm, tk) dense A tiles
    a_occ: jax.Array,   # (ntA, tm, tk) float32 0/1 occupancy
    b_val: jax.Array,   # (ntB, tk, tn)
    b_occ: jax.Array,   # (ntB, tk, tn) float32 0/1
    pa: jax.Array,      # (P,) int32, padded; padding -> segment num_segments
    pb: jax.Array,      # (P,) int32
    seg: jax.Array,     # (P,) int32, sorted ascending
    *,
    num_segments: int,
    chunk: int = DEFAULT_CHUNK,
    acc_dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array]:
    """Returns (c_val, c_cnt): (num_segments, tm, tn) accumulators.

    Chunked with lax.scan so gathered pair blocks never exceed
    chunk * tile_bytes of HBM, regardless of pair-list length.
    """
    tm = a_val.shape[1]
    tn = b_val.shape[2]
    p = pa.shape[0]
    c_val = jnp.zeros((num_segments + 1, tm, tn), dtype=acc_dtype)
    c_cnt = jnp.zeros((num_segments + 1, tm, tn), dtype=jnp.float32)

    if p == 0:
        return c_val[:-1], c_cnt[:-1]

    if p <= chunk:
        prod, cnt = _pair_matmuls(
            a_val[pa], a_occ[pa], b_val[pb], b_occ[pb], acc_dtype
        )
        c_val = c_val.at[seg].add(prod, indices_are_sorted=True)
        c_cnt = c_cnt.at[seg].add(cnt, indices_are_sorted=True)
        return c_val[:-1], c_cnt[:-1]

    assert p % chunk == 0, "caller pads pair arrays to a chunk multiple"
    n_chunks = p // chunk
    pa_c = pa.reshape(n_chunks, chunk)
    pb_c = pb.reshape(n_chunks, chunk)
    seg_c = seg.reshape(n_chunks, chunk)

    def body(carry, xs):
        cv, cc = carry
        pac, pbc, segc = xs
        prod, cnt = _pair_matmuls(
            a_val[pac], a_occ[pac], b_val[pbc], b_occ[pbc], acc_dtype
        )
        cv = cv.at[segc].add(prod, indices_are_sorted=True)
        cc = cc.at[segc].add(cnt, indices_are_sorted=True)
        return (cv, cc), None

    (c_val, c_cnt), _ = jax.lax.scan(
        body, (c_val, c_cnt), (pa_c, pb_c, seg_c)
    )
    return c_val[:-1], c_cnt[:-1]


def pad_pairs(
    pa: np.ndarray, pb: np.ndarray, seg: np.ndarray, num_segments: int,
    chunk: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad pair arrays to a chunk multiple; padding pairs point at tile 0
    and the dummy segment `num_segments` (dropped by pair_accumulate)."""
    p = pa.size
    if p <= chunk or p % chunk == 0:
        return pa, pb, seg  # single-shot path / already aligned
    padn = -(-p // chunk) * chunk - p
    pad32 = lambda x, v: np.concatenate([x, np.full(padn, v, dtype=np.int32)])
    return pad32(pa, 0), pad32(pb, 0), pad32(seg, num_segments)


def pair_slots(
    pa: np.ndarray, pb: np.ndarray, seg: np.ndarray, pair_ptr: np.ndarray,
    nt_a: int, nt_b: int, max_block: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Pair lists (grouped by C tile) -> slot form: (blocks, maxp, block)
    int32 A and B tile of the j-th pair of every C tile, maxp the most
    pairs of any C tile. C tiles are split into equal blocks of at most
    max_block (the last one padded). Empty slots hold nt_a / nt_b, one
    past the last tile, which slot_accumulate reads as a zero tile."""
    nt_c = pair_ptr.size - 1
    maxp = int(np.diff(pair_ptr).max()) if nt_c else 0
    blocks = max(1, -(-nt_c // max_block))
    block = -(-nt_c // blocks)
    sa = np.full((maxp, blocks * block), nt_a, dtype=np.int32)
    sb = np.full((maxp, blocks * block), nt_b, dtype=np.int32)
    rank = np.arange(pa.size) - pair_ptr[seg]
    sa[rank, seg] = pa
    sb[rank, seg] = pb
    split = lambda x: x.reshape(maxp, blocks, block).transpose(1, 0, 2)
    return split(sa), split(sb)


@functools.partial(jax.jit, static_argnames=("num_segments",))
def slot_accumulate(
    a_val: jax.Array,   # (ntA, tm, tk) dense A tiles
    a_occ: jax.Array,   # (ntA, tm, tk) 0/1 occupancy
    b_val: jax.Array,   # (ntB, tk, tn)
    b_occ: jax.Array,   # (ntB, tk, tn) 0/1
    sa: jax.Array,      # (blocks, maxp, block) int32 from pair_slots
    sb: jax.Array,      # (blocks, maxp, block) int32
    *,
    num_segments: int,
) -> tuple[jax.Array, jax.Array]:
    """Returns (c_val, c_cnt): (num_segments, tm, tn) f32 accumulators.

    Scatter-free form of pair_accumulate: each C tile sums its own pair
    slots, one batched product per slot layer, and is written once. On
    the H100, XLA's scatter of pair products into (64, 128) C tiles
    fails to launch (out of memory) beyond a few thousand pairs; this
    form has no scatter. Blocks of C tiles run in turn (lax.map), so the
    tiles one layer gathers never exceed one block."""
    tm, tn = a_val.shape[1], b_val.shape[2]
    blocks, maxp, block = sa.shape
    take = functools.partial(jnp.take, axis=0, mode="fill", fill_value=0)

    def run_block(slots):
        sa_b, sb_b = slots

        def layer(j, carry):
            cv, cc = carry
            prod, cnt = _pair_matmuls(
                take(a_val, sa_b[j]), take(a_occ, sa_b[j]),
                take(b_val, sb_b[j]), take(b_occ, sb_b[j]), jnp.float32)
            return cv + prod, cc + cnt

        zero = jnp.zeros((block, tm, tn), jnp.float32)
        return jax.lax.fori_loop(0, maxp, layer, (zero, zero))

    if blocks == 1:
        c_val, c_cnt = run_block((sa[0], sb[0]))
    else:
        c_val, c_cnt = jax.lax.map(run_block, (sa, sb))
        c_val = c_val.reshape(blocks * block, tm, tn)
        c_cnt = c_cnt.reshape(blocks * block, tm, tn)
    return c_val[:num_segments], c_cnt[:num_segments]
