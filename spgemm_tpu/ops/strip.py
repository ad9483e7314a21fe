"""The structured route of the numeric phase: packed tiles, the pair
schedule, XLA pair products, a bit-packed occupancy download.

The counterpart of the reference's step-4 kernels
(`src/tilespgemm-cuda.h:1273-2218`). Host side: A and B are packed once
into dense (nt, tm, tn) f32 value tiles and bf16 0/1 occupancy tiles
(native packer), and the pair schedule (`ops/symbolic.py:PairSchedule`)
lists every (A tile, B tile) pair grouped by candidate C tile. Device
side: `ops/numeric.py:slot_accumulate` gives each candidate C tile its
list of pair slots; each slot layer gathers the tiles of one pair per
C tile and multiplies them in one batched matmul (`Precision.HIGHEST`:
IEEE f32, not TF32), and each C tile sums its own products and is
written once, with no scatter. The 0/1 occupancy product counts
structural contributions exactly. The counts travel back as bitmask
words, 1/32 of their f32 size.

A hand-written Triton kernel for this phase (one program per C tile,
the sum kept in registers) was measured against this XLA form on the
H100 and removed: it won the numeric phase but tied end to end
(PERF.md, ROADMAP.md "Removed in the port").
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from spgemm_tpu.models.tile import TileMat
from spgemm_tpu.ops.numeric import pair_slots, slot_accumulate
from spgemm_tpu.ops.symbolic import PairSchedule, build_pair_schedule


# Bytes of HBM one block of C tiles may gather per slot layer (A and B
# tiles in f32 + bf16, products and sums in f32).
SLOT_BLOCK_BYTES = 2 << 30


def c_tile_block(tm: int, tk: int, tn: int) -> int:
    """Most C tiles in one slot_accumulate block for these tile
    shapes."""
    per_tile = (tm * tk + tk * tn) * 6 + tm * tn * 16
    return max(1, SLOT_BLOCK_BYTES // per_tile)


@jax.jit
def pack_occupancy(c_cnt):
    """(nt, tm, tn) structural counts -> (nt, tm, tn/32) int32 bitmask
    words, LSB first: the occupancy download shrinks 32x."""
    tm, tn = c_cnt.shape[1], c_cnt.shape[2]
    occ = (c_cnt > 0).reshape(-1, tm, tn // 32, 32).astype(jnp.int32)
    shifts = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, 32), 3)
    return jnp.sum(occ << shifts, axis=3, dtype=jnp.int32)


def unpack_occupancy(words: np.ndarray, tn: int) -> np.ndarray:
    """Host inverse of pack_occupancy: (nt, tm, tn) bool (the words are
    LSB-first int32, i.e. little-endian bytes)."""
    by = np.ascontiguousarray(words).view(np.uint8)
    bits = np.unpackbits(by, axis=-1, bitorder="little")
    return bits.reshape(words.shape[0], words.shape[1], -1)[
        :, :, :tn].astype(bool)


def download_tiles(c_val, c_cnt) -> tuple[np.ndarray, np.ndarray]:
    """Device (values, counts) -> host (values, 0/1 f32 occupancy); the
    counts travel as packed bitmask words when tn allows it."""
    tn = c_val.shape[2]
    if tn % 32 == 0:
        occ = unpack_occupancy(np.asarray(pack_occupancy(c_cnt)), tn)
    else:
        occ = np.asarray(c_cnt) > 0
    return np.asarray(c_val), occ.astype(np.float32)


@dataclasses.dataclass
class StripPlan:
    """Everything the numeric phase needs: the pair schedule (the
    symbolic phase) and the packed dense tiles of A and B (f32 values,
    bf16 0/1 occupancy — one-time format prep)."""

    sched: PairSchedule
    a_val: np.ndarray      # (ntA, tm, tk) f32
    a_occ: np.ndarray      # (ntA, tm, tk) bf16
    b_val: np.ndarray      # (ntB, tk, tn) f32
    b_occ: np.ndarray      # (ntB, tk, tn) bf16
    prep_ms: float = 0.0
    symbolic_ms: float = 0.0

    @property
    def ctrow(self):
        return self.sched.ctrow

    @property
    def ctcol(self):
        return self.sched.ctcol

    @property
    def nt_c(self) -> int:
        return self.sched.nt_c

    @property
    def num_pairs(self) -> int:
        return self.sched.num_pairs

    def device_args(self):
        """Host arrays run_strip takes: the packed tiles and the pair
        slots of every C tile (numeric.pair_slots)."""
        s = self.sched
        (nt_a, tm, tk), (nt_b, _, tn) = self.a_val.shape, self.b_val.shape
        sa, sb = pair_slots(s.pa, s.pb, s.seg, s.pair_ptr, nt_a, nt_b,
                            c_tile_block(tm, tk, tn))
        return (self.a_val, self.a_occ, self.b_val, self.b_occ, sa, sb)


def pack_tiles(t: TileMat) -> tuple[np.ndarray, np.ndarray]:
    """(nt, tm, tn) f32 values and bf16 occupancy of a TileMat (native
    packer when available)."""
    from spgemm_tpu.utils.native import pack_tiles_native

    packed = pack_tiles_native(t)
    if packed is not None:
        return packed
    return t.dense(np.float32), t.occ().astype(jnp.bfloat16)


def build_strip_plan(a: TileMat, b: TileMat) -> StripPlan:
    t0 = time.perf_counter()
    a_val, a_occ = pack_tiles(a)
    b_val, b_occ = (a_val, a_occ) if b is a else pack_tiles(b)
    prep_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sched = build_pair_schedule(a, b)
    return StripPlan(sched=sched, a_val=a_val, a_occ=a_occ, b_val=b_val,
                     b_occ=b_occ, prep_ms=prep_ms,
                     symbolic_ms=(time.perf_counter() - t0) * 1e3)


def run_strip(dev_args, nt_c: int):
    """The numeric phase on device-resident plan arrays: (c_val, c_cnt),
    each (nt_c, tm, tn) f32 in candidate order."""
    return slot_accumulate(*dev_args, num_segments=nt_c)


def strip_numeric(plan: StripPlan) -> tuple[np.ndarray, np.ndarray]:
    """Upload, run and download: host (c_val, c_occ), each (nt_c, tm, tn)
    in candidate order."""
    c_val, c_cnt = run_strip(jax.device_put(plan.device_args()), plan.nt_c)
    return download_tiles(c_val, c_cnt)
