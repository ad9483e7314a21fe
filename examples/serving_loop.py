#!/usr/bin/env python
"""Pattern-static serving loop: the build-once / run-many production
shape both executors exist for (the reference's REPEAT_NUM loop with
GPU-resident operands, `src/common.h:91` + step-4-only re-runs,
`src/tilespgemm-cuda.h:2649-2728`).

A sparsity pattern is fixed (a mesh, a graph, a circuit); values change
every tick (new weights, new conductances). The symbolic work — tiling,
pair scheduling or scan-plan build — happens ONCE; each tick is then
  update_values(new_a, new_b)   # host gather(+multiply) at stream bw
  run()                         # one device dispatch on resident planes
with no retiling, no symbolic, no full re-upload of anything but the
value planes.

Routes through the THREE engines to show the API is uniform:
  structured pattern  -> StripExecutor  (XLA tile-pair products, f32)
  unstructured        -> EscExecutor    (scan engine)
  exact f64           -> OzakiExecutor  (int8 slice-pair matmuls)

Usage: python examples/serving_loop.py [n] [ticks]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.models.tile import csr_to_tiles
from spgemm_tpu.ops import golden
from spgemm_tpu.ops.esc import build_esc_scan_plan, esc_scan_trim
from spgemm_tpu.ops.executor import (EscExecutor, OzakiExecutor,
                                     StripExecutor)


def banded(n: int, band: int, seed: int = 0) -> CSR:
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    return CSR.from_coo(r, c, rng.standard_normal(r.size), (n, n))


def unstructured(n: int, deg: int, seed: int = 1) -> CSR:
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n * deg)
    c = rng.integers(0, n, n * deg)
    return CSR.from_coo(r, c, rng.standard_normal(r.size), (n, n))


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    rng = np.random.default_rng(42)

    # --- structured: StripExecutor -------------------------------------
    a = banded(n, 16)
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)  # B's inner blocking must match tn
    t0 = time.perf_counter()
    ex = StripExecutor(at, bt)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[strip] plan built once: {build_ms:.1f} ms "
          f"(pairs={ex.plan.num_pairs})")
    # serving shape: A's values change every tick, B is the fixed
    # operator (StripExecutor keeps B's packed slabs resident and
    # re-uploads only A's value plane)
    for tick in range(ticks):
        vals = rng.standard_normal(a.nnz)
        a_new = CSR(a.indptr, a.indices, vals, a.shape)
        t0 = time.perf_counter()
        ex.update_values(csr_to_tiles(a_new, 16, 128))
        c_tiles = ex.run_compact()
        tick_ms = (time.perf_counter() - t0) * 1e3
        ref = golden.spgemm_scipy(a_new, a)
        got = golden.drop_explicit_zeros(c_tiles.to_csr())
        ok = got.pattern_equal(ref) and np.allclose(
            got.data, ref.data, rtol=1e-4, atol=1e-6)
        print(f"[strip] tick {tick}: {tick_ms:.1f} ms "
              f"nnzC={got.nnz} {'OK' if ok else 'MISMATCH'}")

    # --- unstructured: EscExecutor -------------------------------------
    u = unstructured(n, 8)
    t0 = time.perf_counter()
    plan = build_esc_scan_plan(u, u, keep_sources=True)
    ex2 = EscExecutor(plan)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[esc]   plan built once: {build_ms:.1f} ms "
          f"(F={plan.num_products})")
    for tick in range(ticks):
        vals = rng.standard_normal(u.nnz)
        t0 = time.perf_counter()
        ex2.update_values(vals, vals)
        c = ex2.run_csr()
        tick_ms = (time.perf_counter() - t0) * 1e3
        ref = golden.spgemm_scipy(
            CSR(u.indptr, u.indices, vals, u.shape),
            CSR(u.indptr, u.indices, vals, u.shape))
        got = golden.drop_explicit_zeros(c)
        ok = got.pattern_equal(ref) and np.allclose(
            got.data, ref.data, rtol=1e-4, atol=1e-6)
        print(f"[esc]   tick {tick}: {tick_ms:.1f} ms "
              f"nnzC={got.nnz} {'OK' if ok else 'MISMATCH'}")

    # --- exact f64: OzakiExecutor --------------------------------------
    from spgemm_tpu.ops.ozaki import build_ozaki_plan, ozaki_compact

    af = banded(n, 8, seed=7)
    atf = csr_to_tiles(af, 16, 128)
    btf = csr_to_tiles(af, 128, 128)
    t0 = time.perf_counter()
    oplan = build_ozaki_plan(atf, btf)
    ex3 = OzakiExecutor(oplan, atf, btf)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[ozaki] plan built once: {build_ms:.1f} ms "
          f"(S={oplan.sa}x{oplan.sb})")
    for tick in range(ticks):
        vals = rng.standard_normal(af.nnz)
        a_new = CSR(af.indptr, af.indices, vals, af.shape)
        t0 = time.perf_counter()
        ex3.update_values(csr_to_tiles(a_new, 16, 128),
                          csr_to_tiles(a_new, 128, 128))
        out = ex3.run()
        c_tiles = ozaki_compact(oplan, *out, af.shape)
        tick_ms = (time.perf_counter() - t0) * 1e3
        ref = golden.spgemm_scipy(a_new, a_new)
        got = golden.drop_explicit_zeros(c_tiles.to_csr())
        # f64-eps-class relative to the result scale (tiny entries carry
        # the engine's documented blocked-accuracy bound)
        scale = np.abs(ref.data).max() if ref.nnz else 1.0
        ok = got.pattern_equal(ref) and np.allclose(
            got.data, ref.data, rtol=1e-9, atol=1e-13 * scale)
        print(f"[ozaki] tick {tick}: {tick_ms:.1f} ms "
              f"nnzC={got.nnz} {'OK' if ok else 'MISMATCH'} (f64)")


if __name__ == "__main__":
    main()
