#!/usr/bin/env python
"""Algebraic-multigrid Galerkin coarsening through the framework: the
triple product A_coarse = R A P (R = P^T) — the classic production
SpGEMM workload (TileSpGEMM paper PPoPP'22 motivates SpGEMM with AMG
setup; the reference benchmarks the same C = A*B kernel this chains).

Builds a 2D 5-point Poisson operator, an aggregation-based tentative
prolongator P (every 2x2 node block -> one coarse aggregate), and
coarsens twice:  A_{l+1} = P_l^T A_l P_l  — each level is two
spgemm_csr calls (A@P, then P^T@(AP)), value-checked against scipy.

The coarse operators stay symmetric M-matrices, so the check is exact
in pattern and tight in values. Run on the GPU or the CPU:
  python examples/amg_galerkin.py [grid_n] [levels]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from spgemm_tpu.models.csr import CSR
from spgemm_tpu.ops import golden
from spgemm_tpu.ops.spgemm import spgemm_csr


def poisson2d(g: int) -> CSR:
    """5-point Laplacian on a g x g grid (n = g^2)."""
    n = g * g
    idx = np.arange(n)
    i, j = idx // g, idx % g
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = ((i + di >= 0) & (i + di < g) & (j + dj >= 0) & (j + dj < g))
        rows.append(idx[ok])
        cols.append((i[ok] + di) * g + (j[ok] + dj))
        vals.append(np.full(int(ok.sum()), -1.0))
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n, n))


def aggregate_p(g: int) -> CSR:
    """Tentative prolongator: 2x2 node aggregates, piecewise-constant."""
    n = g * g
    gc = (g + 1) // 2
    idx = np.arange(n)
    i, j = idx // g, idx % g
    agg = (i // 2) * gc + (j // 2)
    return CSR.from_coo(idx, agg, np.ones(n), (n, gc * gc))


def main() -> None:
    g = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    a = poisson2d(g)
    for lvl in range(levels):
        p = aggregate_p(g)
        t0 = time.perf_counter()
        ap, r1 = spgemm_csr(a, p)                     # A @ P
        rap, r2 = spgemm_csr(p.transpose(), ap)      # P^T @ (A P)
        ms = (time.perf_counter() - t0) * 1e3
        ref = golden.spgemm_scipy(p.transpose(), golden.spgemm_scipy(a, p))
        got = golden.drop_explicit_zeros(rap)
        ok = (got.pattern_equal(golden.drop_explicit_zeros(ref))
              and np.allclose(got.data,
                              golden.drop_explicit_zeros(ref).data,
                              rtol=1e-5, atol=1e-8))
        print(f"level {lvl}: {a.m}x{a.n} (nnz {a.nnz}) -> "
              f"{rap.m}x{rap.n} (nnz {got.nnz})  {ms:.1f} ms  "
              f"backends=({r1.stats.get('backend')}, "
              f"{r2.stats.get('backend')})  "
              f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)
        a = got
        g = (g + 1) // 2
    print("galerkin coarsening verified at every level")


if __name__ == "__main__":
    main()
