#!/usr/bin/env python
"""Side-by-side timings of the alternative paths the router chooses
between, on the card, at the smoke run's sizes — the evidence behind
each "kept / removed" decision in PERF.md.

  structured f32 (cant-like A^2 and A*A^T): the strip route (packed
      tiles, XLA pair products) vs the XLA slab ("gustavson"), end to
      end through spgemm_csr and numeric-only (resident operands,
      chained);
  f64 (cant-like, Gaussian values): native x64 slab vs the Ozaki XLA
      slab vs the double-double scan, end to end, each value-checked;
  ESC scan (R-MAT 65,536, edge factor 16): the plain-jnp scan's time and
      achieved bytes/s, and the fusion count of its compiled HLO;
  SpMM (cant-like x X(62,451, 128), R-MAT x X through spmm_gather):
      time and achieved bytes/s.

End-to-end pairs alternate their order (a, b, b, a, ...). Every number
is printed with the card's name and power limit.

Usage: python tools/compare_paths.py [--pairs 5] [--only strip,f64,esc,spmm]
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H100_BYTES_PER_S = 3.35e12


def gbs(nbytes, ms) -> str:
    rate = nbytes / (ms * 1e-3)
    return (f"{rate / 1e9:.1f} GB/s ({100 * rate / H100_BYTES_PER_S:.1f}% "
            "of 3.35 TB/s)")


def med(xs):
    return float(np.median(np.asarray(xs, np.float64)))


def e2e(fn, pairs, names):
    """Alternating wall times of two callables; returns {name: [ms]}."""
    out = {n: [] for n in names}
    for f in fn.values():
        f()  # compile both first
    for i in range(pairs):
        order = names if i % 2 == 0 else names[::-1]
        for n in order:
            t0 = time.perf_counter()
            fn[n]()
            out[n].append((time.perf_counter() - t0) * 1e3)
    return out


def structured(pairs):
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops.executor import StripExecutor
    from spgemm_tpu.ops.gustavson import (build_gustavson_plan,
                                          gustavson_numeric)
    from spgemm_tpu.ops.spgemm import spgemm_csr
    from spgemm_tpu.utils.generators import cantlike
    from spgemm_tpu.utils.timing import chained_device_ms

    import jax
    import jax.numpy as jnp

    a0 = cantlike()
    a = CSR(a0.indptr, a0.indices,
            np.random.default_rng(1).standard_normal(a0.nnz), a0.shape)
    for cfg, aat in (("A2", False), ("AAT", True)):
        fns = {be: (lambda be=be: spgemm_csr(a, aat=aat, backend=be))
               for be in ("strip", "gustavson")}
        t = e2e(fns, pairs, ["strip", "gustavson"])
        _, rs = spgemm_csr(a, aat=aat, backend="strip")
        _, rg = spgemm_csr(a, aat=aat, backend="gustavson")
        for be, r in (("strip", rs), ("gustavson", rg)):
            ph = {k: round(v, 2) for k, v in r.timings_ms.items()}
            print(f"{cfg} {be}: e2e median {med(t[be]):.1f} ms "
                  f"runs={[round(x, 1) for x in t[be]]} phases={ph} "
                  f"backend={r.stats['backend']}", flush=True)
        at = csr_to_tiles(a, 16, 128)
        bt = (csr_to_tiles(a.transpose(), 128, 128) if aat
              else csr_to_tiles(a, 128, 128))
        ks = StripExecutor(at, bt).time_numeric(loop=20, repeats=3)
        plan = build_gustavson_plan(at, bt)
        arrs = jax.device_put((plan.a3_val, plan.a3_occ, plan.b3_val,
                               plan.b3_occ, plan.seg))
        kw = dict(gk=plan.gk, max_a=plan.max_a, max_b=plan.max_b,
                  tm=plan.tm, tn=plan.tn, nt_c=plan.nt_c)

        @jax.jit
        def chain(av, *rest):
            def body(i, acc):
                cv, _ = gustavson_numeric(av + acc * 1e-30, *rest, **kw)
                return acc + jnp.sum(cv)
            return jax.lax.fori_loop(0, 20, body, jnp.float32(0))

        gs = chained_device_ms(chain, *arrs, repeats=3, loop=20)
        print(f"{cfg} numeric only (chained x20): strip {ks:.3f} ms, "
              f"xla slab {gs:.3f} ms", flush=True)
        del arrs, plan


def f64(pairs):
    import jax.numpy as jnp

    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.ops import golden
    from spgemm_tpu.ops.spgemm import spgemm_csr
    from spgemm_tpu.utils.generators import cantlike

    a0 = cantlike()
    a = CSR(a0.indptr, a0.indices,
            np.random.default_rng(3).standard_normal(a0.nnz), a0.shape)
    ref = golden.spgemm_scipy(a, a)
    routes = {"native-x64": {"backend": "auto"},
              "ozaki": {"backend": "ozaki"},
              "dd-scan": {"backend": "esc"}}
    for name, kw in routes.items():
        runs = []
        for _ in range(pairs):
            t0 = time.perf_counter()
            c, res = spgemm_csr(a, compute_dtype=jnp.float64, **kw)
            runs.append((time.perf_counter() - t0) * 1e3)
        got = golden.drop_explicit_zeros(c)
        ok = got.pattern_equal(golden.drop_explicit_zeros(ref))
        err = float(np.abs(got.data - golden.drop_explicit_zeros(ref).data
                           ).max() / np.abs(ref.data).max()) if ok else -1
        ph = {k: round(v, 2) for k, v in res.timings_ms.items()}
        print(f"f64 {name}: e2e median {med(runs[1:] or runs):.1f} ms "
              f"runs={[round(x, 1) for x in runs]} (first includes "
              f"compile) phases={ph} backend={res.stats['backend']} "
              f"pattern_ok={ok} max_err/max|c|={err:.3e}", flush=True)


def esc():
    import jax

    from spgemm_tpu.ops.esc import (build_esc_scan_plan, choose_group_rows,
                                    esc_scan_reduce)
    from spgemm_tpu.ops.executor import EscExecutor
    from spgemm_tpu.utils.generators import rmat

    g = rmat(np.random.default_rng(0), 65536, 16)
    plan = build_esc_scan_plan(g, g, group_rows=choose_group_rows(g, g))
    ex = EscExecutor(plan)
    ms = ex.time_numeric(loop=20, repeats=3)
    r = plan.qv.shape[0]
    nbytes = r * 128 * (4 + 2) + (r // plan.group_rows) * 128 * 4
    print(f"esc scan rmat65536: R={r} G={plan.group_rows} "
          f"passes={plan.passes} products={plan.num_products} "
          f"{ms:.3f} ms, {gbs(nbytes, ms)}", flush=True)
    hlo = jax.jit(esc_scan_reduce, static_argnames=(
        "passes", "group_rows")).lower(
            ex._vals[0], ex._meta, passes=plan.passes,
            group_rows=plan.group_rows).compile().as_text()
    entry = hlo[hlo.index("ENTRY"):]
    entry = entry[: entry.index("\n}")]
    ops = [ln.strip() for ln in entry.splitlines()[1:]
           if re.search(r" (fusion|custom-call|copy|dynamic-slice)\(", ln)]
    print(f"esc scan compiled HLO: {len(ops)} device ops in ENTRY",
          flush=True)
    for ln in ops:
        print("   ", ln[:160], flush=True)


def spmm():
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops.spmm import time_spmm, time_spmm_gather
    from spgemm_tpu.utils.generators import cantlike, rmat

    a = cantlike()
    at = csr_to_tiles(a, 16, 128)
    x = np.random.default_rng(4).standard_normal((a.n, 128)).astype(
        np.float32)
    ms = time_spmm(at, x)
    nbytes = at.nt * at.tm * at.tn * 4 + a.n * 128 * 4 + a.m * 128 * 4
    print(f"spmm cant x 128 (xla tiles): {ms:.3f} ms, needed bytes at "
          f"{gbs(nbytes, ms)}", flush=True)
    g = rmat(np.random.default_rng(0), 65536, 16)
    xg = np.random.default_rng(5).standard_normal((g.n, 128)).astype(
        np.float32)
    ms = time_spmm_gather(g, xg)
    nbytes = g.nnz * (128 * 4 + 8) + g.m * 128 * 4
    print(f"spmm_gather rmat65536 x 128: {ms:.3f} ms, {gbs(nbytes, ms)}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--only", default="strip,f64,esc,spmm")
    args = ap.parse_args(argv)

    import jax

    from spgemm_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("compare_paths: needs the GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    only = set(args.only.split(","))
    if "strip" in only:
        structured(args.pairs)
    if "f64" in only:
        f64(args.pairs)
    if "esc" in only:
        esc()
    if "spmm" in only:
        spmm()
    return 0


if __name__ == "__main__":
    sys.exit(main())
