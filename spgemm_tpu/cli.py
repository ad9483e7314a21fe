"""Command-line driver: the analogue of the reference's `./test` binary
(`src/main.cu:13-359`, README.md:47-71 output contract).

    python -m spgemm_tpu [-d DEV] [-aat 0|1] A.mtx [tile_m tile_n] [options]

Prints the same information the reference prints per run (matrix info,
load time, tile size, flops, conversion ms, format space, step times,
tile/nnz counts, runtime + GFLOPS, check verdict) and appends the four
CSV sinks (`results_tile.csv`, `step_runtime.csv`, `mem-cost.csv`,
`preprocessing.csv`; reference `main.cu:283-320`).

Improvements over the reference driver:
  * the correctness check compares values (fp64 tolerance), not just the
    pattern (`spgemm_cusparse.h:282` skips values);
  * `-aat 1` works on any rectangular matrix and builds A^T directly in
    tile space.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spgemm_tpu",
        description="Tiled SpGEMM: C = A^2 or C = A*A^T",
    )
    p.add_argument("-d", "--device", type=int, default=0,
                   help="device ordinal (reference: -d)")
    p.add_argument("-aat", type=int, choices=[0, 1], default=0,
                   help="1: C = A*A^T, 0: C = A^2 (reference: -aat)")
    p.add_argument("matrix", help="Matrix Market file (.mtx[.gz])")
    p.add_argument("tile_m", nargs="?", type=int, default=16)
    p.add_argument("tile_n", nargs="?", type=int, default=128)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "strip", "gustavson", "dense", "esc",
                            "xla", "ozaki"])
    p.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    p.add_argument("--check", default="values",
                   choices=["none", "pattern", "values"],
                   help="oracle comparison level (reference checks pattern)")
    p.add_argument("--csv-dir", default=None,
                   help="append result CSVs to this directory")
    p.add_argument("--repeat", type=int, default=1,
                   help="best-of repeat count (reference REPEAT_NUM)")
    p.add_argument("--synthetic-values", action="store_true",
                   help="overwrite values with i%%10 (reference main.cu:111)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    from spgemm_tpu.io.mmio import read_mtx
    from spgemm_tpu.models.csr import flop_count_spgemm
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops import golden
    from spgemm_tpu.ops.spgemm import spgemm_csr
    from spgemm_tpu.utils import csv_sink
    from spgemm_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    if args.dtype == "f64" and args.backend not in ("auto", "ozaki",
                                                    "esc"):
        # auto/ozaki/esc manage f64 themselves (the auto route enables
        # x64 for its own call; the Ozaki engine and the double-double
        # scan need none); an explicit tiled backend needs the flag
        jax.config.update("jax_enable_x64", True)
    compute_dtype = jnp.float64 if args.dtype == "f64" else jnp.float32

    devices = jax.devices()
    dev = devices[min(args.device, len(devices) - 1)]
    print(f"device: {dev}")

    t0 = time.perf_counter()
    a, is_sym = read_mtx(args.matrix)
    load_s = time.perf_counter() - t0
    name = os.path.basename(args.matrix).removesuffix(".gz").removesuffix(".mtx")
    print(f"matrix: {name}  m={a.m} n={a.n} nnz={a.nnz} "
          f"symmetric={int(is_sym)}")
    print(f"load time: {load_s:.3f} s")

    if args.synthetic_values:
        a = a.with_sequential_values()
    if args.aat and is_sym:
        # reference refuses AAT on symmetric inputs (main.cu:120-124)
        print("AAT on a symmetric matrix equals A^2; computing A^2 instead",
              file=sys.stderr)
        args.aat = 0
    if not args.aat and a.m != a.n:
        print("error: C = A^2 requires a square matrix (use -aat 1)",
              file=sys.stderr)
        return 2

    tm, tn = args.tile_m, args.tile_n
    print(f"tile size: {tm} x {tn}  (B tiles {tn} x {tn})")

    b_csr = a.transpose() if args.aat else a
    nnz_cub = flop_count_spgemm(a, b_csr)
    print(f"nnzCub (flops base): {nnz_cub}  "
          f"({2*nnz_cub/1e9:.3f} GFLOP)")

    # conversion timing (the reference's csr2tile ms)
    t0 = time.perf_counter()
    at = csr_to_tiles(a, tm, tn)
    convert_ms = (time.perf_counter() - t0) * 1e3
    csr_mb = (a.indptr.nbytes + a.indices.nbytes + a.data.nbytes) / 1e6
    tile_mb = at.total_bytes() / 1e6
    print(f"CSR->tile conversion: {convert_ms:.2f} ms  "
          f"(numtile(A)={at.nt})")
    print(f"space: CSR {csr_mb:.2f} MB vs tiled {tile_mb:.2f} MB")

    best = None
    best_runtime = float("inf")
    for _ in range(max(1, args.repeat)):
        c, res = spgemm_csr(
            a, aat=bool(args.aat), tm=tm, tn=tn,
            backend=args.backend, compute_dtype=compute_dtype,
            device=dev,
        )
        rt = (res.timings_ms.get("symbolic_ms", 0.0)
              + res.timings_ms.get("numeric_ms", 0.0))
        if rt < best_runtime:
            best_runtime, best = rt, (c, res)
    c, res = best

    tms = res.timings_ms
    print(f"backend: {res.stats.get('backend', args.backend)}")
    print(f"step times: symbolic {tms.get('symbolic_ms', 0):.2f} ms, "
          f"upload {tms.get('upload_ms', 0):.2f} ms, "
          f"numeric {tms.get('numeric_ms', 0):.2f} ms, "
          f"compact {tms.get('compact_ms', 0):.2f} ms")
    print(f"numtile(C): {int(res.stats['numblkC'])} "
          f"(candidates {int(res.stats['numblkC_candidate'])})")
    print(f"nnz(C): {c.nnz}  compression: "
          f"{res.stats.get('compression', float('nan')):.2f}")
    gflops = 2.0 * nnz_cub / (best_runtime * 1e6) if best_runtime else 0.0
    print(f"runtime: {best_runtime:.2f} ms  ({gflops:.2f} GFLOPS)")
    print("note: wall-clock device timings include dispatch latency; "
          "see bench.py for amortized kernel timing")

    verdict = "SKIPPED"
    if args.check != "none":
        ref = golden.spgemm_scipy(a, b_csr)
        got = golden.drop_explicit_zeros(c)
        pattern_ok = got.pattern_equal(ref)
        if args.check == "pattern":
            verdict = "PASSED" if pattern_ok else "NOT PASSED"
        else:
            tol = 1e-12 if args.dtype == "f64" else 1e-5
            ok = pattern_ok and np.allclose(got.data, ref.data, rtol=tol)
            verdict = "PASSED" if ok else "NOT PASSED"
        print(f"check ({args.check} vs scipy oracle): [{verdict}]")

    if args.csv_dir:
        d = args.csv_dir
        csv_sink.append_row(
            os.path.join(d, "results_tile.csv"), csv_sink.RESULTS_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn, c.nnz,
             round(res.stats.get("compression", 0), 4),
             round(best_runtime, 4), round(gflops, 4),
             args.backend, args.dtype],
        )
        csv_sink.append_row(
            os.path.join(d, "step_runtime.csv"), csv_sink.STEP_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn,
             round(tms.get("symbolic_ms", 0), 4),
             round(tms.get("upload_ms", 0), 4),
             round(tms.get("numeric_ms", 0), 4),
             round(tms.get("compact_ms", 0), 4)],
        )
        csv_sink.append_row(
            os.path.join(d, "mem-cost.csv"), csv_sink.MEM_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn,
             round(csr_mb, 4), round(tile_mb, 4)],
        )
        csv_sink.append_row(
            os.path.join(d, "preprocessing.csv"), csv_sink.PREPROC_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn, round(convert_ms, 4)],
        )

    return 0 if verdict in ("PASSED", "SKIPPED") else 1


if __name__ == "__main__":
    sys.exit(main())
