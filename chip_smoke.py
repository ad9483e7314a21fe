#!/usr/bin/env python
"""Card smoke run: the main path of spgemm_tpu once, end to end, on one
GPU, through the public entry points, at the reference's own problem
size (the cant-like 62,451^2 matrix, ~4.0 M nnz, nnzCub ~2.6e8), with
every result checked against scipy.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: only the sharded paths

Phases (one card): A^2 and A*A^T on the structured route (integer values
exact, a Gaussian copy to rtol 1e-5 row-scaled), an R-MAT graph on the
unstructured ESC route, f64 on the f64 auto route and on both of its
alternatives (rtol 1e-12 row-scaled), SpMM through spmm and spmm_gather,
the CLI once, and the card-marked tests (`pytest -m gpu`) in-process.

It needs a GPU: on any other platform it exits non-zero and prints no
result. Any failed phase raises, so the script exits non-zero. The last
line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RTOL_F32 = 1e-5    # f32 accumulation over <= ~200 products per entry
RTOL_F64 = 1e-12   # f64 routes, row-scaled
RMAT_N = 65536     # Graph500-style Kronecker graph, edge factor 16
SEED = 0


class PhaseError(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def row_scaled_err(got, ref) -> float:
    """max over rows of max|got - ref| / max|ref| (CSR pair of equal
    pattern, or dense arrays)."""
    import scipy.sparse as sp

    if sp.issparse(ref):
        d = abs(got - ref).tocsr()
        num = np.asarray(d.max(axis=1).todense()).ravel()
        den = np.asarray(abs(ref).max(axis=1).todense()).ravel()
    else:
        num = np.abs(got - ref).max(axis=1)
        den = np.abs(ref).max(axis=1)
    den = np.where(den > 0, den, 1.0)
    return float((num / den).max()) if num.size else 0.0


def to_scipy(c):
    import scipy.sparse as sp

    return sp.csr_matrix((c.data, c.indices, c.indptr), shape=c.shape)


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def timed(fn):
    """(result of the cold call, cold ms, warm ms); the warm call runs
    the same inputs again after compilation."""
    t0 = time.perf_counter()
    fn()
    cold = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = fn()
    warm = (time.perf_counter() - t0) * 1e3
    return out, cold, warm


def report(name, route, cold, warm, result):
    print(f"phase {name}: route={route} cold_ms={cold:.1f} "
          f"warm_ms={warm:.1f} peak_bytes={peak_bytes()} check={result}",
          flush=True)


def spgemm_phase(name, a, b, aat, want_route, gaussian=True):
    """spgemm_csr on integer values (pattern exact; values exact on the
    structured route, rtol 1e-5 row-scaled on the graph) and on a
    Gaussian copy (rtol 1e-5 row-scaled)."""
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.ops import golden
    from spgemm_tpu.ops.spgemm import spgemm_csr

    bb = a.transpose() if aat else (a if b is None else b)
    ref = golden.spgemm_scipy(a, bb)
    (c, res), cold, warm = timed(lambda: spgemm_csr(a, b, aat=aat))
    route = str(res.stats["backend"])
    check(route.startswith(want_route), f"{name}: route {route}")
    got = golden.drop_explicit_zeros(c)
    check(got.pattern_equal(golden.drop_explicit_zeros(ref)),
          f"{name}: pattern")
    if not gaussian:
        err = row_scaled_err(to_scipy(got), to_scipy(ref))
        check(err <= RTOL_F32, f"{name}: row-scaled err {err:.3e}")
        report(name, route, cold, warm,
               f"pattern exact, row-scaled err {err:.3e} <= {RTOL_F32:g}")
        return
    check(np.array_equal(got.data, golden.drop_explicit_zeros(ref).data),
          f"{name}: integer values not exact")
    report(name, route, cold, warm, "pattern exact, integer values exact")
    ag = CSR(a.indptr, a.indices,
             np.random.default_rng(SEED + 1).standard_normal(a.nnz), a.shape)
    bg = None if b is None else CSR(
        b.indptr, b.indices,
        np.random.default_rng(SEED + 2).standard_normal(b.nnz), b.shape)
    refg = to_scipy(golden.spgemm_scipy(ag, ag.transpose() if aat
                                        else (ag if bg is None else bg)))
    (cg, resg), cold, warm = timed(lambda: spgemm_csr(ag, bg, aat=aat))
    err = row_scaled_err(to_scipy(cg), refg)
    check(cg.pattern_equal(c), f"{name} gaussian: pattern")
    check(err <= RTOL_F32, f"{name} gaussian: row-scaled err {err:.3e}")
    report(f"{name}-gaussian", str(resg.stats["backend"]), cold, warm,
           f"row-scaled err {err:.3e} <= {RTOL_F32:g}")


def f64_phase(a):
    """f64 on the auto route, then on its two alternatives; every one
    must pass rtol 1e-12 row-scaled."""
    import jax.numpy as jnp

    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.ops import golden
    from spgemm_tpu.ops.spgemm import spgemm_csr

    ag = CSR(a.indptr, a.indices,
             np.random.default_rng(SEED + 3).standard_normal(a.nnz), a.shape)
    ref = to_scipy(golden.spgemm_scipy(ag, ag))
    for name, kw, want in (
            ("f64-auto", {}, "gustavson"),
            ("f64-ozaki", {"backend": "ozaki"}, "ozaki"),
            ("f64-dd-scan", {"backend": "esc"}, "esc")):
        (c, res), cold, warm = timed(
            lambda: spgemm_csr(ag, compute_dtype=jnp.float64, **kw))
        route = str(res.stats["backend"])
        check(route.startswith(want), f"{name}: route {route}")
        err = row_scaled_err(to_scipy(c), ref)
        check(err <= RTOL_F64, f"{name}: row-scaled err {err:.3e}")
        report(name, route, cold, warm,
               f"row-scaled err {err:.3e} <= {RTOL_F64:g}")


def spmm_phase(cant, graph):
    import jax

    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops.spmm import spmm, spmm_gather

    x = np.random.default_rng(SEED + 4).standard_normal(
        (cant.n, 128)).astype(np.float32)
    at = csr_to_tiles(cant, 16, 128)
    ref = to_scipy(cant) @ x.astype(np.float64)
    y, cold, warm = timed(lambda: jax.block_until_ready(spmm(at, x)))
    err = row_scaled_err(np.asarray(y, np.float64), ref)
    check(err <= RTOL_F32, f"spmm: row-scaled err {err:.3e}")
    report("spmm-cant", "xla tiles", cold, warm,
           f"row-scaled err {err:.3e} <= {RTOL_F32:g}")

    xg = np.random.default_rng(SEED + 5).standard_normal(
        (graph.n, 128)).astype(np.float32)
    refg = to_scipy(graph) @ xg.astype(np.float64)
    y, cold, warm = timed(lambda: spmm_gather(graph, xg))
    err = row_scaled_err(np.asarray(y, np.float64), refg)
    check(err <= RTOL_F32, f"spmm_gather: row-scaled err {err:.3e}")
    report("spmm-rmat", "gather", cold, warm,
           f"row-scaled err {err:.3e} <= {RTOL_F32:g}")


def cli_phase(a):
    from spgemm_tpu import cli
    from spgemm_tpu.io.mmio import write_mtx

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cantlike.mtx")
        write_mtx(path, a)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([path, "16", "128", "--check", "values"])
        wall = (time.perf_counter() - t0) * 1e3
    text = out.getvalue()
    route = next((ln.split(":", 1)[1].strip() for ln in text.splitlines()
                  if ln.startswith("backend:")), "?")
    check(rc == 0 and "[PASSED]" in text, f"cli: rc={rc}\n{text}")
    report("cli", route, wall, wall, "[PASSED]")


def card_tests_phase():
    import pytest

    os.environ["SPGEMM_CARD_TESTS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    wall = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"card tests: pytest exit {rc}")
    report("card-tests", "pytest -m gpu", wall, wall, "all passed")


def four_card_phase(cant):
    """The sharded paths on a flat 4-device mesh, each compared with the
    one-card spgemm_csr result and scipy."""
    import jax.numpy as jnp

    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.models.tile import csr_to_tiles
    from spgemm_tpu.ops import golden
    from spgemm_tpu.ops.spgemm import spgemm_csr
    from spgemm_tpu.parallel import dist

    import jax

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, "
          f"found {len(jax.devices())}")
    mesh = dist.make_mesh(4)
    at = csr_to_tiles(cant, 16, 128)
    bt = csr_to_tiles(cant, 128, 128)
    ref = golden.drop_explicit_zeros(golden.spgemm_scipy(cant, cant))
    one, res1 = spgemm_csr(cant)
    one = golden.drop_explicit_zeros(one)
    check(one.pattern_equal(ref) and np.array_equal(one.data, ref.data),
          "one-card reference run")
    print(f"one-card spgemm_csr: route={res1.stats['backend']} "
          f"nnzC={one.nnz}", flush=True)

    seen = []

    def shards(outs):
        devs = sorted({str(s.device) for o in outs
                       for s in o.addressable_shards})
        print(f"  output shards on: {', '.join(devs)}", flush=True)
        check(len(devs) == 4, f"output shards on {len(devs)} devices")
        seen.append(devs)

    def ran_sharded(name):
        check(len(seen) == 2, f"{name}: did not run on the mesh")
        seen.clear()

    variants = (
        ("spgemm_sharded", lambda i: dist.spgemm_sharded(
            at, bt, mesh, inspect=i)),
        ("spgemm_sharded_ring", lambda i: dist.spgemm_sharded_ring(
            at, bt, mesh, inspect=i)),
        ("spgemm_sharded_strip", lambda i: dist.spgemm_sharded_strip(
            at, bt, mesh, inspect=i)),
    )
    for name, run in variants:
        (c), cold, warm = timed(lambda: run(shards).to_csr())
        got = golden.drop_explicit_zeros(c)
        check(got.pattern_equal(one) and np.array_equal(got.data, one.data),
              f"{name}: differs from the one-card result")
        ran_sharded(name)
        report(name, "4 devices", cold, warm,
               "equals one-card result and scipy")
    c, cold, warm = timed(lambda: dist.spgemm_sharded_esc(
        cant, cant, mesh, inspect=shards))
    got = golden.drop_explicit_zeros(c)
    err = row_scaled_err(to_scipy(got), to_scipy(ref))
    check(got.pattern_equal(one) and err <= RTOL_F32,
          f"spgemm_sharded_esc: err {err:.3e}")
    ran_sharded("spgemm_sharded_esc")
    report("spgemm_sharded_esc", "4 devices", cold, warm,
           f"pattern equals one-card, row-scaled err {err:.3e}")

    ag = CSR(cant.indptr, cant.indices,
             np.random.default_rng(SEED + 3).standard_normal(cant.nnz),
             cant.shape)
    ref64 = to_scipy(golden.spgemm_scipy(ag, ag))
    one64, _ = spgemm_csr(ag, compute_dtype=jnp.float64)
    agt = csr_to_tiles(ag, 16, 128)
    bgt = csr_to_tiles(ag, 128, 128)
    c, cold, warm = timed(lambda: dist.spgemm_sharded_ozaki(
        agt, bgt, mesh, inspect=shards).to_csr())
    err = row_scaled_err(to_scipy(c), ref64)
    err1 = row_scaled_err(to_scipy(c), to_scipy(one64))
    check(err <= RTOL_F64 and err1 <= RTOL_F64,
          f"spgemm_sharded_ozaki: err {err:.3e} / {err1:.3e}")
    ran_sharded("spgemm_sharded_ozaki")
    report("spgemm_sharded_ozaki", "4 devices", cold, warm,
           f"row-scaled err vs scipy {err:.3e}, vs one-card {err1:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    import jax

    from spgemm_tpu.utils import native
    from spgemm_tpu.utils.generators import cantlike, rmat
    from spgemm_tpu.utils.platform import enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    print(f"device_kind: {dev.device_kind}  devices: {len(jax.devices())}  "
          f"jax {jax.__version__}  compile cache: {cache}", flush=True)
    lib = native.get_lib()
    check(lib is not None, "native host library (native/csr2tile.cpp) "
          "was not built or loaded")
    print(f"native library: loaded ({native._LIB})  host pool: "
          f"{native.pool_backing()}", flush=True)

    t0 = time.perf_counter()
    cant = cantlike()
    graph = rmat(np.random.default_rng(SEED), RMAT_N, 16)
    print(f"inputs: cant-like {cant.m}x{cant.n} nnz={cant.nnz}; R-MAT "
          f"n={graph.m} nnz={graph.nnz} ({(time.perf_counter()-t0)*1e3:.0f}"
          " ms to generate)", flush=True)

    if args.four:
        four_card_phase(cant)
    else:
        spgemm_phase("A2-f32", cant, None, False, "strip")
        spgemm_phase("AAT-f32", cant, None, True, "strip")
        spgemm_phase("A2-f32-rmat", graph, None, False, "esc",
                     gaussian=False)
        f64_phase(cant)
        spmm_phase(cant, graph)
        cli_phase(cant)
        card_tests_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
