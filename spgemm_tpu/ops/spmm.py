"""SpMV / SpMM on the tiled sparse format: Y = A @ X with dense X.

The reference has no SpMV/SpMM, but the north-star spec extends the tile
structure to dense right-hand sides (batched k = 32/128), reusing the
tile-product machinery (BASELINE.json configs[3]).

Tile formulation: X is viewed as (gn, tn, k) row-blocks; each stored A
tile contributes one (tm, tn) x (tn, k) matmul, and tile-rows reduce with
a scatter-add over at most gm segments:

    Y[trow] += A_dense[t] @ X_blocks[tcol[t]]

This is one batched gather + batched matmul + segment reduction in plain
XLA, no per-nonzero control flow. Unstructured A goes through the raw-CSR
gather formulation (spmm_gather) instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spgemm_tpu.models.tile import TileMat


@functools.partial(jax.jit, static_argnames=("gm", "chunk"))
def _spmm_tiles(
    a_dense: jax.Array,   # (nt, tm, tn)
    trow: jax.Array,      # (nt,) int32, sorted ascending
    tcol: jax.Array,      # (nt,) int32
    xb: jax.Array,        # (gn, tn, k)
    *,
    gm: int,
    chunk: int = 65536,
) -> jax.Array:
    nt, tm, _ = a_dense.shape
    k = xb.shape[2]
    y = jnp.zeros((gm, tm, k), dtype=a_dense.dtype)
    if nt == 0:
        return y

    def accum(y, ad, tr, tc):
        prod = jax.lax.dot_general(
            ad,
            xb[tc],
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=a_dense.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        return y.at[tr].add(prod, indices_are_sorted=True)

    if nt <= chunk:
        return accum(y, a_dense, trow, tcol)

    # chunked accumulation for very large tile counts
    n_full = (nt // chunk) * chunk

    def body(carry, xs):
        ad, tr, tc = xs
        return accum(carry, ad, tr, tc), None

    y, _ = jax.lax.scan(
        body,
        y,
        (
            a_dense[:n_full].reshape(-1, chunk, tm, a_dense.shape[2]),
            trow[:n_full].reshape(-1, chunk),
            tcol[:n_full].reshape(-1, chunk),
        ),
    )
    if n_full < nt:
        y = accum(y, a_dense[n_full:], trow[n_full:], tcol[n_full:])
    return y


def spmm(a: TileMat, x, *, dtype=jnp.float32, backend: str = "auto") -> jax.Array:
    """Y = A @ X. x: (n, k) or (n,) array-like. Returns (m, k) / (m,).

    backend "auto" picks by a modelled device-traffic comparison: the
    raw-CSR gather path (spmm_gather — one X row gather per nonzero)
    when its bytes undercut the tile path's (sparse unstructured tiles
    waste bandwidth on padding; a 16 MB floor keeps tiny problems on the
    one-dispatch tile path), else the XLA tile path (_spmm_tiles).
    "gather" and "xla" force one side.
    """
    if backend not in ("auto", "gather", "xla"):
        raise ValueError(f"unknown SpMM backend {backend!r}")
    x = np.asarray(x)
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    if x.shape[0] != a.n:
        raise ValueError(f"shape mismatch: A is {a.shape}, X is {x.shape}")
    k = x.shape[1]
    k_pad = max(128, -(-k // 128) * 128)

    f64 = jnp.dtype(dtype) == jnp.dtype(np.float64)
    # unstructured patterns (many near-empty tiles) blow up the dense
    # tile path — a 786k-tile random matrix needs >6 GB of dense tiles.
    # The gather formulation works from the raw CSR instead. Both are
    # bandwidth-bound: the tile path streams tm*tn*4 B per stored tile,
    # the gather path one k_pad-wide X row + 8 B of (val, col) per
    # nonzero — so gather wins whenever tiles average fewer than
    # ~tm*tn*4/(k_pad*4+8) nonzeros (~16 at 16x128 tiles, k=128).
    gather_bytes = a.nnz * (k_pad * 4 + 8)
    tile_bytes = a.nt * a.tm * a.tn * 4
    if backend == "gather" or (
        backend == "auto"
        and (tile_bytes > 1 << 30
             or (not f64 and gather_bytes < tile_bytes
                 and tile_bytes > 16 << 20))
    ):
        return _finish(spmm_gather(a.to_csr(), x, dtype=dtype), vec, a, k)
    pad = a.gn * a.tn - a.n
    xb = np.pad(x, ((0, pad), (0, 0))).reshape(a.gn, a.tn, k)
    y = _spmm_tiles(
        jnp.asarray(a.dense(), dtype=dtype),
        jnp.asarray(a.trow),
        jnp.asarray(a.tcol),
        jnp.asarray(xb, dtype=dtype),
        gm=a.gm,
    ).reshape(a.gm * a.tm, k)
    y = y[: a.m, :k]
    return y[:, 0] if vec else y


def _finish(y, vec, a, k):
    y = np.asarray(y)[: a.m, :k]
    return y[:, 0] if vec else y


def _spmm_gather_classes(a, cap: int = 512, gran: int = 4):
    """Row-length classes for the gather SpMM: rows binned by nnz at
    `gran` granularity (padding <= gran-1 gathered X rows per row); rows
    longer than `cap` split into sibling segments summed on the host.
    Returns [(c, rows_idx, seg_ptr)] where rows_idx lists the CSR row of
    each segment and seg_ptr its data offset."""
    row_nnz = np.diff(a.indptr).astype(np.int64)
    by_c: dict[int, list] = {}
    for r in np.flatnonzero(row_nnz > 0):
        ln = int(row_nnz[r])
        lo = int(a.indptr[r])
        while ln > 0:
            seg = min(ln, cap)
            c = max(gran, -(-seg // gran) * gran)
            by_c.setdefault(c, []).append((r, lo, seg))
            lo += seg
            ln -= seg
    return sorted(by_c.items())


@functools.partial(jax.jit, static_argnames=("k_pad", "fuse"))
def _spmm_gather_kernel(av, col, xb, *, k_pad, fuse=True):
    """out[s, :] = sum_c av[s, c] * X[col[s, c]]: one X row gather per
    nonzero fused into a multiply-reduce. fuse=False instead pins the
    gather as a standalone op behind an optimization_barrier and reduces
    with a batched (1,c)x(c,k) contraction — an A/B variant that costs
    an extra device round-trip of the (s*c, k_pad) gathered block."""
    sN, c = av.shape
    xg = jnp.take(xb, col.reshape(-1), axis=0)
    if fuse:
        return jnp.sum(av[:, :, None] * xg.reshape(sN, c, k_pad), axis=1)
    xg = jax.lax.optimization_barrier(xg)  # standalone gather kernel
    out = jax.lax.dot_general(
        av[:, None, :], xg.reshape(sN, c, k_pad),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=av.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]  # (s, k_pad)


def _pack_spmm_gather(a_csr, x, np_dt, cap: int = 512, gran: int = 4):
    """Shared operand packing for the gather SpMM and its timer: padded
    X block plus per-row-length-class (av, col) streams and the segment
    row map for the host epilogue."""
    x = np.asarray(x)
    k = x.shape[1]
    k_pad = max(128, -(-k // 128) * 128)
    xb = np.zeros((a_csr.n + 1, k_pad), np_dt)
    xb[: a_csr.n, :k] = x
    classes = []
    for c, segs in _spmm_gather_classes(a_csr, cap, gran):
        sN = len(segs)
        av = np.zeros((sN, c), np_dt)
        col = np.full((sN, c), a_csr.n, np.int32)  # pad: zero X row
        rows = np.zeros(sN, np.int64)
        for si, (r, lo, seg) in enumerate(segs):
            av[si, :seg] = a_csr.data[lo : lo + seg]
            col[si, :seg] = a_csr.indices[lo : lo + seg]
            rows[si] = r
        classes.append((av, col, rows))
    return xb, classes, k, k_pad


def spmm_gather(a_csr, x, *, dtype=jnp.float32, cap: int = 512,
                gran: int = 4, fuse: bool = True):
    """Y = A @ X for unstructured A, straight from CSR: no tiles, no
    scatter — one X row gather per nonzero fused into a multiply-reduce
    over row-length classes. Computes in `dtype` (float64 needs
    jax_enable_x64).

    Traffic model: per nonzero the device moves one X row (k_pad*4 B =
    512 B at k=128, a random row gather), 4 B of value and 4 B of column
    index; the output write amortizes over the row length — 2k flops per
    ~520 B, a bandwidth-bound formulation by design.

    fuse=True (default) reduces with a fused multiply-reduce; fuse=False
    is the A/B variant above. Env SPGEMM_SPMM_FUSE overrides the default
    for measurement runs only."""
    np_dt = np.dtype(jnp.dtype(dtype).name)
    if np_dt == np.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "float64 gather SpMM needs jax_enable_x64=True")
    import os as _os

    _env = _os.environ.get("SPGEMM_SPMM_FUSE")
    if _env is not None:
        fuse = _env == "1"
    xb, classes, k, k_pad = _pack_spmm_gather(a_csr, x, np_dt)
    y = np.zeros((a_csr.m, k_pad), np_dt)
    for av, col, rows in classes:
        out = np.asarray(_spmm_gather_kernel(
            jnp.asarray(av), jnp.asarray(col), jnp.asarray(xb),
            k_pad=k_pad, fuse=fuse))
        np.add.at(y, rows, out)  # sibling segments of split rows sum
    return y[:, :k]


def spmv(a: TileMat, x, *, dtype=jnp.float32) -> jax.Array:
    """y = A @ x for a 1-D x (SpMV), via the SpMM path."""
    return spmm(a, x, dtype=dtype)


def time_spmm(a: TileMat, x, *, loop: int = 20, repeats: int = 2,
              dtype=jnp.float32) -> float:
    """Amortized per-dispatch device time of the XLA tile SpMM
    (_spmm_tiles, chained dispatches; see utils.timing.chained_device_ms)."""
    from spgemm_tpu.utils.timing import chained_device_ms

    x = np.asarray(x)
    k = x.shape[1]
    pad = a.gn * a.tn - a.n
    xb = np.pad(x, ((0, pad), (0, 0))).reshape(a.gn, a.tn, k)
    dev = jax.device_put((jnp.asarray(a.dense(), dtype=dtype),
                          jnp.asarray(a.trow), jnp.asarray(a.tcol),
                          jnp.asarray(xb, dtype=dtype)))
    jax.block_until_ready(dev)

    @jax.jit
    def chain(ad, trow, tcol, xd):
        def body(i, acc):
            y = _spmm_tiles(ad + acc * 1e-30, trow, tcol, xd, gm=a.gm)
            return acc + jnp.sum(y).astype(jnp.float32)
        return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

    return chained_device_ms(chain, *dev, repeats=repeats, loop=loop)


def time_spmm_gather(a_csr, x, *, loop: int = 20,
                     repeats: int = 2) -> float:
    """Amortized device time of the gather SpMM kernel (resident
    operands, chained dispatches)."""
    from spgemm_tpu.utils.timing import chained_device_ms

    xb, classes, k, k_pad = _pack_spmm_gather(a_csr, x, np.float32)
    dev = [(jnp.asarray(av), jnp.asarray(col)) for av, col, _ in classes]
    xd = jnp.asarray(xb)
    jax.block_until_ready([d[0] for d in dev] + [xd])

    import os as _os

    _env = _os.environ.get("SPGEMM_SPMM_FUSE")
    fuse = _env == "1" if _env is not None else True

    @jax.jit
    def chain(xd, *flat):
        arrs = [(flat[2 * i], flat[2 * i + 1])
                for i in range(len(flat) // 2)]

        def body(i, acc):
            s = acc
            for av, col in arrs:
                out = _spmm_gather_kernel(av + acc * 1e-30, col, xd,
                                          k_pad=k_pad, fuse=fuse)
                s = s + jnp.sum(out)
            return s

        return jax.lax.fori_loop(0, loop, body, jnp.float32(0))

    flat = []
    for d in dev:
        flat += list(d)
    return chained_device_ms(chain, xd, *flat,
                             repeats=repeats, loop=loop)
