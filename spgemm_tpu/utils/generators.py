"""Synthetic matrix generators spanning the reference's structural
regimes (stand-ins for the `data/run18.sh`/`run142.sh` SuiteSparse
matrix lists, generated in the repo from a seed). Shared by bench.py,
chip_smoke.py, tools/run_suite.py, examples, and tests."""

from __future__ import annotations

import numpy as np


def banded(rng, n, band, fill=0.5):
    from spgemm_tpu.models.csr import CSR

    offs = np.arange(-band, band + 1, dtype=np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n) & (rng.random(r.size) < fill)
    keep |= r == c
    return CSR.from_coo(r[keep], c[keep],
                        rng.integers(1, 10, keep.sum()).astype(np.float64),
                        (n, n))


CANT_ROWS, CANT_BAND = 62451, 64


def cantlike(rows: int = CANT_ROWS, band: int = CANT_BAND):
    """Deterministic stand-in for SuiteSparse cant (62,451^2): a +-band
    band with about half its entries kept by a hash, ~(band+0.5) nnz per
    row, integer values 1..9 — at the defaults ~4.0 M nnz and nnzCub
    ~2.6e8, close to cant's 2.69e8 (BASELINE.md)."""
    from spgemm_tpu.models.csr import CSR

    offs = np.arange(-band, band + 1, dtype=np.int64)
    r = np.repeat(np.arange(rows, dtype=np.int64), offs.size)
    c = r + np.tile(offs, rows)
    keep = (c >= 0) & (c < rows) & (((r * 31 + c * 17) & 3) < 2)
    keep |= r == c
    r, c = r[keep], c[keep]
    vals = ((r * 7 + c * 13) % 9 + 1).astype(np.float64)
    return CSR.from_coo(r, c, vals, (rows, rows))


def block_diag(rng, n, bs=64, fill=0.3):
    from spgemm_tpu.models.csr import CSR

    nb = n // bs
    rb = rng.integers(0, bs, size=int(nb * bs * bs * fill))
    cb = rng.integers(0, bs, size=rb.size)
    blk = rng.integers(0, nb, size=rb.size)
    return CSR.from_coo(blk * bs + rb, blk * bs + cb,
                        rng.integers(1, 10, rb.size).astype(np.float64),
                        (n, n))


def random_uniform(rng, n, nnz_per_row=16):
    from spgemm_tpu.models.csr import CSR

    nnz = n * nnz_per_row
    return CSR.from_coo(
        rng.integers(0, n, nnz), rng.integers(0, n, nnz),
        rng.integers(1, 10, nnz).astype(np.float64), (n, n),
    )


def power_law(rng, n, base=4, heavy_frac=0.01, heavy=256):
    from spgemm_tpu.models.csr import CSR

    lens = np.full(n, base)
    lens[rng.choice(n, size=max(1, int(n * heavy_frac)),
                    replace=False)] = heavy
    r = np.repeat(np.arange(n), lens)
    c = rng.integers(0, n, r.size)
    return CSR.from_coo(r, c, rng.integers(1, 10, r.size).astype(np.float64),
                        (n, n))


def rmat(rng, n, nnz_per_row=16, a=0.57, b=0.19, c=0.19, values="int"):
    """R-MAT/Kronecker power-law graph (Chakrabarti et al.) — the
    standard scale-free generator for unstructured SpGEMM regression."""
    from spgemm_tpu.models.csr import CSR

    levels = max(1, int(np.ceil(np.log2(n))))
    nnz = n * nnz_per_row
    r = np.zeros(nnz, np.int64)
    cc = np.zeros(nnz, np.int64)
    for _ in range(levels):
        u = rng.random(nnz)
        quad = (u > a).astype(np.int64) + (u > a + b) + (u > a + b + c)
        r = r * 2 + (quad >> 1)
        cc = cc * 2 + (quad & 1)
    keep = (r < n) & (cc < n)
    k = int(keep.sum())
    vals = (np.ones(k) if values == "ones"
            else rng.integers(1, 10, k).astype(np.float64))
    return CSR.from_coo(r[keep], cc[keep], vals, (n, n))
