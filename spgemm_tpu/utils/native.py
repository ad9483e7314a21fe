"""Native (C++) host-format fast path, loaded via ctypes.

The reference's host format layer is C with OpenMP (`src/csr2tile.h`,
`src/tile2csr.h`); this module provides the same role for this framework:
`native/csr2tile.cpp` compiled on first use with g++ into a cached shared
library. The NumPy implementations in models/tile.py remain the reference
semantics and the fallback (set SPGEMM_TPU_NATIVE=0 to force them).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
import time

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "csr2tile.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB = os.path.join(_BUILD_DIR, "libspgemmtile.so")

_lock = threading.Lock()
_lib = None
_tried = False

I32 = ctypes.POINTER(ctypes.c_int32)
U32 = ctypes.POINTER(ctypes.c_uint32)
F64 = ctypes.POINTER(ctypes.c_double)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        _SRC, "-o", _LIB,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        print(f"spgemm_tpu: native build failed ({e}); using NumPy converters",
              file=sys.stderr)
        return None
    return _LIB


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if os.environ.get("SPGEMM_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            print(f"spgemm_tpu: native load failed ({e})", file=sys.stderr)
            return None
        lib.csr2tile_count.restype = ctypes.c_int64
        _lib = lib
        return _lib


def csr_to_tiles_native(csr, tm: int, tn: int):
    """Native csr2tile; returns a TileMat or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from spgemm_tpu.models.csr import INDEX_DTYPE
    from spgemm_tpu.models.tile import MASK_DTYPE, TileMat, cdiv

    m, n = csr.shape
    gm = cdiv(m, tm)
    mw = cdiv(tn, 32)
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int32)
    data = np.ascontiguousarray(csr.data, dtype=np.float64)
    # the C code trusts these invariants — a malformed CSR would read out
    # of bounds, so validate at the ctypes boundary
    if indptr.size != m + 1 or int(indptr[-1]) != indices.size \
            or indices.size != data.size:
        raise ValueError(
            f"malformed CSR: indptr has {indptr.size} entries for m={m}, "
            f"indptr[-1]={int(indptr[-1])}, nnz={indices.size}"
        )

    tptr = np.zeros(gm + 1, dtype=np.int32)
    nt = int(lib.csr2tile_count(
        _ptr(indptr, I32), _ptr(indices, I32),
        ctypes.c_int64(m), ctypes.c_int64(n),
        ctypes.c_int64(tm), ctypes.c_int64(tn),
        _ptr(tptr, I32),
    ))

    # Only mask needs pre-zeroing (fill |='s bits into it); every other
    # array is fully written by csr2tile_fill, and the zeroing of rc/val
    # alone was ~48 MB of memset per cant-scale conversion.
    trow = np.empty(nt, dtype=np.int32)
    tcol = np.empty(nt, dtype=np.int32)
    tnnz_ptr = np.empty(nt + 1, dtype=np.int32)
    rowptr = np.empty((nt, tm + 1), dtype=np.int32)
    mask = np.zeros((nt, tm, mw), dtype=MASK_DTYPE)
    rc = np.empty(csr.nnz, dtype=np.int32)
    val = np.empty(csr.nnz, dtype=np.float64)
    lib.csr2tile_fill(
        _ptr(indptr, I32), _ptr(indices, I32), _ptr(data, F64),
        ctypes.c_int64(m), ctypes.c_int64(n),
        ctypes.c_int64(tm), ctypes.c_int64(tn),
        _ptr(tptr, I32),
        _ptr(trow, I32), _ptr(tcol, I32), _ptr(tnnz_ptr, I32),
        _ptr(rowptr, I32), _ptr(mask, U32), _ptr(rc, I32), _ptr(val, F64),
    )
    return TileMat(
        shape=(m, n), tm=tm, tn=tn,
        trow=trow.astype(INDEX_DTYPE, copy=False),
        tcol=tcol.astype(INDEX_DTYPE, copy=False),
        tptr=tptr.astype(INDEX_DTYPE, copy=False),
        tnnz_ptr=tnnz_ptr.astype(INDEX_DTYPE, copy=False),
        rc=rc, val=val, mask=mask, rowptr=rowptr,
    )


def tiles_to_csr_native(t):
    """Native tile2csr; returns a CSR or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from spgemm_tpu.models.csr import CSR

    indptr = np.zeros(t.m + 1, dtype=np.int32)
    indices = np.zeros(t.nnz, dtype=np.int32)
    data = np.zeros(t.nnz, dtype=np.float64)
    lib.tile2csr(
        _ptr(np.ascontiguousarray(t.trow, np.int32), I32),
        _ptr(np.ascontiguousarray(t.tcol, np.int32), I32),
        _ptr(np.ascontiguousarray(t.tnnz_ptr, np.int32), I32),
        _ptr(np.ascontiguousarray(t.rowptr, np.int32), I32),
        _ptr(np.ascontiguousarray(t.rc, np.int32), I32),
        _ptr(np.ascontiguousarray(t.val, np.float64), F64),
        ctypes.c_int64(t.nt), ctypes.c_int64(t.m),
        ctypes.c_int64(t.tm), ctypes.c_int64(t.tn),
        _ptr(indptr, I32), _ptr(indices, I32), _ptr(data, F64),
    )
    return CSR(indptr, indices, data, t.shape)


I64 = ctypes.POINTER(ctypes.c_int64)


def esc_symbolic_native(a, b, s_slots: int, f_max: int, w_min: int):
    """Native symbolic for the digit-ESC engine (ops/esc.py): C pattern,
    per-interval product counts, and the padded per-class operand-stream
    fill. Returns (c_indptr i64, c_indices i32, flops, prod_cnt i64,
    asrc, bsrc, slot, layout) or None if unavailable; `layout` is the
    _sibling_layout result the fill was written against."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "esc_pattern_count"):
        return None
    lib.esc_pattern_count.restype = ctypes.c_int64
    lib.esc_products_count.restype = ctypes.c_int64

    m, n = a.m, b.n
    ai = np.ascontiguousarray(a.indptr, np.int32)
    aj = np.ascontiguousarray(a.indices, np.int32)
    bi = np.ascontiguousarray(b.indptr, np.int32)
    bj = np.ascontiguousarray(b.indices, np.int32)

    c_indptr = np.zeros(m + 1, np.int32)
    nnz_c = int(lib.esc_pattern_count(
        _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
        ctypes.c_int64(m), ctypes.c_int64(n), _ptr(c_indptr, I32)))

    n_int = max(1, -(-nnz_c // s_slots))
    c_indices = np.zeros(nnz_c, np.int32)
    prod_cnt = np.zeros(n_int, np.int64)
    flops = int(lib.esc_products_count(
        _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
        ctypes.c_int64(m), ctypes.c_int64(n), _ptr(c_indptr, I32),
        _ptr(c_indices, I32), ctypes.c_int64(s_slots),
        _ptr(prod_cnt, I64)))

    from spgemm_tpu.ops.esc import _sibling_layout

    layout = _sibling_layout(prod_cnt, nnz_c, s_slots, f_max, w_min)
    asrc = np.full(layout["flat_total"], -1, np.int32)
    bsrc = np.zeros(layout["flat_total"], np.int32)
    slot = np.zeros(layout["flat_total"], np.int32)
    av = np.zeros(layout["flat_total"], np.float64)
    bv = np.zeros(layout["flat_total"], np.float64)
    if flops:
        ad = np.ascontiguousarray(a.data, np.float64)
        bd = np.ascontiguousarray(b.data, np.float64)
        lib.esc_fill(
            _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
            _ptr(ad, F64), _ptr(bd, F64),
            ctypes.c_int64(m), ctypes.c_int64(n), _ptr(c_indptr, I32),
            _ptr(c_indices, I32), ctypes.c_int64(s_slots),
            ctypes.c_int64(f_max),
            _ptr(layout["sib_ptr"], I64), _ptr(layout["sib_base"], I64),
            ctypes.c_int64(n_int),
            _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(slot, I32),
            _ptr(av, F64), _ptr(bv, F64))
    return (c_indptr.astype(np.int64), c_indices, flops, prod_cnt,
            asrc, bsrc, slot, layout, av, bv)


_libc = None


def madvise_hugepage(*arrays):
    """Advise the kernel to back these numpy arrays with transparent
    hugepages (THP is in `madvise` mode on this host). First-touch page
    faulting measured 0.8 GB/s with 4 KB pages vs 2.2 GB/s with THP, and
    random 4 B writes 7 M/s vs 49 M/s — the difference is TLB reach.
    No-op on failure; safe on any private anonymous mapping."""
    global _libc
    if _libc is None:
        try:
            _libc = ctypes.CDLL("libc.so.6", use_errno=True)
            _libc.madvise.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        except OSError:
            _libc = False
    if not _libc:
        return
    page = 4096
    for arr in arrays:
        addr = arr.ctypes.data
        start = (addr + page - 1) & ~(page - 1)
        end = (addr + arr.nbytes) & ~(page - 1)
        if end > start:
            _libc.madvise(start, end - start, 14)  # MADV_HUGEPAGE


def _madvise_populate_write(addr: int, nbytes: int) -> None:
    """madvise(MADV_POPULATE_WRITE): synchronously fault-in + write-map
    a region. On this host it populates provisioned tmpfs pages at
    ~16 GB/s, vs paying the minor faults inside the consumer's NT-store
    loop at ~4 GB/s (each fault flushes the write-combining buffers) or
    ~0.4 GB/s when the page also needs VMM provisioning. No-op on
    failure (pre-5.14 kernels reject advice 23)."""
    global _libc
    if _libc is None:
        madvise_hugepage()  # initializes _libc
    if not _libc:
        return
    page = 4096
    start = (addr + page - 1) & ~(page - 1)
    end = (addr + nbytes) & ~(page - 1)
    if end > start:
        _libc.madvise(start, end - start, 23)  # MADV_POPULATE_WRITE


_POOL: list = []

# per-stage TSC totals of the most recent esc_scan_build (profiling aid)
last_scan_build_stages: dict | None = None

# Optional shared-memory arena backing the pool, on only when
# SPGEMM_POOL_FILE names its file (e.g. /dev/shm/spgemm_arena). On a VM
# whose guest memory is backed lazily by the host, the FIRST touch of a
# guest page since boot can be provisioned far slower than a touch of an
# already-backed page, and anonymous memory freed at process exit need
# not come back to the next process. A tmpfs file pins the provisioned
# pages in the page cache by NAME, so every later process attaches warm.
# The default is process-private anonymous memory: nothing is written
# outside the checkout, and two processes (or two checkouts) never share
# pages or state, so one run's host times cannot depend on another's.
_ARENA_PATH = os.environ.get("SPGEMM_POOL_FILE", "")
_ARENA_MAX = int(os.environ.get("SPGEMM_POOL_MAX_GB", "100")) << 30
# NOTE: the file and its carves are virtual (sparse tmpfs + writers
# populate only the prefixes they touch) — the cap bounds address
# space, not RAM. Plan planes are sized at loose upper bounds whose
# pow2 caps can sum to >60 GB at cant scale while touching ~5 GB; a
# 40 GB cap pushed those carves onto cold anonymous memory.
_arena_mm = None       # the mmap object, or False if unavailable
_arena_off = 0         # carve cursor (bytes)
_arena_fd = -1
# Sidecar recording which arena ranges have ever been resident ("off len"
# lines) — pool_boot_provision re-populates them so every plan build runs
# on provisioned pages no matter which process touched them first. The
# carve cursor itself is useless for this: pow2 caps make it a sparse
# VIRTUAL bound (measured 70 GB cursor for ~15 GB touched), and populating
# untouched pages would materialize them for nothing.
_ARENA_HWM_PATH = _ARENA_PATH + ".hwm" if _ARENA_PATH else ""
_boot_thread = None    # the one-per-process background provisioner
_exit_scan_armed = False


def _arena_fits() -> bool:
    """Whether the tmpfs holding the arena has _ARENA_MAX bytes free. The
    arena file is sparse, but touching a page past the tmpfs size kills
    the process with SIGBUS, so a smaller tmpfs means anonymous memory."""
    if not _ARENA_PATH:
        return False
    try:
        st = os.statvfs(os.path.dirname(_ARENA_PATH) or ".")
    except OSError:
        return False
    return st.f_bavail * st.f_frsize >= _ARENA_MAX


def pool_backing() -> str:
    """"shm" when pool buffers come from the SPGEMM_POOL_FILE arena,
    "anon" when they are anonymous process memory (the default)."""
    return "shm" if _arena_attach() is not False else "anon"


def _arena_attach():
    """mmap the arena file (create + size on first use). Returns the
    mmap object or False if unavailable (SPGEMM_POOL_FILE unset, too
    little free space where it lives, or another live process holds the
    flock — two concurrent processes must not share scratch)."""
    global _arena_mm, _arena_fd
    if _arena_mm is not None:
        return _arena_mm
    import fcntl
    import mmap as _mmap

    if not _arena_fits():
        _arena_mm = False
        return _arena_mm
    fd = -1
    try:
        fd = os.open(_ARENA_PATH, os.O_RDWR | os.O_CREAT, 0o600)
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        # tmpfs files are sparse: size to the cap up front (pages
        # materialize on first touch), mmap once for process lifetime
        if os.fstat(fd).st_size < _ARENA_MAX:
            os.ftruncate(fd, _ARENA_MAX)
        _arena_mm = _mmap.mmap(fd, _ARENA_MAX)
        _arena_fd = fd  # keeps fd + flock alive for process lifetime
    except (OSError, ValueError):
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass
        _arena_mm = False
    return _arena_mm


def _new_buffer(cap: int):
    """A cap-byte pool buffer: carved from the shared arena when it
    fits, anonymous (THP-advised) otherwise. Deliberately NOT populated
    here: plan-array requests are sized at loose upper bounds (the scan
    planes' r_ub can be 10x the touched rows at cant scale), so eager
    population would write tens of GB nobody touches — writers populate
    the exact ranges they stream into instead (esc_scan_build's chunked
    MADV_POPULATE_WRITE ahead of its NT flush; pool_array for zero/fill
    requests).

    Each carve is a SEPARATE np.frombuffer over the mmap, never a slice
    of one big arena array: numpy collapses view chains through ndarray
    bases, so a slice-of-a-slice would point its .base past the carved
    buffer at the top-level array — and pool_array's getrefcount
    liveness check would see every checked-out buffer as free (measured:
    two live pool arrays handed the same memory). frombuffer's base is
    the mmap object, where the collapse stops, so each carve anchors its
    own view chain exactly like an owning np.empty buffer does."""
    global _arena_off, _exit_scan_armed
    mm = _arena_attach()
    if mm is not False and _arena_off + cap <= len(mm):
        buf = np.frombuffer(mm, np.uint8, count=cap, offset=_arena_off)
        _arena_off += cap
        if not _exit_scan_armed:
            _exit_scan_armed = True
            import atexit

            atexit.register(_hwm_save)
        return buf
    buf = np.empty(cap, np.uint8)
    madvise_hugepage(buf)
    return buf


def _arena_base() -> int:
    return np.frombuffer(_arena_mm, np.uint8, count=1).ctypes.data


def _resident_ranges(upto: int) -> list[tuple[int, int]]:
    """(offset, length) runs of resident arena pages in [0, upto),
    via mincore — the ground truth for which pages this boot has
    provisioned, independent of who touched them or how."""
    global _libc
    if _libc is None:
        madvise_hugepage()  # initializes _libc
    if not _libc:
        return []
    try:
        _libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_char_p]
    except AttributeError:
        return []
    base = _arena_base()
    page = 4096
    ranges: list[tuple[int, int]] = []
    chunk = 1 << 32
    for off in range(0, upto, chunk):
        ln = min(chunk, upto - off)
        npg = (ln + page - 1) // page
        vec = ctypes.create_string_buffer(npg)
        if _libc.mincore(base + off, ln, vec) != 0:
            continue
        bits = np.frombuffer(vec, np.uint8, count=npg) & 1
        edge = np.diff(np.concatenate(([0], bits, [0])))
        for s, e in zip(np.flatnonzero(edge == 1),
                        np.flatnonzero(edge == -1)):
            start = off + int(s) * page
            length = int(e - s) * page
            if ranges and ranges[-1][0] + ranges[-1][1] == start:
                ranges[-1] = (ranges[-1][0], ranges[-1][1] + length)
            else:
                ranges.append((start, length))
    return ranges


def _hwm_read() -> list[tuple[int, int]]:
    try:
        out = []
        with open(_ARENA_HWM_PATH) as f:
            for line in f:
                off, ln = line.split()
                out.append((int(off), int(ln)))
        return out
    except (OSError, ValueError):
        return []


def _hwm_save() -> None:
    """atexit: union this process's resident arena ranges into the
    sidecar (atomic rename; the arena flock serializes writers)."""
    if not _arena_mm or _arena_off <= 0:
        return
    try:
        spans = _hwm_read() + _resident_ranges(_arena_off)
        spans.sort()
        merged: list[list[int]] = []
        for off, ln in spans:
            if merged and off <= merged[-1][0] + merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], off + ln - merged[-1][0])
            else:
                merged.append([off, ln])
        tmp = _ARENA_HWM_PATH + f".{os.getpid()}"
        with open(tmp, "w") as f:
            f.writelines(f"{off} {ln}\n" for off, ln in merged)
        os.replace(tmp, _ARENA_HWM_PATH)
    except (OSError, ValueError):
        pass


def pool_boot_provision(wait: bool = False) -> int:
    """Populate the arena ranges previous processes had resident.

    Host-memory model (see _arena_attach): the VMM provisions each
    guest page ONCE per VM boot at ~0.13 GB/s; already-provisioned
    tmpfs pages re-populate into a new process at ~17 GB/s. Round 3
    paid that one-time cost as a 480 s cliff inside the first timed
    plan build. This runs it up front instead: synchronously when the
    pages are warm (sub-second per 10 GB), in a daemon thread when the
    boot is fresh (the cost overlaps matrix load and device set-up).
    Tools call wait=True before their timed regions. Returns the byte
    count provisioned (0 when there is no arena or no recorded state).
    Disable with SPGEMM_POOL_BOOT=0."""
    global _boot_thread
    if os.environ.get("SPGEMM_POOL_BOOT", "1") == "0":
        return 0
    mm = _arena_attach()
    if mm is False:
        return 0
    spans = [(off, ln) for off, ln in _hwm_read()
             if 0 <= off and off + ln <= len(mm)]
    total = sum(ln for _, ln in spans)
    if total <= 0:
        return 0
    if _boot_thread is not None:
        if wait:
            _boot_thread.join()
        return total
    base = _arena_base()
    chunk = 256 << 20
    t0 = time.perf_counter()
    first_off, first_ln = spans[0]
    head = min(chunk, first_ln)
    _madvise_populate_write(base + first_off, head)
    warm = (time.perf_counter() - t0) < 0.5
    rest = [(first_off + head, first_ln - head)] + spans[1:]

    def _populate_rest():
        for off, ln in rest:
            for o in range(off, off + ln, chunk):
                _madvise_populate_write(base + o, min(chunk, off + ln - o))

    if warm or wait:
        _populate_rest()
        return total
    _boot_thread = threading.Thread(target=_populate_rest, daemon=True,
                                    name="spgemm-pool-provision")
    _boot_thread.start()
    return total


def pool_array(shape, dtype, *, zero: bool = False, fill=None):
    """Process-level big-buffer pool over the shared-memory arena (see
    _arena_attach for the host-memory model). numpy frees large arrays
    with munmap, so without a pool every plan build re-pays page
    population. Buffers here are never unmapped; one is reused when no
    references outside the pool remain (checked via sys.getrefcount on
    the base buffer — plan arrays returned to callers keep their buffer
    checked out until the plan is dropped)."""
    import sys

    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    best = None
    for buf in _POOL:
        if buf.nbytes >= nbytes and sys.getrefcount(buf) == 3:
            # 3 == pool entry + loop variable + getrefcount argument
            if best is None or buf.nbytes < best.nbytes:
                best = buf
    if best is None:
        cap = 1 << max(20, (max(nbytes, 1) - 1).bit_length())
        best = _new_buffer(cap)
        _POOL.append(best)
    arr = best[:nbytes].view(dtype).reshape(shape)
    if zero or fill is not None:
        # the fill touches every byte anyway: populate first (16 GB/s
        # on provisioned tmpfs) so the fill's stores hit mapped pages
        # instead of minor-faulting per 4 KB (~4 GB/s)
        _madvise_populate_write(best.ctypes.data, nbytes)
        arr.fill(0 if zero else fill)
    return arr


def pool_prewarm(nbytes: int, parts: int = 4,
                 part_cap: int | None = None) -> None:
    """Populate ~nbytes of pool memory up front, so the first plan
    build's timed region doesn't include page population. With the
    shared arena this is one sparse touch (one write per 4 KB page) of
    the arena prefix — minor faults onto page-cache pages on a warm
    boot (~2-4 GB/s), VMM provisioning once per VM boot. parts/part_cap
    are kept for the anon-fallback path, where each buffer's CAPACITY
    must cover the largest single plan-array request (pow2-rounded) or
    the first build allocates fresh unfaulted buffers."""
    mm = _arena_attach()
    if mm is not False:
        pool_boot_provision(wait=True)  # prior processes' carve ranges
        want = min(max(nbytes, part_cap or 0), len(mm))
        view = np.frombuffer(mm, np.uint8, count=want)
        _madvise_populate_write(view.ctypes.data, want)
        return
    per = 1 << max(20, (max(nbytes // parts, 1) - 1).bit_length())
    cap = per if part_cap is None else \
        1 << max(20, (max(part_cap, per) - 1).bit_length())
    held = []
    for _ in range(parts):
        buf = pool_array((cap,), np.uint8)
        buf[:per].fill(0)  # fault only the expected touched prefix
        held.append(buf)
    del held


def esc_plan_request_bytes(a, b, group_rows: int = 1) -> int:
    """Largest single pool_array request (bytes) the scan-plan build
    will make for (a, b) — pool_prewarm's part_cap must cover this or
    the first build allocates fresh (unfaulted) buffers and pays the
    host's ~11 s/GB first-touch cost inside the timed region. Mirrors
    esc_scan_symbolic_native's r_ub / ub_total bounds."""
    blen = np.diff(np.asarray(b.indptr, np.int64))
    aj = np.asarray(a.indices, np.int64)
    ai = np.asarray(a.indptr, np.int64)
    cs0 = np.zeros(aj.size + 1, np.int64)
    np.cumsum(blen[aj], out=cs0[1:])
    flops = int(cs0[-1])
    from spgemm_tpu.ops.esc import ROW_ALIGN

    row_f = cs0[ai[1:]] - cs0[ai[:-1]]
    ub_total = max(1, int(np.minimum(row_f, b.n).sum()))
    n_win_ub = ub_total // 128 + 1
    r_ub = (flops + 127) // 128 + n_win_ub * group_rows + ROW_ALIGN
    return max(r_ub * 128 * 4, ub_total * 4, (n_win_ub + 1) * 8)


def esc_scan_symbolic_native(a, b, keep_sources: bool = True,
                             group_rows: int = 1):
    """Native symbolic for the scan-mode ESC kernel (ops/esc.py
    ScanPlan): dest-sorted (R, 128) row layout, run-start index map.
    keep_sources=False skips the a_src/b_src maps (write streams the
    one-shot f32 multiply doesn't need). Returns the
    _esc_scan_symbolic_numpy tuple or None.

    ONE native call (esc_scan_build): symbolic walk, incremental window
    layout and the sequential-write fill are fused — see the design
    notes in native/csr2tile.cpp and tools/profile_esc_plan.py.
    c_indices and the planes are pool-backed (pool_array) and sized at
    cheap upper bounds; untouched tail pages cost nothing."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "esc_scan_build"):
        return None
    lib.esc_scan_build.restype = ctypes.c_int64

    m, n = a.m, b.n
    ai = np.ascontiguousarray(a.indptr, np.int32)
    aj = np.ascontiguousarray(a.indices, np.int32)
    bi = np.ascontiguousarray(b.indptr, np.int32)
    bj = np.ascontiguousarray(b.indices, np.int32)

    # per-row product counts -> F and the nnzC upper bound (vectorized)
    blen = np.diff(bi.astype(np.int64))
    cs0 = np.zeros(aj.size + 1, np.int64)
    np.cumsum(blen[aj], out=cs0[1:])
    flops = int(cs0[-1])
    from spgemm_tpu.ops.esc import ROW_ALIGN

    if flops == 0:
        # empty product stream: mirror the NumPy fallback's layout
        # (ROW_ALIGN-padded zero planes, single empty window)
        zf = np.zeros((ROW_ALIGN, 128), np.float32)
        zi = np.zeros((ROW_ALIGN, 128), np.int32)
        asrc = bsrc = (zi if keep_sources else None)
        return (np.zeros(m + 1, np.int64), np.zeros(0, np.int32), 0,
                zf, zi, np.zeros(2, np.int64), asrc, bsrc, 1)

    row_f = cs0[ai[1:].astype(np.int64)] - cs0[ai[:-1].astype(np.int64)]
    ub_total = max(1, int(np.minimum(row_f, n).sum()))
    n_win_ub = ub_total // 128 + 1
    # every window may pad up to group_rows-1 extra rows
    r_ub = ((flops + 127) // 128 + n_win_ub * group_rows + ROW_ALIGN)

    c_indptr = np.zeros(m + 1, np.int32)
    c_indices = pool_array((ub_total,), np.int32)
    # planes arrive UNINITIALIZED: esc_scan_build writes every row in
    # [0, r_total) exactly once via its NT-store arena flush (a
    # host-side pre-zero over the loose r_ub bound cost multi-GB
    # memsets — 40+ s at cant scale). Only the [r_total:r_pad] tail is
    # cleared here after the call.
    qv = pool_array((r_ub, 128), np.float32)
    meta = pool_array((r_ub, 128), np.int32)
    if keep_sources:
        asrc = pool_array((r_ub, 128), np.int32)
        bsrc = pool_array((r_ub, 128), np.int32)
    else:
        asrc = bsrc = np.zeros(1, np.int32)  # dummy target
    win_rowptr_buf = pool_array((n_win_ub + 1,), np.int64)
    stats = np.zeros(8, np.int64)  # [0]=max_run [1]=r_total [2:7]=stage tsc
    ad = np.ascontiguousarray(a.data, np.float64)
    bd = np.ascontiguousarray(b.data, np.float64)
    nnz_c = int(lib.esc_scan_build(
        _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
        _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(m), ctypes.c_int64(n),
        _ptr(c_indptr, I32), _ptr(c_indices, I32),
        _ptr(qv, F32), _ptr(meta, I32),
        _ptr(asrc, I32), _ptr(bsrc, I32),
        ctypes.c_int64(1 if keep_sources else 0),
        ctypes.c_int64(group_rows),
        ctypes.c_int64(r_ub),
        _ptr(win_rowptr_buf, I64), _ptr(stats, I64)))

    # stage breakdown (TSC tick totals; fractions locate the hot stage —
    # read by tools/profile_esc_plan.py)
    global last_scan_build_stages
    last_scan_build_stages = dict(zip(
        ("walk", "extract", "layout", "scatter", "flush"),
        (int(v) for v in stats[2:7])))

    n_win = max(1, -(-nnz_c // 128))
    win_rowptr = win_rowptr_buf[: n_win + 1]
    # pad R to the row alignment; clear the (< ROW_ALIGN-row) tail the
    # native build never touched (the trim's win_rowptr never reaches
    # it, but the scan streams it)
    r_total = int(stats[1])
    r_pad = -(-r_total // ROW_ALIGN) * ROW_ALIGN
    qv, meta = qv[:r_pad], meta[:r_pad]
    qv[r_total:] = 0.0
    meta[r_total:] = 0
    if keep_sources:
        asrc, bsrc = asrc[:r_pad], bsrc[:r_pad]
        asrc[r_total:] = -1
        bsrc[r_total:] = 0
    else:
        asrc = bsrc = None
    return (c_indptr.astype(np.int64), c_indices[:nnz_c], flops, qv, meta,
            win_rowptr, asrc, bsrc, max(1, int(stats[0])))


U16 = ctypes.POINTER(ctypes.c_uint16)
F32 = ctypes.POINTER(ctypes.c_float)


def esc_refresh_qv_native(asrc, bsrc, a_data, b_data, out=None):
    """Fused gather-multiply-round refresh of a ScanPlan's qv plane
    (pattern fixed, new values). Returns the f32 plane or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "esc_refresh_qv"):
        return None
    asrc = np.ascontiguousarray(asrc, np.int32)
    bsrc = np.ascontiguousarray(bsrc, np.int32)
    ad = np.ascontiguousarray(a_data, np.float64)
    bd = np.ascontiguousarray(b_data, np.float64)
    if out is None:
        out = pool_array(asrc.shape, np.float32)
    lib.esc_refresh_qv(
        _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(asrc.size), _ptr(out, F32))
    return out


def esc_refresh_dd_native(asrc, bsrc, a_data, b_data):
    """Double-double refresh: exact f64 products split into (hi, lo)
    f32 planes. Returns (hi, lo) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "esc_refresh_dd"):
        return None
    asrc = np.ascontiguousarray(asrc, np.int32)
    bsrc = np.ascontiguousarray(bsrc, np.int32)
    ad = np.ascontiguousarray(a_data, np.float64)
    bd = np.ascontiguousarray(b_data, np.float64)
    hi = pool_array(asrc.shape, np.float32)
    lo = pool_array(asrc.shape, np.float32)
    lib.esc_refresh_dd(
        _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(asrc.size), _ptr(hi, F32), _ptr(lo, F32))
    return hi, lo


def esc_gather_planes_native(asrc, bsrc, a_data, b_data):
    """Separate (av, bv) f32 operand planes for the in-kernel-multiply
    scan variant. Returns (av, bv) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "esc_gather_planes"):
        return None
    asrc = np.ascontiguousarray(asrc, np.int32)
    bsrc = np.ascontiguousarray(bsrc, np.int32)
    ad = np.ascontiguousarray(a_data, np.float64)
    bd = np.ascontiguousarray(b_data, np.float64)
    av = pool_array(asrc.shape, np.float32)
    bv = pool_array(asrc.shape, np.float32)
    lib.esc_gather_planes(
        _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(asrc.size), _ptr(av, F32), _ptr(bv, F32))
    return av, bv


def pack_tiles_native(t):
    """Native packing of a TileMat's dense tile blocks (f32 values + bf16
    occupancy), (nt, tm, tn) each. Returns (val, occ) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pack_tiles_dense"):
        return None
    import jax.numpy as _jnp

    tnnz = np.ascontiguousarray(t.tnnz_ptr, dtype=np.int32)
    rc = np.ascontiguousarray(t.rc, dtype=np.int32)
    val = np.ascontiguousarray(t.val, dtype=np.float64)
    out_val = np.zeros((t.nt, t.tm, t.tn), dtype=np.float32)
    out_occ16 = np.zeros((t.nt, t.tm, t.tn), dtype=np.uint16)
    lib.pack_tiles_dense(
        _ptr(tnnz, I32), _ptr(rc, I32), _ptr(val, F64),
        ctypes.c_int64(t.nt), ctypes.c_int64(t.tm * t.tn),
        _ptr(out_val, F32), _ptr(out_occ16, U16),
    )
    return out_val, out_occ16.view(_jnp.bfloat16)




