// Native CSR <-> tile converters: the framework's host-side format hot
// path, the functional equivalent of the reference's OpenMP converters
// (`src/csr2tile.h:205-506`, `src/tile2csr.h:8-140`) re-written as two
// fused passes with per-thread tile-column maps.
//
// Exposed via a C ABI consumed through ctypes (spgemm_tpu/utils/native.py).
// Layout contract matches spgemm_tpu.models.tile.TileMat:
//   tiles sorted by (tile_row, tile_col); intra-tile nonzeros row-major;
//   rc = ri*tn + ci (int32); masks uint32 LSB-first, ceil(tn/32) words
//   per intra-tile row; rowptr (nt, tm+1) int32.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC csr2tile.cpp -o libspgemmtile.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__SSE2__)
#include <immintrin.h>
#endif

#if defined(__linux__)
#include <sys/mman.h>
#endif
#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23  // Linux 5.14+; madvise fails cleanly before
#endif

namespace {
// Monotone populate-ahead cursor for a stream destination. The output
// planes are pool buffers sized at loose upper bounds, so the Python
// side cannot pre-populate them (it would write tens of GB nobody
// touches); the writer knows the exact range it is about to stream
// into. MADV_POPULATE_WRITE maps provisioned tmpfs pages at ~16 GB/s;
// without it every 4 KB page minor-faults inside the NT-store loop,
// draining the write-combining buffers (~4 GB/s warm, ~0.4 GB/s when
// the page also needs the VMM's once-per-boot provisioning).
struct PopCursor {
  char* base = nullptr;
  int64_t limit = 0;  // buffer size in bytes (clamps the chunking)
  int64_t done = 0;   // bytes populated so far
  static constexpr int64_t kChunk = 64 << 20;  // amortize the syscall
  void ensure(int64_t end) {
#if defined(__linux__)
    if (end <= done || base == nullptr) return;
    const int64_t page = 4096;
    int64_t lo = done & ~(page - 1);
    int64_t hi = std::min(std::max(end, done + kChunk), limit);
    hi = (hi + page - 1) & ~(page - 1);
    uintptr_t a0 = ((uintptr_t)base + lo + page - 1) & ~(uintptr_t)(page - 1);
    uintptr_t a1 = std::min(((uintptr_t)base + hi) & ~(uintptr_t)(page - 1),
                            ((uintptr_t)base + limit) & ~(uintptr_t)(page - 1));
    if (a1 > a0) madvise((void*)a0, a1 - a0, MADV_POPULATE_WRITE);
    done = hi;
#else
    (void)end;
#endif
  }
};
}  // namespace

extern "C" {

// Phase A: count non-empty tiles per tile-row. Writes tptr (gm+1,
// exclusive scan) and returns total tile count.
int64_t csr2tile_count(
    const int32_t* indptr, const int32_t* indices,
    int64_t m, int64_t n, int64_t tm, int64_t tn,
    int32_t* tptr /* gm+1 */) {
  const int64_t gm = (m + tm - 1) / tm;
  const int64_t gn = (n + tn - 1) / tn;
  // tile dims are powers of two in practice; int division by a runtime
  // divisor costs ~25 cycles/op and dominated the converter (measured
  // ~6 divisions/nnz). The p2 ternaries below are loop-invariant, so
  // -O3 unswitches them into shift-only loops.
  const bool p2 = (tn & (tn - 1)) == 0;
  const int sh = __builtin_ctzll((uint64_t)tn);

#pragma omp parallel
  {
    std::vector<int32_t> stamp(gn, -1);
#pragma omp for schedule(dynamic, 8)
    for (int64_t bi = 0; bi < gm; ++bi) {
      int32_t cnt = 0;
      const int64_t r0 = bi * tm;
      const int64_t r1 = r0 + tm < m ? r0 + tm : m;
      for (int64_t r = r0; r < r1; ++r) {
        for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          const int64_t c = indices[p];
          const int64_t tc = p2 ? (c >> sh) : (c / tn);
          if (stamp[tc] != (int32_t)bi) {
            stamp[tc] = (int32_t)bi;
            ++cnt;
          }
        }
      }
      tptr[bi + 1] = cnt;
    }
  }
  tptr[0] = 0;
  for (int64_t i = 0; i < gm; ++i) tptr[i + 1] += tptr[i];
  return tptr[gm];
}

// Phase B: fill all tile arrays. Caller allocates based on phase A's nt.
void csr2tile_fill(
    const int32_t* indptr, const int32_t* indices, const double* data,
    int64_t m, int64_t n, int64_t tm, int64_t tn,
    const int32_t* tptr,
    int32_t* trow, int32_t* tcol,          // (nt,)
    int32_t* tnnz_ptr,                     // (nt+1,) exclusive scan
    int32_t* rowptr,                       // (nt, tm+1)
    uint32_t* mask,                        // (nt, tm, mw)
    int32_t* rc,                           // (nnz,)
    double* val) {                         // (nnz,)
  const int64_t gm = (m + tm - 1) / tm;
  const int64_t gn = (n + tn - 1) / tn;
  const int64_t mw = (tn + 31) / 32;
  const int64_t nt = tptr[gm];
  const bool p2 = (tn & (tn - 1)) == 0;
  const int sh = __builtin_ctzll((uint64_t)tn);

  // pass 1: ONE walk of the row block's nonzeros that both discovers the
  // distinct tile cols (first-seen order) and counts per-(tile, intra-row)
  // nonzeros into a first-seen-ordinal scratch; the sorted permutation is
  // applied to the small per-tile count blocks afterwards. Mask bits are
  // set in pass 2 (which touches every nonzero anyway), so fill walks the
  // nnz twice total instead of three times.
#pragma omp parallel
  {
    std::vector<int32_t> ord(gn, -1);     // tile col -> first-seen ordinal
    std::vector<int32_t> cnt;             // (local ordinal, ri) -> count
#pragma omp for schedule(dynamic, 8)
    for (int64_t bi = 0; bi < gm; ++bi) {
      const int32_t base = tptr[bi];
      const int32_t ntiles = tptr[bi + 1] - base;
      if ((int64_t)cnt.size() < (int64_t)ntiles * tm)
        cnt.resize((int64_t)ntiles * tm);
      const int64_t r0 = bi * tm;
      const int64_t r1 = r0 + tm < m ? r0 + tm : m;
      int32_t seen = 0;
      for (int64_t r = r0; r < r1; ++r) {
        const int64_t ri = r - r0;
        for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          const int64_t c = indices[p];
          const int64_t tc = p2 ? (c >> sh) : (c / tn);
          int32_t o = ord[tc];
          if (o < 0) {
            o = seen++;
            ord[tc] = o;
            tcol[base + o] = (int32_t)tc;   // first-seen order for now
            memset(cnt.data() + (int64_t)o * tm, 0, tm * sizeof(int32_t));
          }
          ++cnt[(int64_t)o * tm + ri];
        }
      }
      // sort the (small) tile-col list: insertion sort
      for (int32_t i = 1; i < ntiles; ++i) {
        int32_t key = tcol[base + i];
        int32_t j = i - 1;
        while (j >= 0 && tcol[base + j] > key) {
          tcol[base + j + 1] = tcol[base + j];
          --j;
        }
        tcol[base + j + 1] = key;
      }
      // scatter the per-tile count blocks into rowptr in sorted order;
      // ord[tc] still holds each tile's first-seen ordinal.
      for (int32_t i = 0; i < ntiles; ++i) {
        trow[base + i] = (int32_t)bi;
        const int32_t fo = ord[tcol[base + i]];
        int32_t* rp = rowptr + (int64_t)(base + i) * (tm + 1);
        rp[0] = 0;
        memcpy(rp + 1, cnt.data() + (int64_t)fo * tm, tm * sizeof(int32_t));
      }
      for (int32_t i = 0; i < ntiles; ++i) ord[tcol[base + i]] = -1;
    }
  }

  // scan rowptr per tile and build tnnz_ptr
  tnnz_ptr[0] = 0;
  for (int64_t t = 0; t < nt; ++t) {
    int32_t* rp = rowptr + t * (tm + 1);
    for (int64_t i = 0; i < tm; ++i) rp[i + 1] += rp[i];
    tnnz_ptr[t + 1] = tnnz_ptr[t] + rp[tm];
  }

  // pass 2: scatter values/rc using per-(tile,row) cursors
#pragma omp parallel
  {
    std::vector<int32_t> ord(gn, -1);
    std::vector<int32_t> cursor;          // per local tile-row block
#pragma omp for schedule(dynamic, 8)
    for (int64_t bi = 0; bi < gm; ++bi) {
      const int32_t base = tptr[bi];
      const int32_t ntiles = tptr[bi + 1] - base;
      for (int32_t i = 0; i < ntiles; ++i) ord[tcol[base + i]] = base + i;
      const int64_t r0 = bi * tm;
      const int64_t r1 = r0 + tm < m ? r0 + tm : m;
      for (int64_t r = r0; r < r1; ++r) {
        const int64_t ri = r - r0;
        // per-row cursor within each tile: nonzeros arrive in ascending
        // column order inside a row, so a running cursor per tile row
        // preserves row-major intra-tile order.
        for (int32_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          const int64_t c = indices[p];
          const int64_t ci = p2 ? (c & (tn - 1)) : (c % tn);
          const int32_t t = ord[p2 ? (c >> sh) : (c / tn)];
          int32_t* rp = rowptr + (int64_t)t * (tm + 1);
          const int64_t pos = tnnz_ptr[t] + rp[ri]++;
          rc[pos] = (int32_t)(ri * tn + ci);
          val[pos] = data[p];
          mask[((int64_t)t * tm + ri) * mw + (ci >> 5)] |=
              (uint32_t)1 << (ci & 31);
        }
      }
      for (int32_t i = 0; i < ntiles; ++i) ord[tcol[base + i]] = -1;
    }
  }

  // rowptr was advanced by the cursors; shift back (rp[i] now equals the
  // old rp[i+1], so rebuild by right-shifting with leading zero)
#pragma omp parallel for schedule(static)
  for (int64_t t = 0; t < nt; ++t) {
    int32_t* rp = rowptr + t * (tm + 1);
    for (int64_t i = tm; i > 0; --i) rp[i] = rp[i - 1];
    rp[0] = 0;
  }
}

// tile -> CSR: rebuild plain CSR (rows sorted, cols sorted within rows).
void tile2csr(
    const int32_t* trow, const int32_t* tcol, const int32_t* tnnz_ptr,
    const int32_t* rowptr, const int32_t* rc, const double* val,
    int64_t nt, int64_t m, int64_t tm, int64_t tn,
    int32_t* indptr /* m+1, zeroed */, int32_t* indices, double* data) {
  // count per global row
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t r0 = (int64_t)trow[t] * tm;
    const int32_t* rp = rowptr + t * (tm + 1);
    for (int64_t i = 0; i < tm; ++i) {
      const int64_t gr = r0 + i;
      if (gr < m) indptr[gr + 1] += rp[i + 1] - rp[i];
    }
  }
  for (int64_t i = 0; i < m; ++i) indptr[i + 1] += indptr[i];
  std::vector<int32_t> cur(indptr, indptr + m);
  // tiles are sorted (trow, tcol) and intra-tile rows are col-sorted, so
  // appending in tile order keeps columns sorted per row.
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t r0 = (int64_t)trow[t] * tm;
    const int64_t c0 = (int64_t)tcol[t] * tn;
    const int32_t* rp = rowptr + t * (tm + 1);
    for (int64_t i = 0; i < tm; ++i) {
      const int64_t gr = r0 + i;
      for (int32_t p = rp[i]; p < rp[i + 1]; ++p) {
        const int64_t q = tnnz_ptr[t] + p;
        indices[cur[gr]] = (int32_t)(
            c0 + (((tn & (tn - 1)) == 0) ? (rc[q] & (tn - 1))
                                         : (rc[q] % tn)));
        data[cur[gr]] = val[q];
        ++cur[gr];
      }
    }
  }
}

// -------------------------------------------------------------------------
// Device-operand packing for the tile-pair kernel (the framework's
// analogue of the reference's H2D staging,
// `src/tilespgemm-cuda.h:2255-2324`): dense per-tile value blocks (f32)
// and occupancy blocks (bfloat16 bit pattern 0x3F80 = 1.0f, written as
// uint16), (nt, tm*tn) in tile order. Caller passes zeroed buffers.
// -------------------------------------------------------------------------

void pack_tiles_dense(
    const int32_t* tnnz_ptr, const int32_t* rc, const double* val,
    int64_t nt, int64_t tile_elems,
    float* out_val, uint16_t* out_occ) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t t = 0; t < nt; ++t) {
    float* dv = out_val + t * tile_elems;
    uint16_t* doq = out_occ + t * tile_elems;
    for (int32_t p = tnnz_ptr[t]; p < tnnz_ptr[t + 1]; ++p) {
      dv[rc[p]] = (float)val[p];
      doq[rc[p]] = 0x3F80;  // bfloat16 1.0
    }
  }
}

// --- ESC symbolic (unstructured engine, ops/esc.py) -----------------------
// The host half of the digit-ESC engine: the role the reference fills
// with nsparse's GPU hash tables (`src/spgemm_nsparse_kernel.h:1171-1438`).
// Three O(flops) passes with a per-row stamp map:
//   1. esc_pattern_count  — C's structural row pointer (merge count)
//   2. esc_products_count — C's sorted column indices + products per
//                           S-slot interval of C's value array
//   3. esc_fill           — per-product (group, slot) assignment written
//                           straight into the padded per-class operand
//                           streams (counting sort, sibling splits)

// Pass 1: structural pattern count. Fills c_indptr (m+1, exclusive scan),
// returns nnzC.
int64_t esc_pattern_count(
    const int32_t* a_indptr, const int32_t* a_indices,
    const int32_t* b_indptr, const int32_t* b_indices,
    int64_t m, int64_t n, int32_t* c_indptr /* m+1 */) {
  std::vector<int64_t> stamp(n, -1);
  c_indptr[0] = 0;
  int64_t total = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t cnt = 0;
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        const int32_t j = b_indices[q];
        if (stamp[j] != i) {
          stamp[j] = i;
          ++cnt;
        }
      }
    }
    total += cnt;
    c_indptr[i + 1] = (int32_t)total;
  }
  return total;
}

// Pass 2: fill c_indices (sorted columns per row) and count products per
// S-slot interval of C's value array. Returns the total product count F.
int64_t esc_products_count(
    const int32_t* a_indptr, const int32_t* a_indices,
    const int32_t* b_indptr, const int32_t* b_indices,
    int64_t m, int64_t n, const int32_t* c_indptr,
    int32_t* c_indices /* nnzC */, int64_t s_slots,
    int64_t* prod_cnt /* ceil(nnzC/s_slots) */) {
  std::vector<int64_t> stamp(n, -1);
  std::vector<int32_t> pos(n);
  int64_t flops = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t base = c_indptr[i];
    int32_t cnt = 0;
    int32_t* cols = c_indices + base;
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        const int32_t j = b_indices[q];
        if (stamp[j] != i) {
          stamp[j] = i;
          cols[cnt++] = j;
        }
      }
    }
    std::sort(cols, cols + cnt);
    for (int32_t t = 0; t < cnt; ++t) pos[cols[t]] = t;
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        const int64_t dest = base + pos[b_indices[q]];
        ++prod_cnt[dest / s_slots];
        ++flops;
      }
    }
  }
  return flops;
}

// Pass 3: write every product's (a index, b index, slot) into its final
// padded position. sib_ptr/sib_base encode the caller-computed sibling
// and width-class layout: interval g's products go, in A-order, to
// siblings sib_ptr[g], sib_ptr[g]+1, ... in chunks of f_max; sibling s
// occupies flat positions [sib_base[s], sib_base[s] + its class width).
void esc_fill(
    const int32_t* a_indptr, const int32_t* a_indices,
    const int32_t* b_indptr, const int32_t* b_indices,
    const double* a_data, const double* b_data,
    int64_t m, int64_t n, const int32_t* c_indptr,
    const int32_t* c_indices, int64_t s_slots, int64_t f_max,
    const int64_t* sib_ptr, const int64_t* sib_base,
    int64_t num_intervals,
    int32_t* asrc, int32_t* bsrc, int32_t* slot,
    double* av, double* bv) {
  std::vector<int32_t> pos(n);
  std::vector<int64_t> counter(num_intervals, 0);
  for (int64_t i = 0; i < m; ++i) {
    const int64_t base = c_indptr[i];
    const int32_t cnt = c_indptr[i + 1] - c_indptr[i];
    for (int32_t t = 0; t < cnt; ++t) {
      pos[c_indices[base + t]] = t;
    }
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      const double aval = a_data[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        const int64_t dest = base + pos[b_indices[q]];
        const int64_t g = dest / s_slots;
        const int64_t c = counter[g]++;
        const int64_t off = sib_base[sib_ptr[g] + c / f_max] + c % f_max;
        asrc[off] = p;
        bsrc[off] = q;
        slot[off] = (int32_t)(dest - g * s_slots);
        av[off] = aval;
        bv[off] = b_data[q];
      }
    }
  }
}

// --- scan-mode ESC symbolic (ops/esc.py ScanPlan) --------------------------
// Lays every partial product out dest-SORTED in (row, lane) form: window
// w = dest/128 of C's value array; its products, counting-sorted by
// dest, fill consecutive 128-lane rows. The device kernel then reduces
// runs with a lane suffix-scan + dynamic_gather. Same role as the
// reference's per-bin numeric launches (`tilespgemm-cuda.h:2649-2728`).
//
// Host-memory model this is built for (measured, tools/profile_esc_plan
// .py round 2 -> 3): random 4 B writes ~7 M/s (49 M/s with hugepages),
// sequential streams ~10 GB/s, and FIRST-TOUCH of new memory is backed
// by the virtualized host at only ~90 MB/s — so the build is ONE fused
// pass that (a) walks the F products exactly once, (b) writes each
// plane position exactly once through a cache-resident interleaved
// assembly arena flushed with non-temporal stores (no plane memset, no
// write-allocate reads, no read-modify-write to DRAM), and (c) touches
// the minimum footprint (no per-product dest stream, no global
// dup/perm arrays — all row-local scratch). Window layout is computed
// incrementally: dests are enumerated strictly monotonically, so
// win_rowptr is a running state, not a separate pass.
// rmat65536 (399 M products), warm pool, keep_sources=True: 116 s
// (round 2) -> 9.2 s (radix fill) -> 6.7 s (arena fill + fused DestCur
// scatter, 59 M prod/s; 5.35 s / 75 M prod/s without source maps).
// Stage split without sources: walk 37%, extract 13%, layout 20%,
// scatter 19%, flush 11% (tools/profile_esc_plan.py). Cold first build
// after prewarm also improves, 75 s -> ~45 s (arena vectors are the
// only remaining first-touch surface).

}  // extern "C" — the helpers below are templates / overloads

namespace {
// Interleaved plane cells: one random 8/16 B write per product lands
// qv+meta (+asrc/bsrc) together in one cache line, and the flush
// de-interleaves them into the output planes as pure sequential
// streams. The planes themselves are never memset and never read.
struct Cell { float pv; int32_t mt; };
struct CellS { float pv; int32_t mt; int32_t p, q; };

// Per-dest placement, seeded by the layout pass and READ-ONLY in the
// scatter pass: pos = start + rank, where rank (the product's arrival
// ordinal within its dest) is emitted by the dup-count pass. A
// read-only 16-B load replaced the earlier cur++ read-modify-write —
// 399 M random stores gone from the rmat65536 build.
struct DestCur { int64_t start; int64_t end_slot; };  // end<<7 | slot

// One C row's product scatter into the assembly arena, templated on
// the rank width (u16 when the row's A-nnz <= 65535, so dup fits) and
// the cell type (sources or not).
template <typename RankT, typename CellT>
inline void scan_scatter_row(
    const int32_t* a_indptr, const int32_t* a_indices,
    const int32_t* b_indptr, const double* a_data, const double* b_data,
    int64_t i, int64_t f_row, const uint32_t* dls, const RankT* rks,
    const DestCur* dc, CellT* cells, int64_t abase) {
  int64_t x = 0;
  for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
    const int32_t k = a_indices[p];
    const double aval = a_data[p];
    const int32_t q0 = b_indptr[k], q1 = b_indptr[k + 1];
    for (int32_t q = q0; q < q1; ++q, ++x) {
      if (x + 8 < f_row) __builtin_prefetch(&dc[dls[x + 8]], 0, 3);
      const DestCur d = dc[dls[x]];
      const int64_t pos = d.start + rks[x];
      const int64_t dist = std::min<int64_t>(
          (d.end_slot >> 7) - 1 - pos, 127 - (pos & 127));
      CellT& c = cells[pos - abase];
      c.pv = (float)(aval * b_data[q]);
      c.mt |= (int32_t)((d.end_slot & 127) | (dist << 15));
      if constexpr (sizeof(CellT) == sizeof(CellS)) {
        c.p = p;
        c.q = q;
      }
    }
  }
}

// Cheap stage clock for the build profiler (tools/profile_esc_plan.py):
// raw TSC ticks — consumers only use stage *fractions* of the total, so
// no frequency calibration is needed.
inline uint64_t stage_tsc() {
#if defined(__x86_64__) || defined(__i386__)
  return __builtin_ia32_rdtsc();
#else
  return 0;
#endif
}

// De-interleave `nrows` 128-lane rows of cells into the output planes.
// Non-temporal stores: the planes are written exactly once and not
// read again on the host, so skipping the write-allocate read halves
// the DRAM traffic of this pass.
inline void flush_rows(const Cell* src, int64_t nrows,
                       float* qv, int32_t* mt) {
#if defined(__SSE2__)
  if (!(((uintptr_t)qv | (uintptr_t)mt) & 15)) {
    const int64_t cnt = nrows * 128;
    for (int64_t i = 0; i < cnt; i += 4) {
      const __m128 a = _mm_load_ps((const float*)(src + i));      // p0 m0 p1 m1
      const __m128 b = _mm_load_ps((const float*)(src + i + 2));  // p2 m2 p3 m3
      _mm_stream_ps(qv + i, _mm_shuffle_ps(a, b, 0x88));
      _mm_stream_si128((__m128i*)(mt + i),
                       _mm_castps_si128(_mm_shuffle_ps(a, b, 0xDD)));
    }
    _mm_sfence();
    return;
  }
#endif
  for (int64_t i = 0; i < nrows * 128; ++i) {
    qv[i] = src[i].pv;
    mt[i] = src[i].mt;
  }
}

inline void flush_rows(const CellS* src, int64_t nrows, float* qv,
                       int32_t* mt, int32_t* ap, int32_t* bq) {
#if defined(__SSE2__)
  if (!(((uintptr_t)qv | (uintptr_t)mt | (uintptr_t)ap |
         (uintptr_t)bq) & 15)) {
    const int64_t cnt = nrows * 128;
    for (int64_t i = 0; i < cnt; i += 4) {
      __m128 r0 = _mm_load_ps((const float*)(src + i));
      __m128 r1 = _mm_load_ps((const float*)(src + i + 1));
      __m128 r2 = _mm_load_ps((const float*)(src + i + 2));
      __m128 r3 = _mm_load_ps((const float*)(src + i + 3));
      _MM_TRANSPOSE4_PS(r0, r1, r2, r3);
      _mm_stream_ps(qv + i, r0);
      _mm_stream_si128((__m128i*)(mt + i), _mm_castps_si128(r1));
      _mm_stream_si128((__m128i*)(ap + i), _mm_castps_si128(r2));
      _mm_stream_si128((__m128i*)(bq + i), _mm_castps_si128(r3));
    }
    _mm_sfence();
    return;
  }
#endif
  for (int64_t i = 0; i < nrows * 128; ++i) {
    qv[i] = src[i].pv;
    mt[i] = src[i].mt;
    ap[i] = src[i].p;
    bq[i] = src[i].q;
  }
}
}  // namespace

extern "C" {

// The whole scan-plan build in one call. Per C row:
//   1. walk the row's products once: stamp map collects distinct cols
//      (first-seen ordinal), dup counts, and an 8/16 B record per
//      product (ordinal + f64-exact-rounded f32 value [+ src indices]);
//   2. sorted extraction (bitmap sweep for wide rows, std::sort
//      otherwise) -> c_indices, first-seen->sorted perm, sorted dups;
//   3. enumerate the row's dests (globally monotone): advance the
//      incremental window layout (win_rowptr), compute each dest's
//      padded offset;
//   4. stable counting scatter: per-dest cursors seeded with the
//      padded offsets place every product (and its meta marks) in one
//      write into an interleaved assembly arena; completed plane rows
//      are de-interleaved into qv/meta[/asrc/bsrc] with NT stores.
// qv/meta/asrc/bsrc may arrive UNINITIALIZED: every row in
// [0, r_total) is written exactly once by the arena flush (the caller
// clears only the [r_total:r_pad) block-padding tail).
// meta bit layout per lane: 0-6 slot (dest & 127), 7-13 run-start gather
// lane, 14 slot-present, 15-21 distance to the end of this lane's
// in-row run — the scan kernels mask each doubling pass with one
// compare (dist >= d) instead of rolling the slot tags, saving a third
// of the roll traffic.
// out_stats: [0] = max run length, [1] = rows used (unpadded R);
// [2..6] = per-stage TSC tick totals (walk, extract, layout, scatter,
// arena flush) for tools/profile_esc_plan.py — fractions of their sum
// locate the hot stage.
// Returns nnz_c.
int64_t esc_scan_build(
    const int32_t* a_indptr, const int32_t* a_indices,
    const int32_t* b_indptr, const int32_t* b_indices,
    const double* a_data, const double* b_data,
    int64_t m, int64_t n,
    int32_t* c_indptr,             // (m+1,)
    int32_t* c_indices,            // (>= nnz_c,) filled compactly
    float* qv, int32_t* meta,      // (r_ub*128,) pre-zeroed
    int32_t* asrc, int32_t* bsrc,  // want_src: prefilled -1 / 0
    int64_t want_src,
    int64_t group_rows,            // pad each window's rows to this
    int64_t r_cap,                 // plane capacity in 128-lane rows
    int64_t* win_rowptr,           // (>= n_win+1,)
    int64_t* out_stats) {          // [0]=max_run, [1]=r_total
  // stamp tag (row id) and first-seen ordinal packed into ONE u64 so
  // the hot walk makes a single random access per product (random
  // latency dominates on this host)
  std::vector<uint64_t> sta(n, ~(uint64_t)0);
  std::vector<int32_t> cols(n);
  std::vector<int32_t> dup(n);
  std::vector<uint32_t> inv(n);   // sorted ordinal -> first-seen ordinal
  // Per-dest placement, indexed by FIRST-SEEN ordinal so the product
  // loop needs no perm translation (see DestCur above).
  std::vector<DestCur> dc(n);
  const int64_t nwords = (n + 63) >> 6;
  std::vector<uint64_t> bits(nwords, 0);
  // bitmap sweep costs ~n/64 word ops; std::sort ~cnt*log2(cnt)
  const int64_t bitmap_thresh = std::max<int64_t>(64, n >> 8);
  // per-product first-seen ordinal, the walk's only output stream
  // (4 B/product; values, source indices and the padded position are
  // all regenerated in the scatter pass from the same CSR loops), plus
  // the per-product within-dest rank from the dup-count pass (u16
  // unless a row's A-nnz can push a dup past 65535)
  std::vector<uint32_t> dls;
  std::vector<uint16_t> rk16;
  std::vector<uint32_t> rk32;
  const bool want = want_src != 0;

  int64_t cur_win = 0;     // open window index
  int64_t win_used = 0;    // products assigned to it so far
  int64_t rows_alloc = 0;  // rows of all closed windows
  win_rowptr[0] = 0;
  int64_t max_run = 1;
  // Interleaved assembly arena over plane rows [ar_base, ar_base +
  // ar_rows): all O(flops) plane writes (random within a C row's
  // region) land here, then arena_flush streams completed rows out
  // with NT stores once the global write cursor has passed them. The
  // output planes never see a memset, a write-allocate read, or an
  // RMW — at rmat65536 scale that was ~12 GB of DRAM traffic (plus
  // 40+ s of first-touch on cold pool pages).
  std::vector<Cell> acell;
  std::vector<CellS> acells;
  int64_t ar_base = 0, ar_rows = 0;
  // populate-ahead cursors for the NT-store output planes (see
  // PopCursor): the flush writes rows monotonically, so each plane is
  // populated in 64 MB chunks just ahead of its write cursor
  const int64_t plane_cap = r_cap * 128 * 4;
  PopCursor pop_qv{(char*)qv, plane_cap};
  PopCursor pop_mt{(char*)meta, plane_cap};
  PopCursor pop_as{want ? (char*)asrc : nullptr, plane_cap};
  PopCursor pop_bs{want ? (char*)bsrc : nullptr, plane_cap};
  uint64_t t_walk = 0, t_extract = 0, t_layout = 0, t_scatter = 0,
           t_flush = 0;
  auto arena_extend = [&](int64_t r_end) {
    if (r_end <= ar_base + ar_rows) return;
    const int64_t need = r_end - ar_base;
    if (!want) {
      if ((int64_t)acell.size() < need * 128)
        acell.resize(std::max<int64_t>(need * 128,
                                       2 * (int64_t)acell.size()));
      memset(acell.data() + ar_rows * 128, 0,
             (size_t)(need - ar_rows) * 128 * sizeof(Cell));
    } else {
      if ((int64_t)acells.size() < need * 128)
        acells.resize(std::max<int64_t>(need * 128,
                                        2 * (int64_t)acells.size()));
      CellS* c = acells.data() + ar_rows * 128;
      const int64_t k = (need - ar_rows) * 128;
      for (int64_t x = 0; x < k; ++x) c[x] = CellS{0.0f, 0, -1, 0};
    }
    ar_rows = need;
  };
  auto arena_flush = [&](int64_t r_end) {
    // flush rows [ar_base, r_end): safe once every later write (runs
    // are globally monotone; a run's meta marks stay within the run's
    // own rows) targets rows >= r_end
    if (r_end <= ar_base) return;
    const uint64_t tf0 = stage_tsc();
    const int64_t nr = r_end - ar_base;
    const int64_t wend = r_end * 128 * 4;
    pop_qv.ensure(wend);
    pop_mt.ensure(wend);
    if (want) {
      pop_as.ensure(wend);
      pop_bs.ensure(wend);
    }
    if (!want) {
      flush_rows(acell.data(), nr, qv + ar_base * 128,
                 meta + ar_base * 128);
      memmove(acell.data(), acell.data() + nr * 128,
              (size_t)(ar_rows - nr) * 128 * sizeof(Cell));
    } else {
      flush_rows(acells.data(), nr, qv + ar_base * 128,
                 meta + ar_base * 128, asrc + ar_base * 128,
                 bsrc + ar_base * 128);
      memmove(acells.data(), acells.data() + nr * 128,
              (size_t)(ar_rows - nr) * 128 * sizeof(CellS));
    }
    ar_base = r_end;
    ar_rows -= nr;
    t_flush += stage_tsc() - tf0;
  };
  auto close_windows_until = [&](int64_t w) {
    while (cur_win < w) {
      int64_t wrows = std::max<int64_t>(1, (win_used + 127) >> 7);
      wrows = (wrows + group_rows - 1) / group_rows * group_rows;
      rows_alloc += wrows;
      arena_extend(rows_alloc);
      win_rowptr[cur_win + 1] = rows_alloc;
      ++cur_win;
      win_used = 0;
    }
  };

  c_indptr[0] = 0;
  int64_t base = 0;
  for (int64_t i = 0; i < m; ++i) {
    // scratch capacity for this row's products
    int64_t fb = 0;
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      fb += b_indptr[k + 1] - b_indptr[k];
    }
    if ((int64_t)dls.size() < fb) dls.resize(fb);
    // 1. single product walk: stamp-map collect, dup counts, and the
    // 4 B/product ordinal stream — the minimum the scatter pass needs
    const uint64_t t1_ = stage_tsc();
    int64_t cnt = 0;
    int64_t f_row = 0;
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      const int32_t qe = b_indptr[k + 1];
      for (int32_t q = b_indptr[k]; q < qe; ++q) {
        // hide the stamp map's L2 latency: the b row gives lookahead
        if (q + 8 < qe) __builtin_prefetch(&sta[b_indices[q + 8]], 1, 3);
        const int32_t j = b_indices[q];
        // branchless first-seen (~41% of rmat products open a new
        // dest: the branch mispredicts); dup counting is deferred to a
        // separate prefetched pass over dls — dup[t] here would be a
        // DEPENDENT random load (t only known after sta[j] arrives)
        const uint64_t s = sta[j];
        const bool fresh = (s >> 32) != (uint64_t)i;
        const uint32_t t = fresh ? (uint32_t)cnt : (uint32_t)s;
        sta[j] = ((uint64_t)i << 32) | t;
        cols[cnt] = j;
        cnt += fresh;
        dls[f_row++] = t;
      }
    }
    memset(dup.data(), 0, (size_t)cnt * sizeof(int32_t));
    const bool r16 = (a_indptr[i + 1] - a_indptr[i]) <= 65535;
    if (r16) {
      if ((int64_t)rk16.size() < fb) rk16.resize(fb);
      for (int64_t x = 0; x < f_row; ++x) {
        if (x + 12 < f_row) __builtin_prefetch(&dup[dls[x + 12]], 1, 3);
        rk16[x] = (uint16_t)dup[dls[x]]++;
      }
    } else {
      if ((int64_t)rk32.size() < fb) rk32.resize(fb);
      for (int64_t x = 0; x < f_row; ++x) {
        if (x + 12 < f_row) __builtin_prefetch(&dup[dls[x + 12]], 1, 3);
        rk32[x] = (uint32_t)dup[dls[x]]++;
      }
    }
    const uint64_t t2_ = stage_tsc();
    t_walk += t2_ - t1_;
    if (!cnt) {
      c_indptr[i + 1] = (int32_t)base;
      continue;
    }
    // 2. sorted extraction, two phases so the random sta lookups get a
    // flat prefetch target: (a) decode the dest set into c_indices in
    // sorted order (AVX-512 compress-store: 16 lanes per mask word
    // quarter), (b) one prefetched pass translating col -> first-seen
    // ordinal. sdup moves into the layout loop (same prefetch trick).
    int32_t* cind = c_indices + base;
    if (cnt >= bitmap_thresh) {
      for (int64_t t = 0; t < cnt; ++t)
        bits[cols[t] >> 6] |= (uint64_t)1 << (cols[t] & 63);
      int64_t s = 0;
      for (int64_t w = 0; w < nwords; ++w) {
        uint64_t word = bits[w];
        if (!word) continue;
        bits[w] = 0;
#if defined(__AVX512F__)
        const __m512i lane0 = _mm512_setr_epi32(
            0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
        __m512i v = _mm512_add_epi32(lane0, _mm512_set1_epi32(w << 6));
        const __m512i step = _mm512_set1_epi32(16);
        for (int h = 0; h < 4; ++h) {
          const __mmask16 mk = (__mmask16)(word >> (16 * h));
          _mm512_mask_compressstoreu_epi32(cind + s, mk, v);
          s += __builtin_popcount(mk);
          v = _mm512_add_epi32(v, step);
        }
#else
        while (word) {
          cind[s++] = (int32_t)((w << 6) + __builtin_ctzll(word));
          word &= word - 1;
        }
#endif
      }
    } else {
      std::sort(cols.begin(), cols.begin() + cnt);
      memcpy(cind, cols.data(), (size_t)cnt * sizeof(int32_t));
    }
    for (int64_t t = 0; t < cnt; ++t) {
      if (t + 16 < cnt) __builtin_prefetch(&sta[cind[t + 16]], 0, 3);
      inv[t] = (uint32_t)sta[cind[t]];
    }
    const uint64_t t3_ = stage_tsc();
    t_extract += t3_ - t2_;
    // 3. window layout (dests globally monotone). The run-start /
    // row-continuation meta marks are NOT written here: step 4 visits
    // every product anyway, so it emits them at orel==0 and at row
    // crossings — one pass over the (cache-resident) arena instead of
    // a second walk.
    // Window-aligned blocks: the close/extend checks leave the per-dest
    // loop, and each block splits into a dup-load pass (random loads,
    // prefetched, emitting start offsets) and a mark/seed pass (random
    // stores, prefetched) — separating the two random streams lets each
    // run at its own prefetch depth instead of serializing per dest.
    {
      int64_t t = 0;
      int64_t offbuf[129];
      while (t < cnt) {
        const int64_t d0 = base + t;
        close_windows_until(d0 >> 7);
        const int64_t blk = std::min<int64_t>(cnt - t, 128 - (d0 & 127));
        int64_t off = rows_alloc * 128 + win_used;
        for (int64_t u = 0; u < blk; ++u) {
          if (u + 8 < blk) __builtin_prefetch(&dup[inv[t + u + 8]], 0, 3);
          offbuf[u] = off;
          off += dup[inv[t + u]];
        }
        offbuf[blk] = off;
        arena_extend(((off - 1) >> 7) + 1);
        const int64_t abase_ = ar_base * 128;
        for (int64_t u = 0; u < blk; ++u) {
          if (u + 8 < blk) __builtin_prefetch(&dc[inv[t + u + 8]], 1, 3);
          const int64_t o = offbuf[u];
          const int64_t e = offbuf[u + 1];
          const int64_t slot = (d0 + u) & 127;
          const int64_t r0 = o >> 7;
          const int64_t r1 = (e - 1) >> 7;
          const int64_t run0 = std::min<int64_t>(e - o, 128 - (o & 127));
          if (run0 > max_run) max_run = run0;
          if (r1 > r0) {
            // continuation-row runs shrink monotonically; r0+1's longest
            const int64_t runr = std::min<int64_t>(e - (r0 + 1) * 128, 128);
            if (runr > max_run) max_run = runr;
          }
          // run-start / continuation meta marks, written here per DEST
          // (the scatter loop below stays branch-free per product);
          // continuation writes are bounded by F/128 + cnt in total
          int32_t* mt0 = want ? &acells[r0 * 128 + slot - abase_].mt
                              : &acell[r0 * 128 + slot - abase_].mt;
          *mt0 |= ((int32_t)(o & 127) << 7) | (1 << 14);
          for (int64_t r = r0 + 1; r <= r1; ++r) {
            int32_t* mtc = want ? &acells[r * 128 + slot - abase_].mt
                                : &acell[r * 128 + slot - abase_].mt;
            *mtc |= (1 << 14);
          }
          dc[inv[t + u]] = DestCur{o, (e << 7) | slot};
        }
        win_used = off - rows_alloc * 128;
        t += blk;
      }
    }
    const uint64_t t4_ = stage_tsc();
    t_layout += t4_ - t3_;
    // 4. stable counting scatter into the arena. Each dest's cursor
    // was seeded with its padded offset in the layout pass above —
    // that seeding IS the dest sort (stable: products arrive in
    // A-order and each cursor only advances). The product enumeration
    // is re-walked (sequential b_data reads regenerate pv and the
    // source indices), so per product this costs one 4-B dl read, one
    // random 16-B DestCur access and one arena cell write (the
    // run-start / continuation marks were emitted per dest in layout).
    const int64_t abase = ar_base * 128;
    if (!want) {
      if (r16)
        scan_scatter_row(a_indptr, a_indices, b_indptr, a_data, b_data,
                         i, f_row, dls.data(), rk16.data(), dc.data(),
                         acell.data(), abase);
      else
        scan_scatter_row(a_indptr, a_indices, b_indptr, a_data, b_data,
                         i, f_row, dls.data(), rk32.data(), dc.data(),
                         acell.data(), abase);
    } else {
      if (r16)
        scan_scatter_row(a_indptr, a_indices, b_indptr, a_data, b_data,
                         i, f_row, dls.data(), rk16.data(), dc.data(),
                         acells.data(), abase);
      else
        scan_scatter_row(a_indptr, a_indices, b_indptr, a_data, b_data,
                         i, f_row, dls.data(), rk32.data(), dc.data(),
                         acells.data(), abase);
    }
    base += cnt;
    c_indptr[i + 1] = (int32_t)base;
    t_scatter += stage_tsc() - t4_;
    // rows below the open window's write row are final — stream out
    arena_flush(rows_alloc + (win_used >> 7));
  }
  close_windows_until(base ? (base + 127) >> 7 : 1);
  arena_flush(rows_alloc);
  out_stats[0] = max_run;
  out_stats[1] = rows_alloc;
  out_stats[2] = (int64_t)t_walk;
  out_stats[3] = (int64_t)t_extract;
  out_stats[4] = (int64_t)t_layout;
  out_stats[5] = (int64_t)t_scatter;
  out_stats[6] = (int64_t)t_flush;
  return base;
}

// Pattern-fixed value refresh for ScanPlan (the ESC analogue of the
// reference's step-4-only re-run, `tilespgemm-cuda.h:2649-2728`): one
// sequential pass over the (R*128) source maps; the input value arrays
// are cache-resident (nnz * 8 B), so this runs at stream bandwidth.
void esc_refresh_qv(const int32_t* asrc, const int32_t* bsrc,
                    const double* a_data, const double* b_data,
                    int64_t total, float* qv) {
  for (int64_t i = 0; i < total; ++i) {
    const int32_t p = asrc[i];
    qv[i] = p >= 0 ? (float)(a_data[p] * b_data[bsrc[i]]) : 0.0f;
  }
}

// Double-double flavour: exact f64 product split into (hi, lo) f32.
void esc_refresh_dd(const int32_t* asrc, const int32_t* bsrc,
                    const double* a_data, const double* b_data,
                    int64_t total, float* hi, float* lo) {
  for (int64_t i = 0; i < total; ++i) {
    const int32_t p = asrc[i];
    const double prod = p >= 0 ? a_data[p] * b_data[bsrc[i]] : 0.0;
    const float h = (float)prod;
    hi[i] = h;
    lo[i] = (float)(prod - (double)h);
  }
}

// Separate operand planes for the in-kernel-multiply scan variant
// (esc_scan_mul_pallas): av/bv f32, padding lanes 0.
void esc_gather_planes(const int32_t* asrc, const int32_t* bsrc,
                       const double* a_data, const double* b_data,
                       int64_t total, float* av, float* bv) {
  for (int64_t i = 0; i < total; ++i) {
    const int32_t p = asrc[i];
    if (p >= 0) {
      av[i] = (float)a_data[p];
      bv[i] = (float)b_data[bsrc[i]];
    } else {
      av[i] = 0.0f;
      bv[i] = 0.0f;
    }
  }
}

}  // extern "C"
