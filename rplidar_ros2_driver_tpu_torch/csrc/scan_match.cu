// Correlative scan-matcher kernels of the SLAM front-end, written for
// Hopper (sm_90a).  Each entry takes N streams and launches once for all of
// them (one fleet tick).  All arithmetic is int32 and wraps like the JAX
// package's int32 (two's complement, arithmetic right shifts), so any order
// of summation — and any regrouping of a sum of products — gives the same
// bits as the plain versions.
//
// B6  coarse_scores_i32 — replaces the JAX package's TPU kernel
//     ops/pallas_scan_match.py coarse_scores_pallas (_coarse_kernel):
//     mq = clip(log_odds, 0, clamp_q) >> quant_shift, written out for B7;
//     the scan rotated to the predicted heading; every coarse translation
//     (du, dv) in ±w coarse cells scored by a 4-corner bilinear gather on
//     the c×c-max-pooled mq, summed over valid beams -> (N, U, V).
// B7  fine_scores_i32 — replaces fine_scores_pallas (_fine_kernel): per θ
//     candidate, the scan re-rotated and shifted by the coarse winner,
//     bilinear-gathered on mq over ±r cells -> (N, T, F, F), C order.
// B8  log_odds_update_i32 — replaces log_odds_update_pallas
//     (_update_kernel): cells hit by an endpoint get +hit_q, cells any of
//     the free-space samples o + (w−o)·k // S (k < S, floor division)
//     lands in get +miss_q unless hit, clamp ±clamp_q -> (N, G, G).
//
// What bounds B6 and B7 on an H100, at the config-12 fleet tick (N=4,
// G=256, B=2048, c=4, U=V=5, T=13, F=9) and the map replay's (N=1): the
// bytes are small (B6 reads 1 MiB of log-odds and writes 1 MiB of mq, about
// 0.6 us of HBM time; B7 reads mq from L2); the work is the gathers and
// their int32 arithmetic, 52 × 2048 (θ, beam) pairs × 81 candidates for B7.
// Their first design (one block per (θ, stream) or (u, stream), 52 and 20
// blocks at config 12, 13 and 5 at N=1) was bound by latency: at most 52 of
// the 132 SMs busy, a 5-step shuffle reduction and a shared atomic per
// candidate per 32 beams, 180 L2 loads per (θ, beam) of which 100 were
// distinct, and B6 pooling 16 log-odds cells for each of 36 corners per
// beam.  The design now:
//
//   * Fill the card with thread block clusters.  Each (θ, stream) of B7 and
//     each stream of B6 is one cluster of K blocks; block k takes beams
//     [k·⌈B/K⌉, (k+1)·⌈B/K⌉), so a block may have none (B < K).  The
//     wrapper's plan picks K and the block size: B7 256 threads and the
//     largest power of two K ≤ 8 whose blocks fit one wave with room for
//     whole clusters (4 × 52 = 208 blocks at config 12, 8 × 13 = 104 at
//     N=1: a beam or two per thread); B6 8 blocks of 128 threads.  Launched
//     with cudaLaunchKernelEx and a cluster-dimension attribute.
//   * Reduce once.  A thread keeps its candidates' sums across all its
//     beams — in registers for the r and w the repo's configurations use
//     (templated: B7 r = 4, B6 w = 2), in its own slot of shared memory for
//     any other (the runtime path, which walks the candidate rows in chunks
//     that fit).  Then the per-thread sums go through shared memory once
//     (one thread per candidate adds the block's slots), and rank 0 of the
//     cluster adds the blocks' sums through distributed shared memory and
//     writes the output: no zeroed output, no global atomics, no second
//     launch.
//   * Load each cell once per beam.  A beam's (F+1)×(F+1) patch is walked
//     row by row: each row's horizontal interpolation gy·v(y) + fy·v(y+1)
//     is kept for the next row, and candidate row du takes gx·h(du) +
//     fx·h(du+1) — the four-corner sum regrouped (equal modulo 2^32).  B7:
//     100 loads per (θ, beam) where there were 180.  Splitting a beam's
//     candidate rows over 2 or 3 lanes (the shared row passed by shuffle)
//     was tried and measured no faster than more threads with one lane
//     per beam.
//   * B6 pools once.  Block k of a stream's cluster takes a stripe of
//     coarse rows (a multiple of 8, so every stripe starts on 16 bytes),
//     reads each log-odds cell of it once, writes the same stripe of mq and
//     pools it into shared memory; after a cluster barrier each block
//     copies the other stripes from its peers (distributed shared memory,
//     16-byte words) and gathers its beams' corners from its own copy.  The
//     pooled map is int16 (8 KiB at G=256, 128 KiB at G=1024).  When
//     clamp_q >> quant_shift, the largest mq, does not fit int16 (the
//     wrapper checks) or the map does not fit in shared memory beside the
//     sums (past ~330 coarse cells a side at w = 2), the direct route pools each
//     corner from log_odds.
//   * B7 reads mq through L1 and does not stage it.  Staging costs each
//     block G²·4 bytes of L2 reads (256 KiB at G=256: 208 blocks would read
//     52 MiB, ~2 µs a block at ~128 B/clk of L2 bandwidth per SM) to save
//     gathers that mostly hit L1 anyway: 32 neighbouring beams of a scan
//     land on a few map lines.  At G=1024 mq (4 MiB) stays in L2 too.
//
// What is left is latency, an order of magnitude above the bounds
// (PERF.md): the dependent row loads of each beam, the reduction and the
// cluster barriers.
//
// B8's first design ran one block per (stripe of 8192 / G rows, stream):
// 32 blocks at config 12's tick and 8 at the map replay's, and every block
// rotated every beam and walked all its samples to keep the cells of its
// own rows, the rotation done G² / 8192 times over (0.0151 ms device at
// config 12 on an NVIDIA H100 80GB HBM3 at 700 W, 23x its bound; PERF.md).
// Now each stream is one cluster of K blocks (the wrapper's plan,
// update_plan: up to 16, past the portable 8), block k takes beams
// [k·⌈B/K⌉, (k+1)·⌈B/K⌉) and rotates each once, and owns the stripe of rows
// [k·rows, (k+1)·rows), which it updates.  Flags are two bits a cell, hit
// and free, in 32-bit words of shared memory: hit and free of one cell
// share a word, so they are set with OR reductions (plain stores of two
// writers would lose one of them).  A cell off the map marks nothing.
//
//   * The local route, wherever a bitmap of the whole map fits a block
//     (G up to 935; 16 KiB at G=256): each block clears its own bitmap
//     (one __syncthreads, no cluster barrier), marks its beams' cells in it
//     with shared atomics, arrives at the one cluster barrier that
//     publishes the bitmaps, gathers its stripe's words from every block's
//     bitmap (distributed shared memory, a thread's K loads in flight at
//     once) and applies them; a relaxed arrive after the gather and a wait
//     at the end keep each bitmap alive while peers read it.
//   * The remote route, for larger maps: block k keeps only its stripe's
//     flags, clears them, and a first cluster barrier (release) orders
//     that before any peer marks; each cell is then marked in the owner's
//     stripe with a reduction into distributed shared memory (mapa, then
//     red.shared::cluster.or), and a second barrier waits for them all.
//     At config 12's tick it takes 0.0052 ms against the local route's
//     0.0042 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): two barriers that
//     release, the second waiting for the reductions in flight.
//   * Either way the loads of the pose, the block's first beam and the
//     first kUpdatePrefetch 16-byte words a thread of its stripe of the
//     map are issued before the first wait, so that their latency hides
//     it; the stripe is updated with 16-byte loads and stores (scalar ones
//     at its unaligned ends, or throughout when the map and the output are
//     not 16-byte aligned alike).
//   * Sample 0 of every beam is the sensor's own cell: it is marked once a
//     warp, not once a beam, or 2048 reductions would queue on one word.
//     (Combining all of a warp's marks of one word with __match_any_sync
//     cost more than the queueing it saved.)  free_samples = 4, the
//     repo's, is instantiated, so that the floor divisions by S are
//     shifts; any other S takes the runtime path (0.00442 ms against
//     the instantiation's 0.00410 at config 12's tick).
//   * K = 16 against the portable 8: 0.00410 against 0.00445 ms, and no
//     host cost per launch that the measurement could tell apart.
//     (Both: NVIDIA H100 80GB HBM3, 700 W; tools/update_plans.py,
//     PERF.md.)
//
// Only the > 0 predicate of each count matters, so flags replace the TPU
// kernel's one-hot matmul.
//
// No kernel needs its output zeroed, allocates, or synchronises the host;
// each launches on the caller's stream and the entry returns the launch's
// error; each entry takes the card's index and makes that card current
// itself (device_guard.cuh).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSubBits = 5;
constexpr int kSub = 1 << kSubBits;
constexpr int kAngBits = 14;
// B6/B7: the plan picks 32 to 256 threads a block; two blocks of 256 a
// SM cap a thread at 128 registers
constexpr int kMaxThreads = 256;
// B8: threads a block (the launch bound), the largest cluster it is
// prepared for, and the 16-byte words of its stripe a thread loads early
constexpr int kUpdateThreads = 512;
constexpr int kUpdateMaxCluster = 16;
constexpr int kUpdatePrefetch = 4;
constexpr int kMaxDevices = 64;

// int32 arithmetic that wraps as JAX's and PyTorch's int32 does
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// rotate_rows: (c·x − s·y + half) >> ANG_BITS, arithmetic shift
__device__ __forceinline__ void rotate(int x, int y, int c, int s, int& xr, int& yr) {
  const int half = 1 << (kAngBits - 1);
  xr = wadd(wsub(wmul(c, x), wmul(s, y)), half) >> kAngBits;
  yr = wadd(wadd(wmul(s, x), wmul(c, y)), half) >> kAngBits;
}

// floor division by a positive divisor (C++ '/' truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int quantize(int v, int clamp_q, int qshift) {
  return min(max(v, 0), clamp_q) >> qshift;
}

__device__ __forceinline__ bool on_map(int x, int y, int g) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(g) &&
         static_cast<unsigned>(y) < static_cast<unsigned>(g);
}

// ---------------------------------------------------------------------------
// map readers: the value of cell (x, y), 0 off the map
// ---------------------------------------------------------------------------

// B7: mq in global memory (L2-resident), read through L1
struct GlobalMap {
  const int* __restrict__ m;
  int g;
  __device__ __forceinline__ int operator()(int x, int y) const {
    return on_map(x, y, g) ? __ldg(m + x * g + y) : 0;
  }
};

// B6: the pooled map staged in shared memory
template <class E>
struct SharedMap {
  const E* m;
  int g;
  __device__ __forceinline__ int operator()(int x, int y) const {
    return on_map(x, y, g) ? static_cast<int>(m[x * g + y]) : 0;
  }
};

// B6's direct route: coarse cell (x, y) pooled from log_odds — the max of
// its c×c cells, clipped and shifted (max commutes with the monotone clip
// and shift)
struct PoolingMap {
  const int* __restrict__ lo;
  int G, gc, c, clamp_q, qshift;
  __device__ __forceinline__ int operator()(int x, int y) const {
    if (!on_map(x, y, gc)) return 0;
    const int* base = lo + static_cast<size_t>(x) * c * G + static_cast<size_t>(y) * c;
    int m = __ldg(base);
    for (int a = 0; a < c; ++a) {
      const int* row = base + static_cast<size_t>(a) * G;
      for (int b = 0; b < c; ++b) m = max(m, __ldg(row + b));
    }
    return quantize(m, clamp_q, qshift);
  }
};

// ---------------------------------------------------------------------------
// one beam's F×F bilinear scores: candidate (du, dv) reads the corners
// (x0+du+{0,1}, y0+dv+{0,1}) with 5-bit fractions fx, fy.  The (F+1)² patch
// is walked row by row, each cell loaded once: h(row, dv) = gy·v(dv) +
// fy·v(dv+1) is kept for the next row, and candidate row du adds gx·h(du) +
// fx·h(du+1).
// ---------------------------------------------------------------------------

// compile-time F: the sums in registers.  A lane that is not `live` loads
// nothing and adds zeros (the warp walks in step: predicated loads keep
// ptxas at 128 registers without spills, where skipping the lane took 255).
template <int F, class Map>
__device__ __forceinline__ void walk_registers(const Map& map, bool live, int x0, int y0, int fx,
                                               int fy, int (&acc)[F * F]) {
  const int gx = kSub - fx, gy = kSub - fy;
  int hp[F];
#pragma unroll
  for (int i = 0; i <= F; ++i) {
    int v[F + 1];
#pragma unroll
    for (int j = 0; j <= F; ++j) v[j] = live ? map(x0 + i, y0 + j) : 0;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const int h = wadd(wmul(gy, v[j]), wmul(fy, v[j + 1]));
      if (i > 0) {
        acc[(i - 1) * F + j] = wadd(acc[(i - 1) * F + j], wadd(wmul(gx, hp[j]), wmul(fx, h)));
      }
      hp[j] = h;
    }
  }
}

// runtime F, candidate rows [d0, d0 + rows) only: the sums (acc) and the
// kept row (hrow) in this thread's slots of shared memory
template <class Map>
__device__ __forceinline__ void walk_shared(const Map& map, int x0, int y0, int fx, int fy, int F,
                                            int d0, int rows, int* acc, int* hrow) {
  const int gx = kSub - fx, gy = kSub - fy;
  for (int i = d0; i <= d0 + rows; ++i) {
    int v0 = map(x0 + i, y0);
    for (int j = 0; j < F; ++j) {
      const int v1 = map(x0 + i, y0 + j + 1);
      const int h = wadd(wmul(gy, v0), wmul(fy, v1));
      if (i > d0) {
        int& a = acc[(i - 1 - d0) * F + j];
        a = wadd(a, wadd(wmul(gx, hrow[j]), wmul(fx, h)));
      }
      hrow[j] = h;
      v0 = v1;
    }
  }
}

// part[k] = Σ over the block's threads t of red[t·slot + k], k < count
// (slot odd: a warp's slots fall in distinct banks)
__device__ __forceinline__ void block_sum(const int* red, int slot, int count, int* part) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    int s = 0;
    for (int t = 0; t < static_cast<int>(blockDim.x); ++t) s = wadd(s, red[t * slot + k]);
    part[k] = s;
  }
}

// The block's sums over its beams [b0, b1) (thread i takes b0 + i, b0 + i +
// nt, ...) of the F×F candidates -> part[0, F²).  place(b, x0, y0, fx, fy)
// gives beam b's corner origin and fractions; invalid beams add nothing.
// red holds nt slots of (rows·F) | 1 ints (rows = F on the register path),
// hrow nt·F (the runtime path's kept rows, which walks the candidate rows
// in chunks of `rows`).
template <int FT, class Map, class Place>
__device__ __forceinline__ void block_scores(const Map& map, const Place& place,
                                             const uint8_t* __restrict__ okn, int b0, int b1,
                                             int F, int rows, int* part, int* red, int* hrow) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int slot = (rows * F) | 1;
  if constexpr (FT > 0) {
    int acc[FT * FT];
#pragma unroll
    for (int k = 0; k < FT * FT; ++k) acc[k] = 0;
    for (int base = b0; base < b1; base += nt) {
      const int b = base + tid;
      const bool live = b < b1 && okn[b];
      int x0 = 0, y0 = 0, fx = 0, fy = 0;
      if (live) place(b, x0, y0, fx, fy);
      walk_registers<FT>(map, live, x0, y0, fx, fy, acc);
    }
#pragma unroll
    for (int k = 0; k < FT * FT; ++k) red[tid * slot + k] = acc[k];
    __syncthreads();
    block_sum(red, slot, FT * FT, part);
  } else {
    int* acc = red + tid * slot;
    int* hr = hrow + tid * F;
    for (int d0 = 0; d0 < F; d0 += rows) {
      const int nr = min(rows, F - d0);
      for (int k = 0; k < nr * F; ++k) acc[k] = 0;
      for (int b = b0 + tid; b < b1; b += nt) {
        if (!okn[b]) continue;
        int x0, y0, fx, fy;
        place(b, x0, y0, fx, fy);
        walk_shared(map, x0, y0, fx, fy, F, d0, nr, acc, hr);
      }
      __syncthreads();
      block_sum(red, slot, nr * F, part + d0 * F);
      __syncthreads();  // red is zeroed again by the next chunk
    }
  }
}

// Rank 0 of the cluster adds every block's part[0, count) (distributed
// shared memory) and writes the sums to out; the second barrier keeps each
// block's shared memory alive until rank 0 has read it.
__device__ __forceinline__ void cluster_sum_store(cg::cluster_group& cluster, int* part,
                                                  int count, int* __restrict__ out) {
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int kb = static_cast<int>(cluster.num_blocks());
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      int s = part[k];
      for (int q = 1; q < kb; ++q) s = wadd(s, cluster.map_shared_rank(part, q)[k]);
      out[k] = s;
    }
  }
  cluster.sync();
}

// ---------------------------------------------------------------------------
// B6: coarse translation sweep; one cluster per stream
// ---------------------------------------------------------------------------

// W: window at compile time (0: the runtime path, w); STAGED: the pooled
// map staged in shared memory as int16 (false: the direct route)
template <int W, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, 2)
    coarse_scores_kernel(const int* __restrict__ log_odds, const int* __restrict__ pq,
                         const uint8_t* __restrict__ ok, const int* __restrict__ posec,
                         const int* __restrict__ trig, int* __restrict__ mq,
                         int* __restrict__ score, int G, int B, int c, int clog, int clamp_q,
                         int qshift, int w, int rows) {
  extern __shared__ __align__(16) unsigned char coarse_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int U = W > 0 ? 2 * W + 1 : 2 * w + 1;
  const int gc = G / c;
  const int nt = blockDim.x, tid = threadIdx.x, n = blockIdx.y;
  const int kb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // [pooled map, padded to 16 bytes][part U²][red nt·((rows·U) | 1)][hrow nt·U]
  const int pooled_bytes = STAGED ? (gc * gc * 2 + 15) & ~15 : 0;
  int16_t* pooled = reinterpret_cast<int16_t*>(coarse_smem);
  int* part = reinterpret_cast<int*>(coarse_smem + pooled_bytes);
  int* red = part + U * U;
  int* hrow = red + ((rows * U) | 1) * nt;

  // this block's stripe of coarse rows: mq written, pooled into shared memory
  const size_t plane = static_cast<size_t>(G) * G;
  const int* lo = log_odds + n * plane;
  int* mqn = mq + n * plane;
  const int crows = ((gc + kb - 1) / kb + 7) & ~7;
  const int cr0 = min(gc, rank * crows), cr1 = min(gc, cr0 + crows);
  const bool vec4 = c == 4 && ((reinterpret_cast<uintptr_t>(lo) |
                                reinterpret_cast<uintptr_t>(mqn)) & 15) == 0;
  for (int i = tid; i < (cr1 - cr0) * gc; i += nt) {
    const int cx = cr0 + i / gc, cy = i % gc;
    int m = 0;  // quantized values are >= 0
    if (vec4) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const size_t off = static_cast<size_t>(cx * 4 + a) * G + cy * 4;
        int4 v = __ldg(reinterpret_cast<const int4*>(lo + off));
        v.x = quantize(v.x, clamp_q, qshift);
        v.y = quantize(v.y, clamp_q, qshift);
        v.z = quantize(v.z, clamp_q, qshift);
        v.w = quantize(v.w, clamp_q, qshift);
        *reinterpret_cast<int4*>(mqn + off) = v;
        m = max(m, max(max(v.x, v.y), max(v.z, v.w)));
      }
    } else {
      for (int a = 0; a < c; ++a) {
        const size_t row = static_cast<size_t>(cx * c + a) * G + static_cast<size_t>(cy) * c;
        for (int b = 0; b < c; ++b) {
          const int v = quantize(__ldg(lo + row + b), clamp_q, qshift);
          mqn[row + b] = v;
          m = max(m, v);
        }
      }
    }
    if constexpr (STAGED) pooled[cx * gc + cy] = static_cast<int16_t>(m);
  }
  if constexpr (STAGED) {
    // every stripe pooled: copy the peers' stripes into this block's map
    cluster.sync();
    for (int q = 0; q < kb; ++q) {
      const int q0 = min(gc, q * crows), q1 = min(gc, q0 + crows);
      if (q == rank || q0 >= q1) continue;
      const int4* src = reinterpret_cast<const int4*>(cluster.map_shared_rank(pooled, q) + q0 * gc);
      int4* dst = reinterpret_cast<int4*>(pooled + q0 * gc);
      const int words = ((q1 - q0) * gc * 2 + 15) >> 4;  // the last stripe takes the padding
      for (int i = tid; i < words; i += nt) dst[i] = src[i];
    }
    __syncthreads();
  }

  // this block's share of the beams, scored on the pooled map
  const int share = (B + kb - 1) / kb;
  const int b0 = min(B, rank * share), b1 = min(B, b0 + share);
  const int cq = trig[2 * n], sq = trig[2 * n + 1];
  const int ox = posec[2 * n], oy = posec[2 * n + 1];
  const int ww = (U - 1) / 2;
  const int* pqn = pq + 2 * static_cast<size_t>(n) * B;
  auto place = [&](int b, int& x0, int& y0, int& fx, int& fy) {
    int rx, ry;
    rotate(pqn[2 * b], pqn[2 * b + 1], cq, sq, rx, ry);
    const int scx = wadd(rx, ox) >> clog, scy = wadd(ry, oy) >> clog;
    x0 = (scx >> kSubBits) - ww;
    y0 = (scy >> kSubBits) - ww;
    fx = scx & (kSub - 1);
    fy = scy & (kSub - 1);
  };
  const uint8_t* okn = ok + static_cast<size_t>(n) * B;
  constexpr int kU = W > 0 ? 2 * W + 1 : 0;
  if constexpr (STAGED) {
    block_scores<kU>(SharedMap<int16_t>{pooled, gc}, place, okn, b0, b1, U, rows, part, red, hrow);
  } else {
    block_scores<kU>(PoolingMap{lo, G, gc, c, clamp_q, qshift}, place, okn, b0, b1, U, rows,
                     part, red, hrow);
  }
  cluster_sum_store(cluster, part, U * U, score + static_cast<size_t>(n) * U * U);
}

// ---------------------------------------------------------------------------
// B7: joint (dθ, dx, dy) refinement; one cluster per (θ, stream)
// ---------------------------------------------------------------------------

// R: fine radius at compile time (0: the runtime path, r)
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
    fine_scores_kernel(const int* __restrict__ mq, const int* __restrict__ pq,
                       const uint8_t* __restrict__ ok, const int* __restrict__ posec,
                       const int* __restrict__ cos_q, const int* __restrict__ sin_q,
                       const int* __restrict__ uv, int* __restrict__ score, int G, int B, int T,
                       int csub, int r, int rows) {
  extern __shared__ __align__(16) int fine_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F = R > 0 ? 2 * R + 1 : 2 * r + 1;
  const int nt = blockDim.x, t = blockIdx.y, n = blockIdx.z;
  const int kb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // [part F²][red nt·((rows·F) | 1)][hrow nt·F]
  int* part = fine_smem;
  int* red = part + F * F;
  int* hrow = red + ((rows * F) | 1) * nt;

  const int share = (B + kb - 1) / kb;
  const int b0 = min(B, rank * share), b1 = min(B, b0 + share);
  const int cq = cos_q[n * T + t], sq = sin_q[n * T + t];
  const int ox = wadd(posec[2 * n], wmul(uv[2 * n], csub));
  const int oy = wadd(posec[2 * n + 1], wmul(uv[2 * n + 1], csub));
  const int rr = (F - 1) / 2;
  const int* pqn = pq + 2 * static_cast<size_t>(n) * B;
  auto place = [&](int b, int& x0, int& y0, int& fx, int& fy) {
    int rx, ry;
    rotate(pqn[2 * b], pqn[2 * b + 1], cq, sq, rx, ry);
    const int fbx = wadd(rx, ox), fby = wadd(ry, oy);
    x0 = (fbx >> kSubBits) - rr;
    y0 = (fby >> kSubBits) - rr;
    fx = fbx & (kSub - 1);
    fy = fby & (kSub - 1);
  };
  constexpr int kF = R > 0 ? 2 * R + 1 : 0;
  block_scores<kF>(GlobalMap{mq + static_cast<size_t>(n) * G * G, G}, place,
                   ok + static_cast<size_t>(n) * B, b0, b1, F, rows, part, red, hrow);
  cluster_sum_store(cluster, part, F * F, score + (static_cast<size_t>(n) * T + t) * F * F);
}

// ---------------------------------------------------------------------------
// B8: log-odds update; one cluster per stream
// ---------------------------------------------------------------------------

// log-odds v of cell j of this block's stripe, updated by its flags
__device__ __forceinline__ int update_cell(const unsigned* flags, int j, int v, int hit_q,
                                           int miss_q, int clamp_q) {
  const unsigned f = flags[j >> 4] >> ((j & 15) * 2);
  const int delta = (f & 1u) ? hit_q : ((f & 2u) ? miss_q : 0);
  return min(max(wadd(v, delta), -clamp_q), clamp_q);
}

// the 16-byte word v of cells [j, j + 4), updated
__device__ __forceinline__ int4 update_word(const unsigned* flags, int j, int4 v, int hit_q,
                                            int miss_q, int clamp_q) {
  v.x = update_cell(flags, j, v.x, hit_q, miss_q, clamp_q);
  v.y = update_cell(flags, j + 1, v.y, hit_q, miss_q, clamp_q);
  v.z = update_cell(flags, j + 2, v.z, hit_q, miss_q, clamp_q);
  v.w = update_cell(flags, j + 3, v.w, hit_q, miss_q, clamp_q);
  return v;
}

// the two halves of a cluster barrier, so that a block works between them:
// arrive (releasing this thread's writes) and wait (acquiring the peers')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// an arrive that publishes nothing: this block is done reading its peers'
// shared memory (the values read are consumed before it)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// the address of `p` (this block's shared memory) in block `rank`'s
__device__ __forceinline__ unsigned cluster_addr(const unsigned* p, int rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// B8's two routes (the wrapper's plan picks one).  Local: each block marks
// its beams' cells in its own bitmap of the whole map, and after one
// cluster barrier gathers its stripe's words from every block's bitmap.
// Remote: each block marks each cell in the stripe flags of the block that
// owns its row, by a reduction into distributed shared memory.  Either way
// two bits a cell: hit (bit 0) and free (bit 1) of cell c in bit 2·(c % 16)
// of word c / 16.
template <bool kLocal>
struct Marker {
  unsigned* flags;  // local: the whole map's bitmap; remote: this stripe's
  int G, rows;
  float inv_rows;   // 1 / rows: the owner by a multiply, corrected below
  // mark cell (sx, sy) >> kSubBits; off the map, nothing (never clipped
  // onto an edge)
  __device__ __forceinline__ void operator()(int sx, int sy, unsigned bit) const {
    const int cx = sx >> kSubBits, cy = sy >> kSubBits;
    if (!on_map(cx, cy, G)) return;
    if constexpr (kLocal) {
      const int c = cx * G + cy;
      atomicOr(flags + (c >> 4), bit << ((c & 15) * 2));
    } else {
      int owner = __float2int_rz(static_cast<float>(cx) * inv_rows);
      owner += (owner + 1) * rows <= cx ? 1 : 0;
      owner -= owner * rows > cx ? 1 : 0;
      const int j = (cx - owner * rows) * G + cy;
      const unsigned addr = cluster_addr(flags + (j >> 4), owner);
      const unsigned bits = bit << ((j & 15) * 2);
      asm volatile("red.shared::cluster.or.b32 [%0], %1;\n" ::"r"(addr), "r"(bits) : "memory");
    }
  }
};

// S: free_samples at compile time (0: the runtime path, `samples`)
template <int S, bool kLocal>
__global__ void __launch_bounds__(kUpdateThreads)
    log_odds_update_kernel(const int* __restrict__ log_odds, const int* __restrict__ pq,
                           const uint8_t* __restrict__ ok, const int* __restrict__ posec,
                           const int* __restrict__ trig, int* __restrict__ out, int G, int B,
                           int rows, int hit_q, int miss_q, int clamp_q, int samples) {
  // local: [the map's bitmap, (G²/16 words, padded to 16 bytes)][this
  // stripe's words]; remote: [this stripe's words]
  extern __shared__ __align__(16) unsigned flags[];
  cg::cluster_group cluster = cg::this_cluster();
  const int kb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.y, nt = blockDim.x, tid = threadIdx.x;
  const int r0 = min(G, rank * rows), r1 = min(G, r0 + rows);
  const int ncell = (r1 - r0) * G;
  const int ns = S > 0 ? S : samples;
  const int map_words = (((G * G + 15) >> 4) + 3) & ~3;
  if constexpr (kLocal) {
    for (int i = tid; i < map_words >> 2; i += nt) reinterpret_cast<uint4*>(flags)[i] = uint4{};
  } else {
    for (int i = tid; i < (rows * G + 15) >> 4; i += nt) flags[i] = 0u;
    cluster_arrive();  // this block's flags are clear
  }

  // meanwhile: the stripe's first 16-byte words (the cells [0, head) and
  // [tail, ncell) go one by one, the words between when the map and the
  // output share their alignment), the pose, and this thread's first beam
  const size_t base = static_cast<size_t>(n) * G * G + static_cast<size_t>(r0) * G;
  const int* lo = log_odds + base;
  int* dst = out + base;
  const uintptr_t la = reinterpret_cast<uintptr_t>(lo), da = reinterpret_cast<uintptr_t>(dst);
  const int head =
      ((la ^ da) & 15) == 0 ? min(ncell, static_cast<int>(((16 - (la & 15)) & 15) >> 2)) : ncell;
  const int words = (ncell - head) >> 2, tail = head + 4 * words;
  const int4* lo4 = reinterpret_cast<const int4*>(lo + head);
  int4* dst4 = reinterpret_cast<int4*>(dst + head);
  int4 early[kUpdatePrefetch];
#pragma unroll
  for (int q = 0; q < kUpdatePrefetch; ++q) {
    const int i = tid + q * nt;
    early[q] = i < words ? __ldg(lo4 + i) : make_int4(0, 0, 0, 0);
  }
  const int cq = trig[2 * n], sq = trig[2 * n + 1];
  const int ox = posec[2 * n], oy = posec[2 * n + 1];
  const int share = (B + kb - 1) / kb;
  const int b0 = min(B, rank * share), b1 = min(B, b0 + share);
  const uint8_t* okn = ok + static_cast<size_t>(n) * B;
  const int* pqn = pq + 2 * static_cast<size_t>(n) * B;
  int b = b0 + tid;
  bool live = false;
  int px = 0, py = 0;
  if (b < b1) {
    live = okn[b];
    px = pqn[2 * b];
    py = pqn[2 * b + 1];
  }
  const Marker<kLocal> mark{flags, G, rows, 1.0f / static_cast<float>(rows)};
  if constexpr (kLocal) {
    __syncthreads();  // the bitmap is clear
  } else {
    cluster_wait();  // every block's flags are clear
  }

  // this block's beams, each rotated once.  Sample 0 of every beam is the
  // sensor's own cell: it is marked once a warp, below, not once a beam
  bool any = false;
  while (b < b1) {
    if (live) {
      any = true;
      int rx, ry;
      rotate(px, py, cq, sq, rx, ry);
      const int wx = wadd(rx, ox), wy = wadd(ry, oy);
      mark(wx, wy, 1u);
      for (int k = 1; k < ns; ++k) {
        mark(wadd(ox, floor_div(wmul(wsub(wx, ox), k), ns)),
             wadd(oy, floor_div(wmul(wsub(wy, oy), k), ns)), 2u);
      }
    }
    b += nt;  // a block with more beams than threads
    if (b < b1) {
      live = okn[b];
      px = pqn[2 * b];
      py = pqn[2 * b + 1];
    }
  }
  const unsigned warp_any = __ballot_sync(0xFFFFFFFFu, any);
  if (ns > 0 && warp_any && (tid & 31) == __ffs(warp_any) - 1) mark(ox, oy, 2u);

  // the stripe's flags, word (skew + j) / 16 for its cell j
  const unsigned* stripe = flags;
  int skew = 0;
  if constexpr (kLocal) {
    cluster_arrive();  // this block's bitmap is complete
    cluster_wait();    // every block's is
    const int c0 = r0 * G, w0 = c0 >> 4, w1 = (c0 + ncell + 15) >> 4;
    unsigned* gathered = flags + map_words;
    for (int w = w0 + tid; w < w1; w += nt) {
      unsigned v[kUpdateMaxCluster];  // every block's word in flight at once
#pragma unroll
      for (int q = 0; q < kUpdateMaxCluster; ++q) {
        v[q] = q < kb ? *cluster.map_shared_rank(flags + w, q) : 0u;
      }
      unsigned f = 0;
#pragma unroll
      for (int q = 0; q < kUpdateMaxCluster; ++q) f |= v[q];
      gathered[w - w0] = f;
    }
    cluster_arrive_relaxed();  // done reading the peers' bitmaps
    __syncthreads();
    stripe = gathered;
    skew = c0 & 15;
  } else {
    cluster.sync();  // every mark is in place; no peer touches these flags again
  }

  // delta and clamp over the stripe: the early words, then the rest
#pragma unroll
  for (int q = 0; q < kUpdatePrefetch; ++q) {
    const int i = tid + q * nt;
    if (i < words) {
      dst4[i] = update_word(stripe, skew + head + 4 * i, early[q], hit_q, miss_q, clamp_q);
    }
  }
  for (int i = tid + kUpdatePrefetch * nt; i < words; i += nt) {
    dst4[i] = update_word(stripe, skew + head + 4 * i, __ldg(lo4 + i), hit_q, miss_q, clamp_q);
  }
  for (int j = tid; j < head; j += nt) {
    dst[j] = update_cell(stripe, skew + j, __ldg(lo + j), hit_q, miss_q, clamp_q);
  }
  for (int j = tail + tid; j < ncell; j += nt) {
    dst[j] = update_cell(stripe, skew + j, __ldg(lo + j), hit_q, miss_q, clamp_q);
  }
  if constexpr (kLocal) cluster_wait();  // no peer still reads this block's bitmap
}

// ---------------------------------------------------------------------------
// cluster launches
// ---------------------------------------------------------------------------

// one slot per kernel instantiation: B7 r = 4, runtime; B6 (w = 2, runtime)
// × (int16 staged, direct); B8 (S = 4, runtime) × (local, remote)
constexpr int kFineSlot = 0;
constexpr int kCoarseSlot = 2;
constexpr int kUpdateSlot = kCoarseSlot + 4;
constexpr int kSlots = kUpdateSlot + 4;
bool g_prepared[kSlots][kMaxDevices];  // set once per device and slot

// Launch `kernel` on `grid` in clusters of `cluster` blocks along x.  The
// first launch of a slot on a device lets its kernel take the card's
// largest dynamic shared memory and clusters past 8.
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int slot, dim3 grid, int cluster, int threads,
                    int smem, int device, void* stream, Args... args) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_prepared[slot][device]) {
    int optin = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    g_prepared[slot][device] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The wrapper's plan for one launch (ops/scan_match_kernels.py): blocks per
// cluster, threads per block, candidate rows a thread holds (F on the
// register path, a chunk on the runtime path) and dynamic shared memory in
// bytes.
struct Plan {
  int cluster, threads, rows, smem;
  // false when the plan is malformed or gives a block less shared memory
  // than its layout [pooled][part F²][red threads·((rows·F) | 1)][hrow
  // threads·F, runtime path only] takes
  bool fits(int pooled, int F, bool registers) const {
    const int need = pooled + 4 * (F * F + threads * ((rows * F) | 1) +
                                   (registers ? 0 : threads * F));
    return cluster >= 1 && threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
           rows >= 1 && rows <= F && (!registers || rows == F) && smem >= need;
  }
};

struct CoarseArgs {
  const int* log_odds;
  const int* pq;
  const uint8_t* ok;
  const int* posec;
  const int* trig;
  int* mq;
  int* score;
  int N, G, B, c, clog, clamp_q, qshift, w;
};

template <int W, bool STAGED>
int launch_coarse(int slot, const CoarseArgs& a, const Plan& p, int device, void* stream) {
  const int gc = a.G / a.c;
  const int pooled = STAGED ? (gc * gc * 2 + 15) & ~15 : 0;
  if (!p.fits(pooled, 2 * a.w + 1, W > 0)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(coarse_scores_kernel<W, STAGED>, slot, dim3(p.cluster, a.N, 1), p.cluster,
                         p.threads, p.smem, device, stream, a.log_odds, a.pq, a.ok, a.posec,
                         a.trig, a.mq, a.score, a.G, a.B, a.c, a.clog, a.clamp_q, a.qshift, a.w,
                         p.rows);
}

template <bool STAGED>
int coarse_by_window(int slot, const CoarseArgs& a, const Plan& p, int device, void* stream) {
  return a.w == 2 ? launch_coarse<2, STAGED>(slot, a, p, device, stream)
                  : launch_coarse<0, STAGED>(slot + 1, a, p, device, stream);
}

struct FineArgs {
  const int* mq;
  const int* pq;
  const uint8_t* ok;
  const int* posec;
  const int* cos_q;
  const int* sin_q;
  const int* uv;
  int* score;
  int N, G, B, T, csub, r;
};

template <int R>
int launch_fine(int slot, const FineArgs& a, const Plan& p, int device, void* stream) {
  if (!p.fits(0, 2 * a.r + 1, R > 0)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(fine_scores_kernel<R>, slot, dim3(p.cluster, a.T, a.N), p.cluster,
                         p.threads, p.smem, device, stream, a.mq, a.pq, a.ok, a.posec, a.cos_q,
                         a.sin_q, a.uv, a.score, a.G, a.B, a.T, a.csub, a.r, p.rows);
}

struct UpdateArgs {
  const int* log_odds;
  const int* pq;
  const uint8_t* ok;
  const int* posec;
  const int* trig;
  int* out;
  int N, G, B, hit_q, miss_q, clamp_q, samples;
};

template <int S, bool kLocal>
int launch_update(int slot, const UpdateArgs& a, const Plan& p, int device, void* stream) {
  return launch_clusters(log_odds_update_kernel<S, kLocal>, slot, dim3(p.cluster, a.N, 1),
                         p.cluster, p.threads, p.smem, device, stream, a.log_odds, a.pq, a.ok,
                         a.posec, a.trig, a.out, a.G, a.B, p.rows, a.hit_q, a.miss_q, a.clamp_q,
                         a.samples);
}

template <bool kLocal>
int update_by_samples(int slot, const UpdateArgs& a, const Plan& p, int device, void* stream) {
  return a.samples == 4 ? launch_update<4, kLocal>(slot, a, p, device, stream)
                        : launch_update<0, kLocal>(slot + 1, a, p, device, stream);
}

}  // namespace

// B6.  elem: the pooled map's cell bytes (2: int16, staged; 0: the direct
// route); cluster, threads, rows, smem: the wrapper's plan.
extern "C" int coarse_scores_i32(const int* log_odds, const int* pq, const uint8_t* ok,
                                 const int* posec, const int* trig, int* mq, int* score, int N,
                                 int G, int B, int c, int clog, int clamp_q, int qshift, int w,
                                 int elem, int cluster, int threads, int rows, int smem,
                                 int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const CoarseArgs a{log_odds, pq, ok, posec, trig, mq, score, N, G, B, c, clog, clamp_q, qshift, w};
  const Plan p{cluster, threads, rows, smem};
  switch (elem) {
    case 2: return coarse_by_window<true>(kCoarseSlot, a, p, device, stream);
    case 0: return coarse_by_window<false>(kCoarseSlot + 2, a, p, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B7.  cluster, threads, rows, smem: the wrapper's plan.
extern "C" int fine_scores_i32(const int* mq, const int* pq, const uint8_t* ok, const int* posec,
                               const int* cos_q, const int* sin_q, const int* uv, int* score,
                               int N, int G, int B, int T, int csub, int r, int cluster,
                               int threads, int rows, int smem, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const FineArgs a{mq, pq, ok, posec, cos_q, sin_q, uv, score, N, G, B, T, csub, r};
  const Plan p{cluster, threads, rows, smem};
  return r == 4 ? launch_fine<4>(kFineSlot, a, p, device, stream)
                : launch_fine<0>(kFineSlot + 1, a, p, device, stream);
}

// B8.  local: the route (1: each block's own bitmap of the map, 0: marks
// into the owners' stripes); cluster, threads, rows, smem: the wrapper's
// plan (update_plan).
extern "C" int log_odds_update_i32(const int* log_odds, const int* pq, const uint8_t* ok,
                                   const int* posec, const int* trig, int* out, int N, int G,
                                   int B, int hit_q, int miss_q, int clamp_q, int samples,
                                   int local, int cluster, int threads, int rows, int smem,
                                   int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  // the plan must cover every row and give each block its layout's words:
  // [bitmap, padded to 16 bytes][the stripe's words, one more when it
  // starts inside a word] (local) or [the stripe's words] (remote)
  const int stripe = (rows * G + 15) / 16 + (local ? 1 : 0);
  const int bitmap = local ? (((G * G + 15) / 16 + 3) & ~3) : 0;
  const bool fits = cluster >= 1 && cluster <= kUpdateMaxCluster && threads >= 32 &&
                    threads <= kUpdateThreads && threads % 32 == 0 && rows >= 1 &&
                    rows * cluster >= G && smem >= 4 * (bitmap + stripe);
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  const UpdateArgs a{log_odds, pq, ok, posec, trig, out, N, G, B, hit_q, miss_q, clamp_q, samples};
  const Plan p{cluster, threads, rows, smem};
  return local ? update_by_samples<true>(kUpdateSlot, a, p, device, stream)
               : update_by_samples<false>(kUpdateSlot + 2, a, p, device, stream);
}
