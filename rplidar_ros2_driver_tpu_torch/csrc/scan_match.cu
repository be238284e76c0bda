// Correlative scan-matcher kernels of the SLAM front-end, written for
// Hopper (sm_90a).  Each entry takes N streams and launches once for all of
// them (one fleet tick).  All arithmetic is int32 and wraps like the JAX
// package's int32 (two's complement, arithmetic right shifts), so any order
// of summation gives the same bits as the plain versions.
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
// What bounds them on an H100, at the config-12 fleet tick (N=4, G=256,
// B=2048, U=V=5, T=13, F=9): the bytes are small (log-odds 1 MiB in, mq
// and the updated map 1 MiB out each), about 0.3–0.6 us of HBM time per
// kernel; the work is gathers: B6 25 candidates × 4 corners × c² = 16
// pooled cells per valid beam (3.3 M int32 loads a tick), B7 13 × 81 × 4
// (8.6 M loads), B8 5 cell marks per beam.  All of it is L2-resident
// (256 KiB per stream map), so the kernels are bound by load latency and
// the number of blocks in flight, not by HBM.
//
// Design (simple first; see PERF.md for the measured gap to the bound):
//   * B6: one block per (u, stream).  The U blocks of a stream share the
//     elementwise mq write.  A thread takes one beam at a time, rotates it
//     and walks the V + 1 coarse columns of its two corner rows, pooling
//     each coarse cell straight from log_odds (max commutes with the
//     monotone clip and shift, so no block waits for another's mq); each
//     candidate's value is summed over the warp with shuffles and added to
//     a shared accumulator.  Off-map corners contribute 0; invalid beams
//     contribute 0 and still take part in the shuffles.
//   * B7: one block per (θ, stream), the same walk over F rows of F + 1
//     columns on mq (global memory, L2-resident: 256 KiB a stream at
//     G=256, 4 MiB at G=1024, too large for shared memory).
//   * B8: one block per (stripe of rows, stream).  The block rotates every
//     beam, marks the hit and free cells that fall in its rows in shared
//     byte flags (off-map cells and cells of other stripes mark nothing —
//     never clipped onto an edge), then applies delta and clamp to its
//     stripe.  Only the > 0 predicate of each count matters, so flags
//     replace the TPU kernel's one-hot matmul.
// No kernel needs its output zeroed, allocates, or synchronises; each
// launches on the caller's stream and the entry returns cudaGetLastError();
// each entry takes the card's index and makes that card current itself
// (device_guard.cuh).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kSubBits = 5;
constexpr int kSub = 1 << kSubBits;
constexpr int kAngBits = 14;
constexpr int kThreads = 256;
constexpr int kStripeCells = 8192;  // B8: rows per block = kStripeCells / G

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

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v = wadd(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the bilinear combination of the four corners (x, y), (x+1, y), (x, y+1),
// (x+1, y+1) with 5-bit fractions fx, fy (Σ weights = SUB²)
__device__ __forceinline__ int bilinear(int fx, int fy, int v00, int v10, int v01, int v11) {
  const int gx = kSub - fx, gy = kSub - fy;
  int t = wmul(wmul(gx, gy), v00);
  t = wadd(t, wmul(wmul(fx, gy), v10));
  t = wadd(t, wmul(wmul(gx, fy), v01));
  return wadd(t, wmul(wmul(fx, fy), v11));
}

// mq value of one fine cell, 0 off the map
__device__ __forceinline__ int mq_at(const int* __restrict__ mq, int G, int x, int y) {
  return (x >= 0 && x < G && y >= 0 && y < G) ? mq[static_cast<size_t>(x) * G + y] : 0;
}

// pooled mq of coarse cell (cx, cy): max over its c×c fine cells of
// clip(lo, 0, clamp_q) >> qshift, taken as clip-and-shift of the max
// (both are monotone); 0 off the pooled map
__device__ __forceinline__ int pooled_at(const int* __restrict__ lo, int G, int gc, int c,
                                         int clamp_q, int qshift, int cx, int cy) {
  if (cx < 0 || cx >= gc || cy < 0 || cy >= gc) return 0;
  const int* base = lo + static_cast<size_t>(cx) * c * G + static_cast<size_t>(cy) * c;
  int m = base[0];
  for (int a = 0; a < c; ++a) {
    const int* row = base + static_cast<size_t>(a) * G;
    for (int b = 0; b < c; ++b) m = max(m, row[b]);
  }
  return min(max(m, 0), clamp_q) >> qshift;
}

__global__ void coarse_scores_kernel(const int* __restrict__ log_odds, const int* __restrict__ pq,
                                     const uint8_t* __restrict__ ok,
                                     const int* __restrict__ posec, const int* __restrict__ trig,
                                     int* __restrict__ mq, int* __restrict__ score, int G, int B,
                                     int c, int clog, int clamp_q, int qshift, int w) {
  extern __shared__ int acc[];  // the V sums of this block's row u
  const int U = 2 * w + 1;
  const int u = blockIdx.x, n = blockIdx.y;
  const size_t plane = static_cast<size_t>(G) * G;
  const int* lo = log_odds + n * plane;

  // the stream's quantized match map, split over its U blocks
  for (size_t i = static_cast<size_t>(u) * blockDim.x + threadIdx.x; i < plane;
       i += static_cast<size_t>(U) * blockDim.x) {
    mq[n * plane + i] = min(max(lo[i], 0), clamp_q) >> qshift;
  }
  for (int v = threadIdx.x; v < U; v += blockDim.x) acc[v] = 0;
  __syncthreads();

  const int gc = G / c;
  const int cq = trig[2 * n], sq = trig[2 * n + 1];
  const int ox = posec[2 * n], oy = posec[2 * n + 1];
  const int lane = threadIdx.x & 31;
  for (int b0 = 0; b0 < B; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const bool live = b < B && ok[static_cast<size_t>(n) * B + b];
    int ix = 0, ccy = 0, fx = 0, fy = 0;
    if (live) {
      const int* p = pq + 2 * (static_cast<size_t>(n) * B + b);
      int rx, ry;
      rotate(p[0], p[1], cq, sq, rx, ry);
      const int scx = wadd(rx, ox) >> clog, scy = wadd(ry, oy) >> clog;
      ix = (scx >> kSubBits) + (u - w);
      ccy = scy >> kSubBits;
      fx = scx & (kSub - 1);
      fy = scy & (kSub - 1);
    }
    // candidate v reads columns iy = ccy − w + v and iy + 1: walk the
    // V + 1 columns once, keeping the previous column's two corners
    int p0 = 0, p1 = 0;
    for (int j = 0; j <= U; ++j) {
      int q0 = 0, q1 = 0;
      if (live) {
        const int iy = ccy - w + j;
        q0 = pooled_at(lo, G, gc, c, clamp_q, qshift, ix, iy);
        q1 = pooled_at(lo, G, gc, c, clamp_q, qshift, ix + 1, iy);
      }
      if (j > 0) {
        const int s = warp_sum(bilinear(fx, fy, p0, p1, q0, q1));
        if (lane == 0) atomicAdd(&acc[j - 1], s);
      }
      p0 = q0;
      p1 = q1;
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < U; v += blockDim.x) {
    score[(static_cast<size_t>(n) * U + u) * U + v] = acc[v];
  }
}

__global__ void fine_scores_kernel(const int* __restrict__ mq, const int* __restrict__ pq,
                                   const uint8_t* __restrict__ ok, const int* __restrict__ posec,
                                   const int* __restrict__ cos_q, const int* __restrict__ sin_q,
                                   const int* __restrict__ uv, int* __restrict__ score, int G,
                                   int B, int T, int csub, int r) {
  extern __shared__ int acc[];  // the F·F sums of this block's θ
  const int F = 2 * r + 1;
  const int t = blockIdx.x, n = blockIdx.y;
  for (int i = threadIdx.x; i < F * F; i += blockDim.x) acc[i] = 0;
  __syncthreads();

  const int* m = mq + static_cast<size_t>(n) * G * G;
  const int cq = cos_q[n * T + t], sq = sin_q[n * T + t];
  const int ox = wadd(posec[2 * n], wmul(uv[2 * n], csub));
  const int oy = wadd(posec[2 * n + 1], wmul(uv[2 * n + 1], csub));
  const int lane = threadIdx.x & 31;
  for (int b0 = 0; b0 < B; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const bool live = b < B && ok[static_cast<size_t>(n) * B + b];
    int fcx = 0, fcy = 0, fx = 0, fy = 0;
    if (live) {
      const int* p = pq + 2 * (static_cast<size_t>(n) * B + b);
      int rx, ry;
      rotate(p[0], p[1], cq, sq, rx, ry);
      const int fbx = wadd(rx, ox), fby = wadd(ry, oy);
      fcx = fbx >> kSubBits;
      fcy = fby >> kSubBits;
      fx = fbx & (kSub - 1);
      fy = fby & (kSub - 1);
    }
    for (int du = 0; du < F; ++du) {
      const int ix = fcx - r + du;
      int p0 = 0, p1 = 0;
      for (int j = 0; j <= F; ++j) {
        int q0 = 0, q1 = 0;
        if (live) {
          const int iy = fcy - r + j;
          q0 = mq_at(m, G, ix, iy);
          q1 = mq_at(m, G, ix + 1, iy);
        }
        if (j > 0) {
          const int s = warp_sum(bilinear(fx, fy, p0, p1, q0, q1));
          if (lane == 0) atomicAdd(&acc[du * F + j - 1], s);
        }
        p0 = q0;
        p1 = q1;
      }
    }
  }
  __syncthreads();
  int* out = score + (static_cast<size_t>(n) * T + t) * F * F;
  for (int i = threadIdx.x; i < F * F; i += blockDim.x) out[i] = acc[i];
}

__global__ void log_odds_update_kernel(const int* __restrict__ log_odds,
                                       const int* __restrict__ pq,
                                       const uint8_t* __restrict__ ok,
                                       const int* __restrict__ posec,
                                       const int* __restrict__ trig, int* __restrict__ out,
                                       int G, int B, int rows, int hit_q, int miss_q,
                                       int clamp_q, int samples) {
  extern __shared__ uint8_t flags[];  // [rows][G] hit, then [rows][G] free
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, G - r0);
  uint8_t* hit = flags;
  uint8_t* fre = flags + static_cast<size_t>(rows) * G;
  for (int i = threadIdx.x; i < 2 * rows * G; i += blockDim.x) flags[i] = 0;
  __syncthreads();

  const int cq = trig[2 * n], sq = trig[2 * n + 1];
  const int ox = posec[2 * n], oy = posec[2 * n + 1];
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    if (!ok[static_cast<size_t>(n) * B + b]) continue;
    const int* p = pq + 2 * (static_cast<size_t>(n) * B + b);
    int rx, ry;
    rotate(p[0], p[1], cq, sq, rx, ry);
    const int wx = wadd(rx, ox), wy = wadd(ry, oy);
    int hx = (wx >> kSubBits) - r0, hy = wy >> kSubBits;
    if (hx >= 0 && hx < nr && hy >= 0 && hy < G) hit[hx * G + hy] = 1;
    for (int k = 0; k < samples; ++k) {
      const int sx = wadd(ox, floor_div(wmul(wsub(wx, ox), k), samples));
      const int sy = wadd(oy, floor_div(wmul(wsub(wy, oy), k), samples));
      hx = (sx >> kSubBits) - r0;
      hy = sy >> kSubBits;
      if (hx >= 0 && hx < nr && hy >= 0 && hy < G) fre[hx * G + hy] = 1;
    }
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(n) * G * G + static_cast<size_t>(r0) * G;
  for (int i = threadIdx.x; i < nr * G; i += blockDim.x) {
    const int delta = hit[i] ? hit_q : (fre[i] ? miss_q : 0);
    out[base + i] = min(max(wadd(log_odds[base + i], delta), -clamp_q), clamp_q);
  }
}

}  // namespace

extern "C" int coarse_scores_i32(const int* log_odds, const int* pq, const uint8_t* ok,
                                 const int* posec, const int* trig, int* mq, int* score, int N,
                                 int G, int B, int c, int clog, int clamp_q, int qshift, int w,
                                 int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int U = 2 * w + 1;
  coarse_scores_kernel<<<dim3(U, N), kThreads, U * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(
      log_odds, pq, ok, posec, trig, mq, score, G, B, c, clog, clamp_q, qshift, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fine_scores_i32(const int* mq, const int* pq, const uint8_t* ok, const int* posec,
                               const int* cos_q, const int* sin_q, const int* uv, int* score,
                               int N, int G, int B, int T, int csub, int r, int device,
                               void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int F = 2 * r + 1;
  fine_scores_kernel<<<dim3(T, N), kThreads, F * F * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(
      mq, pq, ok, posec, cos_q, sin_q, uv, score, G, B, T, csub, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int log_odds_update_i32(const int* log_odds, const int* pq, const uint8_t* ok,
                                   const int* posec, const int* trig, int* out, int N, int G,
                                   int B, int hit_q, int miss_q, int clamp_q, int samples,
                                   int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int rows = G < kStripeCells / G ? G : kStripeCells / G;  // >= 8 for G <= 1024
  const int stripes = (G + rows - 1) / rows;
  log_odds_update_kernel<<<dim3(stripes, N), kThreads, 2 * rows * G,
                           static_cast<cudaStream_t>(stream)>>>(
      log_odds, pq, ok, posec, trig, out, G, B, rows, hit_q, miss_q, clamp_q, samples);
  return static_cast<int>(cudaGetLastError());
}
