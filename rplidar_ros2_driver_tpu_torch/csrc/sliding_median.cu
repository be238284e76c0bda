// Sliding temporal-median kernel of the fused K-scan filter path, written
// for Hopper (sm_90a).
//
// B3  sliding_median_f32 — replaces the JAX package's TPU kernel
//     ops/pallas_kernels.py sliding_median_pallas (its pallas_call in
//     _sliding_median_call): for a (W + K, B) history stripe (the previous
//     ring in age order, then K new rows) and each step i in [0, K), the
//     per-beam lower median of the finite values of rows i+1 .. i+W,
//     s[clip((nvalid-1)//2, 0, W-1)] of the ascending window; +inf when no
//     value of the window is finite.
//
// What bounds it on an H100: at the replay path's size (W=64, K=512,
// B=2048) the stripe is 4.5 MiB in and the medians 4 MiB out, about
// 2.7 us of HBM time at 3.35 TB/s; the least compare work, 2·W·K·B, is
// about 2 us at the 67 TFLOP/s float32 rate.  A per-window count-rank
// selection (as B1 does) would do K·B·W² ≈ 4.3e9 compare pairs, and the
// TPU kernel's bitonic network K·B·W·log²W: both far from those bounds.
//
// Selection rule: nothing is sorted.  Every stripe row j >= 1 is a
// candidate, v = ext[j][b], and is followed through every window that
// holds it, i in [j-W, j-1] ∩ [0, K).  Ties are broken by row, so the
// window's members are totally ordered: v's rank in window i is
//     #{rows r < j of the window: u <= v} + #{rows r > j: u < v},
// and v is window i's lower median iff its rank is k = max((nvalid-1)>>1,
// 0).  Exactly one member has each rank, so exactly one thread writes each
// output, and its value is the sort's s[k] — the bits the sort gives, for
// any values but NaN; a window with no finite value is written +inf, as
// the plain version masks it.  The rank slides: moving from window i-1 to
// window i removes row i (always before the candidates still in the
// window: u <= v) and adds row i+W (after them: u < v), one compare each.
//
// The first design ran one thread per (candidate, beam) out of L1/L2:
// about 3W global loads and two counts (#{<v}, #{==v}) per compare, with
// every window's nvalid recounted by each of its W members (0.1776 ms
// device at W=64, K=512, B=2048 on an NVIDIA H100 80GB HBM3 at 700 W, 67x
// its bound; PERF.md).  Now:
//   * a block takes kBeams = 32 neighbouring beams (lane = beam) and a run
//     of R = kQ x warps candidate rows; it stages the rows its windows read,
//     at most R + 2W - 2 of them (W=64, R=48: 174 rows, 22 KB), in shared
//     memory once, with 16-byte cp.async copies where the stripe's rows are
//     16-byte aligned (B % 4 == 0 and an aligned base), 4-byte ones
//     otherwise, +inf past the ragged beam edge.  Every warp then reads one
//     row at a time across its 32 lanes: conflict-free;
//   * each thread owns kQ = 6 consecutive candidate rows of its beam in
//     registers, so each row it reads is compared against all six, and
//     the window's nvalid is counted once for the six (3, 4 and 8 rows a
//     thread are slower: PERF.md, tools/kernel_variants.py);
//   * one compare per member and window: the row tie-break makes the test
//     rank == k, not #{<v} <= k < #{<v} + #{==v}; at most one of a
//     thread's candidates has rank k, so a window costs it one store;
//   * the windows where the thread's own rows enter or leave, or where
//     some of its candidates are outside the window, take the general
//     rule (per-candidate row order, in-window test); the W - kQ windows
//     between take the plain slide, with no test but rank == k.  A warp's
//     lanes share j, so they always agree on the phase;
//   * W is arbitrary and never padded, K needs no multiple of 8 (the Pallas
//     padding was a Mosaic constraint), the ragged beam edge is masked.
//     The entry's caller (ops/median_kernels.sliding_plan) picks the warps
//     per block, fewer when a block's rows would pass kStageBytes, and past
//     that the unstaged route: the same threads reading the stripe from
//     device memory through L1.  A block's rows are min(R + 2W - 2,
//     W + K - 1), so the unstaged route takes W > 190 with W + K > 385,
//     e.g. the chain's largest tested window, 1536.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the entry takes the card's index and makes that card
// current itself (device_guard.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "device_guard.cuh"

namespace {

constexpr int kBeams = 32;                  // beams per block (threadIdx.x, one warp)
constexpr int kQ = 6;                       // candidate rows per thread
constexpr int kMaxWarps = 8;                // warps per block (threadIdx.y)
constexpr size_t kStageBytes = 48 * 1024;   // staged rows: shared memory without opt-in

__device__ __forceinline__ void cp_async(float* smem, const float* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
  }
}

// Copy rows lo .. hi of beams b0 .. b0+31 into tile[(r - lo) * kBeams + lane]
// (+inf past the beam edge), then wait for the copies and the block.
__device__ __forceinline__ void stage_rows(const float* __restrict__ ext, float* tile, int lo,
                                           int hi, int B, int b0) {
  const int t = threadIdx.y * kBeams + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int rows = hi - lo + 1;
  const bool wide = B % 4 == 0 && (reinterpret_cast<uintptr_t>(ext) & 15) == 0;
  if (wide && b0 + kBeams <= B) {  // 8 copies of 16 bytes a row
    for (int c = t; c < rows * (kBeams / 4); c += nthreads) {
      const int r = c / (kBeams / 4), q = (c % (kBeams / 4)) * 4;
      cp_async(tile + r * kBeams + q, ext + static_cast<size_t>(lo + r) * B + b0 + q, 16);
    }
  } else {
    for (int c = t; c < rows * kBeams; c += nthreads) {
      const int r = c / kBeams, lane = c % kBeams;
      if (b0 + lane < B) {
        cp_async(tile + c, ext + static_cast<size_t>(lo + r) * B + b0 + lane, 4);
      } else {
        tile[c] = INFINITY;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// One beam's column of the stripe from row lo on: the staged tile (32-bit
// offsets into shared memory, kBeams floats a row) or device memory.
template <bool kStaged>
struct Column {
  const float* p;
  int lo;
  static constexpr int step = kBeams;  // elements from one row to the next
  __device__ __forceinline__ const float* at(int r) const { return p + (r - lo) * kBeams; }
  __device__ __forceinline__ float operator[](int r) const { return *at(r); }
};
template <>
struct Column<false> {
  const float* p;
  int lo;
  size_t step;
  __device__ __forceinline__ const float* at(int r) const {
    return p + static_cast<size_t>(r - lo) * step;
  }
  __device__ __forceinline__ float operator[](int r) const { return *at(r); }
};

// Row r's share of candidate row jd's rank: rows before it count u <= v,
// rows after it u < v, the candidate itself nothing.
__device__ __forceinline__ int before(float u, int r, float v, int jd) {
  return r < jd ? (u <= v ? 1 : 0) : (r > jd && u < v ? 1 : 0);
}

template <bool kStaged>
__global__ void __launch_bounds__(kBeams * kMaxWarps)
    sliding_median_kernel(const float* __restrict__ ext, float* __restrict__ out, int W, int K,
                          int B) {
  extern __shared__ __align__(16) float tile[];
  const int lane = threadIdx.x;
  const int R = kQ * blockDim.y;
  const int b0 = blockIdx.y * kBeams;
  const int b = b0 + lane;
  const int last_row = W + K - 1;
  const int j0 = 1 + blockIdx.x * R;  // row 0 is in no window
  // the rows the block's windows read: from the first window of its first
  // candidate to the last window of its last one
  const int lo = max(j0 - W, 0) + 1;
  const int hi = min(j0 + R - 2, K - 1) + W;
  Column<kStaged> col;
  if constexpr (kStaged) {
    stage_rows(ext, tile, lo, hi, B, b0);
    col = {tile + lane, lo};
  } else {
    col = {ext + static_cast<size_t>(lo) * B + b, lo, static_cast<size_t>(B)};
  }
  const int j = j0 + threadIdx.y * kQ;  // this thread's candidate rows j .. j+kQ-1
  if (b >= B || j > last_row) return;

  float v[kQ];
  int cnt[kQ];
#pragma unroll
  for (int d = 0; d < kQ; ++d) {
    v[d] = j + d <= last_row ? col[j + d] : INFINITY;  // a row past the stripe is in no window
    cnt[d] = 0;
  }
  const int first = max(j - W, 0);          // candidate j's first window
  const int last = min(j + kQ - 2, K - 1);  // candidate j+kQ-1's last window
  // window `first`: rows first+1 .. first+W, split at the candidates' rows
  int nvalid = 0;
  const int top = first + W;
  for (int r = first + 1; r <= min(j - 1, top); ++r) {
    const float u = col[r];
    nvalid += isfinite(u) ? 1 : 0;
#pragma unroll
    for (int d = 0; d < kQ; ++d) cnt[d] += u <= v[d] ? 1 : 0;
  }
  for (int r = j; r <= min(j + kQ - 1, top); ++r) {
    const float u = col[r];
    nvalid += isfinite(u) ? 1 : 0;
#pragma unroll
    for (int d = 0; d < kQ; ++d) cnt[d] += before(u, r, v[d], j + d);
  }
  for (int r = j + kQ; r <= top; ++r) {
    const float u = col[r];
    nvalid += isfinite(u) ? 1 : 0;
#pragma unroll
    for (int d = 0; d < kQ; ++d) cnt[d] += u < v[d] ? 1 : 0;
  }

  const int top_general = min(last, min(j + kQ - W - 1, j - 1));
  float* o = out + static_cast<size_t>(first) * B + b;
  // window i's median is the candidate whose rank is k; a window with no
  // finite value is +inf
  auto emit = [&](int i, bool all_in) {
    const int k = max((nvalid - 1) >> 1, 0);
    bool hit = false;  // at most one of the thread's candidates has rank k
    float m = 0.0f;
#pragma unroll
    for (int d = 0; d < kQ; ++d) {
      const bool in = all_in || (i >= j + d - W && i <= j + d - 1);
      if (in && cnt[d] == k) {
        hit = true;
        m = v[d];
      }
    }
    if (hit) *o = nvalid > 0 ? m : INFINITY;
  };
  // window i-1 held rows i .. i+W-1; window i drops row i, gains row i+W:
  // the general rule, for windows where the moving rows may be the
  // thread's own or some candidate is outside the window
  auto slide = [&](int i) {
    const float gone = col[i];
    const float came = col[i + W];
    nvalid += (isfinite(came) ? 1 : 0) - (isfinite(gone) ? 1 : 0);
#pragma unroll
    for (int d = 0; d < kQ; ++d) {
      cnt[d] += before(came, i + W, v[d], j + d) - before(gone, i, v[d], j + d);
    }
    o += B;
  };
  emit(first, false);
  int i = first + 1;
  for (; i <= top_general; ++i) {
    slide(i);
    emit(i, false);
  }
  // windows j+kQ-W .. j-1: every candidate is in, row i is before them all
  // and row i+W after them all
  const float* gone_p = col.at(i);
  const float* came_p = col.at(i + W);
  for (const int top_plain = min(last, j - 1); i <= top_plain; ++i) {
    const float gone = *gone_p;
    const float came = *came_p;
    gone_p += col.step;
    came_p += col.step;
    nvalid += (isfinite(came) ? 1 : 0) - (isfinite(gone) ? 1 : 0);
#pragma unroll
    for (int d = 0; d < kQ; ++d) cnt[d] += (came < v[d] ? 1 : 0) - (gone <= v[d] ? 1 : 0);
    o += B;
    emit(i, true);
  }
  for (; i <= last; ++i) {
    slide(i);
    emit(i, false);
  }
}

}  // namespace

// warps: warps per block (R = kQ x warps candidate rows); rows: the staged
// rows of a block (its dynamic shared memory is rows x kBeams floats), or 0
// for the unstaged route.  Both come from ops/median_kernels.sliding_plan.
extern "C" int sliding_median_f32(const float* ext, float* out, int W, int K, int B, int warps,
                                  int rows, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int R = kQ * warps;
  const size_t smem = static_cast<size_t>(rows) * kBeams * sizeof(float);
  // a staged block holds up to min(R + 2W - 2, W + K - 1) rows
  if (warps < 1 || warps > kMaxWarps || rows < 0 || smem > kStageBytes ||
      (rows > 0 && rows < std::min(R + 2 * W - 2, W + K - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBeams, warps);
  const dim3 grid((W + K - 1 + R - 1) / R, (B + kBeams - 1) / kBeams);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    sliding_median_kernel<true><<<grid, block, smem, s>>>(ext, out, W, K, B);
  } else {
    sliding_median_kernel<false><<<grid, block, 0, s>>>(ext, out, W, K, B);
  }
  return static_cast<int>(cudaGetLastError());
}
