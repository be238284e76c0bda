// Temporal-median kernels of the filter chain, written for Hopper (sm_90a).
//
// B1  temporal_median_f32 — replaces the JAX package's TPU kernel
//     ops/pallas_kernels.py temporal_median_pallas (its pallas_call in
//     _median_call): per beam, the lower median of the finite values of a
//     (W, B) ring, s[clip((nvalid-1)//2, 0, W-1)] of the ascending column;
//     a beam with no finite value is +inf.
// B2  sorted_replace_f32 — replaces ops/pallas_kernels.py
//     sorted_replace_pallas (its pallas_call in _sorted_replace_call): on
//     the per-beam sorted window, delete the FIRST occurrence of `old`,
//     insert `new` "after equals" (p = #{s < new} - (old < new)), write the
//     shifted column and the new window's lower median.
//
// What bounds them on an H100: not the memory.  At the main path's size
// (W=64, B=2048) B1 reads 512 KiB and writes 8 KiB, B2 reads 528 KiB and
// writes 520 KiB: about 0.16 us and 0.32 us of HBM time at 3.35 TB/s, less
// than a kernel launch.  What they spend is the launch, the latency of one
// round trip to device memory, and compare work: an exact selection of the
// k-th of W values costs O(W) compares per candidate.
//
// B1's design.  The TPU kernel ran a bitonic network because VMEM wants
// static vector shapes; here selection is by rank (v is the k-th smallest
// iff #{u < v} <= k < #{u < v} + #{u == v}), and any exact selection gives
// the sort's bits, so nothing is sorted.  One warp owns one beam column,
// kCols = 8 columns to a 256-thread block, so W=64, B=2048 runs 256 blocks,
// all resident at once on 132 SMs:
//   * the block stages its (W, 8) tile in shared memory with 16-byte
//     cp.async copies (two per row: every 32-byte sector fetched is used),
//     plain loads with +inf on the ragged beam edge or a row that is not
//     16-byte aligned (B % 4 != 0);
//   * the warp counts its column's finite values once, __popc of a
//     __ballot_sync per 32 rows, and sets k = (nvalid - 1) >> 1;
//   * each lane ranks its own candidates (rows lane, lane + 32, ...; kCand
//     of them at a time in registers) against the whole column; every lane
//     reads the same shared word at each step, a broadcast, so there are no
//     bank conflicts: W=64 is one pass of 64 steps;
//   * the lane that holds the k-th value is found by a ballot and the value
//     taken with __shfl_sync; the warp stops at the first pass that finds
//     it.  A column with no finite value stays +inf;
//   * W is arbitrary: a column too tall for kStageBytes of shared memory
//     (W > 1536) is read from device memory directly, the same broadcast
//     loads through L1.
//
// B2's design.  Its first design ran one thread per beam, 64 threads a
// block: 32 blocks on 132 SMs, each thread walking its strided column
// twice, about 190 dependent memory operations with nothing to hide them
// (0.0182 ms device at W=64, B=2048 on an NVIDIA H100 80GB HBM3 at 700 W,
// 57x its bound; PERF.md).  Now it fills the card and works out of shared
// memory as B1 does:
//   * a block owns kCols = 8 beams (256 blocks at B=2048) and stages its
//     (W, 8) slab with B1's copies (stage_tile);
//   * warp c takes column c: the delete slot d is __ffs of the first
//     non-zero __ballot_sync(v == old) over chunks of 32 rows (0 when no
//     row holds old, as the plain version's argmax gives), the insert slot
//     p the sum of __popc(__ballot_sync(v < new)) less (old < new); a
//     second ballot pass counts the updated column's finite values, and
//     one shared read gives the lower median;
//   * all threads then write the updated slab row by row, beam-fastest
//     (a warp's stores are four whole 32-byte sectors), element i the
//     3-way select of Replace read from shared memory;
//   * a column too tall to stage is read from device memory directly, as
//     B1's is: the slab and the block's 96 bytes of slots (kSlotBytes)
//     must fit kStageBytes together, so W > 1533 is not staged.
//
// +inf takes part like any value.  Both launch on the caller's stream,
// allocate nothing and return cudaGetLastError(); each entry takes the
// card's index and makes that card current itself (device_guard.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCols = 8;                    // beam columns (warps) per block
constexpr int kCand = 2;                    // B1: candidates per lane per pass
constexpr size_t kStageBytes = 48 * 1024;   // a staged tile: shared memory without opt-in
// B2's static shared memory, the per-column slots d, p and new: a staged
// launch fits its tile beside them in kStageBytes
constexpr size_t kSlotBytes = kCols * (2 * sizeof(int) + sizeof(float));

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Stage the block's (W, kCols) tile of the row-major (W, B) plane from beam
// b0: 16-byte cp.async copies (two per row, every 32-byte sector fetched is
// used) when the tile is whole and its rows are 16-byte aligned, else plain
// loads with +inf past the ragged beam edge.  The caller waits
// (cp_async_wait_all, then __syncthreads) before it reads the tile.
__device__ __forceinline__ void stage_tile(const float* __restrict__ win, float* tile, int W,
                                           int B, int b0) {
  const bool vec = b0 + kCols <= B && (B & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(win) & 15) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) {
      const int j = i >> 1, h = (i & 1) * 4;
      cp_async16(tile + j * kCols + h, win + (size_t)j * B + b0 + h);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = threadIdx.x; i < kCols * W; i += blockDim.x) {
      const int j = i / kCols, c = i % kCols;
      tile[i] = b0 + c < B ? win[(size_t)j * B + b0 + c] : INFINITY;
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The lower median of one column (stride `stride` between rows), for the
// whole warp; every lane returns it.
__device__ __forceinline__ float column_median(const float* col, size_t stride, int W,
                                               int lane) {
  int nvalid = 0;
  for (int j0 = 0; j0 < W; j0 += 32) {
    const int j = j0 + lane;
    nvalid += __popc(__ballot_sync(kFull, j < W && isfinite(col[j * stride])));
  }
  if (nvalid == 0) return INFINITY;  // warp-uniform
  const int k = (nvalid - 1) >> 1;   // < nvalid: the answer is finite
  for (int s0 = 0; s0 < W; s0 += 32 * kCand) {
    float v[kCand];
    int less[kCand], equal[kCand];
#pragma unroll
    for (int c = 0; c < kCand; ++c) {
      const int j = s0 + 32 * c + lane;
      v[c] = j < W ? col[j * stride] : NAN;  // NaN ranks nowhere
      less[c] = 0;
      equal[c] = 0;
    }
#pragma unroll 8
    for (int j = 0; j < W; ++j) {
      const float u = col[j * stride];  // the same word in every lane
#pragma unroll
      for (int c = 0; c < kCand; ++c) {
        less[c] += u < v[c] ? 1 : 0;
        equal[c] += u == v[c] ? 1 : 0;
      }
    }
    bool hit = false;
    float mine = INFINITY;
#pragma unroll
    for (int c = 0; c < kCand; ++c) {
      if (!hit && less[c] <= k && k < less[c] + equal[c]) {
        hit = true;
        mine = v[c];
      }
    }
    // every lane that hit holds the same value: take the first one's
    const unsigned found = __ballot_sync(kFull, hit);
    if (found) return __shfl_sync(kFull, mine, __ffs(found) - 1);
  }
  return INFINITY;  // unreachable for a column with a finite value
}

template <bool kStaged>
__global__ void __launch_bounds__(kCols * 32)
    temporal_median_kernel(const float* __restrict__ win, float* __restrict__ out, int W,
                           int B) {
  extern __shared__ __align__(16) float tile[];  // (W, kCols) when staged
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kCols;
  const int b = b0 + warp;
  if constexpr (kStaged) {
    stage_tile(win, tile, W, B, b0);
    cp_async_wait_all();
    __syncthreads();
  }
  if (b >= B) return;  // whole warps leave together
  float m;
  if constexpr (kStaged) {
    m = column_median(tile + warp, kCols, W, lane);
  } else {
    m = column_median(win + b, (size_t)B, W, lane);
  }
  if (lane == 0) out[b] = m;
}

struct Replace {
  const float* col;  // this beam's sorted column, `stride` floats between rows
  size_t stride;
  int W, d, p;
  float nv;
  // element i of the updated column: insert slot, then the two shifts
  __device__ float operator()(int i) const {
    if (i == p) return nv;
    if (d < p && i >= d && i < p) return col[(size_t)((i + 1) % W) * stride];
    if (d > p && i > p && i <= d) return col[(size_t)((i - 1 + W) % W) * stride];
    return col[(size_t)i * stride];
  }
};

template <bool kStaged>
__global__ void __launch_bounds__(kCols * 32)
    sorted_replace_kernel(const float* __restrict__ s, const float* __restrict__ old_v,
                          const float* __restrict__ new_v, float* __restrict__ out,
                          float* __restrict__ med, int W, int B) {
  extern __shared__ __align__(16) float tile[];  // (W, kCols) when staged
  __shared__ int slot_d[kCols], slot_p[kCols];  // kSlotBytes in all
  __shared__ float slot_new[kCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kCols;
  const int b = b0 + warp;
  const size_t stride = kStaged ? kCols : (size_t)B;
  if constexpr (kStaged) stage_tile(s, tile, W, B, b0);
  const bool live = b < B;  // warp-uniform
  // this column's evicted and inserted values, loaded while the copies fly
  const float ov = live ? old_v[b] : 0.0f;
  const float nv = live ? new_v[b] : 0.0f;
  if constexpr (kStaged) {
    cp_async_wait_all();
    __syncthreads();
  }
  if (live) {
    const float* col = kStaged ? tile + warp : s + b;
    // d: the first row holding `old` (0 when absent, as argmax gives); the
    // count of rows below `new`.  Rows past W hold NaN: no ballot takes them
    int d = -1, below = 0;
    for (int j0 = 0; j0 < W; j0 += 32) {
      const int j = j0 + lane;
      const float v = j < W ? col[j * stride] : NAN;
      const unsigned eq = __ballot_sync(kFull, v == ov);
      if (d < 0 && eq) d = j0 + __ffs(eq) - 1;
      below += __popc(__ballot_sync(kFull, v < nv));
    }
    const Replace elem{col, stride, W, d < 0 ? 0 : d, below - (ov < nv ? 1 : 0), nv};
    // lower median of the updated column: clip(floor((nvalid-1)/2), 0,
    // W-1) of its finite values, +inf when it has none
    int nvalid = 0;
    for (int j0 = 0; j0 < W; j0 += 32) {
      const int j = j0 + lane;
      nvalid += __popc(__ballot_sync(kFull, j < W && isfinite(elem(j))));
    }
    if (lane == 0) {
      med[b] = nvalid > 0 ? elem(min((nvalid - 1) >> 1, W - 1)) : INFINITY;
      slot_d[warp] = elem.d;
      slot_p[warp] = elem.p;
      slot_new[warp] = nv;
    }
  }
  __syncthreads();
  // the updated slab, row by row, beam-fastest: a warp stores whole sectors
  for (int e = threadIdx.x; e < W * kCols; e += blockDim.x) {
    const int i = e / kCols, c = e % kCols;
    if (b0 + c >= B) continue;
    const Replace elem{kStaged ? tile + c : s + b0 + c, stride, W, slot_d[c], slot_p[c],
                       slot_new[c]};
    out[(size_t)i * B + b0 + c] = elem(i);
  }
}

}  // namespace

extern "C" int temporal_median_f32(const float* win, float* out, int W, int B, int device,
                                   void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const size_t smem = (size_t)W * kCols * sizeof(float);
  const dim3 grid((B + kCols - 1) / kCols);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem <= kStageBytes) {
    temporal_median_kernel<true><<<grid, kCols * 32, smem, s>>>(win, out, W, B);
  } else {
    temporal_median_kernel<false><<<grid, kCols * 32, 0, s>>>(win, out, W, B);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sorted_replace_f32(const float* s, const float* old_v,
                                  const float* new_v, float* out, float* med,
                                  int W, int B, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const size_t smem = (size_t)W * kCols * sizeof(float);
  const dim3 grid((B + kCols - 1) / kCols);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem + kSlotBytes <= kStageBytes) {
    sorted_replace_kernel<true><<<grid, kCols * 32, smem, st>>>(s, old_v, new_v, out, med, W, B);
  } else {
    sorted_replace_kernel<false><<<grid, kCols * 32, 0, st>>>(s, old_v, new_v, out, med, W, B);
  }
  return static_cast<int>(cudaGetLastError());
}
