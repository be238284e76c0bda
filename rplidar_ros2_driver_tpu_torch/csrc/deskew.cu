// De-skew kernels of the fused ingest path, written for Hopper (sm_90a).
//
// B4  beam_min_i32 — replaces the JAX package's TPU kernel
//     ops/pallas_deskew.py beam_min_pallas (its pallas_call in
//     _beam_min_call, kernel _beam_min_kernel): for each row r, the
//     per-beam int32 minimum of values[r, j] over the nodes j with
//     beam[r, j] == b; RECON_EMPTY (0x7FFFFFFF) where no node landed.
//     The fused ingest calls it for the tick's sub-sweep rasterizer (one
//     row per stream, n = frames x samples nodes, nbeams = recon_beams)
//     and for the revolution profiles (one row per stream and revolution
//     slot, n = max_nodes, nbeams = profile_beams).
// B5  shift_sad_i32 — replaces ops/pallas_deskew.py shift_sad_pallas
//     (_shift_sad_call, kernel _shift_sad_kernel): for each row r and
//     circular shift s_c, over the beams valid in both prev[r] and
//     roll(cur[r], s_c) the sum of |clip(rolled - prev, ±max_trans)|,
//     floor-divided by their count; RECON_EMPTY when the count is below
//     min_valid.  One row per stream and revolution slot.
//
// Both are exact: int32 min and sum are associative and commutative, so
// any evaluation order — shared-memory atomics, warp shuffles — gives the
// TPU kernel's bits.
//
// What bounds them on an H100: at the ingest path's shapes they move
// tens of KB (B4 at 1 x 2560 nodes -> 2048 beams: 28 KB, about 0.01 us of
// HBM time; at 8 x 4096 -> 256: 270 KB, 0.08 us; B5 at 8 rows x 17 shifts
// x 256 beams: 16 KB read) and do under a million integer operations, so
// what they spend is the launch and one or two round trips to device
// memory: a few microseconds each, hundreds of times their byte bound.
//
// B4's design: one block of kThreads per row holds all of the row's beams
// in shared memory (nbeams <= 8192, so at most 32 KB), so each node is
// read once, by one thread, and every SM that has a row works on it alone:
//   * each thread issues its first 16-byte (int4) loads of `beam` and
//     `values` before it initialises its share of the beams to
//     RECON_EMPTY, so the round trip to memory overlaps the initialisation
//     and the barrier; at the rasterizer's 2,560 nodes that first load is
//     the whole row;
//   * a node whose beam lies in [0, nbeams) and whose value is not
//     RECON_EMPTY goes into its beam with a shared-memory atomicMin; any
//     other node touches nothing (RECON_EMPTY is the largest int32, so
//     skipping it changes no minimum);
//   * a row that does not start on a 16-byte boundary (n % 4 != 0, or an
//     offset view) takes scalar loads for its head up to the boundary and
//     for the tail; when `beam` and `values` sit at different phases the
//     whole row is read with scalar loads;
//   * the row is written out with 16-byte stores the same way.
// One block per row puts the rasterizer's single row on one SM.  Splitting
// that row over a thread-block cluster, reduced through distributed shared
// memory, would pay only while the block's device time stays above ~3 us;
// chip_smoke.py measures it below that (PERF.md), so there is no cluster.
// B5 gives one warp to each (row, candidate): lanes stride the D beams,
// read prev[d] and cur[(d - s) mod D] directly (no rolled plane in
// memory), and reduce the clamped |Δ| sum and the valid-pair count with
// warp shuffles; both are non-negative, so C's truncating division is the
// floor division.
//
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError(); each entry takes the card's index and makes that
// card current itself (device_guard.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kEmpty = 0x7FFFFFFF;
constexpr int kThreads = 1024;  // threads per B4 block (one block per row)
constexpr int kWarps = 8;       // warps (candidates) per B5 block

// Elements before the first 16-byte boundary of a 4-byte-aligned pointer.
__device__ __forceinline__ int phase(const void* p) {
  return static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
}

__device__ __forceinline__ void take(int* acc, int beam, int val, int nbeams) {
  if (static_cast<unsigned>(beam) < static_cast<unsigned>(nbeams) && val != kEmpty) {
    atomicMin(&acc[beam], val);
  }
}

__device__ __forceinline__ void take4(int* acc, int4 b, int4 v, int nbeams) {
  take(acc, b.x, v.x, nbeams);
  take(acc, b.y, v.y, nbeams);
  take(acc, b.z, v.z, nbeams);
  take(acc, b.w, v.w, nbeams);
}

__global__ void __launch_bounds__(kThreads)
    beam_min_kernel(const int* __restrict__ beam, const int* __restrict__ values,
                    int* __restrict__ out, int n, int nbeams) {
  extern __shared__ int acc[];  // (nbeams,)
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  const int* b = beam + row * n;
  const int* v = values + row * n;
  // head (scalar) | body (int4) | tail (scalar); no body when the two rows
  // sit at different 16-byte phases
  const int pb = phase(b);
  const bool same = pb == phase(v);
  const int head = same ? min(pb, n) : n;
  const int body = same ? (n - head) >> 2 : 0;
  const int4* b4 = reinterpret_cast<const int4*>(b + head);
  const int4* v4 = reinterpret_cast<const int4*>(v + head);
  int4 bq, vq;
  const bool first = t < body;
  if (first) {  // in flight while the beams are initialised
    bq = __ldg(b4 + t);
    vq = __ldg(v4 + t);
  }
  for (int i = t; i < nbeams; i += kThreads) acc[i] = kEmpty;
  __syncthreads();
  if (first) take4(acc, bq, vq, nbeams);
  for (int q = t + kThreads; q < body; q += kThreads) take4(acc, __ldg(b4 + q), __ldg(v4 + q), nbeams);
  for (int j = t; j < head; j += kThreads) take(acc, __ldg(b + j), __ldg(v + j), nbeams);
  for (int j = head + 4 * body + t; j < n; j += kThreads) take(acc, __ldg(b + j), __ldg(v + j), nbeams);
  __syncthreads();
  int* o = out + row * nbeams;
  const int ohead = min(phase(o), nbeams);
  const int obody = (nbeams - ohead) >> 2;
  int4* o4 = reinterpret_cast<int4*>(o + ohead);
  for (int q = t; q < obody; q += kThreads) {
    const int* a = acc + ohead + 4 * q;
    o4[q] = make_int4(a[0], a[1], a[2], a[3]);
  }
  if (t < ohead) o[t] = acc[t];
  for (int j = ohead + 4 * obody + t; j < nbeams; j += kThreads) o[j] = acc[j];
}

__global__ void shift_sad_kernel(const int* __restrict__ prev,
                                 const int* __restrict__ cur,
                                 const int* __restrict__ shifts,
                                 int* __restrict__ out, int rows, int C, int D,
                                 int min_valid, int max_trans) {
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows * C) return;  // whole warps exit together
  const int row = warp / C;
  const int c = warp % C;
  const int s = shifts[c];
  const int* p = prev + static_cast<size_t>(row) * D;
  const int* q = cur + static_cast<size_t>(row) * D;
  int sad = 0, cnt = 0;
  for (int d = lane; d < D; d += 32) {
    int src = (d - s) % D;  // roll(cur, s)[d] = cur[(d - s) mod D]
    if (src < 0) src += D;
    const int a = p[d];
    const int b = q[src];
    if (a != kEmpty && b != kEmpty) {
      const int diff = min(max(b - a, -max_trans), max_trans);
      sad += diff < 0 ? -diff : diff;
      cnt += 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    sad += __shfl_down_sync(0xFFFFFFFFu, sad, off);
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
  }
  if (lane == 0) {
    out[static_cast<size_t>(row) * C + c] =
        cnt >= min_valid ? sad / max(cnt, 1) : kEmpty;
  }
}

}  // namespace

extern "C" int beam_min_i32(const int* beam, const int* values, int* out, int rows, int n,
                            int nbeams, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  beam_min_kernel<<<rows, kThreads, nbeams * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      beam, values, out, n, nbeams);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shift_sad_i32(const int* prev, const int* cur, const int* shifts,
                             int* out, int rows, int C, int D, int min_valid,
                             int max_trans, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int warps = rows * C;
  const int blocks = (warps + kWarps - 1) / kWarps;
  shift_sad_kernel<<<blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      prev, cur, shifts, out, rows, C, D, min_valid, max_trans);
  return static_cast<int>(cudaGetLastError());
}
