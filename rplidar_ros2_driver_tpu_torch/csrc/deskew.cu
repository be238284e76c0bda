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
// B5's first design gave one warp to each (row, candidate): 136 warps in
// 17 blocks at 8 rows x 17 shifts x 256 beams, on 17 of 132 SMs, each lane
// reading prev and cur from device memory (all 17 warps of a row read the
// same 2 KB again) and paying a signed % per element (0.00178 ms device on
// an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  Now:
//   * a block of kSadWarps = 4 warps takes one row and four of its
//     candidates, a warp each (8 rows x 5 blocks at the path's shape, on
//     40 SMs); it stages prev[r] and cur[r] in shared memory (2 KB at
//     D=256) with B4's copies — 16-byte loads from the first 16-byte
//     boundary, scalar loads for the head and the tail — issued first,
//     with the warp's shift, so that one round trip to memory brings all
//     of them; nothing is read from device memory again.  A whole row's
//     candidates in one block (the 17 warps of one SM) issue the beam loop
//     17 times over on one SM, and one warp a block stages the row per
//     candidate: both are slower (PERF.md, tools/kernel_variants.py);
//   * each warp reduces its shift to s' in [0, D) once (s % D, plus D when
//     negative), while its copies are in flight; the source of beam d is
//     then d - s', plus D when negative: a select, not a modulo per
//     element.  Any int32 shift is taken;
//   * lanes stride the D beams; the clamped |Δ| sum and the valid-pair
//     count are reduced with one __reduce_add_sync each; both are
//     non-negative, so C's truncating division is the floor division.
// The wrapper takes D <= kSadMaxBeams, the two profiles' 48 KB of shared
// memory (the ingest path's profile_beams are at most 1024).
//
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError(); each entry takes the card's index and makes that
// card current itself (device_guard.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "device_guard.cuh"

namespace {

constexpr int kEmpty = 0x7FFFFFFF;
constexpr int kThreads = 1024;  // threads per B4 block (one block per row)
constexpr int kSadWarps = 4;           // warps (one candidate each) per B5 block
constexpr int kSadMaxBeams = 6 * 1024;  // B5: two staged profiles in 48 KB of shared memory

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

__device__ __forceinline__ void store4(int* o, int4 x) {
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

// Copy the n ints of rows p and q into shared memory at sp and sq: int4
// loads from each row's first 16-byte boundary, both rows' loads in flight
// before either is stored, then scalar loads for the heads and tails.
__device__ __forceinline__ void stage_pair(int* sp, const int* __restrict__ p, int* sq,
                                           const int* __restrict__ q, int n, int t,
                                           int nthreads) {
  const int hp = min(phase(p), n), hq = min(phase(q), n);
  const int bp = (n - hp) >> 2, bq = (n - hq) >> 2;
  const int4* p4 = reinterpret_cast<const int4*>(p + hp);
  const int4* q4 = reinterpret_cast<const int4*>(q + hq);
  for (int i = t; i < max(bp, bq); i += nthreads) {
    int4 x, y;
    if (i < bp) x = __ldg(p4 + i);
    if (i < bq) y = __ldg(q4 + i);
    if (i < bp) store4(sp + hp + 4 * i, x);
    if (i < bq) store4(sq + hq + 4 * i, y);
  }
  if (t < hp) sp[t] = __ldg(p + t);
  if (t < hq) sq[t] = __ldg(q + t);
  for (int j = hp + 4 * bp + t; j < n; j += nthreads) sp[j] = __ldg(p + j);
  for (int j = hq + 4 * bq + t; j < n; j += nthreads) sq[j] = __ldg(q + j);
}

__global__ void __launch_bounds__(kSadWarps * 32)
    shift_sad_kernel(const int* __restrict__ prev, const int* __restrict__ cur,
                     const int* __restrict__ shifts, int* __restrict__ out, int C, int D,
                     int min_valid, int max_trans) {
  extern __shared__ int prof[];  // prev[row] (D), then cur[row] (D)
  int* sp = prof;
  int* sc = prof + D;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const size_t row = blockIdx.x;
  const int c = blockIdx.y * (blockDim.x >> 5) + (t >> 5);  // this warp's candidate
  const int s = c < C ? __ldg(shifts + c) : 0;  // in flight with the profiles
  stage_pair(sp, prev + row * D, sc, cur + row * D, D, t, blockDim.x);
  int sh = s % D;  // roll(cur, s)[d] = cur[(d - s) mod D] = cur[d - sh (+ D)]
  if (sh < 0) sh += D;
  __syncthreads();
  if (c >= C) return;
  int sad = 0, cnt = 0;
  for (int d = lane; d < D; d += 32) {
    int src = d - sh;
    src += src < 0 ? D : 0;
    const int a = sp[d];
    const int b = sc[src];
    if (a != kEmpty && b != kEmpty) {
      const int diff = min(max(b - a, -max_trans), max_trans);
      sad += diff < 0 ? -diff : diff;
      cnt += 1;
    }
  }
  sad = __reduce_add_sync(0xFFFFFFFFu, sad);
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0) out[row * C + c] = cnt >= min_valid ? sad / max(cnt, 1) : kEmpty;
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
  if (D < 1 || D > kSadMaxBeams) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = std::min(C, kSadWarps);
  const dim3 grid(rows, (C + warps - 1) / warps);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  shift_sad_kernel<<<grid, warps * 32, 2 * D * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
      prev, cur, shifts, out, C, D, min_valid, max_trans);
  return static_cast<int>(cudaGetLastError());
}
