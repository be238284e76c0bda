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
// HBM time; B5 at 8 rows x 17 shifts x 256 beams: 16 KB read) and do
// under a million integer operations, so they are launch-bound: a few
// microseconds each, hundreds of times their byte bound.
//
// Design.  B4 is a scatter-min instead of the TPU kernel's (tile x chunk)
// compare plane: one block per (row, tile of kTile beams) holds its beams
// in shared memory, initialised to RECON_EMPTY; its threads stream the
// row's nodes and atomicMin into shared memory those whose beam falls in
// the tile, then write the tile out.  Any node count works (a strided
// loop, no padding), and a node whose beam lies outside [0, nbeams)
// touches nothing.  B5 gives one warp to each (row, candidate): lanes
// stride the D beams, read prev[d] and cur[(d - s) mod D] directly (no
// rolled plane in memory), and reduce the clamped |Δ| sum and the
// valid-pair count with warp shuffles; both are non-negative, so C's
// truncating division is the floor division.  Both launch on the
// caller's stream, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 0x7FFFFFFF;
constexpr int kTile = 1024;     // beams per B4 block (4 KB of shared memory)
constexpr int kThreads = 256;   // threads per B4 block
constexpr int kWarps = 8;       // warps (candidates) per B5 block

__global__ void beam_min_kernel(const int* __restrict__ beam,
                                const int* __restrict__ values,
                                int* __restrict__ out, int n, int nbeams) {
  __shared__ int tile[kTile];
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int tb = min(kTile, nbeams - t0);
  for (int i = threadIdx.x; i < tb; i += blockDim.x) tile[i] = kEmpty;
  __syncthreads();
  const int* b = beam + static_cast<size_t>(row) * n;
  const int* v = values + static_cast<size_t>(row) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int local = b[j] - t0;
    if (static_cast<unsigned>(local) < static_cast<unsigned>(tb)) {
      const int val = v[j];
      if (val != kEmpty) atomicMin(&tile[local], val);
    }
  }
  __syncthreads();
  int* o = out + static_cast<size_t>(row) * nbeams + t0;
  for (int i = threadIdx.x; i < tb; i += blockDim.x) o[i] = tile[i];
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

extern "C" int beam_min_i32(const int* beam, const int* values, int* out,
                            int rows, int n, int nbeams, void* stream) {
  const dim3 grid((nbeams + kTile - 1) / kTile, rows);
  beam_min_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      beam, values, out, n, nbeams);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shift_sad_i32(const int* prev, const int* cur, const int* shifts,
                             int* out, int rows, int C, int D, int min_valid,
                             int max_trans, void* stream) {
  const int warps = rows * C;
  const int blocks = (warps + kWarps - 1) / kWarps;
  shift_sad_kernel<<<blocks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      prev, cur, shifts, out, rows, C, D, min_valid, max_trans);
  return static_cast<int>(cudaGetLastError());
}
