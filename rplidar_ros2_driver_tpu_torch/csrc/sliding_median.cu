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
// Design: nothing is sorted.  One thread per (candidate row j, beam) owns
// the value v = ext[j][b] and follows it through every window that holds
// it, i in [j-W, j-1] ∩ [0, K).  Over its first window it counts #{u < v},
// #{u == v} and #{u finite} (W loads); each further step slides the window
// by removing row i and adding row i+W (two loads).  v is window i's lower
// median iff v is finite and #{<v} <= (nvalid-1)/2 < #{<v} + #{==v} — any
// exact selection gives the sort's bits — and that thread writes it.  A
// window with no finite value holds only +inf, and every member writes
// +inf.  Every window has W >= 1 members and its lower median has a member
// that passes the test, so every output is written; threads holding equal
// values write the same bits.  Work per beam is O((W + K)·W) instead of
// O(K·W²).  Threads of a warp take 32 neighbouring beams of one row, so
// every load of the row-major stripe is one coalesced 128-byte line; a
// block's rows (its candidates ± W) stay in L1, the whole stripe in the
// 50 MB L2.  No shared memory: W is arbitrary and never padded, K needs no
// multiple of 8 (the Pallas padding was a Mosaic constraint), the ragged
// beam edge is masked.  It launches on the caller's stream, allocates
// nothing and returns cudaGetLastError(); the entry takes the card's index
// and makes that card current itself (device_guard.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "device_guard.cuh"

namespace {

constexpr int kBeams = 32;  // beams per block (threadIdx.x, one warp)
constexpr int kRows = 8;    // candidate rows per block (threadIdx.y)

__global__ void sliding_median_kernel(const float* __restrict__ ext,
                                      float* __restrict__ out, int W, int K,
                                      int B) {
  const int b = blockIdx.y * kBeams + threadIdx.x;
  const int j = 1 + blockIdx.x * kRows + threadIdx.y;  // row 0 is in no window
  if (b >= B || j > W + K - 1) return;
  const float* col = ext + b;
  const size_t stride = static_cast<size_t>(B);
  const float v = col[j * stride];
  const bool finite = isfinite(v);
  const int first = max(0, j - W);
  const int last = min(K - 1, j - 1);

  // counts over window `first`: rows first+1 .. first+W
  int less = 0, equal = 0, nvalid = 0;
  for (int r = first + 1; r <= first + W; ++r) {
    const float u = col[r * stride];
    less += u < v ? 1 : 0;
    equal += u == v ? 1 : 0;
    nvalid += isfinite(u) ? 1 : 0;
  }
  for (int i = first;; ) {
    if (nvalid == 0) {
      out[i * stride + b] = INFINITY;  // every member, v included, is +inf
    } else if (finite) {
      const int k = (nvalid - 1) >> 1;
      if (less <= k && k < less + equal) out[i * stride + b] = v;
    }
    if (++i > last) break;
    // window i-1 held rows i .. i+W-1; window i drops row i, gains row i+W
    const float gone = col[i * stride];
    const float came = col[(i + W) * stride];
    less += (came < v ? 1 : 0) - (gone < v ? 1 : 0);
    equal += (came == v ? 1 : 0) - (gone == v ? 1 : 0);
    nvalid += (isfinite(came) ? 1 : 0) - (isfinite(gone) ? 1 : 0);
  }
}

}  // namespace

extern "C" int sliding_median_f32(const float* ext, float* out, int W, int K,
                                  int B, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const dim3 block(kBeams, kRows);
  const dim3 grid((W + K - 1 + kRows - 1) / kRows, (B + kBeams - 1) / kBeams);
  sliding_median_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      ext, out, W, K, B);
  return static_cast<int>(cudaGetLastError());
}
