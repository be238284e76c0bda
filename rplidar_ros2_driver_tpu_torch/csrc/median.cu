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
// than a kernel launch.  What they spend is compare work in few threads: B1
// does (W / kSplit) x W compares per thread, B2 walks its column twice in
// one thread per beam (chip_smoke.py measures their device time on the card;
// PERF.md keeps the numbers).  The design keeps each to one launch with no
// scratch allocation and no host synchronisation, puts several threads on
// each B1 column so more warps are in flight, and leaves the compare loops
// as the lever for a faster version:
//   * the TPU kernels ran a bitonic network because VMEM wants static
//     vector shapes; here one beam maps to one thread (B2) or to a few
//     threads of one column (B1), threads of a warp take neighbouring beams
//     of the same row, so every load of the row-major (W, B) plane is a
//     coalesced 128-byte line;
//   * B1 selects by counting rank (v is the k-th smallest iff
//     #{< v} <= k < #{< v} + #{== v}); any exact selection gives the bits of
//     the sort, so no sort is needed.  kSplit threads share one column's
//     candidates, the column staged once in shared memory;
//   * B2 finds the delete slot d and insert slot p in one pass and writes
//     the shifted column in a second, each output element a 3-way select.
// W is arbitrary (never padded), the ragged beam edge is masked, +inf takes
// part like any value.  Both launch on the caller's stream, allocate
// nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBeams = 32;  // beams per B1 block (threadIdx.x, one warp)
constexpr int kSplit = 8;   // threads sharing one beam's candidates (threadIdx.y)
constexpr size_t kStaticSmemLimit = 48 * 1024;  // no opt-in attribute needed below it

__global__ void temporal_median_kernel(const float* __restrict__ win,
                                       float* __restrict__ out, int W, int B,
                                       int staged) {
  extern __shared__ float stage[];  // (W, kBeams) when staged
  __shared__ float found[kSplit][kBeams];
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int b = blockIdx.x * kBeams + x;
  const bool live = b < B;

  const float* col;
  size_t stride;
  if (staged) {
    for (int j = y; j < W; j += kSplit) {
      stage[j * kBeams + x] = live ? win[(size_t)j * B + b] : INFINITY;
    }
    __syncthreads();
    col = stage + x;
    stride = kBeams;
  } else {
    col = win + (live ? b : 0);
    stride = (size_t)B;
  }

  float res = INFINITY;
  if (live) {
    int nvalid = 0;
    for (int j = 0; j < W; ++j) nvalid += isfinite(col[j * stride]) ? 1 : 0;
    if (nvalid > 0) {
      const int k = (nvalid - 1) >> 1;  // < nvalid: the answer is finite
      for (int i = y; i < W; i += kSplit) {
        const float v = col[i * stride];
        if (!isfinite(v)) continue;
        int less = 0, equal = 0;
        for (int j = 0; j < W; ++j) {
          const float u = col[j * stride];
          less += u < v ? 1 : 0;
          equal += u == v ? 1 : 0;
        }
        if (less <= k && k < less + equal) {
          res = v;
          break;
        }
      }
    }
  }
  // every thread that found a candidate found the same value; the others
  // hold +inf, so the minimum over the column's threads is the median
  found[y][x] = res;
  __syncthreads();
  if (y == 0 && live) {
    float m = found[0][x];
    for (int r = 1; r < kSplit; ++r) m = fminf(m, found[r][x]);
    out[b] = m;
  }
}

struct Replace {
  const float* col;  // this beam's sorted column, stride B
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

__global__ void sorted_replace_kernel(const float* __restrict__ s,
                                      const float* __restrict__ old_v,
                                      const float* __restrict__ new_v,
                                      float* __restrict__ out,
                                      float* __restrict__ med, int W, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float ov = old_v[b];
  const float nv = new_v[b];
  const float* col = s + b;
  // pass 1: first slot holding `old` (0 when absent, as argmax gives) and
  // the count of values below `new`
  int d = -1, below = 0;
  for (int i = 0; i < W; ++i) {
    const float v = col[(size_t)i * B];
    if (d < 0 && v == ov) d = i;
    below += v < nv ? 1 : 0;
  }
  if (d < 0) d = 0;
  const Replace elem{col, (size_t)B, W, d, below - (ov < nv ? 1 : 0), nv};
  // pass 2: write the updated column, counting its finite values
  int nvalid = 0;
  for (int i = 0; i < W; ++i) {
    const float v = elem(i);
    out[(size_t)i * B + b] = v;
    nvalid += isfinite(v) ? 1 : 0;
  }
  // lower median: clip(floor((nvalid-1)/2), 0, W-1), +inf when no value
  med[b] = nvalid > 0 ? elem(min((nvalid - 1) >> 1, W - 1)) : INFINITY;
}

}  // namespace

extern "C" int temporal_median_f32(const float* win, float* out, int W, int B,
                                   void* stream) {
  const size_t smem = (size_t)W * kBeams * sizeof(float);
  const int staged = smem <= kStaticSmemLimit - sizeof(float) * kSplit * kBeams;
  const dim3 block(kBeams, kSplit);
  const dim3 grid((B + kBeams - 1) / kBeams);
  temporal_median_kernel<<<grid, block, staged ? smem : 0,
                           static_cast<cudaStream_t>(stream)>>>(win, out, W, B,
                                                                staged);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sorted_replace_f32(const float* s, const float* old_v,
                                  const float* new_v, float* out, float* med,
                                  int W, int B, void* stream) {
  constexpr int kThreads = 64;
  sorted_replace_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      s, old_v, new_v, out, med, W, B);
  return static_cast<int>(cudaGetLastError());
}
