// What K1's energy mode (K1e, stencil.cu) and K7 (energy.cu) share: the
// launch geometry of K1e's grid blocks, whose partial sums K7's middle
// stage reduces, the fixed-order block sum both use, and the ABC weight
// of H.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kGridThreads = 128;  // a z-run of one (x, y) row, as K1e's
constexpr int kMidBlocks = 1024;   // blocks of the middle stage

// Sums v[0..NS) over the block in a fixed order (warp tree, then the warps
// in order); thread 0 writes the sums to out[0..NS).  Every thread of the
// block must call it.
template <int NS, int THREADS>
__device__ void block_sums(double (&v)[NS], double* out) {
  __shared__ double sh[NS][THREADS / 32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    double x = v[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) sh[q][w] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      double s = sh[q][0];
      for (int i = 1; i < THREADS / 32; ++i) s += sh[q][i];
      out[q] = s;
    }
  }
}

__device__ __forceinline__ double abc_h_weight(int Q) {  // 1 - 2^-Q
  return (double)(1.0f - __int_as_float((127 - Q) << 23));  // exact
}

}  // namespace

// The middle stage of the grid sums: sums the `blocks` pairs that the grid
// blocks wrote at part[0 .. 2 blocks) into kMidBlocks pairs after them, in
// fixed contiguous ranges.  Returns cudaGetLastError().
extern "C" int pf_energy_mid(double* part, long long blocks,
                             cudaStream_t stream);
