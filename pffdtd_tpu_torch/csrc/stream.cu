// K4: a streaming probe of device-memory bandwidth, three modes over n
// float32 values: read (sum, per-block partials reduced by a second
// one-block pass), write (fill) and read+write (copy).
//
// Replaces the TPU DMA probes probes/dma_issue{,2,3,4}.py and
// probes/dma_plateau{,2,3}.py `build`, which timed the TPU's DMA issue cost
// and bandwidth plateau.  On the card there is no DMA engine to drive from
// a kernel; what every bound of the port needs is the rate a plain
// streaming kernel reaches, its roof.
//
// Design: a grid sized to the data, one pass of kUnroll independent 16-byte
// (float4) accesses per thread in blocks of kThreads, all loads issued
// before their stores or sums, with streaming cache hints (__ldcs / __stcs:
// the data is touched once, so it should not displace L2).  Block 0 covers
// the n % 4 tail with a scalar loop.  Of the A/B variants timed on the
// H100 (grid-stride loops of one or four float4 a thread, with and without
// the hints, 128-thread blocks, and Hopper's bulk copies through shared
// memory), this was the fastest; PERF.md has their rates.  The read mode
// sums in double per thread, so its result agrees with a float64 sum of the
// same data to double rounding.  Bound: device-memory bandwidth by
// construction (no arithmetic to speak of).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr long long kPerBlock = (long long)kThreads * kUnroll;  // float4s

__device__ __forceinline__ void block_sum(double s, double* out) {
  __shared__ double red[kThreads];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

// the first float4 of this thread; its k-th is kThreads * k further on
__device__ __forceinline__ long long first4() {
  return (long long)blockIdx.x * kPerBlock + threadIdx.x;
}

__global__ void __launch_bounds__(kThreads)
read_kernel(const float* __restrict__ x, long long n, double* partial) {
  const long long n4 = n / 4, i = first4();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    v[k] = i + k * kThreads < n4 ? __ldcs(x4 + i + k * kThreads)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    s += (double)v[k].x + (double)v[k].y + (double)v[k].z + (double)v[k].w;
  if (blockIdx.x == 0)
    for (long long j = 4 * n4 + threadIdx.x; j < n; j += kThreads)
      s += (double)x[j];
  block_sum(s, partial + blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const double* __restrict__ partial, int m, double* out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < m; i += kThreads) s += partial[i];
  block_sum(s, out);
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(float* __restrict__ y, long long n, float value) {
  const long long n4 = n / 4, i = first4();
  float4* y4 = reinterpret_cast<float4*>(y);
  const float4 v = make_float4(value, value, value, value);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    if (i + k * kThreads < n4) __stcs(y4 + i + k * kThreads, v);
  if (blockIdx.x == 0)
    for (long long j = 4 * n4 + threadIdx.x; j < n; j += kThreads)
      y[j] = value;
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  const long long n4 = n / 4, i = first4();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  float4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    if (i + k * kThreads < n4) v[k] = __ldcs(x4 + i + k * kThreads);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    if (i + k * kThreads < n4) __stcs(y4 + i + k * kThreads, v[k]);
  if (blockIdx.x == 0)
    for (long long j = 4 * n4 + threadIdx.x; j < n; j += kThreads)
      y[j] = x[j];
}

}  // namespace

// The number of blocks a mode launches for n values; the read mode's
// partial buffer must hold that many doubles.  -1 if n is out of range.
extern "C" int pf_stream_blocks(long long n) {
  if (n < 0) return -1;
  const long long b = (n / 4 + kPerBlock - 1) / kPerBlock;
  return b < 1 ? 1 : (b > 2147483647LL ? -1 : (int)b);
}

// mode: 0 = read (sum of x into out[0], partial: pf_stream_blocks(n)
// doubles of scratch), 1 = write (fill y with value), 2 = read+write (copy
// x to y).  x, y: 16-byte aligned float32 arrays of n values.  Returns
// cudaGetLastError().
extern "C" int pf_stream(int mode, const void* x, void* y, long long n,
                         double value, void* partial, void* out,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = pf_stream_blocks(n);
  if (blocks <= 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (mode == 0) {
    double* pd = static_cast<double*>(partial);
    read_kernel<<<blocks, kThreads, 0, s>>>(xf, n, pd);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    reduce_kernel<<<1, kThreads, 0, s>>>(pd, blocks,
                                         static_cast<double*>(out));
  } else if (mode == 1) {
    fill_kernel<<<blocks, kThreads, 0, s>>>(yf, n, (float)value);
  } else {
    copy_kernel<<<blocks, kThreads, 0, s>>>(xf, yf, n);
  }
  return (int)cudaGetLastError();
}
