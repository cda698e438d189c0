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
// Design: grid-stride loops of 16-byte (float4) loads and stores, eight
// blocks of 256 threads per SM, a scalar loop for the n % 4 tail.  The read
// mode sums in double per thread, so its result agrees with a float64 sum of
// the same data to double rounding.  Bound: device-memory bandwidth by
// construction (no arithmetic to speak of).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
read_kernel(const float* __restrict__ x, long long n, double* partial) {
  __shared__ double red[kThreads];
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long stride = (long long)gridDim.x * kThreads;
  double s = 0.0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 v = x4[i];
    s += (double)v.x + (double)v.y + (double)v.z + (double)v.w;
  }
  if (blockIdx.x == 0)
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += kThreads)
      s += (double)x[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const double* __restrict__ partial, int m, double* out) {
  __shared__ double red[kThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < m; i += kThreads) s += partial[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(float* __restrict__ y, long long n, float value) {
  const long long n4 = n / 4;
  float4* y4 = reinterpret_cast<float4*>(y);
  const float4 v = make_float4(value, value, value, value);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride)
    y4[i] = v;
  if (blockIdx.x == 0)
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += kThreads)
      y[i] = value;
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride)
    y4[i] = x4[i];
  if (blockIdx.x == 0)
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += kThreads)
      y[i] = x[i];
}

}  // namespace

// The number of blocks every mode launches (8 per SM of the current device);
// the read mode's partial buffer must hold that many doubles.
extern "C" int pf_stream_blocks() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  return 8 * sms;
}

// mode: 0 = read (sum of x into out[0], partial: pf_stream_blocks() doubles
// of scratch), 1 = write (fill y with value), 2 = read+write (copy x to y).
// x, y: 16-byte aligned float32 arrays of n values.  Returns
// cudaGetLastError().
extern "C" int pf_stream(int mode, const void* x, void* y, long long n,
                         double value, void* partial, void* out,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = pf_stream_blocks();
  if (blocks <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    read_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), n,
                                            static_cast<double*>(partial));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    reduce_kernel<<<1, kThreads, 0, s>>>(static_cast<const double*>(partial),
                                         blocks, static_cast<double*>(out));
  } else if (mode == 1) {
    fill_kernel<<<blocks, kThreads, 0, s>>>(static_cast<float*>(y), n,
                                            (float)value);
  } else if (mode == 2) {
    copy_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x),
                                            static_cast<float*>(y), n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
