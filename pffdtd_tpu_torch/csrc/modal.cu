// K8: the modal air-absorption filter's recurrence.
//
// Replaces the `lax.scan` of pffdtd_tpu/analysis/air_abs.py
// `apply_modal_filter` (:157-169, no Pallas kernel there).  Every mode q of
// every channel ch runs the damped recurrence
//   P_new = ((a1[q] P_curr + a2[q] P_prev) + F1[ch,q] u[ch,n+1])
//           - F2[ch,q] u[ch,n]                           n = 0 .. Nt-1
// from P_prev = P_curr = 0, and the result is the final P_curr (the JAX
// scan's carry, which gets the reference's swap right).  The operations are
// the numpy loop's, in its order, and nvcc runs with -fmad=false, so each
// product and sum rounds as numpy's does: K8 gives
// `modal_recurrence_plain`'s bits.
//
// One thread per (channel, mode), all of a block's threads in one channel:
// a1, a2, F1 and F2 of a mode sit in registers and (P_prev, P_curr) is a
// register carry.  Every thread of a channel reads the same u[n], so a
// block stages u in shared memory, kChunk + 1 samples at a time, and reads
// it back as a broadcast.  One launch a call, whatever Nt.
//
// Bound: fp64 operations, 7 a (mode, sample) (4 mul, 3 add; no FMA, so
// each takes an instruction slot of its own): 7 Nch Nt^2.  The carry is a
// serial chain of 4 dependent fp64 operations a sample, which Nch Nt / 32
// warps hide only when each SM holds enough of them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;  // samples of u staged per pass (16 KB)

__global__ void __launch_bounds__(kThreads)
modal_kernel(const double* __restrict__ a1, const double* __restrict__ a2,
             const double* __restrict__ F1, const double* __restrict__ F2,
             const double* __restrict__ u, double* __restrict__ out, int Nt) {
  __shared__ double us[kChunk + 1];
  const int ch = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool live = q < Nt;
  const long long row = (long long)ch * Nt;
  const double c1 = live ? a1[q] : 0.0;
  const double c2 = live ? a2[q] : 0.0;
  const double f1 = live ? F1[row + q] : 0.0;
  const double f2 = live ? F2[row + q] : 0.0;
  const double* __restrict__ uc = u + (long long)ch * (Nt + 1);
  double Pp = 0.0, Pc = 0.0;
  for (int n0 = 0; n0 < Nt; n0 += kChunk) {
    const int m = Nt - n0 < kChunk ? Nt - n0 : kChunk;
    __syncthreads();  // the previous chunk is read by every thread
    for (int i = threadIdx.x; i <= m; i += kThreads) us[i] = uc[n0 + i];
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      double t = c1 * Pc;
      t = t + c2 * Pp;
      t = t + f1 * us[i + 1];
      t = t - f2 * us[i];
      Pp = Pc;
      Pc = t;
    }
  }
  if (live) out[row + q] = Pc;
}

}  // namespace

// a1, a2: (Nt,); F1, F2, out: (Nch, Nt); u: (Nch, Nt + 1); all float64.
// Returns cudaGetLastError().
extern "C" int pf_modal_recurrence(const void* a1, const void* a2,
                                   const void* F1, const void* F2,
                                   const void* u, void* out, int nch, int Nt,
                                   void* stream) {
  if (nch < 1 || Nt < 1) return (int)cudaErrorInvalidValue;
  if (nch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((Nt + kThreads - 1) / kThreads, nch);
  modal_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a1), static_cast<const double*>(a2),
      static_cast<const double*>(F1), static_cast<const double*>(F2),
      static_cast<const double*>(u), static_cast<double*>(out), Nt);
  return (int)cudaGetLastError();
}
