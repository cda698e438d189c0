// K8: the modal air-absorption filter's recurrence.
//
// Replaces the `lax.scan` of pffdtd_tpu/analysis/air_abs.py
// `apply_modal_filter` (:157-169, no Pallas kernel there).  Every mode q of
// every channel ch runs the damped recurrence
//   P_new = ((a1[q] P_curr + a2[q] P_prev) + F1[ch,q] u[ch,n+1])
//           - F2[ch,q] u[ch,n]                           n = 0 .. Nt-1
// from P_prev = P_curr = 0, and the result is the final P_curr (the JAX
// scan's carry, which gets the reference's swap right).
//
// The modes split in two paths (q0 from kernels/modal.py `serial_modes`):
//
// - The serial path, modes q < q0 and q >= Nt - q0: the numpy loop's
//   operations in its order (nvcc runs with -fmad=false), a thread per
//   (channel, mode) with (P_prev, P_curr) as a register carry.  These rows
//   give `modal_recurrence_plain`'s bits.  Near theta_q = pi q / Nt = 0 and
//   = pi the recurrence has a near-double root, and the loop's own rounding
//   error there (about 1e-10 of max|P| at 48,000 samples) is larger than the
//   1e-12 a reordering may differ by; so these modes keep the loop.  Their
//   blocks take the lowest indices and start first (a chain of 4 dependent
//   fp64 operations a sample).  They are few: an SM that holds one beside
//   as many contraction blocks as the others finishes last.
// - The contraction, the other modes: with h_q the mode's impulse response
//   (h(0) = 1, h(1) = a1, h(k) = a1 h(k-1) + a2 h(k-2)) and x = u read
//   backwards (x[k] = u[Nt-k]),
//     P = F1 A - F2 B,  A = sum_k h(k) u[Nt-k],  B = sum_k h(k) u[Nt-1-k]
//   over k = 0 .. Nt-1.  A thread generates h for its mode once and carries
//   A and B of up to kGroup channels in registers, with explicit fma (which
//   -fmad=false leaves alone): 2 + 2 Nch fp64 instructions a (mode, sample)
//   where the loop takes 7 Nch.  A block stages u of its channels backwards
//   in shared memory, kCChunk + 1 samples at a time, read as a broadcast.
//   Channels beyond kGroup take more blocks, each regenerating h.
//
// One launch a call, whatever Nt.  Bound: fp64 operations over the fp64
// peak, Nt (7 Nch ns + (3 + 4 Nch) nc) with ns serial and nc contracted
// modes (an fma counted as 2); issue slots 7 Nch ns + (2 + 2 Nch) nc a
// sample, one fp64 lane each.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;   // samples of u a serial block stages (16 KB)
constexpr int kGroup = 4;      // channels a contraction block carries, most
constexpr int kCChunk = 1024;  // samples a contraction block stages a pass

struct Args {
  const double* a1;
  const double* a2;
  const double* F1;
  const double* F2;
  const double* u;
  double* out;
  int nch, Nt, q0, ns, nsb, ncb;  // ns serial modes in nsb blocks a channel;
                                  // ncb contraction blocks a channel group
};

// Serial block b: channel b / nsb, serial modes (b % nsb) * kThreads + tid.
__device__ void serial_block(const Args& p, int b, double* us) {
  const int Nt = p.Nt;
  const int ch = b / p.nsb;
  const int s = (b % p.nsb) * kThreads + threadIdx.x;
  const bool live = s < p.ns;
  const int q = s < p.q0 ? s : Nt - p.ns + s;  // the low end, then the high
  const long long row = (long long)ch * Nt;
  const double c1 = live ? p.a1[q] : 0.0;
  const double c2 = live ? p.a2[q] : 0.0;
  const double f1 = live ? p.F1[row + q] : 0.0;
  const double f2 = live ? p.F2[row + q] : 0.0;
  const double* __restrict__ uc = p.u + (long long)ch * (Nt + 1);
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
  if (live) p.out[row + q] = Pc;
}

// Contraction block b: channels (b / ncb) * G .. + G - 1 (those >= nch read
// zeros and write nothing), modes q0 + (b % ncb) * kThreads + tid.
template <int G>
__device__ void contract_block(const Args& p, int b, double* us) {
  const int Nt = p.Nt;
  const int ch0 = (b / p.ncb) * G;
  const int q = p.q0 + (b % p.ncb) * kThreads + threadIdx.x;
  const bool live = q < Nt - p.q0;
  const double c1 = live ? p.a1[q] : 0.0;
  const double c2 = live ? p.a2[q] : 0.0;
  double A[G], B[G];
#pragma unroll
  for (int c = 0; c < G; ++c) A[c] = B[c] = 0.0;
  double h = 1.0, hp = 0.0;
  for (int k0 = 0; k0 < Nt; k0 += kCChunk) {
    const int m = Nt - k0 < kCChunk ? Nt - k0 : kCChunk;
    __syncthreads();
    // us[j G + c] = u[ch0 + c, Nt - k0 - j], j = 0 .. m
    for (int i = threadIdx.x; i < (m + 1) * G; i += kThreads) {
      const int j = i / G, c = i % G;
      us[i] = ch0 + c < p.nch
                  ? p.u[(long long)(ch0 + c) * (Nt + 1) + (Nt - k0 - j)]
                  : 0.0;
    }
    __syncthreads();
    double cur[G];
#pragma unroll
    for (int c = 0; c < G; ++c) cur[c] = us[c];
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const double nxt = us[(j + 1) * G + c];
        A[c] = fma(h, cur[c], A[c]);
        B[c] = fma(h, nxt, B[c]);
        cur[c] = nxt;
      }
      const double t = c2 * hp;
      hp = h;
      h = fma(c1, h, t);
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < G; ++c) {
    if (ch0 + c < p.nch) {
      const long long i = (long long)(ch0 + c) * Nt + q;
      p.out[i] = p.F1[i] * A[c] - p.F2[i] * B[c];
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) modal_kernel(const Args p) {
  constexpr int kSerial = kChunk + 1, kContract = G * (kCChunk + 1);
  __shared__ double us[kSerial > kContract ? kSerial : kContract];
  const int nser = p.nch * p.nsb;  // serial blocks first: they start first
  if ((int)blockIdx.x < nser) {
    serial_block(p, blockIdx.x, us);
  } else {
    contract_block<G>(p, blockIdx.x - nser, us);
  }
}

}  // namespace

// a1, a2: (Nt,); F1, F2, out: (Nch, Nt); u: (Nch, Nt + 1); all float64.
// Modes q < q0 and q >= Nt - q0 take the serial path (all of them when
// 2 q0 >= Nt), the rest the contraction.  Returns cudaGetLastError().
extern "C" int pf_modal_recurrence(const void* a1, const void* a2,
                                   const void* F1, const void* F2,
                                   const void* u, void* out, int nch, int Nt,
                                   int q0, void* stream) {
  if (nch < 1 || Nt < 1 || q0 < 1 || q0 > Nt) {
    return (int)cudaErrorInvalidValue;
  }
  Args p{static_cast<const double*>(a1), static_cast<const double*>(a2),
         static_cast<const double*>(F1), static_cast<const double*>(F2),
         static_cast<const double*>(u),  static_cast<double*>(out),
         nch, Nt, 0, 0, 0, 0};
  p.ns = q0 >= Nt - q0 ? Nt : 2 * q0;
  p.q0 = p.ns == Nt ? Nt : q0;  // every mode serial: no contraction blocks
  p.nsb = (p.ns + kThreads - 1) / kThreads;
  p.ncb = (Nt - p.ns + kThreads - 1) / kThreads;
  const int groups = (nch + kGroup - 1) / kGroup;
  const int G = (nch + groups - 1) / groups;  // balanced groups of <= kGroup
  const long long blocks = (long long)nch * p.nsb + (long long)groups * p.ncb;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: modal_kernel<1><<<(int)blocks, kThreads, 0, st>>>(p); break;
    case 2: modal_kernel<2><<<(int)blocks, kThreads, 0, st>>>(p); break;
    case 3: modal_kernel<3><<<(int)blocks, kThreads, 0, st>>>(p); break;
    default: modal_kernel<4><<<(int)blocks, kThreads, 0, st>>>(p); break;
  }
  return (int)cudaGetLastError();
}
