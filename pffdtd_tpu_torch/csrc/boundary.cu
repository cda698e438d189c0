// K2: the frequency-dependent (lossy) boundary update at the Nbl nodes.
//
// Replaces the TPU kernels of pffdtd_tpu/engine/pallas_boundary.py composed
// by `build_boundary_hybrid`: `build_boundary_ring` (the default tiled
// kernel), `build_boundary_update` and `build_boundary_dense`, and the
// z-plane impedance ODE inside pallas_stencil.py `build_fused_stencil`.
// Those exist because gather/scatter serialised on the TPU, so they packed
// nodes into windows and gathered with one-hot matrix products; on the card
// a thread loads its node directly and none of that machinery is ported.
//
// One thread per node, with its MMb = 12 RLC branches in registers and the
// per-material coefficients read from a small (Nmat+1, 4, MMb) table that
// stays in L1 (the reference kept them in constant memory).  The math is
// jax_engine.py:667-678, operation for operation:
//   ub  = unew[bnl]                      (after K1)
//   u2b = u0[bnl]                        (u^{n-1}: K1 wrote a third buffer)
//   ub  = (ub - l*ssaf*sum(2*bDh*vh - bFh*gh) + lo2*ssaf*beta*u2b)
//         / (1 + lo2*ssaf*beta)
//   vh' = b*(ub - u2b) + bd*vh - 2*bFh*gh
//   gh' = gh + (vh' + vh)/2
//   unew[bnl] = ub
// Branch states are stored (MMb, Nbl), so a warp's 32 nodes read and write
// 32 consecutive values per branch.  Nodes are unique: no write races.
//
// ABC mode (ABC = true): the same update at scenes where lossy nodes lie on
// an ABC layer (an open room, a surface at the domain's edge).  The
// reference runs stencil -> lossy ODE -> ABC (jax_engine.py:664-685), but
// K1 has already applied the ABC at every point of those layers, so at a
// node with Q = abcq[i] > 0 (lQ = l*Q, K1's rounding) K2 first undoes it,
//   s   = unew*(1 + lQ) - lQ*u2b        (K1's value before its ABC)
// then runs the ODE and the branch update on s, and applies the ABC to the
// value it writes,
//   unew[bnl] = (ub + lQ*u2b) / (1 + lQ)
// (u2b is u0 at the node, the value the ABC reads).  Nodes with Q = 0 take
// the ODE alone.  ABC = false compiles to K2 as it was: abcq is not read, and
// a scene without such a node launches that instance.
//
// Bound: memory traffic, about 2*2*12 state values per node plus one scattered
// read-modify-write of unew and one scattered read of u0; the sorted node
// list keeps those scattered accesses mostly within a few cache lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int MMb = 12;

// what the ABC mode reads besides the ODE's tensors
template <typename T>
struct AbcArgs {
  const uint8_t* q;  // Q a node, 0 off the ABC layers
  T lQ1, lQ2, lQ3;   // l*Q for Q = 1, 2, 3
};

template <typename T, bool ABC>
__global__ void __launch_bounds__(kThreads)
boundary_update_kernel(T* __restrict__ unew, const T* __restrict__ u0,
                       const int64_t* __restrict__ bnl,
                       const T* __restrict__ ssaf,
                       const int32_t* __restrict__ mat,
                       const T* __restrict__ coef, const T* __restrict__ beta,
                       T* __restrict__ vh, T* __restrict__ gh, long long nbl,
                       T l, T lo2, AbcArgs<T> abc) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nbl) return;
  const long long p = bnl[i];
  const T u2b = u0[p];
  T ub = unew[p];
  const T sa = ssaf[i];
  const int m = mat[i];
  const T* b = coef + (long long)m * 4 * MMb;
  const T* bd = b + MMb;
  const T* bDh = b + 2 * MMb;
  const T* bFh = b + 3 * MMb;

  T v[MMb], g[MMb];
  T s = T(0);
#pragma unroll
  for (int j = 0; j < MMb; ++j) {
    v[j] = vh[j * nbl + i];
    g[j] = gh[j * nbl + i];
    const T t = T(2) * bDh[j] * v[j] - bFh[j] * g[j];
    s = j == 0 ? t : s + t;
  }
  // ABC mode: undo K1's ABC at a node on an ABC layer (Q > 0)
  const int Q = ABC ? abc.q[i] : 0;
  const T lQ = Q == 1 ? abc.lQ1 : (Q == 2 ? abc.lQ2 : abc.lQ3);
  if (ABC && Q > 0) ub = ub * (T(1) + lQ) - lQ * u2b;
  const T lo2Kbg = lo2 * sa * beta[m];
  ub = ub - l * sa * s;
  ub = (ub + lo2Kbg * u2b) / (T(1) + lo2Kbg);
  const T du = ub - u2b;
#pragma unroll
  for (int j = 0; j < MMb; ++j) {
    const T v0 = b[j] * du + bd[j] * v[j] - T(2) * bFh[j] * g[j];
    gh[j * nbl + i] = g[j] + T(0.5) * (v0 + v[j]);
    vh[j * nbl + i] = v0;
  }
  // the ABC after the ODE; the branches took the ODE's ub, as the reference
  if (ABC && Q > 0) ub = (ub + lQ * u2b) / (T(1) + lQ);
  unew[p] = ub;
}

template <typename T, bool ABC>
int launch(void* unew, const void* u0, const void* bnl, const void* ssaf,
           const void* mat, const void* coef, const void* beta, void* vh,
           void* gh, long long nbl, double l, double lo2, const void* abcq,
           double lQ1, double lQ2, double lQ3, cudaStream_t stream) {
  if (nbl <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (nbl + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const AbcArgs<T> abc = {static_cast<const uint8_t*>(abcq), T(lQ1), T(lQ2),
                          T(lQ3)};
  boundary_update_kernel<T, ABC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<T*>(unew), static_cast<const T*>(u0),
      static_cast<const int64_t*>(bnl), static_cast<const T*>(ssaf),
      static_cast<const int32_t*>(mat), static_cast<const T*>(coef),
      static_cast<const T*>(beta), static_cast<T*>(vh), static_cast<T*>(gh),
      nbl, T(l), T(lo2), abc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* unew, const void* u0, const void* bnl, const void* ssaf,
             const void* mat, const void* coef, const void* beta, void* vh,
             void* gh, long long nbl, double l, double lo2, const void* abcq,
             double lQ1, double lQ2, double lQ3, cudaStream_t s) {
  // a uniform choice on the host: no Q array, K2 as it was
  if (abcq == nullptr)
    return launch<T, false>(unew, u0, bnl, ssaf, mat, coef, beta, vh, gh,
                            nbl, l, lo2, abcq, lQ1, lQ2, lQ3, s);
  return launch<T, true>(unew, u0, bnl, ssaf, mat, coef, beta, vh, gh, nbl,
                         l, lo2, abcq, lQ1, lQ2, lQ3, s);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; abcq: (nbl,) uint8 Q a node, or null when
// no lossy node lies on an ABC layer; lQ1..lQ3 are l*Q for Q = 1, 2, 3 (read
// only with abcq).  Returns cudaGetLastError().
extern "C" int pf_boundary_update(int dtype, void* unew, const void* u0,
                                  const void* bnl, const void* ssaf,
                                  const void* mat, const void* coef,
                                  const void* beta, void* vh, void* gh,
                                  long long nbl, double l, double lo2,
                                  const void* abcq, double lQ1, double lQ2,
                                  double lQ3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(unew, u0, bnl, ssaf, mat, coef, beta, vh, gh, nbl,
                           l, lo2, abcq, lQ1, lQ2, lQ3, s);
  if (dtype == 1)
    return dispatch<double>(unew, u0, bnl, ssaf, mat, coef, beta, vh, gh,
                            nbl, l, lo2, abcq, lQ1, lQ2, lQ3, s);
  return (int)cudaErrorInvalidValue;
}
