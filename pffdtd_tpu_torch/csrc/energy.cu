// K7: the energy functionals of the energy-instrumented step.
//
// Replaces what XLA fuses out of pffdtd_tpu/engine/jax_engine.py
// `step_energy` (:704-747, no Pallas kernel there): with V = V_fac, around
// step n,
//   H[n]    = V h/2 sum_int((u^n - u^{n-1})^2 / l2 - u^n L u^{n-1})
//             (the quotient as a product with 1/l2, as the plain version)
//             - V h/2 sum_abc((1 - 2^-Q)(same term))
//             + V c/(2 l2) sum_nodes ssaf (vh^2 D + (Ts gh)^2 F)
//   dE_lost = V h/(4 l) sum_nodes ssaf (vh' + vh)^2 E
//             + V h/(2 l) sum_abc(2^-Q Q (u^{n+1} - u^{n-1})^2)
//   dE_in   = V h/(2 l2) sum_src((u^{n+1} - u^{n-1}) sig_n)
// and L u^n for the next step (engine/energy.py holds the plain version).
//
// Two stages around the step (K1 + K2 + sources), each with a reduction of
// its own:
// (a) the grid sums, in the step's launch: K1's energy mode (K1e,
//     stencil.cu) writes L u^n in place over L u^{n-1} and, per block of
//     kGridThreads points of a z-run, the fp64 sums of H's interior term
//     and of its ABC correction (energy_sums.cuh); a middle stage of 1024
//     blocks sums them in fixed contiguous ranges (`pf_energy_mid`).  The
//     plain version of (a) is kernels/energy.py `energy_grid_pass_plain`.
// (b) the boundary pass, after the step: the ABC loss over the shell of ABC
//     layer points, the lossy dissipation and H's lossy term over the Nbl
//     nodes (branch states before the step from the engine's scratch), and
//     dE_in at the sources; each block writes four fp64 sums.  Then one
//     block of the last stage sums the middle stage's and these partials in
//     a fixed order (strided per thread, then a fixed tree), combines them
//     in fp64 with the constants, and writes H and updates E_lost, E_in in
//     the state's dtype.  No atomics: a run and its resume give the same
//     bits.
//
// Per-point terms are computed in the state's dtype with the plain
// version's operations in its order (nvcc runs with -fmad=false); sums are
// fp64.  dE_in keeps the plain version's rounding outright (its sum is
// rounded to the state's dtype, then scaled in it), so a single source gives
// the plain version's bits.
//
// Bound: device-memory bandwidth.  Pass (b) touches the ABC shell (two
// fields a point) and 3 x 12 branch values a lossy node: a small fraction
// of the step's bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "energy_sums.cuh"  // kGridThreads, kMidBlocks, block_sums, ...

namespace {

constexpr int kThreads = 256;      // the middle stage and the boundary pass
constexpr int kFinalThreads = 1024;
constexpr int MMb = 12;

__device__ __forceinline__ double abc_loss_weight(int Q) {  // 2^-Q Q
  return Q == 3 ? 0.375 : 0.5;
}

// The middle stage of (a): block b sums the b-th contiguous range of
// the grid blocks' pairs (threads strided, then the block's fixed tree).
__global__ void __launch_bounds__(kThreads)
energy_mid_kernel(const double* __restrict__ pa, long long n,
                  double* __restrict__ out) {
  const long long per = (n + kMidBlocks - 1) / kMidBlocks;
  const long long lo = blockIdx.x * per;
  const long long hi = lo + per < n ? lo + per : n;
  double v[2] = {0.0, 0.0};
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    v[0] += pa[2 * i];
    v[1] += pa[2 * i + 1];
  }
  block_sums<2, kThreads>(v, out + 2 * blockIdx.x);
}

// Point i of the ABC shell (the interior points with Q > 0): the two x
// faces, whole; then per middle x row its y-face rows (y = 1, and Ny-2
// unless folded) and the z = 1, Nz-2 points of its other rows.
struct Shell {
  int Nx, Ny, Nz, folded;
  long long plane, per_x;
  int nyf;
  __device__ void point(long long i, int& ix, int& iy, int& iz) const {
    const int nz = Nz - 2;
    if (i < 2 * plane) {
      ix = i < plane ? 1 : Nx - 2;
      const long long j = i % plane;
      iy = 1 + (int)(j / nz);
      iz = 1 + (int)(j % nz);
      return;
    }
    const long long j = i - 2 * plane;
    ix = 2 + (int)(j / per_x);
    long long k = j % per_x;
    if (k < (long long)nyf * nz) {
      iy = k < nz ? 1 : Ny - 2;
      iz = 1 + (int)(k % nz);
    } else {
      k -= (long long)nyf * nz;
      iy = 2 + (int)(k / 2);
      iz = (k % 2) ? Nz - 2 : 1;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
energy_boundary_kernel(const T* __restrict__ unew, const T* __restrict__ u0,
                       const T* __restrict__ vh, const T* __restrict__ vh_prev,
                       const T* __restrict__ gh_prev,
                       const T* __restrict__ ssaf,
                       const int32_t* __restrict__ mat,
                       const T* __restrict__ def,
                       const int64_t* __restrict__ in_ixyz,
                       const T* __restrict__ sig, double* __restrict__ part,
                       Shell sh, long long nshell, long long nbl, int ns,
                       int shell_blocks, int node_blocks, T Ts) {
  // sums: ABC loss, lossy dissipation, H's lossy term, input
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  const int b = blockIdx.x;
  if (b < shell_blocks) {
    const long long i = (long long)b * kThreads + threadIdx.x;
    if (i < nshell) {
      int ix, iy, iz;
      sh.point(i, ix, iy, iz);
      const long long c =
          ((long long)ix * sh.Ny + iy) * (long long)sh.Nz + iz;
      const int Q = (ix == 1 || ix == sh.Nx - 2) +
                    (iy == 1 || (iy == sh.Ny - 2 && !sh.folded)) +
                    (iz == 1 || iz == sh.Nz - 2);
      const T d = unew[c] - u0[c];
      s[0] = abc_loss_weight(Q) * (double)(d * d);
    }
  } else if (b < shell_blocks + node_blocks) {
    const long long i = (long long)(b - shell_blocks) * kThreads + threadIdx.x;
    if (i < nbl) {
      const T sa = ssaf[i];
      const T* D = def + (long long)mat[i] * 3 * MMb;
      const T* E = D + MMb;
      const T* F = D + 2 * MMb;
#pragma unroll
      for (int j = 0; j < MMb; ++j) {
        const T vp = vh_prev[j * nbl + i];
        const T w = vh[j * nbl + i] + vp;
        const T ts = Ts * gh_prev[j * nbl + i];
        s[1] += (double)(sa * (w * w * E[j]));
        s[2] += (double)(sa * (vp * vp * D[j] + ts * ts * F[j]));
      }
    }
  } else {
    for (int i = threadIdx.x; i < ns; i += kThreads) {
      const long long p = in_ixyz[i];
      s[3] += (double)((unew[p] - u0[p]) * sig[i]);
    }
  }
  block_sums<4, kThreads>(s, part + 4 * (long long)b);
}

// The last stage: one block; pa holds na pairs (interior, ABC correction)
// from (a)'s middle stage, pb nb quadruples of pass (b).
template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
energy_final_kernel(const double* __restrict__ pa, int na,
                    const double* __restrict__ pb, int nb, double cH,
                    double cH_lossy, double cL_abc, double cL_lossy, T cIn,
                    T* __restrict__ H, T* __restrict__ E_lost,
                    T* __restrict__ E_in) {
  __shared__ double tot[6];
  double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < na; i += kFinalThreads) {
    s[0] += pa[2 * i];
    s[1] += pa[2 * i + 1];
  }
  for (int i = threadIdx.x; i < nb; i += kFinalThreads) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[2 + q] += pb[4 * i + q];
  }
  block_sums<6, kFinalThreads>(s, tot);
  if (threadIdx.x == 0) {
    // tot: interior, ABC correction, ABC loss, dissipation, lossy H, input
    const double h = cH * tot[0] - cH * tot[1] + cH_lossy * tot[4];
    *H = T(h);
    *E_lost = *E_lost + T(cL_abc * tot[2] + cL_lossy * tot[3]);
    *E_in = *E_in + cIn * T(tot[5]);
  }
}

// the blocks of K1e's launch (stencil.cu), each of which writes a pair
long long grid_blocks(int Nx, int Ny, int Nz) {
  return (long long)((Nz - 2 + kGridThreads - 1) / kGridThreads) * (Ny - 2) *
         (Nx - 2);
}

Shell make_shell(int Nx, int Ny, int Nz, int folded, long long* nshell) {
  Shell sh;
  sh.Nx = Nx;
  sh.Ny = Ny;
  sh.Nz = Nz;
  sh.folded = folded ? 1 : 0;
  sh.nyf = folded ? 1 : 2;
  sh.plane = (long long)(Ny - 2) * (Nz - 2);
  const int nym = folded ? Ny - 3 : Ny - 4;  // middle y rows
  sh.per_x = (long long)sh.nyf * (Nz - 2) + 2LL * nym;
  *nshell = 2 * sh.plane + (long long)(Nx - 4) * sh.per_x;
  return sh;
}

template <typename T>
int launch_boundary(const void* unew, const void* u0, const void* vh,
                    const void* vh_prev, const void* gh_prev,
                    const void* ssaf, const void* mat, const void* def,
                    const void* in_ixyz, const void* sig, long long nbl,
                    int ns, void* part, long long npart, int Nx, int Ny,
                    int Nz, int folded, double Ts, double cH,
                    double cH_lossy, double cL_abc, double cL_lossy,
                    double cIn, void* H, void* E_lost, void* E_in,
                    cudaStream_t stream) {
  if (Nx < 5 || Ny < 5 || Nz < 5 || nbl < 0 || ns < 0)
    return (int)cudaErrorInvalidValue;
  long long nshell;
  const Shell sh = make_shell(Nx, Ny, Nz, folded, &nshell);
  const long long na = grid_blocks(Nx, Ny, Nz);
  const long long sb = (nshell + kThreads - 1) / kThreads;
  const long long nodeb = (nbl + kThreads - 1) / kThreads;
  const long long nb = sb + nodeb + 1;
  if (nb > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  // the scratch: kernels/energy.py `scratch_size` computes the same count
  if (npart < 2 * na + 2 * kMidBlocks + 4 * nb)
    return (int)cudaErrorInvalidValue;
  double* pa = static_cast<double*>(part) + 2 * na;  // the middle stage's
  double* pb = pa + 2 * kMidBlocks;
  energy_boundary_kernel<T><<<(unsigned)nb, kThreads, 0, stream>>>(
      static_cast<const T*>(unew), static_cast<const T*>(u0),
      static_cast<const T*>(vh), static_cast<const T*>(vh_prev),
      static_cast<const T*>(gh_prev), static_cast<const T*>(ssaf),
      static_cast<const int32_t*>(mat), static_cast<const T*>(def),
      static_cast<const int64_t*>(in_ixyz), static_cast<const T*>(sig), pb,
      sh, nshell, nbl, ns, (int)sb, (int)nodeb, T(Ts));
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  energy_final_kernel<T><<<1, kFinalThreads, 0, stream>>>(
      pa, kMidBlocks, pb, (int)nb, cH, cH_lossy, cL_abc, cL_lossy, T(cIn),
      static_cast<T*>(H), static_cast<T*>(E_lost), static_cast<T*>(E_in));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pf_energy_mid(double* part, long long blocks,
                             cudaStream_t stream) {
  energy_mid_kernel<<<kMidBlocks, kThreads, 0, stream>>>(part, blocks,
                                                         part + 2 * blocks);
  return (int)cudaGetLastError();
}

// Pass (b) and the second stage.  cH = V h/2, cH_lossy = V c/(2 l2),
// cL_abc = V h/(2 l), cL_lossy = V h/(4 l), cIn = V h/(2 l2).
extern "C" int pf_energy_boundary(
    int dtype, const void* unew, const void* u0, const void* vh,
    const void* vh_prev, const void* gh_prev, const void* ssaf,
    const void* mat, const void* def, const void* in_ixyz, const void* sig,
    long long nbl, int ns, void* part, long long npart, int Nx, int Ny,
    int Nz, int folded, double Ts, double cH, double cH_lossy, double cL_abc,
    double cL_lossy, double cIn, void* H, void* E_lost, void* E_in,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PF_K7_ARGS                                                        \
  unew, u0, vh, vh_prev, gh_prev, ssaf, mat, def, in_ixyz, sig, nbl, ns,  \
      part, npart, Nx, Ny, Nz, folded, Ts, cH, cH_lossy, cL_abc, cL_lossy, \
      cIn, H, E_lost, E_in, s
  if (dtype == 0) return launch_boundary<float>(PF_K7_ARGS);
  if (dtype == 1) return launch_boundary<double>(PF_K7_ARGS);
#undef PF_K7_ARGS
  return (int)cudaErrorInvalidValue;
}
