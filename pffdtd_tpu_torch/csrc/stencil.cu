// K1: one leapfrog step of the adjacency-masked 7/13-point stencil, with the
// mirror halo flips and the first-order Engquist-Majda ABC fused in.
//
// Replaces the TPU kernel pffdtd_tpu/engine/pallas_stencil.py
// `build_fused_stencil` (its stencil, leapfrog and ABC; the optional z-plane
// impedance ODE of that kernel is K2's work here, boundary.cu).
//
// Per interior point (1..N-2 on every axis), with u1f = u1 after the flips:
//   unew = (2 - sl2*K) * u1f - u0 + a2 * sum_k bit_k * u1f(x + v_k)
//   unew = (unew + l*Q*u0) / (1 + l*Q)    where Q = #axes at an ABC layer > 0
// bit_k is bit k of the packed adjacency (uint8, 6 Cartesian legs; uint16,
// 12 FCC legs) and K its popcount.  The halo layers are never written: the
// flips are virtual.  A neighbour i+d that falls on a halo layer (0 or N-1)
// holds, after the flips, the value at its mirror 2 or N-3, which is i-d;
// on a folded FCC grid the high-y ghost Ny-1 holds Ny-2, the node itself.
// So each thread picks, per axis, the signed offset of its -1 and +1
// neighbours once (flipped at a halo) and each leg adds two of them: no
// branch and no per-leg index arithmetic.  Mirroring each axis on its own
// equals the z, y, x plane copies of the reference's _flip_halos, edges and
// corners included.  The output goes to a third buffer, so u0 and u1 stay
// intact for K2 and the next step (no aliasing hazard, unlike the TPU
// kernel's out-aliases-u0).
//
// K5, shard mode (SHARD = true): the same step on the owned rows of one
// x-slab, replacing pffdtd_tpu/engine/pallas_stencil.py
// `build_fused_stencil_sharded`.  The slab holds S owned rows at local rows
// g0 .. g0+S-1 between ghost rows that carry the neighbours' data; local row
// i is global row i + xo, and Nx is the global extent.  Three things differ
// from K1: the launch covers the owned rows only (so one kernel serves the
// step route's one ghost row and the TB route's tail steps at TB ghost
// rows); the x mirror and the x faces of the ABC are found from the global
// row, so only a slab that owns a global edge flips there, while ghost rows
// of inner edges are real neighbour data; y, z and the fold ghost are K1's.
// SHARD = false compiles to K1 as it was: g0 and xo are not read.
//
// K1e, energy mode (ENERGY = true; SHARD = false): the step above and, in
// the same launch, what K7's grid pass (energy.cu, pass (a)) computes for
// the energy-instrumented step (pffdtd_tpu/engine/jax_engine.py
// `step_energy`): each interior point reads L u^{n-1} from its own cell of
// Lu and writes L u^n = lfac (acc - K u^n) over it (in place: a point
// touches only its own cell, and halos are never written, so they stay
// zero), then forms H's term du^2 / l2 - u^n L u^{n-1}, du = u^n - u^{n-1},
// from the registers the step already holds (acc, K, u^n, u^{n-1}), with
// the grid pass's operations in its order.  The block writes the fp64 sums
// of the term and of (1 - 2^-Q) x term on ABC points with the grid pass's
// block tree (energy_sums.cuh) at pair 2b of part, b the block index in
// the same launch geometry, so part holds the grid pass's bits; the
// launcher then runs its middle stage.  Tail threads past Nz-2 fall through
// with zero sums, since the block sum has a barrier.  ENERGY = false
// compiles to K1 as it was: Lu, part, lfac and inv_l2 are not read.
//
// Bound: device-memory bandwidth.  Each point reads u1, u0 and adj and writes
// out once (fp32 FCC: 4 + 4 + 2 + 4 = 14 bytes); the 12 neighbour re-reads of
// u1 are meant to hit L1/L2, since a block's threads walk one z-row and the
// neighbouring rows are read by the blocks scheduled beside it.  One thread
// per point, z fastest, so a warp's loads and stores coalesce.  Left for
// later: tiling the u1 slab in shared memory, TMA loads, and an in-place
// update that drops the third buffer.  The energy mode adds L u read and
// written once a point (fp32 FCC: 22 B) and 16 B of sums a block, where
// the separate grid pass moved 18 B a point and read u^n's neighbours again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "energy_sums.cuh"  // K7's block sums, ABC weight, middle stage

namespace {

constexpr int kThreads = 128;  // one z-run of a (y, x) row per block
static_assert(kThreads == kGridThreads,
              "the energy mode's partial sums use K7's grid-pass layout");

// what the energy mode reads and writes besides the step's tensors
template <typename T>
struct EnergyArgs {
  T* Lu;         // L u^{n-1} in, L u^n out (in place)
  double* part;  // the grid pass's fp64 scratch
  T lfac, inv_l2;
};

// leg vectors in pffdtd_tpu/voxelizer/vox.py order (CART_VECTORS,
// FCC_VECTORS); bit k of the adjacency belongs to leg k
template <int NN>
__device__ __forceinline__ int3 leg(int k) {
  if (NN == 6) {
    const int v[6][3] = {{1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                         {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};
    return make_int3(v[k][0], v[k][1], v[k][2]);
  } else {
    const int v[12][3] = {{1, 1, 0},  {-1, -1, 0}, {0, 1, 1},  {0, -1, -1},
                          {1, 0, 1},  {-1, 0, -1}, {1, -1, 0}, {-1, 1, 0},
                          {0, 1, -1}, {0, -1, 1},  {1, 0, -1}, {-1, 0, 1}};
    return make_int3(v[k][0], v[k][1], v[k][2]);
  }
}

template <typename T, typename A, int NN, bool SHARD, bool ENERGY>
__global__ void __launch_bounds__(kThreads)
stencil_step_kernel(const T* __restrict__ u0, const T* __restrict__ u1,
                    const A* __restrict__ adj, T* __restrict__ out,
                    int Nx, int Ny, int Nz, int folded,
                    T a2, T sl2, T lQ1, T lQ2, T lQ3, int g0, int xo,
                    EnergyArgs<T> e) {
  const int iz = 1 + blockIdx.x * kThreads + threadIdx.x;
  const int iy = 1 + blockIdx.y;
  const int ix = (SHARD ? g0 : 1) + blockIdx.z;  // local row
  const bool live = iz <= Nz - 2;
  if (!ENERGY && !live) return;
  double sums[2] = {0.0, 0.0};  // energy mode: the term, its ABC share
  if (live) {
    const int sy = Nz;
    const int sx = Ny * Nz;  // the launcher checks that it fits an int
    const long long c = (long long)ix * sx + (long long)iy * sy + iz;
    const int gx = SHARD ? ix + xo : ix;            // global row
    const bool xlo = gx == 1, xhi = gx == Nx - 2;
    const bool ylo = iy == 1, yhi = iy == Ny - 2;
    const bool zlo = iz == 1, zhi = iz == Nz - 2;
    // offset of the neighbour at d = -1, 0, +1 along each axis, after flips
    const int ox[3] = {xlo ? sx : -sx, 0, xhi ? -sx : sx};
    const int oy[3] = {ylo ? sy : -sy, 0, yhi ? (folded ? 0 : -sy) : sy};
    const int oz[3] = {zlo ? 1 : -1, 0, zhi ? -1 : 1};
    const unsigned a = adj[c];
    // the energy mode loads L u^{n-1} with the adjacency, ahead of the legs:
    // loaded after the store of u^{n+1} (the grid pass's place for it), K1e
    // took 8.49 ms at the headline shapes on the H100 where this order
    // takes 1.53, and 1.43 late but without the block sum's barrier
    // (kernels/k1e_probe.py)
    const T L_prev = ENERGY ? e.Lu[c] : T(0);
    const T* __restrict__ u1c = u1 + c;

    // masked leg sum in leg order k = 0..NN-1 (the plain version's order)
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < NN; ++k) {
      const int3 v = leg<NN>(k);
      const T bit = T((a >> k) & 1u);
      const T x = u1c[ox[v.x + 1] + oy[v.y + 1] + oz[v.z + 1]];
      acc = k == 0 ? bit * x : acc + bit * x;
    }
    const T K = T(__popc(a));
    const T u0c = u0[c];
    T unew = (T(2) - sl2 * K) * u1c[0] - u0c + a2 * acc;

    // Engquist-Majda ABC on faces (Q=1), edges (2) and corners (3); the
    // folded FCC grid's high-y layer is the fold ghost, not an ABC face
    const int Q = (xlo || xhi) + (ylo || (yhi && !folded)) + (zlo || zhi);
    if (Q > 0) {
      const T lQ = Q == 1 ? lQ1 : (Q == 2 ? lQ2 : lQ3);
      unew = (unew + lQ * u0c) / (T(1) + lQ);
    }
    out[c] = unew;

    if (ENERGY) {  // K7's grid pass on the same registers, in its order
      const T uc = u1c[0];
      e.Lu[c] = e.lfac * (acc - K * uc);
      const T du = uc - u0c;
      const T term = du * du * e.inv_l2 - uc * L_prev;
      sums[0] = (double)term;
      if (Q > 0) sums[1] = abc_h_weight(Q) * (double)term;
    }
  }
  if (ENERGY) {
    const long long b =
        ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
    block_sums<2, kThreads>(sums, e.part + 2 * b);
  }
}

template <typename T, typename A, int NN, bool SHARD, bool ENERGY>
int launch(const void* u0, const void* u1, const void* adj, void* out,
           int Nx, int Ny, int Nz, int folded, double a2, double sl2,
           double lQ1, double lQ2, double lQ3, int g0, int S, int xo,
           void* Lu, void* part, long long npart, double lfac,
           double inv_l2, cudaStream_t stream) {
  if (Nx < 5 || Ny < 5 || Nz < 5) return (int)cudaErrorInvalidValue;
  // neighbour offsets are ints: an (y, z) plane plus a row must fit
  if ((long long)Ny * Nz + Nz + 1 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int rows = SHARD ? S : Nx - 2;
  if (rows < 1 || rows > 65535 || Ny - 2 > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // the owned rows must be global interior rows
  if (SHARD && (g0 < 1 || g0 + xo < 1 || g0 + S + xo > Nx - 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Nz - 2 + kThreads - 1) / kThreads, Ny - 2, rows);
  const long long blocks = (long long)grid.x * grid.y * grid.z;
  // the scratch: kernels/energy.py `scratch_size` counts at least this
  if (ENERGY && npart < 2 * blocks + 2 * kMidBlocks)
    return (int)cudaErrorInvalidValue;
  const EnergyArgs<T> e = {static_cast<T*>(Lu), static_cast<double*>(part),
                           T(lfac), T(inv_l2)};
  stencil_step_kernel<T, A, NN, SHARD, ENERGY><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const A*>(adj), static_cast<T*>(out), Nx, Ny, Nz,
      folded ? 1 : 0, T(a2), T(sl2), T(lQ1), T(lQ2), T(lQ3), g0, xo, e);
  const int rc = (int)cudaGetLastError();
  if (!ENERGY || rc != 0) return rc;
  return pf_energy_mid(static_cast<double*>(part), blocks, stream);
}

template <bool SHARD, bool ENERGY>
int dispatch(int dtype, int nn, const void* u0, const void* u1,
             const void* adj, void* out, int Nx, int Ny, int Nz, int folded,
             double a2, double sl2, double lQ1, double lQ2, double lQ3,
             int g0, int S, int xo, void* Lu, void* part, long long npart,
             double lfac, double inv_l2, cudaStream_t s) {
#define PF_K1_ARGS                                                       \
  u0, u1, adj, out, Nx, Ny, Nz, folded, a2, sl2, lQ1, lQ2, lQ3, g0, S, xo, \
      Lu, part, npart, lfac, inv_l2, s
  if (dtype == 0 && nn == 6)
    return launch<float, uint8_t, 6, SHARD, ENERGY>(PF_K1_ARGS);
  if (dtype == 0 && nn == 12)
    return launch<float, uint16_t, 12, SHARD, ENERGY>(PF_K1_ARGS);
  if (dtype == 1 && nn == 6)
    return launch<double, uint8_t, 6, SHARD, ENERGY>(PF_K1_ARGS);
  if (dtype == 1 && nn == 12)
    return launch<double, uint16_t, 12, SHARD, ENERGY>(PF_K1_ARGS);
#undef PF_K1_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; nn: 6 (uint8 adjacency) or 12 (uint16).
// lQ1..lQ3 are l*Q for Q = 1, 2, 3.  Returns cudaGetLastError().
extern "C" int pf_stencil_step(int dtype, int nn, const void* u0,
                               const void* u1, const void* adj, void* out,
                               int Nx, int Ny, int Nz, int folded, double a2,
                               double sl2, double lQ1, double lQ2, double lQ3,
                               void* stream) {
  return dispatch<false, false>(dtype, nn, u0, u1, adj, out, Nx, Ny, Nz,
                                folded, a2, sl2, lQ1, lQ2, lQ3, 0, 0, 0,
                                nullptr, nullptr, 0, 0.0, 0.0,
                                static_cast<cudaStream_t>(stream));
}

// K1e: pf_stencil_step plus K7's grid pass (L u^n over Lu in place, the
// partial sums into part, npart doubles) and its middle stage; lfac and
// inv_l2 are K7's constants.
extern "C" int pf_stencil_energy_step(int dtype, int nn, const void* u0,
                                      const void* u1, const void* adj,
                                      void* out, void* Lu, void* part,
                                      long long npart, int Nx, int Ny,
                                      int Nz, int folded, double a2,
                                      double sl2, double lQ1, double lQ2,
                                      double lQ3, double lfac,
                                      double inv_l2, void* stream) {
  return dispatch<false, true>(dtype, nn, u0, u1, adj, out, Nx, Ny, Nz,
                               folded, a2, sl2, lQ1, lQ2, lQ3, 0, 0, 0, Lu,
                               part, npart, lfac, inv_l2,
                               static_cast<cudaStream_t>(stream));
}

// K5: the step on local rows g0 .. g0+S-1 of a slab whose local row i is
// global row i + xo; Nx is the global extent, Ny and Nz the slab's.
extern "C" int pf_stencil_step_shard(int dtype, int nn, const void* u0,
                                     const void* u1, const void* adj,
                                     void* out, int Nx, int Ny, int Nz,
                                     int folded, int g0, int S, int xo,
                                     double a2, double sl2, double lQ1,
                                     double lQ2, double lQ3, void* stream) {
  return dispatch<true, false>(dtype, nn, u0, u1, adj, out, Nx, Ny, Nz,
                               folded, a2, sl2, lQ1, lQ2, lQ3, g0, S, xo,
                               nullptr, nullptr, 0, 0.0, 0.0,
                               static_cast<cudaStream_t>(stream));
}
