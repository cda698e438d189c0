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
// Mirroring each axis on its own equals the z, y, x plane copies of the
// reference's _flip_halos, edges and corners included.  The output goes to
// a third buffer, so u0 and u1 stay intact for K2 and the next step (no
// aliasing hazard, unlike the TPU kernel's out-aliases-u0).
//
// Design: 2.5-D, a y-z tile that marches along x (as K3, tb.cu).  Block
// (tz, ty, c) owns the columns y in [oy0, oy0+By), z in [oz0, oz0+BZ) of
// the rows x in [X0, X0+Cx) (chunk c).  Plane q of u^n, grown by one point
// in y and z, sits in slot q mod kRing of a ring in shared memory; the
// loader fills a cell on a halo layer from its mirror (2 or N-3, Ny-2 for
// the folded high-y ghost), so every point sums its legs at fixed offsets
// from its own cell, and the x mirror is one choice of slot a plane for the
// whole block (at global row 1 the -x neighbour is plane 2's slot, at Nx-2
// the +x one is plane Nx-3's).  At position X the block waits for plane X+1,
// passes one barrier (after which plane X-2's slot is free), starts plane
// X+kRing-2 with cp.async, starts the loads of u^{n-1} and adj of plane X+1
// into registers, and computes plane X from the slots of X-1, X and X+1
// with u^{n-1} and adj loaded one position earlier.  Each point sums its
// legs in leg order k = 0..NN-1 as bit * x terms, or, where every bit is
// set (air: nearly every point), as x terms, which are the same values
// since 1 * x is x; then the leapfrog and the ABC division, with the
// operations of the plain version in its order (-fmad=false), so the step
// is bitwise the plain version's.  Tile and chunk come from the wrapper
// (kernels/stencil.py `plan_k1`, from the shape and dtype alone).
//
// K5, shard mode: the same kernel on the owned rows of one x-slab,
// replacing pffdtd_tpu/engine/pallas_stencil.py
// `build_fused_stencil_sharded`.  The slab holds S owned rows at local rows
// x0 .. x0+S-1 between ghost rows that carry the neighbours' data; local row
// i is global row i + xo, and Nx is the global extent.  The march covers the
// owned rows, and the x mirror and the x faces of the ABC are found from the
// global row, so only a slab that owns a global edge flips there, while
// ghost rows of inner edges are real neighbour data.  K1 is the slab x0 = 1,
// S = Nx-2, xo = 0.
//
// Bound: device-memory bandwidth.  Each point reads u1, u0 and adj and
// writes out once (fp32 FCC: 4 + 4 + 2 + 4 = 14 bytes).  u^n reaches the SM
// once a point plus the ring's halo, (By+2)(BZ+2)/(By BZ) and (Cx+2)/Cx,
// where the 1-D design (each thread reading its 12 neighbours from L2, as
// K1e still does) took nine rows of u^n from L2 for each z-run and ran at
// 45% of the memory's rate on the 1628 x 635 x 1048 FCC grid.  The march
// runs there at 73% of it, within 1.2x of a device copy of the same bytes;
// what is left is spread over the loads, the stores and the arithmetic
// (PERF.md).  Left for later: an in-place update that drops the third
// buffer.
//
// K1e, energy mode (stencil_energy_kernel): the 1-D design, one z-run of 128
// points of a (y, x) row a block, the step above and, in the same launch,
// the grid half of K7 (energy.cu) for the energy-instrumented step
// (pffdtd_tpu/engine/jax_engine.py `step_energy`): each interior point
// reads L u^{n-1} from its own cell of Lu and writes L u^n = lfac (acc -
// K u^n) over it (in place: a point touches only its own cell, and halos
// are never written, so they stay zero), then forms H's term du^2 / l2 -
// u^n L u^{n-1}, du = u^n - u^{n-1}, from the registers the step already
// holds (acc, K, u^n, u^{n-1}), with the operations of the plain version
// (kernels/energy.py `energy_grid_pass_plain`) in its order.  Each thread
// picks, per axis, the signed offset of its -1 and +1 neighbours once
// (flipped at a halo) and each leg adds two of them.  The block writes the
// fp64 sums of the term and of (1 - 2^-Q) x term on ABC points with the
// block tree of energy_sums.cuh at pair 2b of part, b the block index; the
// launcher then runs K7's middle stage.  Tail threads past Nz-2 fall
// through with zero sums, since the block sum has a barrier.  It moves L u
// read and written once a point besides the step's bytes (fp32 FCC: 22 B)
// and 16 B of sums a block.  Left for later: K1's march for K1e, whose
// block sums would then take the march's order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "energy_sums.cuh"  // K7's block sums, ABC weight, middle stage

namespace {

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

// ---- K1 and K5: the march (kernels/stencil.py mirrors these constants)

constexpr int kMarchThreads = 256;
constexpr int kRing = 5;      // u^n planes in shared memory: X-1 .. X+3
constexpr int kMaxRows = 4;   // tile rows a thread computes
static_assert(kRing >= 4, "the ring holds X-1, X, X+1 and the plane ahead");

// ring cells a thread loads a plane, at most: (By+2)(BZ+2) cells over the
// block, By at most kMaxRows rows of every team
template <int BZ>
__host__ __device__ constexpr int march_cells() {
  return ((kMarchThreads / BZ * kMaxRows + 2) * (BZ + 2) + kMarchThreads -
          1) / kMarchThreads;
}

template <typename T, typename A>
struct StepArgs {
  const T* u0;
  const T* u1;
  const A* adj;
  T* out;
  int Nx, Ny, Nz, folded;
  int x0, rows, xo;  // local rows [x0, x0+rows) computed, global = local+xo
  int By, Cx;        // tile rows, chunk rows (the tile's z is BZ)
  T a2, sl2, lQ1, lQ2, lQ3;
};

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// one value from device memory into shared memory (address dst), without
// a register: it lands while the block computes
template <typename T>
__device__ __forceinline__ void copy_async(unsigned dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(sizeof(T)));
}

// in-plane offset of the value that cell (y, z) holds after the mirror
// flips, or -1 for a cell past the far halo (no point reads it)
__device__ __forceinline__ int mirrored(int y, int z, int Ny, int Nz,
                                        int folded) {
  if (y > Ny - 1 || z > Nz - 1) return -1;
  const int my = y == 0 ? 2 : (y == Ny - 1 ? (folded ? Ny - 2 : Ny - 3) : y);
  const int mz = z == 0 ? 2 : (z == Nz - 1 ? Nz - 3 : z);
  return my * Nz + mz;
}

template <typename T, typename A, int NN, int BZ>
__global__ void __launch_bounds__(kMarchThreads)
stencil_step_kernel(const StepArgs<T, A> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RZ = BZ + 2;                   // a ring row
  constexpr int kTeams = kMarchThreads / BZ;   // threads on one z
  constexpr int kCells = march_cells<BZ>();
  constexpr unsigned kAll = (1u << NN) - 1u;
  T* const F = reinterpret_cast<T*>(smem);
  const unsigned sF = (unsigned)__cvta_generic_to_shared(F);
  const int tid = threadIdx.x, team = tid / BZ, zl = tid - team * BZ;
  const int Ny = p.Ny, Nz = p.Nz;
  const int P = (p.By + 2) * RZ;  // cells of a ring plane
  const int oy0 = 1 + blockIdx.y * p.By, oz0 = 1 + blockIdx.x * BZ;
  const int X0 = p.x0 + blockIdx.z * p.Cx;
  const int X1 = min(X0 + p.Cx, p.x0 + p.rows);
  const long long plane = (long long)Ny * Nz;

  // the ring cells this thread loads (cell tid + k * threads of a plane):
  // the in-plane offset of the value each holds after the flips
  int src[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int i = tid + k * kMarchThreads, r = i / RZ;
    src[k] = i < P ? mirrored(oy0 - 1 + r, oz0 - 1 + i - r * RZ, Ny, Nz,
                              p.folded)
                   : -1;
  }
  // the points this thread computes: column z, rows oy0 + team + j kTeams
  const int z = oz0 + zl;
  const bool zlo = z == 1, zhi = z == Nz - 2;
  const int ry = p.By / kTeams;
  unsigned live = 0;
  int off[kMaxRows];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    const int y = oy0 + team + j * kTeams;
    off[j] = y * Nz + z;
    if (j < ry && y <= Ny - 2 && z <= Nz - 2) live |= 1u << j;
  }
  const int c0 = (team + 1) * RZ + zl + 1;  // ring cell of row j = 0

  // plane q of u^n into its slot, as one commit group (empty past X1)
  auto load = [&](int q) {
    if (q <= X1) {
      const T* g = p.u1 + q * plane;
      const unsigned d = sF + ((q % kRing) * P + tid) * sizeof(T);
#pragma unroll
      for (int k = 0; k < kCells; ++k)
        if (src[k] >= 0)
          copy_async(d + k * kMarchThreads * sizeof(T), g + src[k]);
    }
    async_commit();
  };

  for (int q = X0 - 1; q < X0 + kRing - 2; ++q) load(q);
  T u0r[kMaxRows], u0n[kMaxRows];
  A ar[kMaxRows], an[kMaxRows];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    u0r[j] = u0n[j] = T(0);
    ar[j] = an[j] = A(0);
    if (!((live >> j) & 1u)) continue;
    u0r[j] = p.u0[X0 * plane + off[j]];
    ar[j] = p.adj[X0 * plane + off[j]];
  }
  for (int X = X0; X < X1; ++X) {
    async_wait<kRing - 4>();  // this thread's copies of plane X+1
    __syncthreads();          // everyone's; plane X-2's slot is free
    load(X + kRing - 2);
    if (X + 1 < X1) {
      const long long xn = (X + 1) * plane;
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        if (!((live >> j) & 1u)) continue;
        u0n[j] = p.u0[xn + off[j]];
        an[j] = p.adj[xn + off[j]];
      }
    }
    // the x mirror, one choice of slot for the whole block
    const int gx = X + p.xo;
    const bool xlo = gx == 1, xhi = gx == p.Nx - 2;
    const T* Fm = F + ((xlo ? X + 1 : X - 1) % kRing) * P + c0;
    const T* Fc = F + (X % kRing) * P + c0;
    const T* Fp = F + ((xhi ? X - 1 : X + 1) % kRing) * P + c0;
    T* o = p.out + X * plane;
    const int Qxz = (xlo || xhi) + (zlo || zhi);
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (!((live >> j) & 1u)) continue;
      const int c = j * kTeams * RZ;
      T x[NN];
#pragma unroll
      for (int k = 0; k < NN; ++k) {
        const int3 v = leg<NN>(k);
        x[k] = (v.x < 0 ? Fm : (v.x > 0 ? Fp : Fc))[c + v.y * RZ + v.z];
      }
      // masked leg sum in leg order k = 0..NN-1 (the plain version's order)
      const unsigned a = ar[j];
      T acc, K;
      if (a == kAll) {  // every bit set: bit * x is x
        acc = x[0];
#pragma unroll
        for (int k = 1; k < NN; ++k) acc = acc + x[k];
        K = T(NN);
      } else {
        acc = T(a & 1u) * x[0];
#pragma unroll
        for (int k = 1; k < NN; ++k) acc = acc + T((a >> k) & 1u) * x[k];
        K = T(__popc(a));
      }
      const T u0c = u0r[j];
      T unew = (T(2) - p.sl2 * K) * Fc[c] - u0c + p.a2 * acc;
      // Engquist-Majda ABC on faces (Q=1), edges (2) and corners (3); the
      // folded FCC grid's high-y layer is the fold ghost, not an ABC face
      const int y = oy0 + team + j * kTeams;
      const int Q = Qxz + (y == 1 || (y == Ny - 2 && !p.folded));
      if (Q > 0) {
        const T lQ = Q == 1 ? p.lQ1 : (Q == 2 ? p.lQ2 : p.lQ3);
        unew = (unew + lQ * u0c) / (T(1) + lQ);
      }
      o[off[j]] = unew;
    }
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      u0r[j] = u0n[j];
      ar[j] = an[j];
    }
  }
}

template <typename T, typename A, int NN, int BZ>
int launch_march(const StepArgs<T, A>& a, cudaStream_t stream) {
  constexpr int kTeams = kMarchThreads / BZ;
  if (a.By < kTeams || a.By % kTeams || a.By / kTeams > kMaxRows ||
      a.Cx < 1)
    return (int)cudaErrorInvalidValue;
  const long long ntz = (a.Nz - 2 + BZ - 1) / BZ;
  const long long nty = (a.Ny - 2 + a.By - 1) / a.By;
  const long long ntx = (a.rows + a.Cx - 1) / a.Cx;
  if (nty > 65535 || ntx > 65535 || ntz > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  // at most 5 x 34 x 34 fp64 values (BZ = 32, By = 32): under 48 KB
  const size_t smem = (size_t)kRing * (a.By + 2) * (BZ + 2) * sizeof(T);
  stencil_step_kernel<T, A, NN, BZ>
      <<<dim3((unsigned)ntz, (unsigned)nty, (unsigned)ntx), kMarchThreads,
         smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename A, int NN>
int march(const void* u0, const void* u1, const void* adj, void* out,
          int Nx, int Ny, int Nz, int folded, int x0, int rows, int xo,
          int By, int Bz, int Cx, double a2, double sl2, double lQ1,
          double lQ2, double lQ3, cudaStream_t s) {
  const StepArgs<T, A> a = {
      static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const A*>(adj), static_cast<T*>(out), Nx, Ny, Nz,
      folded ? 1 : 0, x0, rows, xo, By, Cx, T(a2), T(sl2), T(lQ1), T(lQ2),
      T(lQ3)};
  if (Bz == 32) return launch_march<T, A, NN, 32>(a, s);
  if (Bz == 64) return launch_march<T, A, NN, 64>(a, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = float64; nn: 6 (uint8 adjacency) or 12 (uint16)
int step(int dtype, int nn, const void* u0, const void* u1, const void* adj,
         void* out, int Nx, int Ny, int Nz, int folded, int x0, int rows,
         int xo, int By, int Bz, int Cx, double a2, double sl2, double lQ1,
         double lQ2, double lQ3, cudaStream_t s) {
  if (Nx < 5 || Ny < 5 || Nz < 5) return (int)cudaErrorInvalidValue;
  // in-plane offsets are ints: an (y, z) plane plus a row must fit
  if ((long long)Ny * Nz + Nz + 1 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // the rows must be global interior rows, with a row each side
  if (rows < 1 || x0 < 1 || x0 + xo < 1 || x0 + rows + xo > Nx - 1)
    return (int)cudaErrorInvalidValue;
#define PF_K1_ARGS                                                          \
  u0, u1, adj, out, Nx, Ny, Nz, folded, x0, rows, xo, By, Bz, Cx, a2, sl2, \
      lQ1, lQ2, lQ3, s
  if (dtype == 0 && nn == 6) return march<float, uint8_t, 6>(PF_K1_ARGS);
  if (dtype == 0 && nn == 12) return march<float, uint16_t, 12>(PF_K1_ARGS);
  if (dtype == 1 && nn == 6) return march<double, uint8_t, 6>(PF_K1_ARGS);
  if (dtype == 1 && nn == 12) return march<double, uint16_t, 12>(PF_K1_ARGS);
#undef PF_K1_ARGS
  return (int)cudaErrorInvalidValue;
}

// ---- K1e: the 1-D design

constexpr int kThreads = 128;  // one z-run of a (y, x) row per block
static_assert(kThreads == kGridThreads,
              "K7's middle stage reads the energy mode's blocks' sums");

// what the energy mode reads and writes besides the step's tensors
template <typename T>
struct EnergyArgs {
  T* Lu;         // L u^{n-1} in, L u^n out (in place)
  double* part;  // K7's fp64 scratch
  T lfac, inv_l2;
};

template <typename T, typename A, int NN>
__global__ void __launch_bounds__(kThreads)
stencil_energy_kernel(const T* __restrict__ u0, const T* __restrict__ u1,
                      const A* __restrict__ adj, T* __restrict__ out,
                      int Nx, int Ny, int Nz, int folded,
                      T a2, T sl2, T lQ1, T lQ2, T lQ3,
                      EnergyArgs<T> e) {
  const int iz = 1 + blockIdx.x * kThreads + threadIdx.x;
  const int iy = 1 + blockIdx.y;
  const int ix = 1 + blockIdx.z;
  const bool live = iz <= Nz - 2;
  double sums[2] = {0.0, 0.0};  // the term, its ABC share
  if (live) {
    const int sy = Nz;
    const int sx = Ny * Nz;  // the launcher checks that it fits an int
    const long long c = (long long)ix * sx + (long long)iy * sy + iz;
    const bool xlo = ix == 1, xhi = ix == Nx - 2;
    const bool ylo = iy == 1, yhi = iy == Ny - 2;
    const bool zlo = iz == 1, zhi = iz == Nz - 2;
    // offset of the neighbour at d = -1, 0, +1 along each axis, after flips
    const int ox[3] = {xlo ? sx : -sx, 0, xhi ? -sx : sx};
    const int oy[3] = {ylo ? sy : -sy, 0, yhi ? (folded ? 0 : -sy) : sy};
    const int oz[3] = {zlo ? 1 : -1, 0, zhi ? -1 : 1};
    const unsigned a = adj[c];
    // L u^{n-1} is loaded with the adjacency, ahead of the legs: loaded
    // after the store of u^{n+1}, K1e took 8.49 ms at the headline shapes
    // on the H100 where this order takes 1.53, and 1.43 late but without
    // the block sum's barrier (PERF.md)
    const T L_prev = e.Lu[c];
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

    {  // K7's grid half on the same registers, in the plain order
      const T uc = u1c[0];
      e.Lu[c] = e.lfac * (acc - K * uc);
      const T du = uc - u0c;
      const T term = du * du * e.inv_l2 - uc * L_prev;
      sums[0] = (double)term;
      if (Q > 0) sums[1] = abc_h_weight(Q) * (double)term;
    }
  }
  const long long b =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  block_sums<2, kThreads>(sums, e.part + 2 * b);
}

template <typename T, typename A, int NN>
int launch_energy(const void* u0, const void* u1, const void* adj, void* out,
                  int Nx, int Ny, int Nz, int folded, double a2, double sl2,
                  double lQ1, double lQ2, double lQ3, void* Lu, void* part,
                  long long npart, double lfac, double inv_l2,
                  cudaStream_t stream) {
  if (Nx < 5 || Ny < 5 || Nz < 5) return (int)cudaErrorInvalidValue;
  // neighbour offsets are ints: an (y, z) plane plus a row must fit
  if ((long long)Ny * Nz + Nz + 1 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (Nx - 2 > 65535 || Ny - 2 > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((Nz - 2 + kThreads - 1) / kThreads, Ny - 2, Nx - 2);
  const long long blocks = (long long)grid.x * grid.y * grid.z;
  // the scratch: kernels/energy.py `scratch_size` counts at least this
  if (npart < 2 * blocks + 2 * kMidBlocks) return (int)cudaErrorInvalidValue;
  const EnergyArgs<T> e = {static_cast<T*>(Lu), static_cast<double*>(part),
                           T(lfac), T(inv_l2)};
  stencil_energy_kernel<T, A, NN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const A*>(adj), static_cast<T*>(out), Nx, Ny, Nz,
      folded ? 1 : 0, T(a2), T(sl2), T(lQ1), T(lQ2), T(lQ3), e);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return pf_energy_mid(static_cast<double*>(part), blocks, stream);
}

}  // namespace

// K1 over the whole grid: tiles of By x Bz and chunks of Cx rows
// (kernels/stencil.py `plan_k1`).  lQ1..lQ3 are l*Q for Q = 1, 2, 3.
// Returns cudaGetLastError().
extern "C" int pf_stencil_step(int dtype, int nn, const void* u0,
                               const void* u1, const void* adj, void* out,
                               int Nx, int Ny, int Nz, int folded, int By,
                               int Bz, int Cx, double a2, double sl2,
                               double lQ1, double lQ2, double lQ3,
                               void* stream) {
  return step(dtype, nn, u0, u1, adj, out, Nx, Ny, Nz, folded, 1, Nx - 2, 0,
              By, Bz, Cx, a2, sl2, lQ1, lQ2, lQ3,
              static_cast<cudaStream_t>(stream));
}

// K1e: the step plus K7's grid half (L u^n over Lu in place, the partial
// sums into part, npart doubles) and K7's middle stage; lfac and inv_l2
// are K7's constants.
extern "C" int pf_stencil_energy_step(int dtype, int nn, const void* u0,
                                      const void* u1, const void* adj,
                                      void* out, void* Lu, void* part,
                                      long long npart, int Nx, int Ny,
                                      int Nz, int folded, double a2,
                                      double sl2, double lQ1, double lQ2,
                                      double lQ3, double lfac,
                                      double inv_l2, void* stream) {
#define PF_K1E_ARGS                                                       \
  u0, u1, adj, out, Nx, Ny, Nz, folded, a2, sl2, lQ1, lQ2, lQ3, Lu, part, \
      npart, lfac, inv_l2, static_cast<cudaStream_t>(stream)
  if (dtype == 0 && nn == 6)
    return launch_energy<float, uint8_t, 6>(PF_K1E_ARGS);
  if (dtype == 0 && nn == 12)
    return launch_energy<float, uint16_t, 12>(PF_K1E_ARGS);
  if (dtype == 1 && nn == 6)
    return launch_energy<double, uint8_t, 6>(PF_K1E_ARGS);
  if (dtype == 1 && nn == 12)
    return launch_energy<double, uint16_t, 12>(PF_K1E_ARGS);
#undef PF_K1E_ARGS
  return (int)cudaErrorInvalidValue;
}

// K5: the step on local rows g0 .. g0+S-1 of a slab whose local row i is
// global row i + xo; Nx is the global extent, Ny and Nz the slab's.
extern "C" int pf_stencil_step_shard(int dtype, int nn, const void* u0,
                                     const void* u1, const void* adj,
                                     void* out, int Nx, int Ny, int Nz,
                                     int folded, int g0, int S, int xo,
                                     int By, int Bz, int Cx, double a2,
                                     double sl2, double lQ1, double lQ2,
                                     double lQ3, void* stream) {
  return step(dtype, nn, u0, u1, adj, out, Nx, Ny, Nz, folded, g0, S, xo, By,
              Bz, Cx, a2, sl2, lQ1, lQ2, lQ3,
              static_cast<cudaStream_t>(stream));
}
