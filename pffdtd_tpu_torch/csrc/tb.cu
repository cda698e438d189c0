// K3: TB leapfrog steps per sweep over the grid (temporal blocking), with the
// virtual halo flips, the masked 7/13-point stencil, the Engquist-Majda ABC,
// the lossy-boundary ODE, the sources and the receiver taps fused in.
//
// Replaces the TPU kernels pffdtd_tpu/engine/pallas_pair.py
// `build_fused_pair` (TB = 2) and pallas_tb.py `build_fused_tb` (TB 2..8),
// single-device mode.  (u^{n-1}, u^n) -> (u^{n+TB-1}, u^{n+TB}); each step is
// exactly K1 (stencil.cu), then K2 (boundary.cu), then the sources, with the
// same operations in the same order, so a sweep equals TB single steps.
//
// Design: overlapped temporal tiling in shared memory.  A block owns a box of
// Bx x By x Bz interior points.  It loads u^n over the region R = the owned
// box grown by TB on every axis (clamped to the interior: the halo layers
// are never loaded, the flips stay virtual as in K1), and u^{n-1} and the
// adjacency over box_0 = the owned box grown by TB-1.  Step s computes the
// box grown by TB-1-s, so the box shrinks one layer per step; FCC legs reach
// one layer per axis, so every neighbour a step reads was computed by the
// step before.  Points of the halo ring are computed redundantly by every
// block that reaches them, from the same inputs, to the same values.
//
// Two field levels suffice: step s writes u^{n+s+1} over u^{n+s-1} point by
// point (the stencil reads u^{n+s-1} only at its own point), after each
// lossy node has stashed u^{n+s-1} at itself in a register for its ODE.
// Lossy nodes: the tile's CSR list (engine/data.py `build_tile_lists`)
// holds every node of box_0 with its offset in R and its ring (distance
// outside the owned box); entry e lives in thread e % 256, slot e / 256, with
// its 12 vh and 12 gh branch states in registers across the TB steps, and
// takes part in step s while ring <= TB-1-s.  Only the owner (ring 0)
// writes vh/gh back.  Sources: each block adds the step's sample at every
// source inside its step box (sig / infac, as the engine).  Taps: the owner
// of a receiver's mirrored point writes the intermediate rows u^{n+1} ..
// u^{n+TB-2}.
//
// Race rule: a block reads its halo ring of u^{n-1}, u^n, vh and gh from the
// input buffers while neighbouring blocks write their owned end-of-sweep
// values, so no output may alias an input: the engine rotates four field
// buffers and double-buffers vh/gh (the wrapper refuses aliases).  The TPU
// kernels alias outputs onto inputs because their grid runs in order on one
// core; blocks here run in no order.
//
// K6, shard mode (SHARD = true): the same sweep over the owned rows of one
// x-slab, replacing the x-slab mode of pallas_pair.py `build_fused_pair`
// (`shard=`), generalised to TB = 2..8.  The slab's local row i is global
// row i + xo; Nx is the global extent.  Tiles cover the owned local rows
// [xa, xb) only and load up to TB ghost rows as data: the x clamp of every
// span is the computable range [xl, xh), all 2G+S local rows on an inner
// edge and the global interior at a global edge.  The x mirror and the
// ABC's x faces use the global row, so only a slab that owns a global edge
// flips there.  The tile lists hold the lossy nodes of the ghost bands too
// (ring > 0), with the owner's start-of-sweep states (the engine copies
// them after every sweep); sources in a ghost band are added by every
// slab that recomputes them, taps are written by the owner.  This file
// builds K3; tb_shard.cu includes it with PF_TB_SHARD set to build K6, so
// the two compile in parallel and K3's code is what it was.
//
// Sizes: fp32, TB = 3 and the owned box 8 x 8 x 32 give R = 14 x 14 x 38 =
// 7,448 points: 2 levels x 29.8 KB + 14.9 KB of uint16 adjacency = 74.5 KB
// of shared memory, so three blocks per SM; the launch bounds hold a thread
// to 85 registers to match (80 used, the branch states partly spilled), 24
// warps per SM.  The wrapper picks smaller boxes where a TB, a dtype or a
// crowded tile needs it.
//
// Bound: device-memory bandwidth for the work it must do.  Per sweep each
// interior point reads u^n, u^{n-1} and adj once and writes two fields once
// (fp32 FCC: 18 bytes per TB steps, against K1's 14 per step), plus each
// lossy node's 2 x 12 branch states in and out.  What holds this first
// design far above that bound on the H100 is its instruction stream: the
// halo ring is recomputed (1.73x the owned point-steps at 8 x 8 x 32,
// TB = 3), every step costs four barriers, and the phases are bound by
// instruction issue and latency at this occupancy: on the card, fewer
// instructions per point and more warps per SM each cut the time, while
// more loads in flight did not (PERF.md).  Left for
// later: a 2.5-D design that marches along x with a ring of planes per
// level (halo work on y and z only), TMA loads of the region, and
// warp-specialised loading.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PF_TB_SHARD
#define PF_TB_SHARD 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 4;  // list entries per thread: 1024 per tile
constexpr int MMb = 12;

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

template <typename T, typename A>
struct Args {
  const T* u0;
  const T* u1;
  const A* adj;
  T* out0;
  T* out1;
  int Nx, Ny, Nz, folded, Bx, By, Bz;
  T a2, sl2, lQ1, lQ2, lQ3, l, lo2;
  const int* tl_ptr;
  const int* tl_node;
  const int* tl_off;
  const int* tl_ring;
  const T* ssaf;
  const int* mat;
  const T* coef;
  const T* beta;
  const T* vh_in;
  const T* gh_in;
  T* vh_out;
  T* gh_out;
  long long nbl;
  const int* src;  // (ns, 3) source coordinates
  const T* sig;    // (TB, ns) this sweep's samples
  int ns;
  const int* rcv;  // (nr, 3) mirrored receiver coordinates
  T* taps;         // (TB-2, nr) rows u^{n+1} .. u^{n+TB-2}
  int nr;
  int xa, xb, xl, xh, xo;  // shard mode: local x ranges and offset
};

// [lo, hi) along one axis of the owned box [o0, o1) grown by g, clamped to
// the interior 1..N-2, or (x in shard mode) to [lo, hi)
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span grow(int o0, int o1, int g, int N) {
  return Span{max(o0 - g, 1), min(o1 + g, N - 1)};
}
__device__ __forceinline__ Span grow(int o0, int o1, int g, int lo, int hi) {
  return Span{max(o0 - g, lo), min(o1 + g, hi)};
}

// i / d for 0 <= i < 2^21 and d >= 1 through a float reciprocal:
// (i + 0.5) / d lies at least 0.5 / d from an integer, and the rounding error
// of the two float operations is below (i + 0.5) / d * 2^-23, smaller than
// that, so the truncation is exact (and cheaper than an integer division by
// a runtime divisor).  Region indices stay below 2^16.
struct DivMod {
  int d;
  float inv;
  __device__ __forceinline__ explicit DivMod(int d_) : d(d_), inv(1.0f / d_) {}
  __device__ __forceinline__ int div(int i) const {
    return __float2int_rz(((float)i + 0.5f) * inv);
  }
};

template <typename T, typename A, int NN, int TB, bool SHARD>
__global__ void __launch_bounds__(kThreads, 3)
tb_sweep_kernel(const Args<T, A> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int Nx = p.Nx, Ny = p.Ny, Nz = p.Nz;
  // owned rows [xa, xb), computable rows [xl, xh), global row = local + xo
  const int xa = SHARD ? p.xa : 1, xb = SHARD ? p.xb : Nx - 1;
  const int xl = SHARD ? p.xl : 1, xh = SHARD ? p.xh : Nx - 1;
  const int xo = SHARD ? p.xo : 0;
  const int ox0 = xa + blockIdx.z * p.Bx, ox1 = min(ox0 + p.Bx, xb);
  const int oy0 = 1 + blockIdx.y * p.By, oy1 = min(oy0 + p.By, Ny - 1);
  const int oz0 = 1 + blockIdx.x * p.Bz, oz1 = min(oz0 + p.Bz, Nz - 1);
  const Span rx = grow(ox0, ox1, TB, xl, xh), ry = grow(oy0, oy1, TB, Ny),
             rz = grow(oz0, oz1, TB, Nz);
  const int Ry = ry.hi - ry.lo, Rz = rz.hi - rz.lo;
  const int nR = (rx.hi - rx.lo) * Ry * Rz;
  const int nRmax = (p.Bx + 2 * TB) * (p.By + 2 * TB) * (p.Bz + 2 * TB);
  T* bufA = reinterpret_cast<T*>(smem);
  T* bufB = bufA + nRmax;
  A* sadj = reinterpret_cast<A*>(bufB + nRmax);
  const int sx = Ry * Rz, sy = Rz;

  // ---- load: u^n over R into bufB; u^{n-1} and adj over box_0 into bufA
  {
    const Span bx = grow(ox0, ox1, TB - 1, xl, xh),
               by = grow(oy0, oy1, TB - 1, Ny), bz = grow(oz0, oz1, TB - 1, Nz);
    const DivMod dz(Rz), dy(Ry);
    for (int i = tid; i < nR; i += kThreads) {
      const int t = dz.div(i), lx = dy.div(t);
      const int lz = i - t * Rz, ly = t - lx * Ry;
      const int gx = rx.lo + lx, gy = ry.lo + ly, gz = rz.lo + lz;
      const long long g = ((long long)gx * Ny + gy) * Nz + gz;
      bufB[i] = p.u1[g];
      if (gx >= bx.lo && gx < bx.hi && gy >= by.lo && gy < by.hi &&
          gz >= bz.lo && gz < bz.hi) {
        bufA[i] = p.u0[g];
        sadj[i] = p.adj[g];
      }
    }
  }

  // ---- lossy list: branch states into registers
  const int tile = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x;
  const int e0 = p.tl_ptr[tile];
  const int ne = p.tl_ptr[tile + 1] - e0;
  T v[kMaxPer][MMb], gh[kMaxPer][MMb], u2b[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int e = tid + k * kThreads;
    u2b[k] = T(0);
#pragma unroll
    for (int j = 0; j < MMb; ++j) {
      v[k][j] = T(0);
      gh[k][j] = T(0);
    }
    if (e < ne) {
      const long long node = p.tl_node[e0 + e];
#pragma unroll
      for (int j = 0; j < MMb; ++j) {
        v[k][j] = p.vh_in[j * p.nbl + node];
        gh[k][j] = p.gh_in[j * p.nbl + node];
      }
    }
  }
  __syncthreads();

  T* cur = bufB;  // u^{n+s}
  T* nxt = bufA;  // u^{n+s-1}, overwritten by u^{n+s+1}
  for (int s = 0; s < TB; ++s) {
    const int gs = TB - 1 - s;
    const Span cx = grow(ox0, ox1, gs, xl, xh), cy = grow(oy0, oy1, gs, Ny),
               cz = grow(oz0, oz1, gs, Nz);

    // (a) each active lossy node stashes u^{n+s-1} at itself
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int e = tid + k * kThreads;
      if (e < ne && p.tl_ring[e0 + e] <= gs) u2b[k] = nxt[p.tl_off[e0 + e]];
    }
    __syncthreads();

    // (b) K1 over the step box: flips, masked stencil, leapfrog, ABC
    const int nyb = cy.hi - cy.lo, nzb = cz.hi - cz.lo;
    const int nb = (cx.hi - cx.lo) * nyb * nzb;
    const DivMod dzb(nzb), dyb(nyb);
    for (int i = tid; i < nb; i += kThreads) {
      const int t = dzb.div(i), tx = dyb.div(t);
      const int gz = cz.lo + i - t * nzb, gy = cy.lo + t - tx * nyb;
      const int gx = cx.lo + tx;
      const int c = ((gx - rx.lo) * Ry + (gy - ry.lo)) * Rz + (gz - rz.lo);
      const bool xlo = gx + xo == 1, xhi = gx + xo == Nx - 2;
      const bool ylo = gy == 1, yhi = gy == Ny - 2;
      const bool zlo = gz == 1, zhi = gz == Nz - 2;
      const int ox[3] = {xlo ? sx : -sx, 0, xhi ? -sx : sx};
      const int oy[3] = {ylo ? sy : -sy, 0, yhi ? (p.folded ? 0 : -sy) : sy};
      const int oz[3] = {zlo ? 1 : -1, 0, zhi ? -1 : 1};
      const unsigned a = sadj[c];
      const T* cc = cur + c;
      // open legs added in leg order; a closed leg adds nothing where K1
      // adds 0 * x, which leaves the sum's value unchanged
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < NN; ++k) {
        const int3 d = leg<NN>(k);
        if ((a >> k) & 1u) acc += cc[ox[d.x + 1] + oy[d.y + 1] + oz[d.z + 1]];
      }
      const T K = T(__popc(a));
      const T u0c = nxt[c];
      T unew = (T(2) - p.sl2 * K) * cc[0] - u0c + p.a2 * acc;
      const int Q = (xlo || xhi) + (ylo || (yhi && !p.folded)) + (zlo || zhi);
      if (Q > 0) {
        const T lQ = Q == 1 ? p.lQ1 : (Q == 2 ? p.lQ2 : p.lQ3);
        unew = (unew + lQ * u0c) / (T(1) + lQ);
      }
      nxt[c] = unew;
    }
    __syncthreads();

    // (c) K2 at the active lossy nodes
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int e = tid + k * kThreads;
      if (e < ne && p.tl_ring[e0 + e] <= gs) {
        const int node = p.tl_node[e0 + e];
        const int off = p.tl_off[e0 + e];
        const T sa = p.ssaf[node];
        const int m = p.mat[node];
        const T* b = p.coef + (long long)m * 4 * MMb;
        const T* bd = b + MMb;
        const T* bDh = b + 2 * MMb;
        const T* bFh = b + 3 * MMb;
        T sum = T(0);
#pragma unroll
        for (int j = 0; j < MMb; ++j) {
          const T t = T(2) * bDh[j] * v[k][j] - bFh[j] * gh[k][j];
          sum = j == 0 ? t : sum + t;
        }
        const T lo2Kbg = p.lo2 * sa * p.beta[m];
        T ub = nxt[off];
        ub = ub - p.l * sa * sum;
        ub = (ub + lo2Kbg * u2b[k]) / (T(1) + lo2Kbg);
        const T du = ub - u2b[k];
#pragma unroll
        for (int j = 0; j < MMb; ++j) {
          const T v0 = b[j] * du + bd[j] * v[k][j] - T(2) * bFh[j] * gh[k][j];
          gh[k][j] = gh[k][j] + T(0.5) * (v0 + v[k][j]);
          v[k][j] = v0;
        }
        nxt[off] = ub;
      }
    }
    __syncthreads();

    // (d) sources inside the step box, in list order (as index_add_)
    if (tid == 0) {
      for (int j = 0; j < p.ns; ++j) {
        const int x = p.src[3 * j], y = p.src[3 * j + 1], z = p.src[3 * j + 2];
        if (x >= cx.lo && x < cx.hi && y >= cy.lo && y < cy.hi &&
            z >= cz.lo && z < cz.hi)
          nxt[((x - rx.lo) * Ry + (y - ry.lo)) * Rz + (z - rz.lo)] +=
              p.sig[s * p.ns + j];
      }
    }
    __syncthreads();

    // (e) taps of the intermediate field u^{n+s+1}, by the owner; the next
    // step writes the other level, so no barrier is needed after it
    if (s < TB - 2) {
      for (int r = tid; r < p.nr; r += kThreads) {
        const int x = p.rcv[3 * r], y = p.rcv[3 * r + 1], z = p.rcv[3 * r + 2];
        if (x >= ox0 && x < ox1 && y >= oy0 && y < oy1 && z >= oz0 && z < oz1)
          p.taps[s * p.nr + r] =
              nxt[((x - rx.lo) * Ry + (y - ry.lo)) * Rz + (z - rz.lo)];
      }
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
  }

  // ---- owned points out: cur = u^{n+TB}, nxt = u^{n+TB-1}
  {
    const int nyo = oy1 - oy0, nzo = oz1 - oz0;
    const int no = (ox1 - ox0) * nyo * nzo;
    for (int i = tid; i < no; i += kThreads) {
      const int gz = oz0 + i % nzo, t = i / nzo;
      const int gy = oy0 + t % nyo, gx = ox0 + t / nyo;
      const int c = ((gx - rx.lo) * Ry + (gy - ry.lo)) * Rz + (gz - rz.lo);
      const long long g = ((long long)gx * Ny + gy) * Nz + gz;
      p.out1[g] = cur[c];
      p.out0[g] = nxt[c];
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int e = tid + k * kThreads;
    if (e < ne && p.tl_ring[e0 + e] == 0) {
      const long long node = p.tl_node[e0 + e];
#pragma unroll
      for (int j = 0; j < MMb; ++j) {
        p.vh_out[j * p.nbl + node] = v[k][j];
        p.gh_out[j * p.nbl + node] = gh[k][j];
      }
    }
  }
}

template <typename T, typename A, int NN, int TB>
int launch_tb(const Args<T, A>& a, cudaStream_t stream) {
  constexpr bool SHARD = PF_TB_SHARD;
  const int rows = SHARD ? a.xb - a.xa : a.Nx - 2;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const long long ntx = (rows + a.Bx - 1) / a.Bx;
  const long long nty = (a.Ny - 2 + a.By - 1) / a.By;
  const long long ntz = (a.Nz - 2 + a.Bz - 1) / a.Bz;
  if (ntx > 65535 || nty > 65535 || ntz > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(a.Bx + 2 * TB) * (a.By + 2 * TB) *
                      (a.Bz + 2 * TB) * (2 * sizeof(T) + sizeof(A));
  cudaError_t e = cudaFuncSetAttribute(
      tb_sweep_kernel<T, A, NN, TB, SHARD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)ntz, (unsigned)nty, (unsigned)ntx);
  tb_sweep_kernel<T, A, NN, TB, SHARD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename A, int NN>
int dispatch_tb(int tb, const Args<T, A>& a, cudaStream_t s) {
  switch (tb) {
    case 2: return launch_tb<T, A, NN, 2>(a, s);
    case 3: return launch_tb<T, A, NN, 3>(a, s);
    case 4: return launch_tb<T, A, NN, 4>(a, s);
    case 5: return launch_tb<T, A, NN, 5>(a, s);
    case 6: return launch_tb<T, A, NN, 6>(a, s);
    case 7: return launch_tb<T, A, NN, 7>(a, s);
    case 8: return launch_tb<T, A, NN, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename A, int NN>
int run(int tb, const void* u0, const void* u1, const void* adj, void* out0,
        void* out1, int Nx, int Ny, int Nz, int folded, int Bx, int By,
        int Bz, double a2, double sl2, double lQ1, double lQ2, double lQ3,
        double l, double lo2, const void* tl_ptr, const void* tl_node,
        const void* tl_off, const void* tl_ring, const void* ssaf,
        const void* mat, const void* coef, const void* beta,
        const void* vh_in, const void* gh_in, void* vh_out, void* gh_out,
        long long nbl, const void* src, const void* sig, int ns,
        const void* rcv, void* taps, int nr, int xa, int xb, int xl, int xh,
        int xo, cudaStream_t stream) {
  if (Nx < 5 || Ny < 5 || Nz < 5 || Bx < 1 || By < 1 || Bz < 1)
    return (int)cudaErrorInvalidValue;
  // shard mode: owned rows inside the computable ones, which are global
  // interior rows
  if (PF_TB_SHARD && (xa < xl || xb > xh || xa >= xb || xl < 0 ||
                      xl + xo < 1 || xh + xo > Nx - 1))
    return (int)cudaErrorInvalidValue;
  Args<T, A> a;
  a.u0 = static_cast<const T*>(u0);
  a.u1 = static_cast<const T*>(u1);
  a.adj = static_cast<const A*>(adj);
  a.out0 = static_cast<T*>(out0);
  a.out1 = static_cast<T*>(out1);
  a.Nx = Nx; a.Ny = Ny; a.Nz = Nz; a.folded = folded ? 1 : 0;
  a.Bx = Bx; a.By = By; a.Bz = Bz;
  a.a2 = T(a2); a.sl2 = T(sl2); a.lQ1 = T(lQ1); a.lQ2 = T(lQ2);
  a.lQ3 = T(lQ3); a.l = T(l); a.lo2 = T(lo2);
  a.tl_ptr = static_cast<const int*>(tl_ptr);
  a.tl_node = static_cast<const int*>(tl_node);
  a.tl_off = static_cast<const int*>(tl_off);
  a.tl_ring = static_cast<const int*>(tl_ring);
  a.ssaf = static_cast<const T*>(ssaf);
  a.mat = static_cast<const int*>(mat);
  a.coef = static_cast<const T*>(coef);
  a.beta = static_cast<const T*>(beta);
  a.vh_in = static_cast<const T*>(vh_in);
  a.gh_in = static_cast<const T*>(gh_in);
  a.vh_out = static_cast<T*>(vh_out);
  a.gh_out = static_cast<T*>(gh_out);
  a.nbl = nbl;
  a.src = static_cast<const int*>(src);
  a.sig = static_cast<const T*>(sig);
  a.ns = ns;
  a.rcv = static_cast<const int*>(rcv);
  a.taps = static_cast<T*>(taps);
  a.nr = nr;
  a.xa = xa; a.xb = xb; a.xl = xl; a.xh = xh; a.xo = xo;
  return dispatch_tb<T, A, NN>(tb, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; nn: 6 (uint8 adjacency) or 12 (uint16);
// tb: 2..8 steps.  Bx, By, Bz: the owned tile box.  tl_*: int32 tile lists
// (engine/data.py TileLists); src, rcv: int32 (n, 3) coordinates; sig:
// (tb, ns); taps: (tb-2, nr) or NULL for tb = 2.  Returns cudaGetLastError().
#define PF_TB_PARAMS                                                          \
  int dtype, int nn, int tb, const void *u0, const void *u1,                 \
      const void *adj, void *out0, void *out1, int Nx, int Ny, int Nz,       \
      int folded, int Bx, int By, int Bz, double a2, double sl2, double lQ1, \
      double lQ2, double lQ3, double l, double lo2, const void *tl_ptr,      \
      const void *tl_node, const void *tl_off, const void *tl_ring,          \
      const void *ssaf, const void *mat, const void *coef, const void *beta, \
      const void *vh_in, const void *gh_in, void *vh_out, void *gh_out,      \
      long long nbl, const void *src, const void *sig, int ns,               \
      const void *rcv, void *taps, int nr
#define PF_TB_ARGS                                                          \
  tb, u0, u1, adj, out0, out1, Nx, Ny, Nz, folded, Bx, By, Bz, a2, sl2, lQ1, \
      lQ2, lQ3, l, lo2, tl_ptr, tl_node, tl_off, tl_ring, ssaf, mat, coef,   \
      beta, vh_in, gh_in, vh_out, gh_out, nbl, src, sig, ns, rcv, taps, nr,  \
      xa, xb, xl, xh, xo, s
#if PF_TB_SHARD
// K6: Nx is the global extent; owned local rows [xa, xb), computable local
// rows [xl, xh), global row = local row + xo.
extern "C" int pf_tb_sweep_shard(PF_TB_PARAMS, int xa, int xb, int xl,
                                 int xh, int xo, void* stream) {
#else
extern "C" int pf_tb_sweep(PF_TB_PARAMS, void* stream) {
  const int xa = 1, xb = Nx - 1, xl = 1, xh = Nx - 1, xo = 0;
#endif
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && nn == 6) return run<float, uint8_t, 6>(PF_TB_ARGS);
  if (dtype == 0 && nn == 12) return run<float, uint16_t, 12>(PF_TB_ARGS);
  if (dtype == 1 && nn == 6) return run<double, uint8_t, 6>(PF_TB_ARGS);
  if (dtype == 1 && nn == 12) return run<double, uint16_t, 12>(PF_TB_ARGS);
  return (int)cudaErrorInvalidValue;
}
#undef PF_TB_ARGS
#undef PF_TB_PARAMS
