// K3: TB leapfrog steps per sweep over the grid (temporal blocking), with the
// virtual halo flips, the masked 7/13-point stencil, the Engquist-Majda ABC,
// the lossy-boundary ODE, the sources and the receiver taps fused in.
//
// Replaces the TPU kernels pffdtd_tpu/engine/pallas_pair.py
// `build_fused_pair` (TB = 2) and pallas_tb.py `build_fused_tb` (TB 2..8),
// single-device mode.  (u^{n-1}, u^n) -> (u^{n+TB-1}, u^{n+TB}); each step is
// exactly K1 (stencil.cu), then K2 (boundary.cu, in its ABC mode where the
// scene has lossy nodes on an ABC layer), then the sources, with the same
// operations in the same order, so a sweep equals TB single steps.
//
// Design: 2.5-D, a y-z tile that marches along x.  Block (tz, ty, c) owns
// the columns y in [oy0, oy0+By), z in [oz0, oz0+Bz) of the rows
// x in [X0, X0+Cx) (chunk c).  Level s = -1, 0, 1, .., TB holds u^{n+s};
// level s is computed over the owned columns grown by TB-s in y and z and
// the owned rows grown by TB-s in x (all clamped to the interior), so halo
// work lies on y and z, plus TB(TB-1) extra plane computations a chunk.
// The block walks march positions X; at position X it
// - loads plane X of u^n (grown by TB), u^{n-1} and adj (grown by TB-1):
//   the fields with cp.async straight into shared memory, adj into
//   registers that are stored at the end of the position, so both loads
//   overlap the position's compute;
// - computes level s at plane X - 2s for every s (skew 2), then the lossy
//   nodes of those planes (K2), then their sources;
// - writes the planes of levels TB-1 and TB that the previous position
//   finished (the owned columns of owned rows), and the receiver taps of
//   levels 1..TB-2.
// With skew 2, level s at plane p reads level s-1 at p-1, p, p+1, all
// finished at earlier positions, so a position needs two barriers (after
// the stencils, and after K2, the sources and the loads; a third before
// the sources only where a source sits on a lossy node).  Skew 1 (level s
// at X - s, where level s+1 must wait for level s within the position:
// three barriers a level) was slower on the card (PERF.md).
//
// Ring-slot rule.  Level s holds its planes in a ring of R_s slots of
// shared memory, plane p in slot p mod R_s, every slot (By+2TB) x
// (Bz+2TB) points, z fastest.  At position X level s writes plane X-2s
// while it is read at planes X-2s-4 .. X-2s-1 (by level s+1's stencil,
// s+2's leapfrog and s+2's K2, which reads u^{n+s} at its nodes): five
// planes, so R_s = 5, level 0 (written by the load) included.  Level -1
// is written at X and read at X-2: R_{-1} = 3; level TB is written and
// then read once, by the next position's output: R_TB = 2.  adj is read by
// every level, at planes X-2 .. X-2TB, and written at the end of position
// X: R_adj = 2TB + 1.  No level updates another's planes in place: the
// leapfrog's u^{n+s-2} and K2's u^{n+s-2} at its nodes stay readable until
// level s has finished with them, and no slot is written while another
// thread may read it, which the barriers order.
//
// Threads: a block of teams x Rz threads, the row width Rz = Bz+2TB a
// template constant (32, or 64 for fp32); thread (team, lane) owns the
// column z = oz0-TB+lane and the rows y = oy0-TB+team+j*teams, j <
// kMaxRows, for the whole march.  Its z mirror offsets and ABC faces and,
// per level, the range of j it computes are found once; only the x mirror
// and x faces change per plane, uniformly over the block.  No division
// runs per point.  Air off the y/z edges (nearly every point) sums its
// legs at fixed offsets, each a shared-memory load with an immediate
// offset; other points take the masked, flipped sum.  A warp is 32
// consecutive z of one row, so its shared-memory accesses hit 32 banks.
// Tensor cores have nothing to do here: the stencil is a masked sum of
// neighbours, no matrix product.
//
// Lossy nodes: the tile's list (engine/data.py `build_tile_lists`) holds
// the nodes within TB-1 of the owned box, sorted by row, with per-row
// pointers, each entry's y-z offset in a slot and its ring (Chebyshev
// distance outside the owned box): level s takes the entries of its plane
// with ring <= TB-s.  Their 12 vh and 12 gh branch states live between
// levels in a per-entry scratch in device memory (read from vh_in/gh_in at
// level 1, written and re-read at each level; an entry lives TB planes, so
// the scratch stays in L2); the owner (ring 0) writes vh_out/gh_out at
// level TB.  Sources: each level adds its plane's samples within its region
// (shared-memory atomics, so coincident sources add in no fixed order, as
// index_add_ on the card).  Taps: the owner of a receiver's mirrored point
// writes the intermediate rows u^{n+1} .. u^{n+TB-2}.
//
// ABC mode (ABC = true): lossy nodes on an ABC layer (an open room, a
// surface at the domain's edge).  The reference runs stencil -> lossy ODE
// -> ABC (jax_engine.py:664-685), but the stencil (b) has already applied
// the ABC at every point of those layers.  So, as K2's ABC mode, an entry
// whose node has Q = abcq[node] > 0 (lQ = lQ1..lQ3, the stencil's rounding)
// first undoes it, s = ub*(1 + lQ) - lQ*u2b with u2b the u^{n+s-2} the
// stencil read at that point, runs the ODE and the branch update on s and
// writes (ub + lQ*u2b)/(1 + lQ).  Q is indexed by node, so the ghost-ring
// entries that other tiles (or slabs) own find theirs too.  The host picks
// the instance: a null abcq launches ABC = false, the sweep as it was, whose
// code never reads abcq (it sits last in Args, after every field the sweep
// reads, so that instance's parameter offsets are unchanged too).
//
// Race rule: a block reads its halo ring of u^{n-1}, u^n, vh and gh from the
// input buffers while neighbouring blocks write their owned end-of-sweep
// values, so no output may alias an input: the engine rotates four field
// buffers and double-buffers vh/gh (the wrapper refuses aliases).
//
// K6, shard mode (SHARD = true): the same sweep over the owned rows of one
// x-slab, replacing the x-slab mode of pallas_pair.py `build_fused_pair`
// (`shard=`), generalised to TB = 2..8.  The slab's local row i is global
// row i + xo; Nx is the global extent.  Chunks cover the owned local rows
// [xa, xb) and planes clamp to the computable rows [xl, xh); the x mirror
// and the ABC's x faces use the global row, so only a slab that owns a
// global edge flips there.  The tile lists hold the lossy nodes of the
// ghost bands too (ring > 0), with the owner's start-of-sweep states (the
// engine copies them after every sweep); sources in a ghost band are added
// by every slab that recomputes them, taps are written by the owner.  This
// file builds K3; tb_shard.cu includes it with PF_TB_SHARD set to build K6,
// so the two compile in parallel.
//
// Sizes: fp32, TB = 3 (20 field slots and 7 adj slots): the planner
// (kernels/tb.py `plan_tiles`) gives the headline scene tiles of By x Bz =
// 31 x 26 owned columns, 37 x 32 point slots, 109 KB of shared memory with
// the uint16 adj, two blocks of 256 threads per SM, and chunks of 50 rows;
// 25 on a slab of 198 rows, since `plan_chunk` shortens the chunks of a
// short extent, whose launch would otherwise end in a long tail of blocks
// running beside idle slots.
//
// Bound: device-memory bandwidth for the work it must do.  Per sweep each
// interior point reads u^n, u^{n-1} and adj once and writes two fields once
// (fp32 FCC: 18 bytes per TB steps, against K1's 14 per step), plus each
// lossy node's 2 x 12 branch states in and out: 0.74 ms for a TB = 3
// sweep of the headline scene at 3.35 TB/s.  This design stays well above
// it (PERF.md has its times): its stencil is latency-bound, each thread's
// rows one dependent chain (adj, the neighbours, the adds in K1's order)
// with two blocks of eight warps an SM, and K2's entries are chains of
// dependent device-memory loads between the barriers of every position.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PF_TB_SHARD
#define PF_TB_SHARD 0
#endif

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxRows = 8;   // rows of the tile a thread holds
constexpr int kMaxChunk = 128;  // rows a block marches over, at most
constexpr int kSkew = 2;      // level s works at plane X - kSkew * s
constexpr int kOut = 15;      // ring of a column outside the interior
constexpr int MMb = 12;

// shared-memory slots of level s (-1 .. TB), see the ring-slot rule
__host__ __device__ constexpr int ring_slots(int s, int TB) {
  return s == -1 ? 3 : s < TB ? 2 * kSkew + 1 : 2;
}
__host__ __device__ constexpr int ring_base(int s, int TB) {
  int b = 0;
  for (int t = -1; t < s; ++t) b += ring_slots(t, TB);
  return b;
}
__host__ __device__ constexpr int field_slots(int TB) {
  return ring_base(TB + 1, TB);
}
__host__ __device__ constexpr int adj_slots(int TB) {
  return kSkew * TB + 1;
}

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

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, typename A>
struct Args {
  const T* u0;
  const T* u1;
  const A* adj;
  T* out0;
  T* out1;
  int Nx, Ny, Nz, folded, Cx, By, Bz;
  T a2, sl2, lQ1, lQ2, lQ3, l, lo2;
  const int* tl_rptr;
  const int* tl_node;
  const int* tl_yz;
  const int* tl_ring;
  long long ne;    // list entries
  T* scratch;      // (2 MMb, ne) branch states between levels
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
  int src_k2;      // a source sits on a listed lossy node
  int xa, xb, xl, xh, xo;  // shard mode: local x ranges and offset
  const uint8_t* abcq;     // ABC mode: Q a lossy node, 0 off the ABC layers
};

// one value from device memory into shared memory (address dst), without
// a register: it lands while the block computes
template <typename T>
__device__ __forceinline__ void copy_async(unsigned dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(sizeof(T)));
}

template <typename T, typename A, int NN, int TB, int RZ, bool SHARD,
          bool ABC>
__global__ void __launch_bounds__(kMaxThreads)
tb_sweep_kernel(const Args<T, A> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rp[kMaxChunk + 2 * 7 + 1];  // the tile's row pointers
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int Nx = p.Nx, Ny = p.Ny, Nz = p.Nz;
  // owned rows [xa, xb), computable rows [xl, xh), global row = local + xo
  const int xa = SHARD ? p.xa : 1, xb = SHARD ? p.xb : Nx - 1;
  const int xl = SHARD ? p.xl : 1, xh = SHARD ? p.xh : Nx - 1;
  const int xo = SHARD ? p.xo : 0;
  const int Cx = p.Cx, By = p.By, Bz = p.Bz;
  constexpr int Rz = RZ;  // = Bz + 2 TB, checked by the launcher
  const int Ry = By + 2 * TB, P = Ry * Rz;
  const int X0 = xa + blockIdx.z * Cx, X1 = min(X0 + Cx, xb);
  const int oy0 = 1 + blockIdx.y * By, oy1 = min(oy0 + By, Ny - 1);
  const int oz0 = 1 + blockIdx.x * Bz, oz1 = min(oz0 + Bz, Nz - 1);
  const int ry0 = oy0 - TB, rz0 = oz0 - TB;  // slot origin (unclamped)
  // the field slots F and the adj slots S, addressed by offsets from them
  T* const F = reinterpret_cast<T*>(smem);
  A* const S = reinterpret_cast<A*>(F + field_slots(TB) * P);
  const unsigned sF = (unsigned)__cvta_generic_to_shared(F);
  const long long plane = (long long)Ny * Nz;
  const int W = Cx + 2 * (TB - 1);  // rows of the tile's list
  const int tile = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x;
  for (int i = tid; i <= W; i += nthr)
    rp[i] = p.tl_rptr[(long long)tile * (W + 1) + i];
  const int rbase = X0 - (TB - 1);  // row of rp[0]

  // ---- per-thread constants: the column z and the rows y of this thread
  // (local row yl = team + j * teams); level s (0..TB) takes the rows
  // j in [jl[s], jh[s]) and the columns with ring rzc <= TB - s
  const int teams = nthr / Rz, team = tid / Rz, zl = tid - team * Rz;
  const int z = rz0 + zl;
  const bool zin = z >= 1 && z <= Nz - 2;
  const int rzc = zin ? max(max(oz0 - z, z - (oz1 - 1)), 0) : kOut;
  const bool zlo = z == 1, zhi = z == Nz - 2;
  const int oz[3] = {zlo ? 1 : -1, 0, zhi ? -1 : 1};
  const int ylo_row = 1 - ry0, yhi_row = Ny - 2 - ry0;  // y = 1, Ny - 2
  int jl[TB + 1], jh[TB + 1];
#pragma unroll
  for (int s = 0; s <= TB; ++s) {
    const int ya = max(oy0 - (TB - s), 1) - ry0;
    const int yb = min(oy1 + (TB - s), Ny - 1) - ry0;
    jl[s] = ya <= team ? 0 : (ya - team + teams - 1) / teams;
    jh[s] = yb <= team ? 0 : (yb - team + teams - 1) / teams;
  }
  // global offset of this thread's row j in a plane: gcol + j * gstep
  const long long gcol = (long long)(ry0 + team) * Nz + z;
  const long long gstep = (long long)teams * Nz;
  // this thread's source and receiver (index tid), if any: the first nthr
  // of each stay in registers for the march
  int sx = -1, sy = 0, sz = 0, rx = -1, ryy = 0, rzz = 0;
  if (tid < p.ns) {
    sx = p.src[3 * tid]; sy = p.src[3 * tid + 1]; sz = p.src[3 * tid + 2];
  }
  if (tid < p.nr) {
    rx = p.rcv[3 * tid]; ryy = p.rcv[3 * tid + 1]; rzz = p.rcv[3 * tid + 2];
    if (rx < X0 || rx >= X1 || ryy < oy0 || ryy >= oy1 || rzz < oz0 ||
        rzz >= oz1)
      rx = -1;  // not this block's
  }

  // offset of plane q of level s in F, and of adj plane q in S
  auto fld = [&](int s, int q) -> int {
    const int R = ring_slots(s, TB);
    return (ring_base(s, TB) + (q + R) % R) * P;
  };
  auto fld_rt = [&](int s, int q) -> int {  // s not known at compile time
    int r = 0;
#pragma unroll
    for (int t = -1; t <= TB; ++t)
      if (t == s) r = fld(t, q);
    return r;
  };
  auto adjo = [&](int q) -> int {
    return ((q + adj_slots(TB)) % adj_slots(TB)) * P;
  };
  // rows of level s: the owned rows grown by TB - s, clamped
  auto lo_of = [&](int s) { return max(X0 - (TB - s), xl); };
  auto hi_of = [&](int s) { return min(X1 + (TB - s), xh); };
  auto valid = [&](int s, int q) { return q >= lo_of(s) && q < hi_of(s); };

  // (b) K1 at level s, plane q: flips, masked stencil, leapfrog, ABC
  auto stencil = [&](int s, int q) {
    const int gx = q + xo;
    const bool xlo = gx == 1, xhi = gx == Nx - 2;
    const int oc = fld(s - 1, q);
    const int om = fld(s - 1, xlo ? q + 1 : q - 1);
    const int op = fld(s - 1, xhi ? q - 1 : q + 1);
    const int ol = fld(s - 2, q), ow = fld(s, q), oa = adjo(q);
    const int Qxz = (xlo || xhi) + (zlo || zhi);
    if (rzc > TB - s) return;
#pragma unroll 2
    for (int j = jl[s]; j < jh[s]; ++j) {
      const int yl = team + j * teams;
      const bool ylo = yl == ylo_row, yhi = yl == yhi_row;
      const int c = yl * Rz + zl;
      const unsigned a = S[oa + c];
      // air off the y/z edges: every leg open at a fixed offset, summed in
      // leg order as K1 sums bit * x
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < NN; ++k) {
        const int3 d = leg<NN>(k);
        const int b = (d.x < 0 ? om : (d.x > 0 ? op : oc)) + c;
        const T x = F[b + d.y * Rz + d.z];
        acc = k == 0 ? x : acc + x;
      }
      if (a != (1u << NN) - 1u || ylo || yhi || zlo || zhi) {
        // open legs added in leg order; a closed leg adds nothing where
        // K1 adds 0 * x, which leaves the sum's value unchanged
        const int oy[3] = {ylo ? Rz : -Rz, 0,
                           yhi ? (p.folded ? 0 : -Rz) : Rz};
        acc = T(0);
#pragma unroll
        for (int k = 0; k < NN; ++k) {
          const int3 d = leg<NN>(k);
          const int b = (d.x < 0 ? om : (d.x > 0 ? op : oc)) + c;
          if ((a >> k) & 1u) acc += F[b + oy[d.y + 1] + oz[d.z + 1]];
        }
      }
      const T K = T(__popc(a));
      const T u0c = F[ol + c];
      T unew = (T(2) - p.sl2 * K) * F[oc + c] - u0c + p.a2 * acc;
      const int Q = Qxz + (ylo || (yhi && !p.folded));
      if (Q > 0) {
        const T lQ = Q == 1 ? p.lQ1 : (Q == 2 ? p.lQ2 : p.lQ3);
        unew = (unew + lQ * u0c) / (T(1) + lQ);
      }
      F[ow + c] = unew;
    }
  };

  // the i-th K2 entry of position X (its levels' entries dealt out as one
  // list): (entry, level), or entry -1 past the end; returns their count
  auto nth_entry = [&](int X, int i, int& e, int& lev) -> int {
    e = -1;
    int base = 0;
#pragma unroll
    for (int s = 1; s <= TB; ++s) {
      const int q = X - kSkew * s;
      if (!valid(s, q)) continue;
      const int e0 = rp[q - rbase], n = rp[q - rbase + 1] - e0;
      if (e < 0 && i >= base && i < base + n) {
        e = e0 + i - base;
        lev = s;
      }
      base += n;
    }
    return base;
  };
  // (c) K2 at entry e, level s: its 12 vh and 12 gh states come from
  // vh_in/gh_in at level 1 and the scratch after, and go to the scratch
  // or, at level TB, to vh_out/gh_out
  auto ode = [&](int s, int q, int e, long long node, int yz) {
    const int ow = fld_rt(s, q) + yz;
    const T u2b = F[fld_rt(s - 2, q) + yz];
    const T* vin = s == 1 ? p.vh_in + node : p.scratch + e;
    const T* gin = s == 1 ? p.gh_in + node : p.scratch + MMb * p.ne + e;
    const long long sin_ = s == 1 ? p.nbl : p.ne;
    T* vout = s == TB ? p.vh_out + node : p.scratch + e;
    T* gout = s == TB ? p.gh_out + node : p.scratch + MMb * p.ne + e;
    const long long sout = s == TB ? p.nbl : p.ne;
    const T sa = p.ssaf[node];
    const int m = p.mat[node];
    const T* b = p.coef + (long long)m * 4 * MMb;
    const T* bd = b + MMb;
    const T* bDh = b + 2 * MMb;
    const T* bFh = b + 3 * MMb;
    T v[MMb], g[MMb];
#pragma unroll
    for (int j = 0; j < MMb; ++j) {
      v[j] = vin[j * sin_];
      g[j] = gin[j * sin_];
    }
    T sum = T(0);
#pragma unroll
    for (int j = 0; j < MMb; ++j) {
      const T t = T(2) * bDh[j] * v[j] - bFh[j] * g[j];
      sum = j == 0 ? t : sum + t;
    }
    const T lo2Kbg = p.lo2 * sa * p.beta[m];
    T ub = F[ow];
    // ABC mode: undo the stencil's ABC at a node on an ABC layer (Q > 0),
    // whose u^{n+s-2} is u2b, as K2's ABC mode does (boundary.cu)
    int Q = 0;
    T lQ = T(0);
    if constexpr (ABC) {
      Q = p.abcq[node];
      lQ = Q == 1 ? p.lQ1 : (Q == 2 ? p.lQ2 : p.lQ3);
      if (Q > 0) ub = ub * (T(1) + lQ) - lQ * u2b;
    }
    ub = ub - p.l * sa * sum;
    ub = (ub + lo2Kbg * u2b) / (T(1) + lo2Kbg);
    const T du = ub - u2b;
#pragma unroll
    for (int j = 0; j < MMb; ++j) {
      const T v0 = b[j] * du + bd[j] * v[j] - T(2) * bFh[j] * g[j];
      gout[j * sout] = g[j] + T(0.5) * (v0 + v[j]);
      vout[j * sout] = v0;
    }
    // the ABC after the ODE; the branches took the ODE's ub
    if constexpr (ABC)
      if (Q > 0) ub = (ub + lQ * u2b) / (T(1) + lQ);
    F[ow] = ub;
  };

  // (d) sources of position X's planes inside their levels' regions
  auto add_source = [&](int X, int j, int x, int y, int zz) {
#pragma unroll
    for (int s = 1; s <= TB; ++s) {
      const int q = X - kSkew * s, g = TB - s;
      if (x == q && valid(s, q) && y >= max(oy0 - g, 1) &&
          y < min(oy1 + g, Ny - 1) && zz >= max(oz0 - g, 1) &&
          zz < min(oz1 + g, Nz - 1))
        atomicAdd(F + fld(s, q) + (y - ry0) * Rz + (zz - rz0),
                  p.sig[(s - 1) * p.ns + j]);
    }
  };

  // (e) the planes the previous position finished: levels TB-1 and TB of
  // owned rows to out0/out1 (owned columns), the taps of levels 1..TB-2
  auto tap = [&](int X, int r, int x, int y, int zz) {
#pragma unroll
    for (int s = 1; s <= TB - 2; ++s) {
      const int q = X - kSkew * s;
      if (x == q)
        p.taps[(s - 1) * p.nr + r] =
            F[fld(s, q) + (y - ry0) * Rz + (zz - rz0)];
    }
  };
  auto write_out = [&](int X) {
    const int q1 = X - kSkew * TB, q0 = X - kSkew * (TB - 1);
    const bool w1 = q1 >= X0 && q1 < X1, w0 = q0 >= X0 && q0 < X1;
    if (w1 || w0) {
      const int o1 = fld(TB, q1), o0 = fld(TB - 1, q0);
      T* g1 = p.out1 + q1 * plane + gcol;
      T* g0 = p.out0 + q0 * plane + gcol;
      if (rzc == 0) {
#pragma unroll 1
        for (int j = jl[TB]; j < jh[TB]; ++j) {
          const int c = (team + j * teams) * Rz + zl;
          if (w1) g1[j * gstep] = F[o1 + c];
          if (w0) g0[j * gstep] = F[o0 + c];
        }
      }
    }
    if (rx >= 0) tap(X, tid, rx, ryy, rzz);
    for (int r = tid + nthr; r < p.nr; r += nthr) {
      const int x = p.rcv[3 * r], y = p.rcv[3 * r + 1], zz = p.rcv[3 * r + 2];
      if (x >= X0 && x < X1 && y >= oy0 && y < oy1 && zz >= oz0 && zz < oz1)
        tap(X, r, x, y, zz);
    }
  };

  const int lo0 = lo_of(0), hi0 = hi_of(0);  // u^n rows
  const int lo1 = lo_of(1), hi1 = hi_of(1);  // u^{n-1} and adj rows
  __syncthreads();  // the row table
  // this thread's first K2 entry of the next position, found one position
  // ahead so that its metadata is in registers, and its states in L1, by
  // the time K2 runs
  int ne_e, ne_s = 1;
  int ne_n = nth_entry(lo0, tid, ne_e, ne_s);
  for (int X = lo0; X <= X1 + kSkew * TB; ++X) {
    // ---- (a) start the loads: this position's K2 entry, plane X
    const int ce = ne_e, cs = ne_s, cn = ne_n;
    long long cnode = 0;
    int cyz = 0, cring = kOut;
    if (ce >= 0) {
      cring = p.tl_ring[ce];
      cnode = p.tl_node[ce];
      cyz = p.tl_yz[ce];
      if (cs > 1) {
#pragma unroll
        for (int j = 0; j < 2 * MMb; ++j)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(p.scratch + ce +
                                                        j * p.ne));
      }
    }
    const bool ldu = X >= lo0 && X < hi0, lda = X >= lo1 && X < hi1;
    A ar[kMaxRows];
    if (ldu) {
      const unsigned d0 = sF + fld(0, X) * sizeof(T);
      const unsigned dm = sF + fld(-1, X) * sizeof(T);
      const T* u1r = p.u1 + X * plane + gcol;
      const T* u0r = p.u0 + X * plane + gcol;
      const A* adr = p.adj + X * plane + gcol;
      // rows j < jh[0] <= kMaxRows: of level 0 from jl[0], of level -1 and
      // adj (the rows of level 1) from jl[1]
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        if (j < jl[0] || j >= jh[0] || rzc > TB) continue;
        const unsigned c = ((team + j * teams) * Rz + zl) * sizeof(T);
        copy_async(d0 + c, u1r + j * gstep);
        if (lda && j >= jl[1] && j < jh[1] && rzc <= TB - 1) {
          copy_async(dm + c, u0r + j * gstep);
          ar[j] = adr[j * gstep];
        }
      }
    }
    async_commit();
    write_out(X - 1);
    // stencils of every level, then K2, then the sources
#pragma unroll
    for (int s = 1; s <= TB; ++s)
      if (valid(s, X - kSkew * s)) stencil(s, X - kSkew * s);
    if (ce >= 0 && cs == 1) {  // level 1 reads vh_in, gh_in at its node
#pragma unroll
      for (int j = 0; j < MMb; ++j) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(p.vh_in + cnode +
                                                      j * p.nbl));
        asm volatile("prefetch.global.L1 [%0];" ::"l"(p.gh_in + cnode +
                                                      j * p.nbl));
      }
    }
    ne_n = nth_entry(X + 1, tid, ne_e, ne_s);
    __syncthreads();
    // (c) K2: the prefetched entry, then any past the first nthr
    if (cring <= TB - cs) ode(cs, X - kSkew * cs, ce, cnode, cyz);
    for (int i = tid + nthr; i < cn; i += nthr) {
      int e, lev;
      nth_entry(X, i, e, lev);
      if (e >= 0 && p.tl_ring[e] <= TB - lev)
        ode(lev, X - kSkew * lev, e, p.tl_node[e], p.tl_yz[e]);
    }
    // (d) sources: behind K2 only where one sits on a lossy node
    if (p.src_k2) __syncthreads();
    if (sx >= 0) add_source(X, tid, sx, sy, sz);
    for (int j = tid + nthr; j < p.ns; j += nthr)
      add_source(X, j, p.src[3 * j], p.src[3 * j + 1], p.src[3 * j + 2]);
    if (lda) {
      const int oa = adjo(X);
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j)
        if (j >= jl[1] && j < jh[1] && rzc <= TB - 1)
          S[oa + (team + j * teams) * Rz + zl] = ar[j];
    }
    async_wait();
    __syncthreads();
  }
}

template <typename T, typename A, int TB>
size_t smem_bytes(int By, int Bz) {
  const size_t P = (size_t)(By + 2 * TB) * (Bz + 2 * TB);
  return P * (field_slots(TB) * sizeof(T) + adj_slots(TB) * sizeof(A));
}

template <typename T, typename A, int NN, int TB, int RZ, bool ABC>
int launch_mode(const Args<T, A>& a, int threads, dim3 grid,
                cudaStream_t stream) {
  constexpr bool SHARD = PF_TB_SHARD;
  const size_t smem = smem_bytes<T, A, TB>(a.By, a.Bz);
  cudaError_t e = cudaFuncSetAttribute(
      tb_sweep_kernel<T, A, NN, TB, RZ, SHARD, ABC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  tb_sweep_kernel<T, A, NN, TB, RZ, SHARD, ABC>
      <<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// a uniform choice on the host: no Q array, the sweep without the ABC mode
template <typename T, typename A, int NN, int TB, int RZ>
int launch_rz(const Args<T, A>& a, int threads, dim3 grid,
              cudaStream_t stream) {
  if (a.abcq == nullptr)
    return launch_mode<T, A, NN, TB, RZ, false>(a, threads, grid, stream);
  return launch_mode<T, A, NN, TB, RZ, true>(a, threads, grid, stream);
}

// row widths Bz + 2 TB: 32 for either dtype, 64 for fp32 (kernels/tb.py
// `ROW_WIDTHS`), except at TB = 8 with the uint16 adj, where a row of 64
// never fits 227 KB and the planner never takes it
template <typename T, typename A, int NN, int TB>
int launch_tb(const Args<T, A>& a, int threads, cudaStream_t stream) {
  constexpr bool SHARD = PF_TB_SHARD;
  const int rows = SHARD ? a.xb - a.xa : a.Nx - 2;
  const int Rz = a.Bz + 2 * TB, Ry = a.By + 2 * TB;
  if (rows < 1 || threads % Rz || threads > kMaxThreads || threads < Rz ||
      (threads / Rz) * kMaxRows < Ry || a.Cx > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const long long ntx = (rows + a.Cx - 1) / a.Cx;
  const long long nty = (a.Ny - 2 + a.By - 1) / a.By;
  const long long ntz = (a.Nz - 2 + a.Bz - 1) / a.Bz;
  if (ntx > 65535 || nty > 65535 || ntz > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)ntz, (unsigned)nty, (unsigned)ntx);
  if (Rz == 32) return launch_rz<T, A, NN, TB, 32>(a, threads, grid, stream);
  if constexpr (sizeof(T) == 4 && !(NN == 12 && TB == 8))
    if (Rz == 64) return launch_rz<T, A, NN, TB, 64>(a, threads, grid, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename A, int NN>
int dispatch_tb(int tb, const Args<T, A>& a, int threads, cudaStream_t s) {
  switch (tb) {
    case 2: return launch_tb<T, A, NN, 2>(a, threads, s);
    case 3: return launch_tb<T, A, NN, 3>(a, threads, s);
    case 4: return launch_tb<T, A, NN, 4>(a, threads, s);
    case 5: return launch_tb<T, A, NN, 5>(a, threads, s);
    case 6: return launch_tb<T, A, NN, 6>(a, threads, s);
    case 7: return launch_tb<T, A, NN, 7>(a, threads, s);
    case 8: return launch_tb<T, A, NN, 8>(a, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename A, int NN>
int run(int tb, const void* u0, const void* u1, const void* adj, void* out0,
        void* out1, int Nx, int Ny, int Nz, int folded, int Cx, int By,
        int Bz, int threads, double a2, double sl2, double lQ1, double lQ2,
        double lQ3, double l, double lo2, const void* tl_rptr,
        const void* tl_node, const void* tl_yz, const void* tl_ring,
        long long ne, void* scratch, const void* ssaf, const void* mat,
        const void* coef, const void* beta, const void* vh_in,
        const void* gh_in, void* vh_out, void* gh_out, long long nbl,
        const void* src, const void* sig, int ns, const void* rcv,
        void* taps, int nr, int src_k2, const void* abcq, int xa, int xb,
        int xl, int xh, int xo, cudaStream_t stream) {
  if (Nx < 5 || Ny < 5 || Nz < 5 || Cx < 1 || By < 1 || Bz < 1)
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
  a.Cx = Cx; a.By = By; a.Bz = Bz;
  a.a2 = T(a2); a.sl2 = T(sl2); a.lQ1 = T(lQ1); a.lQ2 = T(lQ2);
  a.lQ3 = T(lQ3); a.l = T(l); a.lo2 = T(lo2);
  a.tl_rptr = static_cast<const int*>(tl_rptr);
  a.tl_node = static_cast<const int*>(tl_node);
  a.tl_yz = static_cast<const int*>(tl_yz);
  a.tl_ring = static_cast<const int*>(tl_ring);
  a.ne = ne;
  a.scratch = static_cast<T*>(scratch);
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
  a.src_k2 = src_k2;
  a.xa = xa; a.xb = xb; a.xl = xl; a.xh = xh; a.xo = xo;
  a.abcq = static_cast<const uint8_t*>(abcq);
  return dispatch_tb<T, A, NN>(tb, a, threads, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; nn: 6 (uint8 adjacency) or 12 (uint16);
// tb: 2..8 steps.  Cx, By, Bz: the owned rows of a chunk and the owned
// columns of a tile (Bz + 2 tb a multiple of 32); threads: a multiple of
// Bz + 2 tb.  tl_*: int32 tile lists (engine/data.py TileLists: rptr,
// node, yz, ring; ne entries); scratch: (2 MMb, ne) of dtype; src, rcv:
// int32 (n, 3) coordinates; sig: (tb, ns); taps: (tb-2, nr) or NULL for
// tb = 2; src_k2: 1 if a source sits on a listed lossy node (its sample
// then waits for K2); abcq: (nbl,) uint8 Q a lossy node (indexed as vh_in's
// columns), or NULL when no lossy node lies on an ABC layer (the sweep
// without the ABC mode).  Returns cudaGetLastError().
#define PF_TB_PARAMS                                                          \
  int dtype, int nn, int tb, const void *u0, const void *u1,                 \
      const void *adj, void *out0, void *out1, int Nx, int Ny, int Nz,       \
      int folded, int Cx, int By, int Bz, int threads, double a2,            \
      double sl2, double lQ1, double lQ2, double lQ3, double l, double lo2,  \
      const void *tl_rptr, const void *tl_node, const void *tl_yz,           \
      const void *tl_ring, long long ne, void *scratch, const void *ssaf,    \
      const void *mat, const void *coef, const void *beta,                   \
      const void *vh_in, const void *gh_in, void *vh_out, void *gh_out,      \
      long long nbl, const void *src, const void *sig, int ns,               \
      const void *rcv, void *taps, int nr, int src_k2, const void *abcq
#define PF_TB_ARGS                                                            \
  tb, u0, u1, adj, out0, out1, Nx, Ny, Nz, folded, Cx, By, Bz, threads, a2,  \
      sl2, lQ1, lQ2, lQ3, l, lo2, tl_rptr, tl_node, tl_yz, tl_ring, ne,      \
      scratch, ssaf, mat, coef, beta, vh_in, gh_in, vh_out, gh_out, nbl,     \
      src, sig, ns, rcv, taps, nr, src_k2, abcq, xa, xb, xl, xh, xo, s
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
