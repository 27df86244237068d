// Diagonal-block Cholesky and triangular inverse in one launch (K3, and
// the chains' batch K3b), on a cluster of 1, 2, 4 or 8 thread blocks per
// diagonal block.
//
// Replaces the Pallas TPU kernel andvaranaut_tpu/gp/pallas_cholinv.py
// (chol_inv_block_pair, and its jax.vmap over the chains): for an SPD
// diagonal block A (b x b, b <= 512, b a multiple of 32) it equilibrates
// with exact power-of-two scales d ~ sqrt(diag A) (the f32 exponent
// arithmetic of gp/cholinv.py's pow2_sqrt_scales), factors As = A / d /
// d^T, inverts the factor and returns L = Ls d, X = Ls^-1 / d (both lower,
// exact zeros above the diagonal) and ok = all entries of Ls and Ls^-1
// finite and min diag(Ls) > 1e-6.  The wrapper launches nothing else.
//
// Numerics: native f64 throughout.  The TPU kernel carried unevaluated
// f32 (hi, lo) pairs (~2^-48) because Pallas on the TPU has no f64; f64
// is more accurate than the pair and the `ok` contract is unchanged.  The
// sums run in another order than the plain version's (LAPACK through
// torch.linalg), so the two agree to rounding, not bit for bit.
//
// Bit for bit across launches: every sum's order is fixed by the block's
// own indices (panel step p, block-row i, block-column j, the inverse's
// row q), never by which CTA, warp or cluster size computes it.  So each
// block's L, X and ok are the same bits at any batch size, at any position
// in the batch and at any cluster size the wrapper picks (gp/cholinv.py cluster_size); the
// batched MCMC objective relies on that (bigfit._nlml_vg_batched equals
// each chain's serial value+grad).
//
// What bounds it: latency.  2b^3/3 = 89.5 MFLOP at b = 512 is ~1.3 us of
// the card's f64 tensor-core peak and 6 MB of traffic ~2 us; what costs
// time is the chain of dependent panel steps, each one diagonal factor
// (32 dependent pivots, a named barrier each) and two cluster barriers.  The
// design:
//
//   * Cluster: CL thread blocks (CTAs) of 256 threads (8 warps) per
//     block of the batch, on CL SMs of one GPC, sharing the factor through
//     distributed shared memory (DSMEM).  CL is a launch attribute
//     (cudaLaunchKernelEx), so one kernel serves every size; the wrapper
//     picks it from (b, batch) so that a large batch runs in few waves
//     (64 blocks of 256 on clusters of 2 fill 128 SMs once where clusters
//     of 8 would take four waves).
//   * Storage: the equilibrated lower triangle, by 32-row block-rows, in
//     the shared memory of the block-rows' owners (block-row i holds i + 1
//     blocks of 32 x 32 doubles, 8 KB each, unpadded, the column XOR-
//     swizzled by 4 (row % 4) so that the mma fragments' 8-byte loads hit
//     16 distinct banks a half-warp).  The owners come from the wrapper's
//     table (gp/cholinv.py cluster_plan), balanced by area beside 9
//     staging blocks.  Each owner reads its rows from device memory once.
//   * Products on the f64 tensor cores: mma.sync m8n8k4 f64 (DMMA), a warp
//     per 8-, 16- or 32-row strip of a 32 x 32 block, k ascending, the
//     fragments of several k steps loaded before their products.
//   * Cholesky, right-looking by 32-column panels p: every owner forms its
//     panel blocks L[i][p] = A[i][p] T_p^T (T_p = L[p][p]^-1 read from L2,
//     a product rather than a 32-step substitution); then lookahead: the
//     owner of block-row p + 1 publishes its panel blocks, and four of its
//     warps apply step p's update to its diagonal block and factor it
//     (T_{p+1} to a device scratch) while its other four warps and every
//     other CTA do the inverse's work of the step and apply the rest of
//     step p's update, staging the panel blocks
//     L[j][p] from their owners in batches of 9.  The two cluster barriers
//     a step are split (arrive early, wait late), so the diagonal chain
//     runs beside the update and the panel barrier instead of after them.
//   * Inverse, in the same loop, two steps behind the factor: X = Ls^-1 /
//     d right-looking, B[i][j] = -sum_{k<i} L[i][k] X[k][j] accumulated in
//     place in X's output, X[q][j] = T_q B[q][j] (T_q / d on the
//     diagonal) finished by the CTA that owns the 16-column strip once
//     B[q] has taken its last update, then B[i][j] -= L[i][q] X[q][j] by
//     the owners of the rows below.  So the inverse needs no phase of its
//     own and no transform of L: its products fill the factor's steps,
//     which the diagonal chain holds anyway.
//
// Where it would go next: the diagonal factor on fewer issued
// instructions (a blocked 8 x 8 factor with DMMA updates), and the
// m16n8k8/k16 f64 mma shapes of sm_90 in place of m8n8k4 (untried).
//
// Nothing is read or written after a CTA leaves: the last cluster barrier
// keeps every CTA's shared memory alive until all are done with it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 32;        // block edge
constexpr int BLK = NB * NB;  // doubles of one block in shared memory
constexpr int MAXCL = 8;      // largest cluster
constexpr int NT = 256;       // threads: 8 warps
constexpr int NW = NT / 32;
constexpr int MAXB = 512;
constexpr int MAXNB = MAXB / NB;
constexpr int SW = 16;        // columns of an inverse strip
constexpr int MAXNS = MAXB / SW;
constexpr int NSLOT = 9;      // staging blocks
constexpr int SMEM_MAX = 232448 - 256;  // dynamic, beside the static bytes

struct Plan {
  int nb;
  int cl;                       // CTAs of the cluster
  int own_blocks;               // blocks of the largest owner's rows
  int row_owner[MAXNB];
  int row_slot[MAXNB];          // first block of block-row i in its owner
  int strip_owner[MAXNS];       // owner of 16-column strip s
};

// element (r, c) of a 32 x 32 block in shared memory
__device__ __forceinline__ int sw(int r, int c) {
  return r * NB + (c ^ ((r & 3) << 2));
}

__device__ __forceinline__ double pow2_sqrt_scale(double v) {
  float f = __double2float_rn(v);
  if (!isnan(f)) f = fmaxf(f, 1e-30f);
  const int e = static_cast<int>((__float_as_uint(f) >> 23) & 0xFF) - 127;
  const int eh = min(max((e + 1) >> 1, -60), 60);
  return static_cast<double>(
      __uint_as_float(static_cast<unsigned>(eh + 127) << 23));
}

// d += a b over one 8 x 8 x 4 f64 tensor-core product (DMMA)
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// a swizzled 32 x 32 block in the shared memory of this CTA or a peer
struct SmemBlk {
  const double* p;
  __device__ __forceinline__ double operator()(int r, int c) const {
    return p[sw(r, c)];
  }
};

// a swizzled 32 x 32 block in device memory written during this launch
// (read from L2, no stale L1 line)
struct GlobalBlk {
  const double* p;
  __device__ __forceinline__ double operator()(int r, int c) const {
    return __ldcg(p + sw(r, c));
  }
};

// row-major rows at stride ld in device memory written during this launch
// (read from L2, no stale L1 line)
struct GlobalRows {
  const double* p;
  int ld;
  __device__ __forceinline__ double operator()(int r, int c) const {
    return __ldcg(p + static_cast<size_t>(r) * ld + c);
  }
};

// acc += (NEG ? -A : A) (NN ? B : B^T) on the 8 x 8 output tiles (rt0 + x,
// ct0 + y), x < RT, y < CT, of a 32 x 32 block: k ascending by 4, one
// DMMA per tile and k step.  acc[x][y] is the tile's D fragment: lane l
// holds elements (8 (rt0 + x) + l / 4, 8 (ct0 + y) + 2 (l % 4) + e).
// The fragments of KS k steps (KS divides 8) load before their products,
// so that a remote (DSMEM) or L2 operand costs one round trip per KS
// steps.
template <bool NN, bool NEG, int KS, int RT, int CT, class TA, class TB>
__device__ __forceinline__ void warp_mm(double (&acc)[RT][CT][2], const TA& A,
                                        const TB& B, int rt0, int ct0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < NB; k0 += 4 * KS) {
    double a[KS][RT], bb[KS][CT];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k = k0 + 4 * s + t4;
#pragma unroll
      for (int x = 0; x < RT; ++x) {
        const double v = A(8 * (rt0 + x) + g, k);
        a[s][x] = NEG ? -v : v;
      }
#pragma unroll
      for (int y = 0; y < CT; ++y)
        bb[s][y] = NN ? B(k, 8 * (ct0 + y) + g) : B(8 * (ct0 + y) + g, k);
    }
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int x = 0; x < RT; ++x)
#pragma unroll
        for (int y = 0; y < CT; ++y) dmma(acc[x][y], a[s][x], bb[s][y]);
  }
}

template <int RT, int CT>
__device__ __forceinline__ void zero(double (&acc)[RT][CT][2]) {
#pragma unroll
  for (int x = 0; x < RT; ++x)
#pragma unroll
    for (int y = 0; y < CT; ++y) acc[x][y][0] = acc[x][y][1] = 0.0;
}

// the D fragments of acc from / to a swizzled block (two adjacent columns
// stay adjacent under the swizzle: one 16-byte access)
template <bool STORE, int RT, int CT>
__device__ __forceinline__ void frag_io(double (&acc)[RT][CT][2], double* blk,
                                        int rt0, int ct0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int x = 0; x < RT; ++x)
#pragma unroll
    for (int y = 0; y < CT; ++y) {
      double2* p = reinterpret_cast<double2*>(
          blk + sw(8 * (rt0 + x) + g, 8 * (ct0 + y) + 2 * t4));
      if (STORE) {
        *p = make_double2(acc[x][y][0], acc[x][y][1]);
      } else {
        const double2 v = *p;
        acc[x][y][0] = v.x;
        acc[x][y][1] = v.y;
      }
    }
}

// the same for a row-major block in device memory at row stride ld (read
// from L2)
template <bool STORE, int RT, int CT>
__device__ __forceinline__ void frag_rows(double (&acc)[RT][CT][2],
                                          double* p, int ld, int rt0,
                                          int ct0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int x = 0; x < RT; ++x)
#pragma unroll
    for (int y = 0; y < CT; ++y) {
      double2* q = reinterpret_cast<double2*>(
          p + static_cast<size_t>(8 * (rt0 + x) + g) * ld + 8 * (ct0 + y) +
          2 * t4);
      if (STORE) {
        *q = make_double2(acc[x][y][0], acc[x][y][1]);
      } else {
        const double2 v = __ldcg(q);
        acc[x][y][0] = v.x;
        acc[x][y][1] = v.y;
      }
    }
}

// barrier 1 among the first `count` threads counted from the team's first
// warp (bar.sync counts arrivals, whichever warps they come from)
__device__ __forceinline__ void team_sync(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Warps 0-3: the 32 x 32 block P factored in place (its lower triangle),
// then its inverse T = P^-1 written to tg (32 x 32 in the swizzled layout,
// exact zeros above the diagonal).  The factor with lane = row and warp w
// holding columns 4 t + w (t < 8) in registers: at pivot jj the warp that
// holds column jj passes it through shared memory (cb, double-buffered),
// one named barrier among the four warps, then every warp scales its rows'
// entry and updates its own columns.  A quarter of one warp's issue and a
// quarter of its code: fully unrolled on one warp, the 496 update bodies
// issued ~12k cycles and ran from a cold instruction cache on the SM that
// factors a block only once or twice a launch.  Then warp 0 alone: the
// inverse by forward substitution on the identity with lane = column (the
// factor's entries broadcast reads of shared memory, the pivots'
// reciprocal square roots from rdv).
// (No __restrict__: the other warps rewrite cb, rdv and P between the
// barriers, so no value may be kept across them.)
__device__ void factor_diag(double* P, double* tg, double* cb, double* rdv) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  double a[NB / 4];
#pragma unroll
  for (int t = 0; t < NB / 4; ++t) a[t] = P[sw(lane, 4 * t + w)];
#pragma unroll
  for (int jj = 0; jj < NB; ++jj) {
    double* col = cb + (jj & 1) * NB;
    if (w == (jj & 3)) col[lane] = a[jj >> 2];
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
    const double djj = col[jj];
    const double rs = rsqrt(djj);
    const double l = col[lane] * rs;  // L[lane][jj]
    if (w == (jj & 3)) {
      if (lane >= jj) P[sw(lane, jj)] = lane == jj ? djj * rs : l;
      if (lane == jj) rdv[jj] = rs;
    }
#pragma unroll
    for (int t = 0; t < NB / 4; ++t) {
      const int c = 4 * t + w;
      if (c > jj && lane >= c) a[t] = fma(-l, col[c] * rs, a[t]);
    }
  }
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
  if (w != 0) return;
  double x[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) x[r] = r == lane ? 1.0 : 0.0;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const double xq = x[q] * rdv[q];
    x[q] = xq;
#pragma unroll
    for (int r = q + 1; r < NB; ++r) x[r] = fma(-P[sw(r, q)], xq, x[r]);
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) tg[sw(r, lane)] = x[r];
}

// One cluster per block of the batch: cluster blockIdx.y factors the block
// at A + blockIdx.y * sa and writes its L, X, dinv scratch and ok at the
// same batch index (a batch of one is the single launch).  Xo and dinv
// carry no __restrict__: other CTAs write what this one reads back after
// a barrier.
__global__ void __launch_bounds__(NT, 1)
    cholinv_cluster_kernel(const double* __restrict__ A, int lda,
                           long long sa, double* __restrict__ Lo, double* Xo,
                           double* dinv, unsigned char* __restrict__ ok,
                           int b, const Plan plan) {
  {
    const size_t bi = blockIdx.y;
    A += bi * static_cast<size_t>(sa);
    Lo += bi * b * b;
    Xo += bi * b * b;
    dinv += bi * b * NB;
    ok += bi;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) double sm[];
  double* own = sm;
  double* slot = sm + plan.own_blocks * BLK;
  double* dsc = slot + NSLOT * BLK;
  double* rdsc = dsc + b;
  __shared__ int mine[MAXNB];
  __shared__ int nmine;
  __shared__ int cta_bad;
  __shared__ double fcol[2 * NB], frd[NB];  // factor_diag's scratch
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nb = plan.nb;
  auto blk = [&](int i, int j) { return own + (plan.row_slot[i] + j) * BLK; };
  auto peer = [&](int i, int j) -> const double* {
    return cluster.map_shared_rank(sm + (plan.row_slot[i] + j) * BLK,
                                   plan.row_owner[i]);
  };

  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < nb; ++i)
      if (plan.row_owner[i] == me) mine[n++] = i;
    nmine = n;
  }
  for (int r = tid; r < b; r += NT) {
    dsc[r] = pow2_sqrt_scale(A[static_cast<size_t>(r) * lda + r]);
    rdsc[r] = 1.0 / dsc[r];  // exact: a power of two
  }
  __syncthreads();
  const int nm = nmine;
  const int lane = tid & 31;
  // my rows, a warp per row, 16 columns of 32 in flight a lane; As = A /
  // d / d^T by the exact reciprocal powers of two
  for (int q = 0; q < nm; ++q) {
    const int i = mine[q];
    for (int rr = warp; rr < NB; rr += NW) {
      const int row = NB * i + rr;
      const double* src = A + static_cast<size_t>(row) * lda;
      double v[MAXNB];
#pragma unroll
      for (int t = 0; t < MAXNB; ++t)
        if (t <= i) v[t] = src[NB * t + lane];
#pragma unroll
      for (int t = 0; t < MAXNB; ++t)
        if (t <= i)
          blk(i, t)[sw(rr, lane)] = v[t] * rdsc[row] * rdsc[NB * t + lane];
    }
  }
  __syncthreads();
  if (plan.row_owner[0] == me && warp < 4)
    factor_diag(blk(0, 0), dinv, fcol, frd);
  cluster.sync();  // T_0 in dinv
  int bad = 0;

  // slot[0 .. n) = the blocks src(jj, e) (element e of the swizzled
  // layout), by team thread tt of nt, 8 loads in flight a thread
  auto stage = [&](int n, int tt, int nt, auto src) {
    for (int e0 = tt; e0 < n * BLK; e0 += 8 * nt) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nt;
        if (e < n * BLK) v[u] = src(e / BLK, e % BLK);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nt;
        if (e < n * BLK) slot[e] = v[u];
      }
    }
  };

  // Step p's factor update A[i][j] -= L[i][p] L[j][p]^T, p < j <= i, of my
  // rows from mine[first], 16-row halves dealt to the team's nw warps (tw:
  // this warp's index in the team; barrier 1 among them); skip: the block
  // (p + 1, p + 1), which the lookahead updated.
  auto update = [&](int p, int first, int tw, int nw, bool skip) {
    const int tt = 32 * tw + lane, nt = 32 * nw;
    const int jmax = mine[nm - 1];
    for (int j0 = p + 1; j0 <= jmax; j0 += NSLOT) {
      const int j1 = min(j0 + NSLOT, jmax + 1);
      stage(j1 - j0, tt, nt,
            [&](int jj, int e) { return peer(j0 + jj, p)[e]; });
      team_sync(nt);
      int ntask = 0;
      for (int q = first; q < nm; ++q)
        ntask += max(0, min(j1, mine[q] + 1) - j0);
      for (int u = tw; u < 2 * ntask; u += nw) {
        int i = 0, j = 0, rem = u >> 1;
        for (int q = first; q < nm; ++q) {
          const int cnt = max(0, min(j1, mine[q] + 1) - j0);
          if (rem < cnt) {
            i = mine[q];
            j = j0 + rem;
            break;
          }
          rem -= cnt;
        }
        if (skip && i == p + 1 && j == p + 1) continue;
        const int rt0 = 2 * (u & 1);
        double acc[2][4][2];
        frag_io<false>(acc, blk(i, j), rt0, 0);
        warp_mm<false, true, 4>(acc, SmemBlk{blk(i, p)},
                                SmemBlk{slot + (j - j0) * BLK}, rt0, 0);
        frag_io<true>(acc, blk(i, j), rt0, 0);
      }
      team_sync(nt);
    }
  };

  // The inverse's update with the finished row q of X: B[i][j] -= L[i][q]
  // X[q][j] for my rows i > q and j <= q (B[i][q] from zero), B held in
  // place in Xo, X[q][j] staged from Xo in batches
  auto xupdate = [&](int q, int tw, int nw) {
    const int tt = 32 * tw + lane, nt = 32 * nw;
    int first = 0;
    while (first < nm && mine[first] <= q) ++first;
    const int nr = nm - first;
    if (nr == 0) return;
    for (int j0 = 0; j0 <= q; j0 += NSLOT) {
      const int nj = min(NSLOT, q + 1 - j0);
      stage(nj, tt, nt, [&](int jj, int e) {
        const int r = e >> 5, c = (e & 31) ^ ((r & 3) << 2);
        return __ldcg(Xo + static_cast<size_t>(NB * q + r) * b +
                      NB * (j0 + jj) + c);
      });
      team_sync(nt);
      for (int u = tw; u < 2 * nr * nj; u += nw) {
        const int t = u >> 1, i = mine[first + t / nj], j = j0 + t % nj;
        const int rt0 = 2 * (u & 1);
        double* Bij = Xo + static_cast<size_t>(NB * i) * b + NB * j;
        double acc[2][4][2];
        if (j == q)
          zero(acc);
        else
          frag_rows<false>(acc, Bij, b, rt0, 0);
        warp_mm<true, true, 4>(acc, SmemBlk{blk(i, q)},
                               SmemBlk{slot + (j - j0) * BLK}, rt0, 0);
        frag_rows<true>(acc, Bij, b, rt0, 0);
      }
      team_sync(nt);
    }
  };

  // Row q of X from its finished B: for my 16-column strips s, X[q][s] =
  // T_q B[q][s] in place (column block jb < q, a warp a strip), T_q / d
  // (jb == q), zeros (jb > q); by the team's nw warps (tw: this warp's
  // index in the team)
  auto finalize = [&](int q, int tw, int nw) {
    const int tt = 32 * tw + lane, nt = 32 * nw;
    for (int s = 0, u = 0; s < 2 * nb; ++s) {
      if (plan.strip_owner[s] != me) continue;
      const int jb = s >> 1, cs = NB * jb + SW * (s & 1);
      double* Xq = Xo + static_cast<size_t>(NB * q) * b + cs;
      if (jb < q) {
        if (u++ % nw != tw) continue;
        double acc[4][2][2];
        zero(acc);
        warp_mm<true, false, 8>(acc, GlobalBlk{dinv + q * BLK},
                                GlobalRows{Xq, b}, 0, 0);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 2; ++y)
            if (!isfinite(acc[x][y][0]) || !isfinite(acc[x][y][1])) bad = 1;
        frag_rows<true>(acc, Xq, b, 0, 0);
      } else {
        for (int e = tt; e < NB * SW; e += nt) {
          const int r = e / SW, c = e % SW;
          double v = 0.0;
          if (jb == q) {
            v = __ldcg(dinv + q * BLK + sw(r, SW * (s & 1) + c)) *
                rdsc[cs + c];
            if (!isfinite(v)) bad = 1;
          }
          Xq[static_cast<size_t>(r) * b + c] = v;
        }
      }
    }
  };

  // ---- Cholesky, with the inverse two steps behind -------------------
  // Two split cluster barriers a step: B (panel column p and row p - 2 of
  // X published) and T (T_{p+1} and the inverse's B rows published).  The
  // owner of block-row p + 1 arrives at B as soon as its own panel blocks
  // and X strips are formed and factors its diagonal block before it waits
  // there, beside its other warps' updates; every warp arrives at T once
  // its updates are written.  Row q of X is finished at step q + 2, its B
  // having taken the update with row q - 1 at step q + 1.
  for (int p = 0; p < nb + 2; ++p) {
    const int q = p - 2;
    int first = 0;  // my block-rows below p: mine[first..nm)
    while (first < nm && mine[first] <= p) ++first;
    const int nrow = nm - first;
    // L[i][p] = A[i][p] T_p^T, an 8-row strip a warp, T_p read from L2;
    // the strip reads only its own rows of A[i][p]: in place
    for (int u = warp; u < 4 * nrow; u += NW) {
      double* Ab = blk(mine[first + (u >> 2)], p);
      double acc[1][4][2];
      zero(acc);
      warp_mm<false, false, 8>(acc, SmemBlk{Ab}, GlobalBlk{dinv + p * BLK},
                               u & 3, 0);
      frag_io<true>(acc, Ab, u & 3, 0);
    }
    if (p + 1 < nb && plan.row_owner[p + 1] == me) {
      __syncthreads();  // L[p+1][p] formed
      if (warp < 4) {
        cluster_arrive();  // B: my panel blocks
        // lookahead: A[p+1][p+1] -= L[p+1][p] L[p+1][p]^T (an 8-row strip
        // a warp), then warps 0-3 factor it, while warps 4-7 finish my
        // strips of row q of X and update the rest
        double* D = blk(p + 1, p + 1);
        const double* Lp = blk(p + 1, p);
        double acc[1][4][2];
        frag_io<false>(acc, D, warp, 0);
        warp_mm<false, true, 8>(acc, SmemBlk{Lp}, SmemBlk{Lp}, warp, 0);
        frag_io<true>(acc, D, warp, 0);
        asm volatile("bar.sync 2, 128;\n" ::: "memory");
        factor_diag(D, dinv + (p + 1) * BLK, fcol, frd);
        cluster_wait();
        cluster_arrive();  // T: T_{p+1} written
      } else {
        if (q >= 0) finalize(q, warp - 4, 4);
        cluster_arrive();  // B: my strips of row q of X
        cluster_wait();
        update(p, first, warp - 4, 4, true);
        if (q >= 0) xupdate(q, warp - 4, 4);
        cluster_arrive();  // T: the inverse's B rows written
      }
    } else {
      if (q >= 0) finalize(q, warp, NW);
      cluster_arrive();
      cluster_wait();
      if (nrow > 0 && p + 1 < nb) update(p, first, warp, NW, false);
      if (q >= 0) xupdate(q, warp, NW);
      cluster_arrive();
    }
    __syncthreads();
    cluster_wait();  // T_{p+1} in dinv, B rows updated
  }

  // ---- L out (L = Ls d), a warp per row, and the ok checks on Ls -------
  for (int q = 0; q < nm; ++q) {
    const int i = mine[q];
    for (int rr = warp; rr < NB; rr += NW) {
      const int row = NB * i + rr;
      double* dst = Lo + static_cast<size_t>(row) * b;
      for (int c = lane; c < b; c += 32) {
        double v = 0.0;
        if (c <= row) {
          v = blk(i, c >> 5)[sw(rr, c & 31)];
          if (!isfinite(v) || (c == row && !(v > 1e-6))) bad = 1;
          v *= dsc[row];
        }
        dst[c] = v;
      }
    }
  }

  bad = __syncthreads_or(bad);
  if (tid == 0) cta_bad = bad;
  cluster.sync();
  if (me == 0 && tid == 0) {
    int any = 0;
    for (int r = 0; r < plan.cl; ++r)
      any |= *cluster.map_shared_rank(&cta_bad, r);
    *ok = any ? 0 : 1;
  }
  cluster.sync();  // keep every CTA's shared memory until all are done
}

// The plan of a b-block on a cluster of cl CTAs from the wrapper's table
// (row owners of the nb block-rows, MAXNB entries, then the owners of the
// 2 nb strips, MAXNS entries) and the dynamic shared memory it needs;
// false when the table, cl or b is invalid or the plan does not fit.
bool make_plan(int b, int cl, const int* table, Plan* plan, int* smem) {
  if (b <= 0 || b > MAXB || b % NB || table == nullptr ||
      (cl != 1 && cl != 2 && cl != 4 && cl != 8))
    return false;
  const int nb = b / NB;
  int used[MAXCL] = {};
  plan->nb = nb;
  plan->cl = cl;
  for (int i = 0; i < MAXNB; ++i) {
    plan->row_owner[i] = plan->row_slot[i] = 0;
    if (i >= nb) continue;
    const int ro = table[i];
    if (ro < 0 || ro >= cl) return false;
    plan->row_owner[i] = ro;
    plan->row_slot[i] = used[ro];
    used[ro] += i + 1;
  }
  for (int s = 0; s < MAXNS; ++s) {
    plan->strip_owner[s] = 0;
    if (s >= 2 * nb) continue;
    const int so = table[MAXNB + s];
    if (so < 0 || so >= cl) return false;
    plan->strip_owner[s] = so;
  }
  int most = 0;
  for (int c = 0; c < cl; ++c) most = used[c] > most ? used[c] : most;
  plan->own_blocks = most;
  const size_t bytes =
      (static_cast<size_t>(most + NSLOT) * BLK + 2 * b) * sizeof(double);
  if (bytes > static_cast<size_t>(SMEM_MAX)) return false;
  *smem = static_cast<int>(bytes);
  return true;
}

}  // namespace

// A batch of nbatch blocks in one launch of nbatch clusters of cl CTAs
// (the grid's y): block i at A + i * sa (b, b) at row stride lda (lower
// triangle and diagonal read), L, X: (nbatch, b, b) f64 outputs
// (contiguous), dinv: (nbatch, b / 32, 32, 32) f64 scratch (the diagonal
// blocks' inverses), ok: nbatch bytes (a torch.bool each).  table: the
// owners of the 16 block-rows and of the 32 16-column strips
// (gp/cholinv.py cluster_plan).  b <= 512, b % 32 == 0, cl 1, 2, 4 or 8,
// 1 <= nbatch <= 65535.  Every cluster computes exactly what a launch of
// one would, at any cl.  Returns the launch's cudaError_t.
extern "C" int chol_inv_blocks(const void* A, int lda, long long sa,
                               void* L, void* X, void* dinv, void* ok, int b,
                               int nbatch, int cl, const int* table,
                               void* stream) {
  Plan plan;
  int smem = 0;
  if (lda < b || nbatch < 1 || nbatch > 65535 ||
      (nbatch > 1 && sa < static_cast<long long>(lda) * (b - 1) + b) ||
      !make_plan(b, cl, table, &plan, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cholinv_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, nbatch);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, cholinv_cluster_kernel, static_cast<const double*>(A), lda, sa,
      static_cast<double*>(L), static_cast<double*>(X),
      static_cast<double*>(dinv), static_cast<unsigned char*>(ok), b, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One block: chol_inv_blocks with a batch of one.  A: (b, b) at row stride
// lda, L, X: (b, b) contiguous, dinv: (b / 32, 32, 32), ok: one byte.
extern "C" int chol_inv_block(const void* A, int lda, void* L, void* X,
                              void* dinv, void* ok, int b, int cl,
                              const int* table, void* stream) {
  return chol_inv_blocks(A, lda, 0, L, X, dinv, ok, b, 1, cl, table, stream);
}

// info[0]: thread blocks of the cluster, info[1]: dynamic shared memory
// per block in bytes, for a b-block on cl CTAs under the table.  Returns
// 0, or cudaErrorInvalidValue.
extern "C" int chol_inv_info(int b, int cl, const int* table, int* info) {
  Plan plan;
  int smem = 0;
  if (!make_plan(b, cl, table, &plan, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  info[0] = cl;
  info[1] = smem;
  return 0;
}
