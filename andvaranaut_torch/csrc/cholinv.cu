// Diagonal-block Cholesky and triangular inverse in one launch (K3), on a
// cluster of 8 thread blocks.
//
// Replaces the Pallas TPU kernel andvaranaut_tpu/gp/pallas_cholinv.py
// (chol_inv_block_pair): for an SPD diagonal block A (b x b, b <= 512, b a
// multiple of 32) it equilibrates with exact power-of-two scales d ~
// sqrt(diag A) (the f32 exponent arithmetic of gp/cholinv.py's
// pow2_sqrt_scales), factors As = A / d / d^T, inverts the factor and
// returns L = Ls d, X = Ls^-1 / d (both lower, exact zeros above the
// diagonal) and ok = all entries of Ls and Ls^-1 finite and min diag(Ls)
// > 1e-6.  The wrapper launches nothing else.
//
// Numerics: native f64 throughout.  The TPU kernel carried unevaluated
// f32 (hi, lo) pairs (~2^-48) because Pallas on the TPU has no f64; f64
// is more accurate than the pair and the `ok` contract is unchanged.  The
// sums run in another order than the plain version's (LAPACK through
// torch.linalg), so the two agree to rounding, not bit for bit.
//
// What bounds it: latency.  2b^3/3 = 89.5 MFLOP at b = 512 is ~1.3 us of
// the card's f64 peak and 6 MB of traffic ~2 us; what costs time is the
// chain of dependent panel steps and the barriers between them.  The
// kernel before this one ran the whole block on one SM of 132 (3.4 ms at
// b = 512).  This one spreads it over a cluster (__cluster_dims__, no new
// build flag): 8 blocks of 256 threads on 8 SMs of one GPC, which read
// each other's shared memory (DSMEM) and meet at hardware cluster
// barriers.
//
//   * Storage: the equilibrated lower triangle, by 32-row block-rows, in
//     the shared memory of the block-rows' owners (block-row i holds
//     i + 1 blocks of 32 x 32 doubles at row stride 33).  The owners come
//     from the wrapper's table (gp/cholinv.py cluster_plan), balanced by
//     area: 17 blocks a CTA at b = 512 (~140 KB), beside 9 staging blocks.
//     Each owner reads its rows from device memory once.
//   * Cholesky, right-looking by 32-column panels p, two cluster barriers
//     a step: (A) the owner of block-row p has factored the diagonal
//     block (one warp) and written its inverse Tp to a device scratch;
//     (B) every owner forms its panel blocks L[i][p] = A[i][p] Tp^T, a
//     product rather than a 32-step substitution; (C) barrier; (D) every
//     owner stages the panel blocks L[j][p] it needs from their owners'
//     shared memory, in batches of 9, and applies the rank-32 update to
//     its own blocks (i, j), p < j <= i; the owner of block-row p + 1,
//     whose only block there is the diagonal one, then factors it.
//   * Inverse, column-parallel, with no barrier between blocks: each
//     owner first turns its blocks into M[i][k] = -T_i L[i][k] (k < i),
//     then after one cluster barrier each CTA solves its own 32-column
//     blocks of X (the wrapper's column table, balanced by their cost,
//     (b - 32j)^2): X[j][j] = T_j, X[i][j] = sum_{k=j}^{i-1} M[i][k]
//     X[k][j], reading M over DSMEM and its earlier X blocks back from
//     device memory, the sum split over the 4 thread groups and added.
//   * Products: plain f64 FMA, each of the 4 groups of 64 threads on one
//     32 x 32 block at a time, a 4 x 4 register tile a thread (8 shared
//     loads per 16 FMAs, no bank conflict), chosen over f64 mma.sync
//     (DMMA, twice the peak rate) for a first cluster version whose
//     arithmetic is plain to check; the trace below says where DMMA
//     would pay.
//
// Where the time goes at b = 512 (a phase trace, PERF.md): about two
// thirds in the 16 factorisation steps, each bounded by the trailing
// update of the CTA holding block-row 15 (four rounds of 32 x 32 x 32
// products early on) and by the diagonal factor's chain of 32 dependent
// pivots (shuffle, f64 rsqrt, shuffle, FMA); a third in the inverse,
// bounded by column block 0's chain of 15 dependent block-rows.  The next
// steps are DMMA products, factoring block p + 1 ahead of the rest of the
// update (lookahead), and finer column blocks for the inverse.
//
// Nothing is read or written after a CTA leaves: the last cluster barrier
// keeps every CTA's shared memory alive until all are done with it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 32;        // block edge
constexpr int PS = NB + 1;    // padded row stride in shared memory
constexpr int BLK = NB * PS;  // doubles of one block in shared memory
constexpr int CL = 8;         // thread blocks of the cluster
constexpr int NT = 256;       // threads: 4 groups of 64
constexpr int MAXB = 512;
constexpr int MAXNB = MAXB / NB;
constexpr int NSLOT = 9;      // staging blocks
constexpr int SMEM_MAX = 232448 - 128;  // dynamic, beside the static bytes

struct Plan {
  int nb;
  int own_blocks;               // blocks of the largest owner's rows
  int row_owner[MAXNB];
  int row_slot[MAXNB];          // first block of block-row i in its owner
  int col_owner[MAXNB];
};

__device__ __forceinline__ double pow2_sqrt_scale(double v) {
  float f = __double2float_rn(v);
  if (!isnan(f)) f = fmaxf(f, 1e-30f);
  const int e = static_cast<int>((__float_as_uint(f) >> 23) & 0xFF) - 127;
  const int eh = min(max((e + 1) >> 1, -60), 60);
  return static_cast<double>(
      __uint_as_float(static_cast<unsigned>(eh + 127) << 23));
}

// A thread's 4 x 4 register tile of a 32 x 32 block: rows tr + 8x,
// columns tc + 8y.
__device__ __forceinline__ void zero(double (&acc)[4][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.0;
}

// acc += A B^T (A, B at stride PS)
__device__ __forceinline__ void mm_nt(double (&acc)[4][4],
                                      const double* __restrict__ A,
                                      const double* __restrict__ B, int tr,
                                      int tc) {
#pragma unroll 4
  for (int k = 0; k < NB; ++k) {
    double a[4], bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = A[(tr + 8 * q) * PS + k];
      bb[q] = B[(tc + 8 * q) * PS + k];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = fma(a[x], bb[y], acc[x][y]);
  }
}

// acc += A B (A, B at stride PS)
__device__ __forceinline__ void mm_nn(double (&acc)[4][4],
                                      const double* __restrict__ A,
                                      const double* __restrict__ B, int tr,
                                      int tc) {
#pragma unroll 4
  for (int k = 0; k < NB; ++k) {
    double a[4], bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = A[(tr + 8 * q) * PS + k];
      bb[q] = B[k * PS + tc + 8 * q];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = fma(a[x], bb[y], acc[x][y]);
  }
}

// C = s * acc (s = 1 or -1), or C -= acc with sub
template <bool SUB>
__device__ __forceinline__ void put(double* C, const double (&acc)[4][4],
                                    int tr, int tc, double s = 1.0) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      double* c = C + (tr + 8 * x) * PS + tc + 8 * y;
      if (SUB)
        *c -= acc[x][y];
      else
        *c = s * acc[x][y];
    }
}

// dst (shared, stride PS) = the 32 x 32 block at src (row stride ss), by
// the whole CTA.  GLOBAL: src is device memory written during this launch,
// read from L2 (no stale L1 line); else shared memory of this CTA or a
// peer's (DSMEM).
template <bool GLOBAL>
__device__ __forceinline__ void copy_block(double* __restrict__ dst,
                                           const double* __restrict__ src,
                                           int ss) {
  constexpr int PER = NB * NB / NT;
  double v[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * NT;
    if constexpr (GLOBAL)
      v[q] = __ldcg(src + (e >> 5) * ss + (e & 31));
    else
      v[q] = src[(e >> 5) * ss + (e & 31)];
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * NT;
    dst[(e >> 5) * PS + (e & 31)] = v[q];
  }
}

// Warp 0: the 32 x 32 block P (stride PS) factored in place (its lower
// triangle), then its inverse T = P^-1 written to tg (32 x 32, exact zeros
// above the diagonal).  Both in registers, every loop unrolled: the factor
// with lane = row (column jj of the rows below reaches lane r by shuffles;
// the pivot's reciprocal square root once per column), the inverse by
// forward substitution on the identity with lane = column (the factor's
// entries are broadcast reads of shared memory, the pivots' reciprocal
// square roots shuffles), so no step waits on a shared-memory round trip
// of its own.
__device__ void factor_diag(double* __restrict__ P, double* __restrict__ tg) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  double a[NB];
  double rd = 0.0;  // 1 / L[lane][lane]
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = P[lane * PS + c];
#pragma unroll
  for (int jj = 0; jj < NB; ++jj) {
    const double djj = __shfl_sync(FULL, a[jj], jj);
    const double rs = rsqrt(djj);
    if (lane == jj) {
      a[jj] = djj * rs;
      rd = rs;
    } else if (lane > jj) {
      a[jj] *= rs;
    }
#pragma unroll
    for (int c = jj + 1; c < NB; ++c) {
      const double lc = __shfl_sync(FULL, a[jj], c);
      if (lane >= c) a[c] = fma(-a[jj], lc, a[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c <= lane) P[lane * PS + c] = a[c];
  __syncwarp();
  double x[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) x[r] = r == lane ? 1.0 : 0.0;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const double xq = x[q] * __shfl_sync(FULL, rd, q);
    x[q] = xq;
#pragma unroll
    for (int r = q + 1; r < NB; ++r) x[r] = fma(-P[r * PS + q], xq, x[r]);
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) tg[r * NB + lane] = x[r];
}

// One cluster per block of the batch: cluster blockIdx.y factors the block
// at A + blockIdx.y * sa and writes its L, X, dinv scratch and ok at the
// same batch index (a batch of one is the single launch).
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
    cholinv_cluster_kernel(const double* __restrict__ A, int lda,
                           long long sa, double* __restrict__ Lo,
                           double* __restrict__ Xo,
                           double* __restrict__ dinv,
                           unsigned char* __restrict__ ok,
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
  __shared__ int mine[MAXNB];
  __shared__ int nmine;
  __shared__ int cta_bad;
  const int tid = threadIdx.x;
  const int g = tid >> 6;  // group of 64 threads
  const int tr = (tid & 63) >> 3, tc = tid & 7;
  const int nb = plan.nb;
  auto blk = [&](int i, int j) { return own + (plan.row_slot[i] + j) * BLK; };
  auto peer = [&](int i, int j) {
    return cluster.map_shared_rank(sm + (plan.row_slot[i] + j) * BLK,
                                   plan.row_owner[i]);
  };

  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < nb; ++i)
      if (plan.row_owner[i] == me) mine[n++] = i;
    nmine = n;
  }
  for (int r = tid; r < b; r += NT)
    dsc[r] = pow2_sqrt_scale(A[static_cast<size_t>(r) * lda + r]);
  __syncthreads();
  const int nm = nmine;
  for (int q = 0; q < nm; ++q) {
    const int i = mine[q];
    const int w = NB * (i + 1);
    for (int e = tid; e < NB * w; e += NT) {
      const int rr = e / w, c = e - rr * w;
      const int row = NB * i + rr;
      blk(i, c >> 5)[rr * PS + (c & 31)] =
          A[static_cast<size_t>(row) * lda + c] / dsc[row] / dsc[c];
    }
  }
  __syncthreads();
  if (plan.row_owner[0] == me && tid < 32) factor_diag(blk(0, 0), dinv);

  // ---- Cholesky ------------------------------------------------------
  for (int p = 0; p < nb; ++p) {
    cluster.sync();  // (A) block (p, p) factored, T_p in dinv
    int first = 0;   // my block-rows below p: mine[first..nm)
    while (first < nm && mine[first] <= p) ++first;
    const int nrow = nm - first;
    if (nrow > 0) {  // (B) L[i][p] = A[i][p] T_p^T
      copy_block<true>(slot, dinv + p * NB * NB, NB);
      __syncthreads();
      for (int t0 = 0; t0 < nrow; t0 += 4) {
        const int t = t0 + g;
        double acc[4][4];
        zero(acc);
        if (t < nrow) mm_nt(acc, blk(mine[first + t], p), slot, tr, tc);
        __syncthreads();
        if (t < nrow) put<false>(blk(mine[first + t], p), acc, tr, tc);
        __syncthreads();
      }
    }
    cluster.sync();  // (C) panel column p complete in every CTA
    if (nrow > 0) {  // (D) A[i][j] -= L[i][p] L[j][p]^T, p < j <= i
      const int jmax = mine[nm - 1];
      for (int j0 = p + 1; j0 <= jmax; j0 += NSLOT) {
        const int j1 = min(j0 + NSLOT, jmax + 1);
        for (int j = j0; j < j1; ++j)
          copy_block<false>(slot + (j - j0) * BLK, peer(j, p), PS);
        __syncthreads();
        int ntask = 0;
        for (int q = first; q < nm; ++q)
          ntask += max(0, min(j1, mine[q] + 1) - j0);
        for (int t = g; t < ntask; t += 4) {
          int i = 0, j = 0, rem = t;
          for (int q = first; q < nm; ++q) {
            const int cnt = max(0, min(j1, mine[q] + 1) - j0);
            if (rem < cnt) {
              i = mine[q];
              j = j0 + rem;
              break;
            }
            rem -= cnt;
          }
          double acc[4][4];
          zero(acc);
          mm_nt(acc, blk(i, p), slot + (j - j0) * BLK, tr, tc);
          put<true>(blk(i, j), acc, tr, tc);
        }
        __syncthreads();
      }
    }
    if (p + 1 < nb && plan.row_owner[p + 1] == me && tid < 32)
      factor_diag(blk(p + 1, p + 1), dinv + (p + 1) * NB * NB);
  }

  // ---- L out (L = Ls d), and the ok checks on Ls ------------------------
  int bad = 0;
  for (int q = 0; q < nm; ++q) {
    const int i = mine[q];
    for (int e = tid; e < NB * b; e += NT) {
      const int rr = e / b, c = e - rr * b;
      const int row = NB * i + rr;
      double v = 0.0;
      if (c <= row) {
        v = blk(i, c >> 5)[rr * PS + (c & 31)];
        if (!isfinite(v) || (c == row && !(v > 1e-6))) bad = 1;
        v *= dsc[row];
      }
      Lo[static_cast<size_t>(row) * b + c] = v;
    }
  }
  // ---- M[i][k] = -T_i L[i][k], k < i, in place --------------------------
  for (int q = 0; q < nm; ++q) {
    const int i = mine[q];
    __syncthreads();  // the L rows are written; the slot is free
    copy_block<true>(slot, dinv + i * NB * NB, NB);
    __syncthreads();
    for (int k0 = 0; k0 < i; k0 += 4) {
      const int k = k0 + g;
      double acc[4][4];
      zero(acc);
      if (k < i) mm_nn(acc, slot, blk(i, k), tr, tc);
      __syncthreads();
      if (k < i) put<false>(blk(i, k), acc, tr, tc, -1.0);
      __syncthreads();
    }
  }
  cluster.sync();  // M complete in every CTA

  // ---- X = Ls^-1 / d, by 32-column blocks -------------------------------
  for (int jb = 0; jb < nb; ++jb) {
    if (plan.col_owner[jb] != me) continue;
    const int c0 = NB * jb;
    for (int e = tid; e < c0 * NB; e += NT)
      Xo[static_cast<size_t>(e >> 5) * b + c0 + (e & 31)] = 0.0;
    for (int e = tid; e < NB * NB; e += NT) {
      const int r = e >> 5, c = e & 31;
      const double v = __ldcg(dinv + jb * NB * NB + e) * (1.0 / dsc[c0 + c]);
      if (!isfinite(v)) bad = 1;
      Xo[static_cast<size_t>(c0 + r) * b + c0 + c] = v;
    }
    __syncthreads();
    for (int i = jb + 1; i < nb; ++i) {
      double acc[4][4];
      zero(acc);
      for (int k0 = jb; k0 < i; k0 += 4) {
        const int kn = min(4, i - k0);
        for (int u = 0; u < kn; ++u) {
          copy_block<false>(slot + u * BLK, peer(i, k0 + u), PS);
          copy_block<true>(slot + (4 + u) * BLK,
                           Xo + static_cast<size_t>(NB * (k0 + u)) * b + c0,
                           b);
        }
        __syncthreads();
        if (g < kn) mm_nn(acc, slot + g * BLK, slot + (4 + g) * BLK, tr, tc);
        __syncthreads();
      }
      put<false>(slot + g * BLK, acc, tr, tc);  // the 4 groups' partial sums
      __syncthreads();
      for (int e = tid; e < NB * NB; e += NT) {
        const int o = (e >> 5) * PS + (e & 31);
        const double v = ((slot[o] + slot[BLK + o]) + slot[2 * BLK + o]) +
                         slot[3 * BLK + o];
        if (!isfinite(v)) bad = 1;
        Xo[static_cast<size_t>(NB * i + (e >> 5)) * b + c0 + (e & 31)] = v;
      }
      __syncthreads();
    }
  }

  bad = __syncthreads_or(bad);
  if (tid == 0) cta_bad = bad;
  cluster.sync();
  if (me == 0 && tid == 0) {
    int any = 0;
    for (int r = 0; r < CL; ++r) any |= *cluster.map_shared_rank(&cta_bad, r);
    *ok = any ? 0 : 1;
  }
  cluster.sync();  // keep every CTA's shared memory until all are done
}

// The plan of a b-block from the wrapper's table (row owners of the nb
// block-rows, then column-block owners, MAXNB entries each) and the
// dynamic shared memory it needs; false when the table or b is invalid.
bool make_plan(int b, const int* table, Plan* plan, int* smem) {
  if (b <= 0 || b > MAXB || b % NB || table == nullptr) return false;
  const int nb = b / NB;
  int used[CL] = {};
  plan->nb = nb;
  for (int i = 0; i < MAXNB; ++i) {
    plan->row_owner[i] = plan->row_slot[i] = plan->col_owner[i] = 0;
    if (i >= nb) continue;
    const int ro = table[i], co = table[MAXNB + i];
    if (ro < 0 || ro >= CL || co < 0 || co >= CL) return false;
    plan->row_owner[i] = ro;
    plan->row_slot[i] = used[ro];
    used[ro] += i + 1;
    plan->col_owner[i] = co;
  }
  int most = 0;
  for (int c = 0; c < CL; ++c) most = used[c] > most ? used[c] : most;
  plan->own_blocks = most;
  const size_t bytes =
      (static_cast<size_t>(most + NSLOT) * BLK + b) * sizeof(double);
  if (bytes > static_cast<size_t>(SMEM_MAX)) return false;
  *smem = static_cast<int>(bytes);
  return true;
}

}  // namespace

// A batch of nbatch blocks in one launch of nbatch clusters (the grid's y):
// block i at A + i * sa (b, b) at row stride lda (lower triangle and
// diagonal read), L, X: (nbatch, b, b) f64 outputs (contiguous), dinv:
// (nbatch, b / 32, 32, 32) f64 scratch (the diagonal blocks' inverses), ok:
// nbatch bytes (a torch.bool each).  table: the owners of the block-rows
// and of the 32-column blocks, 16 ints each (gp/cholinv.py cluster_plan).
// b <= 512, b % 32 == 0, 1 <= nbatch <= 65535.  Every cluster computes
// exactly what a launch of one would.  Returns the launch's cudaError_t.
extern "C" int chol_inv_blocks(const void* A, int lda, long long sa,
                               void* L, void* X, void* dinv, void* ok, int b,
                               int nbatch, const int* table, void* stream) {
  Plan plan;
  int smem = 0;
  if (lda < b || nbatch < 1 || nbatch > 65535 ||
      (nbatch > 1 && sa < static_cast<long long>(lda) * (b - 1) + b) ||
      !make_plan(b, table, &plan, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cholinv_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cholinv_cluster_kernel<<<dim3(CL, nbatch), NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), lda, sa, static_cast<double*>(L),
      static_cast<double*>(X), static_cast<double*>(dinv),
      static_cast<unsigned char*>(ok), b, plan);
  return static_cast<int>(cudaGetLastError());
}

// One block: chol_inv_blocks with a batch of one.  A: (b, b) at row stride
// lda, L, X: (b, b) contiguous, dinv: (b / 32, 32, 32), ok: one byte.
extern "C" int chol_inv_block(const void* A, int lda, void* L, void* X,
                              void* dinv, void* ok, int b, const int* table,
                              void* stream) {
  return chol_inv_blocks(A, lda, 0, L, X, dinv, ok, b, 1, table, stream);
}

// info[0]: thread blocks of the cluster, info[1]: dynamic shared memory
// per block in bytes, for a b-block under the table.  Returns 0, or
// cudaErrorInvalidValue.
extern "C" int chol_inv_info(int b, const int* table, int* info) {
  Plan plan;
  int smem = 0;
  if (!make_plan(b, table, &plan, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  info[0] = CL;
  info[1] = smem;
  return 0;
}
