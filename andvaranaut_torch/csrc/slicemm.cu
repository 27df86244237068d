// Integer-Ozaki slice products on Hopper's int8 tensor cores (K1, K2).
//
// Replaces the Pallas TPU kernels of andvaranaut_tpu/gp/pallas_slicemm.py:
//   K2  pallas_int_slice_matmul        (C = A B, 256-tile contract)
//   K1  pallas_int_slice_syrk_sub_pair (pair carry -= P P^T, in place)
//
// Both operands arrive as int8 mantissa slices with exact power-of-two
// row scales, made by plain PyTorch in the wrapper (gp/slicemm.py), as
// XLA made them outside the Pallas kernel.  A is (NS, mp, kp) row-major;
// the second operand is given TRANSPOSED, Bt (NS, np, kp) row-major,
// which is exactly the column-major B that WMMA's matrix_b reads, so K1
// reads P for both operands and needs no transposed copy.
//
// One 256-thread block owns a 64x64 output tile.  For every 32-deep k
// chunk it stages all NS slices of both operands in shared memory once
// and issues every slice-pair product (i + j < NS: 21 pairs at NS = 6, 36
// at NS = 8) as WMMA m16n16k16 s8 x s8 -> s32, accumulating EXACTLY in
// int32, one accumulator set per order group s = i + j (int32 is exact
// up to k * 127^2 * NS < 2^31, i.e. k <= 2^14 at NS = 8).  The epilogue
// combines the groups in native f64, C = sum_s G_s 2^-7(s+2) in ascending
// s (each term exact, the same order as the plain version, so kernel
// and plain version agree bit for bit), and applies the row and column
// scales.  The TPU kernel combined in an f32 pair because Pallas has no
// f64; the f64 combine here is at least as accurate.
//
// What bounds it: int8 tensor-core operations.  At the factorisation's
// shapes (k = 1024) a tile does 21 * 64 * 64 * 1024 * 2 = 176 M int8 ops
// per 12 * 64 KB of slice traffic, far above the card's ops-per-byte
// ridge; the register file holds NS group accumulators (NS * 16 int32
// per thread), which is what limits the tile to 64x64 and the block to
// one resident per SM.  No double buffering yet and WMMA rather than
// wgmma: both are the next steps towards the tensor-core bound.
//
// Skip predicates are evaluated on the JAX contract's 256-tile grain;
// a 64-tile lies inside exactly one 256-tile.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;          // output tile rows (and cols)
constexpr int BK = 32;          // k chunk staged per pass
constexpr int NTHREADS = 256;   // 8 warps: 4 rows of 16 x 2 cols of 32
constexpr int TILE = 256;       // grain of the skip contract
constexpr int PER_THREAD = BM * BM / NTHREADS;  // 16 outputs per thread

__device__ __forceinline__ double group_weight(int s) {
  // exact 2^-7(s+2) from the exponent bits
  return __longlong_as_double(static_cast<long long>(1023 - 7 * (s + 2))
                              << 52);
}

// Slice-pair reduction of one 64x64 tile: out[q] receives, for output
// element e = threadIdx.x + q * NTHREADS (row e / 64, col e % 64), the
// unscaled f64 combination sum_s G_s 2^-7(s+2).
template <int NS>
__device__ __forceinline__ void tile_product(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    size_t a_plane, size_t b_plane, int kp, int row0, int col0,
    double (&out)[PER_THREAD]) {
  // operand stage [2][NS][BK / 16][BM][16] bytes; reused as the int32
  // epilogue tile once the k loop is done
  constexpr int STAGE = 2 * NS * (BK / 16) * BM * 16;
  constexpr int EPI = BM * BM * 4;
  __shared__ __align__(128) int8_t smem[STAGE > EPI ? STAGE : EPI];

  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1;  // 16-row strip
  const int wc = warp & 1;   // 32-col strip

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NS][2];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 2; ++c) wmma::fill_fragment(acc[s][c], 0);

  constexpr int VEC_SLICE = BM * BK / 16;  // int4 loads per slice tile
  constexpr int VEC_OP = NS * VEC_SLICE;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    for (int v = threadIdx.x; v < 2 * VEC_OP; v += NTHREADS) {
      const int op = v / VEC_OP;
      const int rem = v - op * VEC_OP;
      const int i = rem / VEC_SLICE;
      const int q = rem - i * VEC_SLICE;
      const int r = q >> 1;
      const int kh = q & 1;
      const int8_t* src =
          op ? bt + i * b_plane + static_cast<size_t>(col0 + r) * kp
             : a + i * a_plane + static_cast<size_t>(row0 + r) * kp;
      src += k0 + kh * 16;
      int4* dst = reinterpret_cast<int4*>(
          smem + ((((op * NS + i) * 2 + kh) * BM + r) * 16));
      *dst = *reinterpret_cast<const int4*>(src);
    }
    __syncthreads();
#pragma unroll
    for (int kh = 0; kh < BK / 16; ++kh) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major> bf[NS][2];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wmma::load_matrix_sync(
              bf[j][c],
              reinterpret_cast<const signed char*>(
                  smem + (((NS + j) * 2 + kh) * BM + wc * 32 + c * 16) * 16),
              16);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> af;
        wmma::load_matrix_sync(
            af,
            reinterpret_cast<const signed char*>(
                smem + ((i * 2 + kh) * BM + wr * 16) * 16),
            16);
#pragma unroll
        for (int j = 0; j < NS - i; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            wmma::mma_sync(acc[i + j][c], af, bf[j][c], acc[i + j][c]);
      }
    }
    __syncthreads();
  }

  int* cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) out[q] = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
      wmma::store_matrix_sync(cs + (wr * 16) * BM + wc * 32 + c * 16,
                              acc[s][c], BM, wmma::mem_row_major);
    __syncthreads();
    const double w = group_weight(s);
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
      out[q] += static_cast<double>(cs[threadIdx.x + q * NTHREADS]) * w;
    __syncthreads();
  }
}

// K2: C (m, n) f64 = (A B) * sa[row] * sb[col] on live tiles, exact
// zeros elsewhere.  The rows given start at global row row_offset (a
// multiple of 256); the skip predicates read global tile indices.
template <int NS>
__global__ void __launch_bounds__(NTHREADS) slice_matmul_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    const double* __restrict__ sa, const double* __restrict__ sb,
    double* __restrict__ C, int m, int n, int kp, size_t a_plane,
    size_t b_plane, int lower_only, int row_start, int col_start,
    int col_end, int row_offset) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BM;
  const int ti = (row_offset + row0) / TILE;
  const int tj = col0 / TILE;
  const bool active = (ti + 1) * TILE > row_start &&
                      (tj + 1) * TILE > col_start && tj * TILE < col_end &&
                      (!lower_only || ti >= tj);
  if (!active) {
    for (int q = 0; q < PER_THREAD; ++q) {
      const int e = threadIdx.x + q * NTHREADS;
      const int r = row0 + e / BM;
      const int c = col0 + e % BM;
      if (r < m && c < n) C[static_cast<size_t>(r) * n + c] = 0.0;
    }
    return;
  }
  double out[PER_THREAD];
  tile_product<NS>(a, bt, a_plane, b_plane, kp, row0, col0, out);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = threadIdx.x + q * NTHREADS;
    const int r = row0 + e / BM;
    const int c = col0 + e % BM;
    if (r < m && c < n)
      C[static_cast<size_t>(r) * n + c] = out[q] * (sa[r] * sb[c]);
  }
}

// K1: (hi, lo) -= P P^T on the lower 256-tiles whose tile column is at or
// right of c0 (a multiple of 256).  p and sa hold the panel rows from c0
// on; the grid covers the (m - c0)^2 trailing square and strictly-upper
// 256-tiles exit at once, so every element outside the live region is
// left bit-identical.  Diagonal 256-tiles are updated whole, upper half
// included, as the TPU kernel does.  The carry is read as the exact f64
// sum hi + lo, the scaled product subtracted in f64, and the result
// split back into a proper f32 pair in place.
template <int NS>
__global__ void __launch_bounds__(NTHREADS) syrk_sub_pair_kernel(
    const int8_t* __restrict__ p, const double* __restrict__ sa,
    float* __restrict__ hi, float* __restrict__ lo, int m, int kp,
    size_t plane, int c0) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BM;
  if (row0 / TILE < col0 / TILE) return;
  double out[PER_THREAD];
  tile_product<NS>(p, p, plane, plane, kp, row0, col0, out);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = threadIdx.x + q * NTHREADS;
    const int r = row0 + e / BM;
    const int c = col0 + e % BM;
    const size_t idx = static_cast<size_t>(c0 + r) * m + (c0 + c);
    const double v = (static_cast<double>(hi[idx]) +
                      static_cast<double>(lo[idx])) -
                     out[q] * (sa[r] * sa[c]);
    const float h = static_cast<float>(v);
    hi[idx] = h;
    lo[idx] = static_cast<float>(v - static_cast<double>(h));
  }
}

}  // namespace

// C = A B for the rows of A from global row row_offset on (a multiple of
// 256).  a: (ns, mp, kp) int8, bt: (ns, np, kp) int8 (B transposed),
// sa: (m,) f64, sb: (n,) f64, C: (m, n) f64, all starting at row_offset.
// mp, np multiples of 64, kp a multiple of 32 and at most 2^14, m <= mp,
// n <= np.  Returns cudaGetLastError().
extern "C" int slice_matmul(const void* a, const void* bt, const void* sa,
                            const void* sb, void* C, int m, int n, int kp,
                            int mp, int np, int ns, int lower_only,
                            int row_start, int col_start, int col_end,
                            int row_offset, void* stream) {
  if (mp % BM || np % BM || kp % BK || kp > (1 << 14) || m > mp ||
      n > np || row_offset % TILE || mp == 0 || np == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(np / BM, mp / BM);
  const size_t ap = static_cast<size_t>(mp) * kp;
  const size_t bp = static_cast<size_t>(np) * kp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(bt);
  const double* SA = static_cast<const double*>(sa);
  const double* SB = static_cast<const double*>(sb);
  double* Cd = static_cast<double*>(C);
  if (ns == 6)
    slice_matmul_kernel<6><<<grid, NTHREADS, 0, st>>>(
        A, B, SA, SB, Cd, m, n, kp, ap, bp, lower_only, row_start,
        col_start, col_end, row_offset);
  else if (ns == 8)
    slice_matmul_kernel<8><<<grid, NTHREADS, 0, st>>>(
        A, B, SA, SB, Cd, m, n, kp, ap, bp, lower_only, row_start,
        col_start, col_end, row_offset);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// (hi, lo) -= P P^T in place.  p: (6, m - c0, kp) int8 slices of the
// panel rows from c0 on, sa: (m - c0,) f64 row scales of those rows,
// hi/lo: (m, m) f32.  m a multiple of 256, kp a multiple of 32 and at
// most 2^14, c0 = the first live column (row_start rounded down to 256),
// c0 < m.
extern "C" int syrk_sub_pair(const void* p, const void* sa, void* hi,
                             void* lo, int m, int kp, int c0,
                             void* stream) {
  if (m % TILE || kp % BK || kp > (1 << 14) || c0 % TILE || c0 < 0 ||
      c0 >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = (m - c0) / BM;
  const dim3 grid(t, t);
  const size_t plane = static_cast<size_t>(m - c0) * kp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* P = static_cast<const int8_t*>(p);
  const double* SA = static_cast<const double*>(sa);
  float* H = static_cast<float*>(hi);
  float* L = static_cast<float*>(lo);
  syrk_sub_pair_kernel<6><<<grid, NTHREADS, 0, st>>>(P, SA, H, L, m, kp,
                                                     plane, c0);
  return static_cast<int>(cudaGetLastError());
}
