// Device code of the one integer-Ozaki slice kernel that still runs the
// WMMA tile, K6 (slicemm.cu's syrk_tn_lower_kernel): the 64x64 output tile
// product of int8 mantissa slices on Hopper's int8 tensor cores.  K1, K2,
// K4, K7, K8, K10 and K12 run hopper_tile.cuh's wgmma tile instead; K6
// moves to it in its own redesign.
//
// One 256-thread block owns a 64x64 output tile.  For every 32-deep k
// chunk it stages all NS slices of both operands in shared memory once
// and issues every slice-pair product (i + j < NS: 21 pairs at NS = 6, 36
// at NS = 8) as WMMA m16n16k16 s8 x s8 -> s32, accumulating EXACTLY in
// int32, one accumulator set per order group s = i + j (int32 is exact
// up to k * 127^2 * NS < 2^31, i.e. k <= 2^14 at NS = 8).  The combine
// adds the groups in native f64, sum_s G_s 2^-7(s+2) in ascending s (each
// term exact, the order of the plain PyTorch versions, so kernels and
// plain versions agree bit for bit).
//
// Operand layout: A is (NS, rows, kp) row-major; the second operand is
// given TRANSPOSED, Bt (NS, rows, kp) row-major, which is exactly the
// column-major B that WMMA's matrix_b reads.

#pragma once

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace ozaki {

using namespace nvcuda;

constexpr int BM = 64;          // output tile rows (and cols)
constexpr int BK = 32;          // k chunk staged per pass
constexpr int NTHREADS = 256;   // 8 warps: 4 rows of 16 x 2 cols of 32
constexpr int TILE = 256;       // grain of the skip contracts
constexpr int PER_THREAD = BM * BM / NTHREADS;  // 16 outputs per thread
constexpr int MAX_K = 1 << 14;  // exact int32 depth of the group sums

__device__ __forceinline__ double group_weight(int s) {
  // exact 2^-7(s+2) from the exponent bits
  return __longlong_as_double(static_cast<long long>(1023 - 7 * (s + 2))
                              << 52);
}

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// The block's shared memory: the operand stage [2][NS][BK / 16][BM][16]
// bytes, reused as the int32 epilogue tile once a k loop is done.  A
// function-scope __shared__ array is one allocation per block, whichever
// path of a kernel asks for it.
template <int NS>
__device__ __forceinline__ int8_t* tile_smem() {
  constexpr int STAGE = 2 * NS * (BK / 16) * BM * 16;
  constexpr int EPI = BM * BM * 4;
  __shared__ __align__(128) int8_t smem[STAGE > EPI ? STAGE : EPI];
  return smem;
}

// Accumulates the slice-pair products of one 64x64 tile over k in
// [k_begin, k_end) (multiples of BK; kp is the operands' row length)
// into zeroed int32 group accumulators acc[s = i + j].
template <int NS>
__device__ __forceinline__ void tile_accumulate(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    size_t a_plane, size_t b_plane, int kp, int row0, int col0,
    int k_begin, int k_end, int8_t* smem, AccFrag (&acc)[NS][2]) {
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1;  // 16-row strip
  const int wc = warp & 1;   // 32-col strip
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 2; ++c) wmma::fill_fragment(acc[s][c], 0);

  constexpr int VEC_SLICE = BM * BK / 16;  // int4 loads per slice tile
  constexpr int VEC_OP = NS * VEC_SLICE;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int v = threadIdx.x; v < 2 * VEC_OP; v += NTHREADS) {
      const int op = v / VEC_OP;
      const int rem = v - op * VEC_OP;
      const int i = rem / VEC_SLICE;
      const int q = rem - i * VEC_SLICE;
      const int r = q >> 1;
      const int kh = q & 1;
      int4* dst = reinterpret_cast<int4*>(
          smem + ((((op * NS + i) * 2 + kh) * BM + r) * 16));
      const int8_t* src =
          op ? bt + i * b_plane + static_cast<size_t>(col0 + r) * kp
             : a + i * a_plane + static_cast<size_t>(row0 + r) * kp;
      src += k0 + kh * 16;
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
}

// Writes group s's accumulators into the 64x64 int32 tile cs (row-major)
// and waits for the whole block.
template <int NS>
__device__ __forceinline__ void store_group(int* cs, AccFrag (&acc)[NS][2],
                                            int s) {
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1;
  const int wc = warp & 1;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    wmma::store_matrix_sync(cs + (wr * 16) * BM + wc * 32 + c * 16,
                            acc[s][c], BM, wmma::mem_row_major);
  __syncthreads();
}

// Slice-pair reduction of one 64x64 tile: out[q] receives, for output
// element e = threadIdx.x + q * NTHREADS (row e / 64, col e % 64), the
// unscaled f64 combination sum_s G_s 2^-7(s+2).
// The k loop runs from k_begin (a multiple of BK) to kp.
template <int NS>
__device__ __forceinline__ void tile_product(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    size_t a_plane, size_t b_plane, int kp, int row0, int col0,
    double (&out)[PER_THREAD], int k_begin = 0) {
  int8_t* smem = tile_smem<NS>();
  AccFrag acc[NS][2];
  tile_accumulate<NS>(a, bt, a_plane, b_plane, kp, row0, col0, k_begin, kp,
                      smem, acc);
  int* cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) out[q] = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    store_group<NS>(cs, acc, s);
    const double w = group_weight(s);
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
      out[q] += static_cast<double>(cs[threadIdx.x + q * NTHREADS]) * w;
    __syncthreads();
  }
}

// tile_product for a depth kp - k_begin above kchunk, where int32 group
// sums could overflow.  The k range runs in chunks of kchunk; each
// chunk's exact int32 group sums are added, as f64 integers (exact below
// 2^53), into the tile's scratch g (NS, 64, 64); the last chunk adds the
// scratch to its own sums and combines the groups exactly as tile_product
// does.  Each group total is the same integer a single pass would hold,
// so the result equals tile_product's bit for bit.
template <int NS>
__device__ __forceinline__ void tile_product_chunked(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    size_t a_plane, size_t b_plane, int kp, int row0, int col0,
    double (&out)[PER_THREAD], int k_begin, int kchunk,
    double* __restrict__ g) {
  int8_t* smem = tile_smem<NS>();
  int* cs = reinterpret_cast<int*>(smem);
  AccFrag acc[NS][2];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) out[q] = 0.0;
  for (int k0 = k_begin; k0 < kp; k0 += kchunk) {
    const int k1 = min(k0 + kchunk, kp);
    tile_accumulate<NS>(a, bt, a_plane, b_plane, kp, row0, col0, k0, k1,
                        smem, acc);
    const bool first = k0 == k_begin;
    const bool last = k1 == kp;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      store_group<NS>(cs, acc, s);
      double* gs = g + static_cast<size_t>(s) * BM * BM;
      const double w = group_weight(s);
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        const int e = threadIdx.x + q * NTHREADS;
        const double v = static_cast<double>(cs[e]);
        if (first)
          gs[e] = v;
        else if (!last)
          gs[e] += v;
        else
          out[q] += (gs[e] + v) * w;
      }
      __syncthreads();
    }
  }
}

}  // namespace ozaki
