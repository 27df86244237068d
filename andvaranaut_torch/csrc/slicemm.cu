// Integer-Ozaki slice products on Hopper's int8 tensor cores (K1, K2, K4,
// K6; K7 launches K6's kernel).
//
// Replaces the Pallas TPU kernels of andvaranaut_tpu/gp/pallas_slicemm.py:
//   K2  pallas_int_slice_matmul        (C = A B, 256-tile contract)
//   K1  pallas_int_slice_syrk_sub_pair (pair carry -= P P^T, in place)
//   K4  pallas_int_slice_mm_sub_pair   (pair carry -= A B, in place, on
//                                       rows >= row_start, cols < col_end)
//   K6  pallas_int_slice_syrk_tn_lower_presliced (C = W^T W, lower tiles,
//                                       from pre-made slices)
//   K7  pallas_int_slice_syrk_tn_lower (the same, W sliced in the wrapper)
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
//
// K4 and K6 reuse the same tile product.  K4 is K1's rectangular
// sibling: the grid covers only the live rectangle (rows from row_start,
// columns below col_end), so everything else is never touched.  K6 reads
// W's slices in W^T layout for both operands (plane[s][i][k] = slice of
// W[k, i], written that way by panel.cu's K5), exactly the row-major
// operand tile_product reads for A and Bt, so no transposed copy exists;
// with w_lower its k loop starts at the tile's first row or column index,
// since W[k, i] = 0 for k < i makes the skipped chunks exact zeros.  Both
// are bound by int8 tensor-core operations like K1.  K6 runs at 8 slices
// (36 pair products, int32 still exact at k = 2^14: 8 * 2^14 * 127^2 <
// 2^31), where the reference ran 6: see TN_NSLICES in gp/slicemm.py for
// the measured gradient grade.  K6's lower-tile work
// is uneven (a tile near the top row does the whole depth, one near the
// bottom almost none), so the heavy tiles are launched first.  A K6 tile
// deeper than 2^14 (n > 16384, e.g. a 17408-row factorisation) runs its
// k range in chunks of at most 2^14 and adds each chunk's exact group
// sums, as f64 integers, into a per-tile scratch in device memory before
// the one f64 combine: the group totals are the integers a single pass
// would hold, so the result is the same bit for bit.

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

// K4: (hi, lo) -= A B on the live rectangle: rows r0.. of the (m, n)
// carry (r0 a multiple of 256) and its first nc columns (a multiple of
// 256).  a and sa hold the slices and row scales of A's rows from r0 on;
// bt and sb those of (B / sb)^T's first nc rows.  The grid covers exactly
// the live rectangle, so every other element is left bit-identical.  The
// update is K1's: exact f64 read of hi + lo, subtraction of the scaled
// product, split back into a proper f32 pair in place.  Explicitly
// rounded operations keep the compiler from fusing the product and the
// subtraction, so the result matches the plain version bit for bit.
template <int NS>
__global__ void __launch_bounds__(NTHREADS) mm_sub_pair_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    const double* __restrict__ sa, const double* __restrict__ sb,
    float* __restrict__ hi, float* __restrict__ lo, int n, int kp,
    size_t a_plane, size_t b_plane, int r0) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BM;
  double out[PER_THREAD];
  tile_product<NS>(a, bt, a_plane, b_plane, kp, row0, col0, out);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = threadIdx.x + q * NTHREADS;
    const int r = row0 + e / BM;
    const int c = col0 + e % BM;
    const size_t idx = static_cast<size_t>(r0 + r) * n + c;
    const double prod = __dmul_rn(out[q], __dmul_rn(sa[r], sb[c]));
    const double v = __dsub_rn(
        __dadd_rn(static_cast<double>(hi[idx]), static_cast<double>(lo[idx])),
        prod);
    const float h = __double2float_rn(v);
    hi[idx] = h;
    lo[idx] = __double2float_rn(__dsub_rn(v, static_cast<double>(h)));
  }
}

// K6 (and K7): C (m, m) f64 = W^T W on lower 256-tiles from W^T-layout
// slices w (NS, mp, kp): C[i][j] = sum_k w[i][k] w[j][k] * sw[i] * sw[j].
// Strictly-upper 256-tiles are written as exact zeros.  Block x walks
// the tile columns, block y the tile rows; with w_lower a tile's k loop
// starts at max(row0, col0) (W[k, i] = 0 for k < i makes the rest exact
// zeros), and the rows are visited top first, heaviest first.  A tile
// whose depth exceeds kchunk runs tile_product_chunked with the scratch
// of 64-tile (blockIdx.y, blockIdx.x) in g, an (nd, nd, NS, 64, 64) f64
// array covering every such tile (the wrapper sizes nd).
template <int NS>
__global__ void __launch_bounds__(NTHREADS) syrk_tn_lower_kernel(
    const int8_t* __restrict__ w, const double* __restrict__ sw,
    double* __restrict__ C, int m, int kp, size_t plane, int w_lower,
    int kchunk, double* __restrict__ g, int nd) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BM;
  if (row0 / TILE < col0 / TILE) {
    for (int q = 0; q < PER_THREAD; ++q) {
      const int e = threadIdx.x + q * NTHREADS;
      const int r = row0 + e / BM;
      const int c = col0 + e % BM;
      if (r < m && c < m) C[static_cast<size_t>(r) * m + c] = 0.0;
    }
    return;
  }
  int k_begin = 0;
  if (w_lower) k_begin = min(max(row0, col0), kp);
  double out[PER_THREAD];
  if (kp - k_begin <= kchunk) {
    tile_product<NS>(w, w, plane, plane, kp, row0, col0, out, k_begin);
  } else {
    if (static_cast<int>(blockIdx.y) >= nd ||
        static_cast<int>(blockIdx.x) >= nd)
      __trap();  // the wrapper sized the scratch too small
    double* gt = g + (static_cast<size_t>(blockIdx.y) * nd + blockIdx.x) *
                         NS * BM * BM;
    tile_product_chunked<NS>(w, w, plane, plane, kp, row0, col0, out,
                             k_begin, kchunk, gt);
  }
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = threadIdx.x + q * NTHREADS;
    const int r = row0 + e / BM;
    const int c = col0 + e % BM;
    if (r < m && c < m)
      C[static_cast<size_t>(r) * m + c] =
          __dmul_rn(out[q], __dmul_rn(sw[r], sw[c]));
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

// (hi, lo) -= P P^T in place.  p: (ns, m - c0, kp) int8 slices of the
// panel rows from c0 on, sa: (m - c0,) f64 row scales of those rows,
// hi/lo: (m, m) f32.  m a multiple of 256, kp a multiple of 32 and at
// most 2^14, c0 = the first live column (row_start rounded down to 256),
// c0 < m.  ns must be 6, the count this kernel is built for.
extern "C" int syrk_sub_pair(const void* p, const void* sa, void* hi,
                             void* lo, int m, int kp, int c0, int ns,
                             void* stream) {
  if (ns != 6 || m % TILE || kp % BK || kp > (1 << 14) || c0 % TILE ||
      c0 < 0 || c0 >= m)
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

// (hi, lo) -= A B in place on rows r0.. and columns ..nc of the (m, n)
// carry.  a: (ns, m - r0, kp) int8 slices of A's rows from r0, sa: their
// (m - r0,) f64 row scales; bt: (ns, nc, kp) int8 slices of (B / sb)^T's
// first nc rows, sb: (nc,) f64 column scales of B; hi/lo: (m, n) f32.
// m, n, r0 and nc multiples of 256, r0 < m, 0 < nc <= n, kp a multiple of
// 32 and at most 2^14, ns 6 (the count this kernel is built for).  A
// call with no live tile is the caller's to skip.
extern "C" int mm_sub_pair(const void* a, const void* bt, const void* sa,
                           const void* sb, void* hi, void* lo, int m, int n,
                           int kp, int r0, int nc, int ns, void* stream) {
  if (ns != 6 || m % TILE || n % TILE || r0 % TILE || nc % TILE || r0 < 0 ||
      r0 >= m || nc <= 0 || nc > n || kp % BK || kp <= 0 ||
      kp > (1 << 14))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nc / BM, (m - r0) / BM);
  const size_t ap = static_cast<size_t>(m - r0) * kp;
  const size_t bp = static_cast<size_t>(nc) * kp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mm_sub_pair_kernel<6><<<grid, NTHREADS, 0, st>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
      static_cast<const double*>(sa), static_cast<const double*>(sb),
      static_cast<float*>(hi), static_cast<float*>(lo), n, kp, ap, bp, r0);
  return static_cast<int>(cudaGetLastError());
}

// C = W^T W on lower 256-tiles.  w: (ns, mp, kp) int8 slices in W^T
// layout (w[s][i][k] the s-th slice of W[k][i] / sw[i], zero padded),
// sw: (m,) f64 column scales, C: (m, m) f64.  mp a multiple of 64 and at
// least m, kp a multiple of 32, ns 8 (the count this kernel is built
// for).  w_lower: W[k][i] == 0 for k < i.  kchunk (a multiple of 32, at
// most 2^14, the exact int32 depth at 8 slices) bounds each tile's
// int32 pass; g: (nd, nd, 8, 64, 64) f64 scratch for the 64-tiles of
// depth above kchunk, all of which lie in the first nd tile rows and
// columns (null when nd is 0).
extern "C" int syrk_tn_lower(const void* w, const void* sw, void* C, int m,
                             int mp, int kp, int ns, int w_lower, int kchunk,
                             void* g, int nd, void* stream) {
  if (ns != 8 || mp % BM || mp < m || m <= 0 || kp % BK || kp <= 0 ||
      kchunk % BK || kchunk <= 0 || kchunk > (1 << 14) || nd < 0 ||
      nd > mp / BM || (nd > 0 && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(mp / BM, mp / BM);
  const size_t plane = static_cast<size_t>(mp) * kp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  syrk_tn_lower_kernel<8><<<grid, NTHREADS, 0, st>>>(
      static_cast<const int8_t*>(w), static_cast<const double*>(sw),
      static_cast<double*>(C), m, kp, plane, w_lower, kchunk,
      static_cast<double*>(g), nd);
  return static_cast<int>(cudaGetLastError());
}
