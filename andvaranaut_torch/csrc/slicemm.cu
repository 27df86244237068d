// Integer-Ozaki slice products on Hopper's int8 tensor cores (K1, K2, K4,
// K6, K8; K7 launches K6's kernel, K12 launches K1's).
//
// Replaces the Pallas TPU kernels of andvaranaut_tpu/gp/pallas_slicemm.py:
//   K2  pallas_int_slice_matmul        (C = A B, 256-tile contract)
//   K1  pallas_int_slice_syrk_sub_pair (pair carry -= P P^T, in place)
//   K4  pallas_int_slice_mm_sub_pair   (pair carry -= A B, in place, on
//                                       rows >= row_start, cols < col_end)
//   K6  pallas_int_slice_syrk_tn_lower_presliced (C = W^T W, lower tiles,
//                                       from pre-made slices)
//   K7  pallas_int_slice_syrk_tn_lower (the same, W sliced in the wrapper)
//   K8  pallas_int_slice_syrk_lower    (C = A A^T on lower tiles, the
//                                       f64-carry factorisation's update)
//   K12 pallas_int_slice_syrk_sub_pair_presliced (K1 on pre-made slices)
//
// The tile product itself is ozaki.cuh's, shared with panel.cu (K10).
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
//
// K8 is K1's product with a store in place of the pair subtraction: the
// f64-carry factorisation (blocks off the 256 grain) subtracts it in
// PyTorch.  Its grid is the live lower triangle of 256-tile pairs only
// (blockIdx.x -> (i, j), i >= j, of the trailing square), times the 16
// 64-tiles of a pair; each off-diagonal pair also zeroes its mirrored
// 64-tile in the strictly-upper triangle, so the output has exact zeros
// wherever no tile is computed without a separate memset of the whole
// matrix.  The operand rows need not fill the last tile (16000 rows are
// 62.5 tiles): loads past the last row read zeros in shared memory and
// stores are guarded, so no padded copy of the slices exists.  Bound by
// int8 operations like K1: 21 pair products of depth k per live lower
// entry, against 8 bytes stored per entry.

#include "ozaki.cuh"

namespace {

using namespace ozaki;

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

// K8: C = P P^T * s s^T on the live lower 256-tiles of the trailing square
// (rows and columns c0.., c0 a multiple of 256), as f64.  p: (NS, nr, kp)
// slices of P's rows from c0 (nr = m - c0), sa their (nr,) scales.
// blockIdx.x is the pair index t of the lower triangle of the trailing
// square's 256-tiles, listed row by row (pair (i, j) at t = i(i+1)/2 + j);
// blockIdx.y the 64-tile inside the pair.  a_upper: P[r][k] == 0 for k <
// r (global row and column indices), so the k loop starts at the tile's
// first row, where the skipped chunks are exact zeros.
template <int NS>
__global__ void __launch_bounds__(NTHREADS) syrk_lower_kernel(
    const int8_t* __restrict__ p, const double* __restrict__ sa,
    double* __restrict__ C, int m, int nr, int kp, size_t plane, int c0,
    int a_upper) {
  const int t = blockIdx.x;
  int i = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  const int j = t - i * (i + 1) / 2;
  const int row0 = i * TILE + (blockIdx.y >> 2) * BM;  // from c0
  const int col0 = j * TILE + (blockIdx.y & 3) * BM;
  if (row0 >= nr || col0 >= nr) return;  // past the ragged last tile
  const int k_begin = a_upper ? min(c0 + row0, kp) : 0;
  double out[PER_THREAD];
  tile_product<NS, true>(p, p, plane, plane, kp, row0, col0, out, k_begin,
                         nr, nr);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = threadIdx.x + q * NTHREADS;
    const int r = row0 + e / BM;
    const int c = col0 + e % BM;
    if (r < nr && c < nr)
      C[static_cast<size_t>(c0 + r) * m + c0 + c] =
          __dmul_rn(out[q], __dmul_rn(sa[r], sa[c]));
  }
  if (i == j) return;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = threadIdx.x + q * NTHREADS;
    const int r = col0 + e / BM;
    const int c = row0 + e % BM;
    if (r < nr && c < nr) C[static_cast<size_t>(c0 + r) * m + c0 + c] = 0.0;
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

// C = P P^T on the lower 256-tiles of the trailing square from c0, with
// exact zeros on its strictly-upper 256-tiles; C's rows and columns above
// c0 are the caller's to fill.  p: (ns, m - c0, kp) int8 slices of P's
// rows from c0, sa: their (m - c0,) f64 row scales, C: (m, m) f64.  m >
// c0 >= 0, c0 a multiple of 256, kp a multiple of 32 and at most 2^14, ns
// 6 (the count this kernel is built for).  a_upper: P[r][k] == 0 for k <
// r.  Returns cudaGetLastError().
extern "C" int syrk_lower(const void* p, const void* sa, void* C, int m,
                          int kp, int c0, int a_upper, int ns,
                          void* stream) {
  if (ns != 6 || m <= 0 || c0 < 0 || c0 >= m || c0 % TILE || kp <= 0 ||
      kp % BK || kp > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nr = m - c0;
  const int nt = (nr + TILE - 1) / TILE;
  const dim3 grid(nt * (nt + 1) / 2, (TILE / BM) * (TILE / BM));
  syrk_lower_kernel<6><<<grid, NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(p), static_cast<const double*>(sa),
      static_cast<double*>(C), m, nr, kp, static_cast<size_t>(nr) * kp, c0,
      a_upper);
  return static_cast<int>(cudaGetLastError());
}
