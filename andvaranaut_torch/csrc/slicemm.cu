// Integer-Ozaki slice products on Hopper's int8 tensor cores (K1, K2, K4,
// K6, K7, K8; K12 launches K1's kernel on K11's slices, K6 K7's kernel on
// K5's).
//
// Replaces the Pallas TPU kernels of andvaranaut_tpu/gp/pallas_slicemm.py:
//   K2  pallas_int_slice_matmul        (C = A B, 256-tile contract)
//   K1  pallas_int_slice_syrk_sub_pair (pair carry -= P P^T, in place)
//   K4  pallas_int_slice_mm_sub_pair   (pair carry -= A B, in place, on
//                                       rows >= row_start, cols < col_end)
//   K6  pallas_int_slice_syrk_tn_lower_presliced (C = W^T W, lower tiles,
//                                       from pre-made slices)
//   K7  pallas_int_slice_syrk_tn_lower (C = W^T W, lower tiles, W sliced
//                                       on the card by slicing.cu)
//   K8  pallas_int_slice_syrk_lower    (C = A A^T on lower tiles, or A
//                                       -= that in place: the f64-carry
//                                       factorisation's update)
//   K12 pallas_int_slice_syrk_sub_pair_presliced (K1 on pre-made slices)
//
// One tile product for all of them (and panel.cu's K10): hopper_tile.cuh's
// wgmma m64n64k32 from a ring of shared-memory stages that one producer
// thread fills with bulk copies, on operands that slicing.cu cut on the
// card into its tiled layout (K5's and K11's by its pair mode).  A 64x64
// output tile accumulates the slice-pair products (i + j < NS: 21 pairs at
// NS = 6, 36 at NS = 8) EXACTLY in int32, one accumulator set per order
// group s = i + j (int32 is exact up to k * 127^2 * NS < 2^31, i.e. k <=
// 2^14 at NS = 8), combines the groups in native f64, C = sum_s G_s
// 2^-7(s+2) in ascending s (each term exact, the same order as the plain
// versions, so kernels and plain versions agree bit for bit), and applies
// the row and column scales.  The TPU kernels combined in an f32 pair
// because Pallas has no f64; the f64 combine here is at least as accurate.
//
// Skip predicates are evaluated on the JAX contract's 256-tile grain;
// a 64-tile lies inside exactly one 256-tile.
//
// K4 on the wgmma tile: K1's rectangular sibling, (hi, lo) -= A B on the
// live rectangle of the identity solve's pair carry (rows from row_start,
// columns below col_end).  Its operands are strided views, L[r0:, lo:hi]
// and x_j[:, :nc]^T, sliced in place by slicing.cu (two launches each);
// the grid covers the live rectangle only, (m - r0) / 64 x nc / 64 tiles
// (128 x 128 at the 16k middle step), so nothing else is read or written;
// the blocks walk it in groups of 16 tile rows (hopper::rect_tile), so that
// a wave of 132 blocks reads ~16 row tiles of A's slices and ~8 column
// tiles of B's from L2 (by rows, a wave would stream all 50 MB of B's
// slices per tile row).
// k is the block width (1024 on the main path), inside the exact int32
// depth, so a tile runs its whole k range in one pass with all six order
// groups in registers.  What bounds it: int8 operations (21 pair products
// of depth k per live entry: 1.46 ms at the 16k middle step), then the
// carry's read-modify-write, 16 bytes per live entry (8192^2 x 16 B = 1.07
// GB, 0.32 ms at 3.35 TB/s).  The design keeps the carry out of the k loop
// (read once, in the epilogue, as float2 pairs of adjacent columns) and
// lets the wgmma ring stream the slices, so the two bounds add rather
// than interleave.
//
// K8 on the wgmma tile: P P^T on the lower 256-tiles of the trailing square
// from c0 (row_start rounded down to 256), for the f64-carry factorisation
// (blocks off the 256 grain).  One slicing launch cuts P[c0:] into the
// tiled layout, which serves as both operands (the rows of P are the rows
// of B^T); rows past m - c0 are the slicing kernel's zero padding, so the
// product reads no row guard and only stores are guarded.  The grid is the
// live 64-tiles only, those whose 256-tile row is at or below their
// 256-tile column (diagonal 256-tiles in full), walked in groups of 16
// tile rows that go down the columns left of the group and then its
// diagonal part (lower_tile), so that a wave shares slices in L2.  With
// a_upper (P[r][k] == 0 for k < r) a tile's k chunks start at c0 +
// max(row0, col0), a multiple of 64 and so of the 32-deep chunk; the
// skipped chunks are exact zeros.  k <= 2^14: one pass, all six order
// groups in registers.  Three epilogues of one kernel (template Epi):
// - store (syrk_lower, the K8 contract): C = out * (sa[r] * sa[c]) on the
//   live tiles and exact zeros everywhere else: each off-diagonal tile's
//   producer warp, once its copies are issued, zeroes the mirrored upper
//   tile while the consumers finish, and the grid's first blocks zero C's
//   rows and columns
//   above c0, one 64-row strip each, so the wrapper launches nothing else;
// - in place (syrk_sub_lower, the factorisation's step): A[r][c] -= out *
//   (sa[r] * sa[c]) for r, c >= row_start on the live tiles, the rest of A
//   untouched (where the two-step form subtracted C's exact zeros, which
//   leaves A bit-identical), so no (m, m) C exists; the tile's rows of A
//   are prefetched into L2 before the k loop, as K4's carry is.
// - pair (syrk_sub_pair, K1 and K12 below).
// Bound by int8 operations: 21 pair products of depth k per live lower
// entry (2.428 ms at 16000 x 1000, row_start 1000), against 8 bytes
// stored (16 read and written in place) per entry.
//
// K1 and K12 on the same kernel, its pair epilogue: the pair carry's
// trailing update (hi, lo) -= P P^T of every step of the pair-carry
// factorisation, on exactly K8's live set (the lower 256-tiles of the
// trailing square from c0, diagonal 256-tiles whole, upper half
// included), so K8's walk serves unchanged.  K1's wrapper cuts P[c0:] once
// (slicing.cu, both operands); K12 takes the slices that K11 cut from the
// carry's finished column block with slicing.cu's pair mode, in the same
// tiled layout, and launches the same kernel on them.  The epilogue is
// K4's: the exact f64 sum hi + lo, minus out * (sa[r] * sa[c]), split back
// into a proper f32 pair, with explicitly rounded operations, two adjacent
// columns as one float2 of each plane, every carry read issued before any
// arithmetic, and the tile's carry rows prefetched into L2 before the k
// loop; every entry of a live tile is written, as the plain version's
// (rows between c0 and row_start have a zero product and are re-split).
// What bounds it: int8 operations, 21 pair products of depth 1024 per live
// lower entry (2.606 ms at the 16k first step, 16384^2 carry, panel
// 16384 x 1024, row_start 1024), against 16 bytes of carry read and
// written per entry (0.57 ms at 3.35 TB/s over 120 M live entries).  The
// design keeps the carry out of the k loop, so the slices stream through
// the ring at the product's rate and the carry costs one pass in the
// epilogue.
//
// K2 on the wgmma tile: one 160-thread block per 64x64 output tile over
// the whole (m, n) output; tiles that the contract leaves dead (rows above
// row_start's 256-tile, and the flags) write exact zeros, so the wrapper
// launches nothing else.  Order groups: all six in registers at NS = 6,
// two passes of four at NS = 8 (the diagonal recursion's compose).
//
// K6 and K7 on one kernel: C = W^T W on lower 256-tiles from W's slices in
// W^T layout, 8 planes with W's pow2 column scales.  K7 cuts them from an
// f64 W (slicing.cu); K6 takes them made by K5 (the pair mode on the
// transposed view of the pair-carried L^-1: K^-1 = L^-T L^-1 for the MAP
// gradient).  Both run at 8 slices where the reference ran 6: see
// TN_NSLICES in gp/slicemm.py for the measured gradient grade.  With
// w_lower (W[k, i] = 0 for k < i, as L^-1) a 64-tile's depth is kp -
// max(row0, col0) and its k chunks start there; the skipped ones are exact
// zeros.  The k range of each tile, from its own first chunk, is cut into
// pieces of `dc` chunks, dc <= 2^14 / 32 so that every int32 group sum
// stays exact; only tiles deeper than dc chunks (n > 16384: the first 16
// tile rows of a 17408-row K6) have more than one piece: a tile of one
// piece combines and stores C itself; a tile of several writes each
// piece's int32 group sums into its slot, and a second kernel adds the
// slots as integers (exact, so the order does not matter) and combines.
// The wrapper takes dc at its cap: shorter pieces, to balance the uneven
// tiles over the SMs, measured slower at every m from 300 to 2048 (their
// slot traffic and the combine cost more than the deep tiles' tail).
//
// The grid is the live lower 64-tiles only, in K8's walk (lower_tile:
// groups of 16 tile rows that go down the columns left of the group, then
// its diagonal part), then the deep tiles' further pieces.  Walked by
// rows, a wave of 132 blocks shares one row tile of the first operand and
// streams 132 different row tiles of the second, which the next tile row
// reads again far beyond what L2 holds: at m = 16384 with w_lower some 92
// GB of slices, 27.5 ms at 3.35 TB/s, as long as the operations take.  In
// a group, a wave shares ~16 row tiles and ~8 column tiles, whose blocks
// stream the same k chunks nearly in step (a group's tiles start their k
// ranges at most 15 x 64 apart), so each chunk comes from device memory
// about once per wave.  With w_lower the first groups are the deepest
// tiles, so the heavy work starts first.  The strictly-upper 256-tiles are
// written as exact zeros in the same launch: each off-diagonal tile's
// producer warp, once its copies are issued, zeroes the mirrored tile
// while the consumers compute (K8's store epilogue does the same).  What
// bounds it: int8 operations, 36 pair products of depth kp - max(i, j)
// per lower entry with w_lower (27.29 ms at m = 16384), against 8 bytes
// stored per entry.
//
// K7b (syrk_tn_tiled_batched, the chains' batch at k <= 2^14) is this
// kernel with the batch on the grid's y, on the planes of slicing.cu's
// one-read batched slicing.  A kernel that sliced W in its own producer
// warpgroup (no planes in device memory) was tried and lost at every
// shape: each tile sliced its two 64-column strips again (8-16 times a
// strip), and that producer ran slower than the consumers' wgmma.  What
// bounds it at the chains' sizes: one 64-tile a block of at most 16 k
// chunks, so each block's ring fill, first wgmma and epilogue are most of
// its time (n = 256, C = 8: 80 blocks in 0.011 ms, 4.5x its bound).  Next:
// several tiles a block (a persistent grid) to overlap one tile's
// epilogue with the next tile's loads.

#include "hopper_tile.cuh"

namespace {

constexpr int TILE = 256;       // grain of the skip contracts
constexpr int MAX_K = 1 << 14;  // exact int32 depth of the group sums

// K2 (wgmma tile): C (m, n) f64 = (A B) * sa[row - r0] * sb[col] on live
// tiles, exact zeros elsewhere.  a holds the tiled slices of A's rows from
// r0 (a multiple of 256), bt those of B^T; the skip predicates read
// global 256-tile indices.
template <int NS>
__global__ void __launch_bounds__(hopper::THREADS, 1) slice_matmul_wgmma_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    const double* __restrict__ sa, const double* __restrict__ sb,
    double* __restrict__ C, int m, int n, int kp, int lower_only,
    int row_start, int col_start, int col_end, int r0) {
  using namespace hopper;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TM;
  const int ti = row0 / TILE;
  const int tj = col0 / TILE;
  const bool active = row0 >= r0 && (ti + 1) * TILE > row_start &&
                      (tj + 1) * TILE > col_start && tj * TILE < col_end &&
                      (!lower_only || ti >= tj);
  if (!active) {
    for (int e = threadIdx.x; e < TM * TM; e += THREADS) {
      const int r = row0 + e / TM;
      const int c = col0 + e % TM;
      if (r < m && c < n) C[static_cast<size_t>(r) * n + c] = 0.0;
    }
    return;
  }
  const int nkc = kp / TKC;
  const size_t tile_bytes = static_cast<size_t>(nkc) * NS * PLANE;
  double out[32];
  if (!tile_run<NS>(a + ((row0 - r0) / TM) * tile_bytes,
                    bt + blockIdx.x * tile_bytes, 0, nkc, out, nullptr))
    return;
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int r = row0 + acc_row(t, q);
    const int c = col0 + acc_col(t, q);
    if (r < m && c < n)
      C[static_cast<size_t>(r) * n + c] =
          __dmul_rn(out[q], __dmul_rn(sa[r - r0], sb[c]));
  }
}

// K4 (wgmma tile): (hi, lo) -= A B on the live rectangle of the (m, n)
// pair carry: rows r0.. (r0 a multiple of 256) and its first nc columns
// (a multiple of 256).  One block per 64-tile of that rectangle, nothing
// outside it, so every other element is left bit-identical.  a holds the
// tiled slices of A's rows from r0, bt those of B's first nc columns (the
// rows of B^T), sa and sb their scales.  The epilogue is K1's update:
// exact f64 read of hi + lo, subtraction of out * (sa[r] * sb[c]), split
// back into a proper f32 pair, with explicitly rounded operations so that
// the compiler fuses nothing and the result matches the plain version
// bit for bit.  A thread's two accumulator registers q, q + 1 are two
// adjacent columns of one row, read and written as one float2; the tile's
// carry rows are prefetched into L2 before the k loop and all of a
// thread's carry reads issued at once after it.
__global__ void __launch_bounds__(hopper::THREADS, 1) mm_sub_pair_wgmma_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    const double* __restrict__ sa, const double* __restrict__ sb,
    float* __restrict__ hi, float* __restrict__ lo, int n, int kp, int r0,
    int ntr, int ntc) {
  using namespace hopper;
  constexpr int NS = 6;
  int rt, ct;
  rect_tile(static_cast<int>(blockIdx.x), ntr, ntc, &rt, &ct);
  const int row0 = rt * TM;  // from r0
  const int col0 = ct * TM;
  const int nkc = kp / TKC;
  const size_t tile_bytes = static_cast<size_t>(nkc) * NS * PLANE;
  // the tile's carry rows (64 x 256 B of hi and of lo) into L2 now, so
  // that the epilogue's reads do not wait on device memory
  for (int e = threadIdx.x; e < TM * 4; e += THREADS) {
    const float* base = (e & 2) ? lo : hi;
    const float* ptr = base + static_cast<size_t>(r0 + row0 + (e >> 2)) * n +
                       col0 + (e & 1) * (TM / 2);
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(ptr));
  }
  double out[32];
  if (!tile_run<NS>(a + rt * tile_bytes, bt + ct * tile_bytes, 0, nkc, out,
                    nullptr))
    return;
  const int t = threadIdx.x;
  float2 hv[16], lv[16];  // every carry read issued before any arithmetic
#pragma unroll
  for (int q = 0; q < 32; q += 2) {
    const size_t idx =
        static_cast<size_t>(r0 + row0 + acc_row(t, q)) * n + col0 +
        acc_col(t, q);
    hv[q / 2] = *reinterpret_cast<const float2*>(hi + idx);
    lv[q / 2] = *reinterpret_cast<const float2*>(lo + idx);
  }
#pragma unroll
  for (int q = 0; q < 32; q += 2) {
    const int r = row0 + acc_row(t, q);
    const int c = col0 + acc_col(t, q);
    const size_t idx = static_cast<size_t>(r0 + r) * n + c;
    const float2 h = hv[q / 2];
    const float2 l = lv[q / 2];
    const double s = sa[r];
    const double v0 = __dsub_rn(
        __dadd_rn(static_cast<double>(h.x), static_cast<double>(l.x)),
        __dmul_rn(out[q], __dmul_rn(s, sb[c])));
    const double v1 = __dsub_rn(
        __dadd_rn(static_cast<double>(h.y), static_cast<double>(l.y)),
        __dmul_rn(out[q + 1], __dmul_rn(s, sb[c + 1])));
    const float2 nh = make_float2(__double2float_rn(v0), __double2float_rn(v1));
    *reinterpret_cast<float2*>(hi + idx) = nh;
    *reinterpret_cast<float2*>(lo + idx) = make_float2(
        __double2float_rn(__dsub_rn(v0, static_cast<double>(nh.x))),
        __double2float_rn(__dsub_rn(v1, static_cast<double>(nh.y))));
  }
}

// K8's walk: the 64-tile (rt, ct), rt / 4 >= ct / 4, of block b of an nt x
// nt tile square.  Groups of hopper::GROUP tile rows (a multiple of 4)
// from r0: first the r0 columns left of the group, every row of the group
// live, column by column; then the group's diagonal part, one 256-column
// (4 tile columns) q at a time, of rows r0 + 4q on.
__host__ __device__ inline int lower_group_blocks(int r0, int R) {
  int n = R * r0;
  for (int q = 0; 4 * q < R; ++q) n += min(4, R - 4 * q) * (R - 4 * q);
  return n;
}

__device__ __forceinline__ void lower_tile(int b, int nt, int* rt, int* ct) {
  int r0 = 0;
  for (;;) {
    const int R = min(hopper::GROUP, nt - r0);
    const int n = lower_group_blocks(r0, R);
    if (b >= n) {
      b -= n;
      r0 += hopper::GROUP;
      continue;
    }
    if (b < R * r0) {
      *rt = r0 + b % R;
      *ct = b / R;
      return;
    }
    b -= R * r0;
    for (int q = 0;; ++q) {
      const int rows = R - 4 * q;
      const int span = min(4, rows) * rows;
      if (b < span) {
        *rt = r0 + 4 * q + b % rows;
        *ct = r0 + 4 * q + b / rows;
        return;
      }
      b -= span;
    }
  }
}

int lower_blocks(int nt) {
  int n = 0;
  for (int r0 = 0; r0 < nt; r0 += hopper::GROUP)
    n += lower_group_blocks(r0, min(hopper::GROUP, nt - r0));
  return n;
}

// The three epilogues of the lower-tile product (syrk_lower_wgmma_kernel).
enum Epi {
  STORE,  // C = P P^T (K8)
  SUB,    // C -= P P^T in place, f64 carry (K8's in-place step)
  PAIR    // (hi, lo) -= P P^T in place, f32-pair carry (K1, K12)
};

// K8, K1 and K12 (wgmma tile) on the trailing square from c0 of an (m, m)
// matrix: p holds the tiled slices of P's rows from c0 (nt row tiles, kp
// deep), sa their (nr = m - c0,) scales.
// - STORE: C[c0 + r][c0 + c] = out * (sa[r] * sa[c]) for r, c < nr,
//   mirrored upper tiles zeroed, and the first nfill blocks zero C's rows
//   above c0 and the columns left of c0 below it.
// - SUB: C[c0 + r][c0 + c] -= out * (sa[r] * sa[c]) for r, c in [rs, nr).
// - PAIR: every entry (c0 + r, c0 + c) of the live tile of the f32-pair
//   carry (hi, lo) becomes the pair split of (hi + lo) - out * (sa[r] *
//   sa[c]) (nr a multiple of 64, so no guard).
template <int E>
__global__ void __launch_bounds__(hopper::THREADS, 1) syrk_lower_wgmma_kernel(
    const int8_t* __restrict__ p, const double* __restrict__ sa,
    double* __restrict__ C, float* __restrict__ hi, float* __restrict__ lo,
    int m, int nr, int kp, int c0, int a_upper, int rs, int nfill, int nt) {
  using namespace hopper;
  constexpr int NS = 6;
  const int t = threadIdx.x;
  int b = static_cast<int>(blockIdx.x);
  if (E == STORE) {
    if (b < nfill) {  // rows [64 b, 64 b + 64): columns left of c0, or all
      const int r1 = min((b + 1) * TM, m);
      for (int r = b * TM; r < r1; ++r) {
        double* row = C + static_cast<size_t>(r) * m;
        const int len = r < c0 ? m : c0;
        for (int c = t; c < len; c += THREADS) row[c] = 0.0;
      }
      return;
    }
    b -= nfill;
  }
  int rt, ct;
  lower_tile(b, nt, &rt, &ct);
  const int row0 = rt * TM;  // from c0
  const int col0 = ct * TM;
  const int nkc = kp / TKC;
  const int kc0 = a_upper ? min((c0 + max(row0, col0)) / TKC, nkc) : 0;
  const size_t tile_bytes = static_cast<size_t>(nkc) * NS * PLANE;
  // the tile's rows of the carry into L2 for the epilogue: 64 x 512 B of
  // C, or 64 x 256 B of hi and of lo
  if (E == SUB)
    for (int e = t; e < TM * 4; e += THREADS) {
      const int r = min(row0 + (e >> 2), nr - 1);
      const int c = min(col0 + (e & 3) * (TM / 4), nr - 1);
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          C + static_cast<size_t>(c0 + r) * m + c0 + c));
    }
  if (E == PAIR)
    for (int e = t; e < TM * 4; e += THREADS) {
      const float* base = (e & 2) ? lo : hi;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          base + static_cast<size_t>(c0 + row0 + (e >> 2)) * m + c0 + col0 +
          (e & 1) * (TM / 2)));
    }
  double out[32];
  if (!tile_run<NS>(p + rt * tile_bytes, p + ct * tile_bytes, kc0, nkc, out,
                    nullptr)) {
    if (E == STORE && rt / 4 != ct / 4) {  // the mirrored upper tile, by rows
      __syncwarp();  // once the producer lane has issued every copy
      for (int e = t - CONSUMERS; e < TM * TM; e += THREADS - CONSUMERS) {
        const int r = col0 + e / TM;
        const int c = row0 + e % TM;
        if (r < nr && c < nr)
          C[static_cast<size_t>(c0 + r) * m + c0 + c] = 0.0;
      }
    }
    return;
  }
  if constexpr (E == SUB) {
    double cv[32];  // every read of C issued before any arithmetic
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int r = row0 + acc_row(t, q);
      const int c = col0 + acc_col(t, q);
      cv[q] = r >= rs && r < nr && c >= rs && c < nr
                  ? C[static_cast<size_t>(c0 + r) * m + c0 + c]
                  : 0.0;
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int r = row0 + acc_row(t, q);
      const int c = col0 + acc_col(t, q);
      if (r >= rs && r < nr && c >= rs && c < nr)
        C[static_cast<size_t>(c0 + r) * m + c0 + c] = __dsub_rn(
            cv[q], __dmul_rn(out[q], __dmul_rn(sa[r], sa[c])));
    }
  } else if constexpr (E == PAIR) {
    // K4's epilogue: a thread's registers q, q + 1 are two adjacent
    // columns of one row, one float2 of hi and of lo; every carry read
    // issued before any arithmetic; explicitly rounded operations, so
    // that nothing is fused and the result is the plain version's
    float2 hv[16], lv[16];
#pragma unroll
    for (int q = 0; q < 32; q += 2) {
      const size_t idx =
          static_cast<size_t>(c0 + row0 + acc_row(t, q)) * m + c0 + col0 +
          acc_col(t, q);
      hv[q / 2] = *reinterpret_cast<const float2*>(hi + idx);
      lv[q / 2] = *reinterpret_cast<const float2*>(lo + idx);
    }
#pragma unroll
    for (int q = 0; q < 32; q += 2) {
      const int r = row0 + acc_row(t, q);
      const int c = col0 + acc_col(t, q);
      const size_t idx = static_cast<size_t>(c0 + r) * m + c0 + c;
      const float2 h = hv[q / 2];
      const float2 l = lv[q / 2];
      const double s = sa[r];
      const double v0 = __dsub_rn(
          __dadd_rn(static_cast<double>(h.x), static_cast<double>(l.x)),
          __dmul_rn(out[q], __dmul_rn(s, sa[c])));
      const double v1 = __dsub_rn(
          __dadd_rn(static_cast<double>(h.y), static_cast<double>(l.y)),
          __dmul_rn(out[q + 1], __dmul_rn(s, sa[c + 1])));
      const float2 nh =
          make_float2(__double2float_rn(v0), __double2float_rn(v1));
      *reinterpret_cast<float2*>(hi + idx) = nh;
      *reinterpret_cast<float2*>(lo + idx) = make_float2(
          __double2float_rn(__dsub_rn(v0, static_cast<double>(nh.x))),
          __double2float_rn(__dsub_rn(v1, static_cast<double>(nh.y))));
    }
  } else {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int r = row0 + acc_row(t, q);
      const int c = col0 + acc_col(t, q);
      if (r < nr && c < nr)
        C[static_cast<size_t>(c0 + r) * m + c0 + c] =
            __dmul_rn(out[q], __dmul_rn(sa[r], sa[c]));
    }
  }
}

// The k pieces of the tn product's 64-tile (row0, col0): returns their count and
// sets the tile's first chunk kcb; piece p covers chunks kcb + p dc up to
// dc further.  *kcb == nkc means no k at all (one empty piece).
__device__ __forceinline__ int tn_pieces(int row0, int col0, int nkc,
                                         int w_lower, int dc, int* kcb) {
  *kcb = w_lower ? min(max(row0, col0) / hopper::TKC, nkc) : 0;
  return *kcb < nkc ? (nkc - *kcb + dc - 1) / dc : 1;
}

// K6 and K7 (wgmma tile): C = W^T W.  w: tiled slices of W^T's rows (8
// planes, nt row tiles), sw: column scales of W.  Block b < nlive is piece
// 0 of the b-th live lower 64-tile of lower_tile's walk; the nd * nd *
// (npieces - 1) blocks after them are pieces 1.. of the tiles in the first
// nd tile rows and columns, piece by piece, each square row by row (upper
// tiles and tiles of fewer pieces return at once).  slots: (nd, nd,
// npieces, 8, 64, 64) int32 for the tiles with more than one piece
// (deeper than dc chunks), all of which lie in that square.
// A batch of products runs on the grid's y (one piece a tile only, nd 0):
// entry y reads w + y * wb (wb bytes of slices an entry) and sw + y * m and
// writes C + y * m * m.
__global__ void __launch_bounds__(hopper::THREADS, 1) syrk_tn_wgmma_kernel(
    const int8_t* __restrict__ w, const double* __restrict__ sw,
    double* __restrict__ C, int m, int kp, int w_lower, int dc,
    int* __restrict__ slots, int nd, int npieces, int nt, int nlive,
    long long wb) {
  using namespace hopper;
  constexpr int NS = 8;
  w += static_cast<size_t>(blockIdx.y) * wb;
  sw += static_cast<size_t>(blockIdx.y) * m;
  C += static_cast<size_t>(blockIdx.y) * m * m;
  int b = static_cast<int>(blockIdx.x);
  int rt, ct, p = 0;
  if (b < nlive) {
    lower_tile(b, nt, &rt, &ct);
  } else {
    b -= nlive;
    p = 1 + b / (nd * nd);
    rt = b % (nd * nd) / nd;
    ct = b % nd;
    if (rt / 4 < ct / 4) return;
  }
  const int row0 = rt * TM;
  const int col0 = ct * TM;
  const int nkc = kp / TKC;
  int kcb;
  const int np = tn_pieces(row0, col0, nkc, w_lower, dc, &kcb);
  if (p >= np) return;
  const int k0 = min(kcb + p * dc, nkc);
  const int k1 = min(k0 + dc, nkc);
  int* slot = nullptr;
  if (np > 1) {
    if (rt >= nd || ct >= nd || p >= npieces)
      __trap();  // the wrapper sized the slots too small
    slot = slots + ((static_cast<size_t>(rt) * nd + ct) * npieces + p) *
                       NS * TM * TM;
  }
  const size_t tile_bytes = static_cast<size_t>(nkc) * NS * PLANE;
  double out[32];
  if (!tile_run<NS>(w + rt * tile_bytes, w + ct * tile_bytes, k0, k1, out,
                    slot)) {
    if (p == 0 && rt / 4 != ct / 4) {  // the mirrored upper tile, by rows
      __syncwarp();  // once the producer lane has issued every copy
      for (int e = threadIdx.x - CONSUMERS; e < TM * TM;
           e += THREADS - CONSUMERS) {
        const int r = col0 + e / TM;
        const int c = row0 + e % TM;
        if (r < m && c < m) C[static_cast<size_t>(r) * m + c] = 0.0;
      }
    }
    return;
  }
  if (slot != nullptr) return;
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int r = row0 + acc_row(t, q);
    const int c = col0 + acc_col(t, q);
    if (r < m && c < m)
      C[static_cast<size_t>(r) * m + c] =
          __dmul_rn(out[q], __dmul_rn(sw[r], sw[c]));
  }
}

// The tn product's second kernel (K6 and K7): for each tile of several
// pieces, the slots' int32 group sums added as integers, combined in
// ascending s and scaled.
__global__ void __launch_bounds__(256) syrk_tn_combine_kernel(
    const double* __restrict__ sw, double* __restrict__ C, int m, int kp,
    int w_lower, int dc, const int* __restrict__ slots, int nd,
    int npieces) {
  using namespace hopper;
  constexpr int NS = 8;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TM;
  if (row0 / TILE < col0 / TILE) return;
  int kcb;
  const int np = tn_pieces(row0, col0, kp / TKC, w_lower, dc, &kcb);
  if (np <= 1) return;
  const int* tile = slots + (static_cast<size_t>(blockIdx.y) * nd +
                             blockIdx.x) * npieces * NS * TM * TM;
  for (int e = threadIdx.x; e < TM * TM; e += blockDim.x) {
    long long g[NS] = {};
    for (int p = 0; p < np; ++p) {
      const int* tp = tile + static_cast<size_t>(p) * NS * TM * TM + e;
#pragma unroll
      for (int s = 0; s < NS; ++s) g[s] += tp[s * TM * TM];
    }
    double o = 0.0;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      o = __dadd_rn(o, __dmul_rn(static_cast<double>(g[s]),
                                 hopper::group_weight(s)));
    const int r = row0 + e / TM;
    const int c = col0 + e % TM;
    if (r < m && c < m)
      C[static_cast<size_t>(r) * m + c] = __dmul_rn(o, __dmul_rn(sw[r], sw[c]));
  }
}

template <class K>
bool smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes)) == cudaSuccess;
}

}  // namespace

// K4: (hi, lo) -= A B in place on rows r0.. and columns ..nc of the (m,
// n) carry, on the wgmma tile.  a: slicing.cu's tiled slices of A's rows
// from r0 ((m - r0) / 64 row tiles), sa: their (m - r0,) f64 scales; bt:
// the tiled slices of B's first nc columns (the rows of B^T, nc / 64 row
// tiles), sb: their (nc,) f64 scales; both kp deep.  hi/lo: (m, n) f32.
// m, n, r0 and nc multiples of 256, r0 < m, 0 < nc <= n, kp a multiple of
// 32 and at most 2^14, ns 6 (the count this kernel is built for).  A call
// with no live tile is the caller's to skip.  Returns cudaGetLastError().
extern "C" int mm_sub_pair(const void* a, const void* bt, const void* sa,
                           const void* sb, void* hi, void* lo, int m, int n,
                           int kp, int r0, int nc, int ns, void* stream) {
  if (ns != 6 || m % TILE || n % TILE || r0 % TILE || nc % TILE || r0 < 0 ||
      r0 >= m || nc <= 0 || nc > n || kp % hopper::TKC || kp <= 0 ||
      kp > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = hopper::smem_bytes<6>();
  if (!smem_attr(mm_sub_pair_wgmma_kernel, smem))
    return static_cast<int>(cudaGetLastError());
  const int ntr = (m - r0) / hopper::TM, ntc = nc / hopper::TM;
  mm_sub_pair_wgmma_kernel<<<ntr * ntc, hopper::THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
      static_cast<const double*>(sa), static_cast<const double*>(sb),
      static_cast<float*>(hi), static_cast<float*>(lo), n, kp, r0, ntr, ntc);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The lower-tile product's launch: the grid of live lower tiles (and,
// storing, the fill blocks).  Returns cudaGetLastError().
template <int E>
int launch_syrk_lower(const void* p, const void* sa, void* C, void* hi,
                      void* lo, int m, int kp, int c0, int a_upper, int rs,
                      void* stream) {
  constexpr size_t smem = hopper::smem_bytes<6>();
  if (!smem_attr(syrk_lower_wgmma_kernel<E>, smem))
    return static_cast<int>(cudaGetLastError());
  const int nr = m - c0;
  const int nt = (nr + hopper::TM - 1) / hopper::TM;
  const int nfill =
      E != STORE || c0 == 0 ? 0 : (m + hopper::TM - 1) / hopper::TM;
  syrk_lower_wgmma_kernel<E><<<nfill + lower_blocks(nt), hopper::THREADS,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(p), static_cast<const double*>(sa),
      static_cast<double*>(C), static_cast<float*>(hi),
      static_cast<float*>(lo), m, nr, kp, c0, a_upper, rs, nfill, nt);
  return static_cast<int>(cudaGetLastError());
}

bool bad_syrk(int m, int kp, int c0, int ns) {
  return ns != 6 || m <= 0 || c0 < 0 || c0 >= m || c0 % TILE || kp <= 0 ||
         kp % hopper::TKC || kp > MAX_K;
}

}  // namespace

// K8: C = P P^T on the lower 256-tiles of the trailing square from c0,
// exact zeros everywhere else; every element of C written.  p: slicing.cu's
// tiled slices of P's rows from c0 (ceil((m - c0) / 64) row tiles, kp
// deep), sa: their (m - c0,) f64 row scales, C: (m, m) f64.  m > c0 >= 0,
// c0 a multiple of 256, kp a multiple of 32 and at most 2^14, ns 6 (the
// count this kernel is built for).  a_upper: P[r][k] == 0 for k < r.
// Returns cudaGetLastError().
extern "C" int syrk_lower(const void* p, const void* sa, void* C, int m,
                          int kp, int c0, int a_upper, int ns,
                          void* stream) {
  if (bad_syrk(m, kp, c0, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_syrk_lower<STORE>(p, sa, C, nullptr, nullptr, m, kp, c0,
                                  a_upper, 0, stream);
}

// K8 in place: A -= P P^T on the lower 256-tiles of the trailing square
// from c0, rows and columns from row_start only (c0 = row_start rounded
// down to 256); nothing else of A is read or written.  p, sa as
// syrk_lower's; A: (m, m) f64.  Returns cudaGetLastError().
extern "C" int syrk_sub_lower(const void* p, const void* sa, void* A, int m,
                              int kp, int c0, int row_start, int ns,
                              void* stream) {
  if (bad_syrk(m, kp, c0, ns) || row_start < c0 || row_start >= m ||
      row_start - c0 >= TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_syrk_lower<SUB>(p, sa, A, nullptr, nullptr, m, kp, c0, 0,
                                row_start - c0, stream);
}

// K1 and K12: (hi, lo) -= P P^T in place on the lower 256-tiles of the
// trailing square from c0, diagonal 256-tiles whole; nothing else of the
// carry is read or written.  p: slicing.cu's tiled slices of P's rows from
// c0 ((m - c0) / 64 row tiles, kp deep), sa: their (m - c0,) f64 row
// scales, hi/lo: the (m, m) f32 pair carry.  m and c0 multiples of 256,
// c0 < m, kp a multiple of 32 and at most 2^14, ns 6 (the count this
// kernel is built for).  Returns cudaGetLastError().
extern "C" int syrk_sub_pair(const void* p, const void* sa, void* hi,
                             void* lo, int m, int kp, int c0, int ns,
                             void* stream) {
  if (bad_syrk(m, kp, c0, ns) || m % TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_syrk_lower<PAIR>(p, sa, nullptr, hi, lo, m, kp, c0, 0, 0,
                                 stream);
}

// K2: C = A B, both operands as slicing.cu's tiled slices.  a: slices of
// A's rows from r0 (a multiple of 256), ceil((m - r0) / 64) row tiles;
// bt: slices of B^T's rows (B's columns), ceil(n / 64) row tiles; both kp
// deep (a multiple of 32, at most 2^14).  sa: (m - r0,) and sb: (n,) f64
// scales; C: (m, n) f64, every element written.  ns 6 or 8.
extern "C" int slice_matmul_tiled(const void* a, const void* bt,
                                  const void* sa, const void* sb, void* C,
                                  int m, int n, int kp, int ns,
                                  int lower_only, int row_start,
                                  int col_start, int col_end, int r0,
                                  void* stream) {
  if (m <= 0 || n <= 0 || kp <= 0 || kp % hopper::TKC || kp > MAX_K ||
      r0 < 0 || r0 % TILE || r0 >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + hopper::TM - 1) / hopper::TM,
                  (m + hopper::TM - 1) / hopper::TM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(bt);
  const double* SA = static_cast<const double*>(sa);
  const double* SB = static_cast<const double*>(sb);
  double* Cd = static_cast<double*>(C);
  if (ns == 6) {
    constexpr size_t smem = hopper::smem_bytes<6>();
    if (!smem_attr(slice_matmul_wgmma_kernel<6>, smem))
      return static_cast<int>(cudaGetLastError());
    slice_matmul_wgmma_kernel<6><<<grid, hopper::THREADS, smem, st>>>(
        A, B, SA, SB, Cd, m, n, kp, lower_only, row_start, col_start,
        col_end, r0);
  } else if (ns == 8) {
    constexpr size_t smem = hopper::smem_bytes<8>();
    if (!smem_attr(slice_matmul_wgmma_kernel<8>, smem))
      return static_cast<int>(cudaGetLastError());
    slice_matmul_wgmma_kernel<8><<<grid, hopper::THREADS, smem, st>>>(
        A, B, SA, SB, Cd, m, n, kp, lower_only, row_start, col_start,
        col_end, r0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6 and K7: C = W^T W on lower 256-tiles from slicing.cu's tiled slices
// of W^T (8 planes, ceil(m / 64) row tiles, kp deep, a multiple of 32) and
// the (m,) f64 column scales sw; C: (m, m) f64, every element written.
// w_lower: W[k][i] == 0 for k < i.  dc: chunks of 32 per k piece, at most
// 2^14 / 32.  slots: (nd, nd, npieces, 8, 64, 64) int32 for the tiles of
// more than one piece (null when nd is 0; with w_lower nd is the count of
// tiles t with kp - 64 t > 32 dc, else all or none); npieces =
// ceil(kp / 32 / dc), the most pieces of a tile.
// Launches the piece kernel and, when nd > 0, the combine kernel.
extern "C" int syrk_tn_tiled(const void* w, const void* sw, void* C, int m,
                             int kp, int ns, int w_lower, int dc,
                             void* slots, int nd, int npieces,
                             void* stream) {
  const int nt = (m + hopper::TM - 1) / hopper::TM;
  if (ns != 8 || m <= 0 || kp <= 0 || kp % hopper::TKC || dc <= 0 ||
      dc * hopper::TKC > MAX_K || nd < 0 || nd > nt ||
      (nd > 0 && slots == nullptr) ||
      npieces != (kp / hopper::TKC + dc - 1) / dc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr size_t smem = hopper::smem_bytes<8>();
  if (!smem_attr(syrk_tn_wgmma_kernel, smem))
    return static_cast<int>(cudaGetLastError());
  const double* SW = static_cast<const double*>(sw);
  double* Cd = static_cast<double*>(C);
  int* S = static_cast<int*>(slots);
  const int nlive = lower_blocks(nt);
  syrk_tn_wgmma_kernel<<<nlive + nd * nd * (npieces - 1), hopper::THREADS,
                         smem, st>>>(static_cast<const int8_t*>(w), SW, Cd, m,
                                     kp, w_lower, dc, S, nd, npieces, nt,
                                     nlive, 0);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || nd == 0) return err;
  syrk_tn_combine_kernel<<<dim3(nd, nd), 256, 0, st>>>(
      SW, Cd, m, kp, w_lower, dc, S, nd, npieces);
  return static_cast<int>(cudaGetLastError());
}

// The batched K7: nbatch products C[i] = W[i]^T W[i] in one launch of the
// piece kernel, batch entry i on the grid's y.  w: (nbatch, ceil(m / 64),
// kp / 32, 8, 2048) tiled slices (slicing.cu's slice_rows_batched of the
// W[i]^T), sw: (nbatch, m) column scales, C: (nbatch, m, m) f64.  kp <=
// 2^14, so every tile is one piece (no slots, no combine kernel), and each
// entry equals syrk_tn_tiled on its slices alone.
extern "C" int syrk_tn_tiled_batched(const void* w, const void* sw, void* C,
                                     int m, int kp, int ns, int w_lower,
                                     int nbatch, void* stream) {
  const int nt = (m + hopper::TM - 1) / hopper::TM;
  const int nkc = kp / hopper::TKC;
  if (ns != 8 || m <= 0 || kp <= 0 || kp % hopper::TKC || kp > MAX_K ||
      nbatch < 1 || nbatch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = hopper::smem_bytes<8>();
  if (!smem_attr(syrk_tn_wgmma_kernel, smem))
    return static_cast<int>(cudaGetLastError());
  const long long wb =
      static_cast<long long>(nt) * nkc * 8 * hopper::TM * hopper::TKC;
  syrk_tn_wgmma_kernel<<<dim3(lower_blocks(nt), nbatch), hopper::THREADS,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const double*>(sw),
      static_cast<double*>(C), m, kp, w_lower, nkc, nullptr, 0, 1, nt,
      lower_blocks(nt), wb);
  return static_cast<int>(cudaGetLastError());
}
