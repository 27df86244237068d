// The panel kernels of the pair-carry factorisation.
//
// K5: the 8 int8 slices of a full (m, m) f32-pair matrix with
// power-of-two column scales, written in W^T layout.
//
// Replaces the Pallas TPU kernel pallas_panel.pair_to_slices_cols
// (andvaranaut_tpu/gp/pallas_panel.py, _slices_cols_kernel), which feeds
// the pair-carried L^-1 to the K^-1 = W^T W product (K6 in slicemm.cu).
//
// Each element's value is the exact f64 sum hi + lo, divided by its
// column's exact pow2 scale (made by the wrapper from the hi plane, as
// the reference does) and cut into NS int8 slices by the exact steps
// R *= 128, c = trunc(R), R -= c.  The TPU kernel carried R as an f32
// pair, whose rounding of hi + lo can move one slice by 1 and the next
// by -128 with the same represented value; the f64 steps here match the
// plain PyTorch version bit for bit instead.  Exact zeros stay zero.
//
// Output layout: out[s][i][k] = slice s of W[k][i], (NS, m, m) row-major,
// the row-major operand that K6's tile product reads for both sides.  So
// the kernel is a transpose: one 256-thread block reads a 64 x 64 tile of
// the pair along rows of W (coalesced), keeps its NS slice tiles in
// shared memory and writes them along rows of W^T, four bytes a thread.
//
// What bounds it: bytes.  It reads 8 bytes and writes NS bytes per
// element and does a handful of f64 operations each; at 16384^2 that is
// 4.3 GB, about 1.3 ms at the card's memory rate.
//
// K10: the fused panel stage (ANDVARANAUT_FUSED_PANEL), which replaces
// the Pallas TPU kernel pallas_panel.panel_into_carry (_panel_kernel) of
// andvaranaut_tpu/gp/pallas_panel.py.  The stage's K11
// (pallas_panel.pair_to_slices) runs slicing.cu's pair mode, on the
// carry's finished column block, and K12 slicemm.cu's syrk_sub_pair.
//
// K10 writes the finished panel P = A[:, col:col+nc] Linv^T into the
// carry's own column block, rows >= row_start, in place, on the wgmma tile
// (hopper_tile.cuh).  Its operands are made on the card in slicing.cu's
// tiled layout: the window A[c0:, col:col+nc] by the pair mode
// (slice_pair_rows: scales from the hi plane, planes of the exact hi + lo)
// and Linv, whose rows are the rows of B^T, by slice_rows; both launches
// precede the product on one stream.  That order is what handles the
// hazard: every output tile of a row needs the whole k range of that
// row's window, which other blocks overwrite, so the window is cut into
// the slices (before the update) by the first launch and the product
// reads only the slices.  The grid covers the live (m - c0) / 64 x nc / 64
// rectangle only, walked in groups of 16 tile rows that share the slices
// in L2 (rect_tile); k = nc <= 2^14, so all six order groups stay in
// registers in one pass.  The epilogue writes v = out * (sa[r] * sb[c])
// for rows >= row_start as a proper f32 pair, two adjacent columns a
// float2, with explicitly rounded operations: the plain version's
// arithmetic, so the panel equals K2's slice_matmul(cols, Linv^T) on
// those rows bit for bit.  Rows above row_start and every column outside
// [col, col + nc) are left bit-identical.  Bound by int8 operations (21 x
// 2 x rows x nc^2: 0.342 ms at the 16k first step); the carry takes 8
// bytes a written entry, the slices 6 bytes a window entry twice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace {

constexpr int NS = 8;             // slices; the caller's count must match
constexpr int T = 64;             // tile edge
constexpr int NTHREADS = 256;
constexpr int PAD = 4;            // keeps rows 4-byte aligned, banks apart

__global__ void __launch_bounds__(NTHREADS) pair_to_slices_cols_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const double* __restrict__ scale, int8_t* __restrict__ out, int m) {
  __shared__ __align__(16) int8_t tile[NS][T][T + PAD];  // [s][i][k]
  const int k0 = blockIdx.y * T;  // rows of W
  const int i0 = blockIdx.x * T;  // columns of W
  const int ti = threadIdx.x % T;
  const double s = scale[i0 + ti];
  for (int r = threadIdx.x / T; r < T; r += NTHREADS / T) {
    const size_t idx = static_cast<size_t>(k0 + r) * m + i0 + ti;
    double v = __ddiv_rn(__dadd_rn(static_cast<double>(hi[idx]),
                                   static_cast<double>(lo[idx])),
                         s);
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      v = __dmul_rn(v, 128.0);
      const double c = trunc(v);
      tile[q][ti][r] = static_cast<int8_t>(static_cast<int>(c));
      v = __dsub_rn(v, c);
    }
  }
  __syncthreads();
  constexpr int WORDS = T / 4;  // 4-byte words per output row
  const size_t plane = static_cast<size_t>(m) * m;
  for (int w = threadIdx.x; w < NS * T * WORDS; w += NTHREADS) {
    const int q = w / (T * WORDS);
    const int rem = w - q * T * WORDS;
    const int ii = rem / WORDS;
    const int kw = rem - ii * WORDS;
    const uint32_t word =
        *reinterpret_cast<const uint32_t*>(&tile[q][ii][kw * 4]);
    *reinterpret_cast<uint32_t*>(out + q * plane +
                                 static_cast<size_t>(i0 + ii) * m + k0 +
                                 kw * 4) = word;
  }
}

}  // namespace

// hi, lo: (m, m) f32; scale: (m,) f64 pow2 column scales; out: (ns, m,
// m) int8.  m a positive multiple of 64; ns must be NS, the count this
// kernel is built for.  Returns cudaGetLastError().
extern "C" int pair_to_slices_cols(const void* hi, const void* lo,
                                   const void* scale, void* out, int m,
                                   int ns, void* stream) {
  if (ns != NS || m <= 0 || m % T)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(m / T, m / T);
  pair_to_slices_cols_kernel<<<grid, NTHREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(lo),
      static_cast<const double*>(scale), static_cast<int8_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int NS_PANEL = 6;  // slices of K10; the count must match

// K10's product: the 64-tile (rt, ct) of the panel, rows from c0, columns
// from col, from the window's tiled slices a (rows from c0) and Linv's bt,
// both kp deep; rows >= row_start are written into the carry as a proper
// f32 pair, the rest are left as they are.
__global__ void __launch_bounds__(hopper::THREADS, 1) panel_wgmma_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    const double* __restrict__ sa, const double* __restrict__ sb,
    float* __restrict__ hi, float* __restrict__ lo, int m, int col, int c0,
    int row_start, int kp, int ntr, int ntc) {
  using namespace hopper;
  int rt, ct;
  rect_tile(static_cast<int>(blockIdx.x), ntr, ntc, &rt, &ct);
  const int row0 = rt * TM;  // from c0
  const int col0 = ct * TM;
  if (c0 + row0 + TM <= row_start) return;  // no row of the tile is live
  const int nkc = kp / TKC;
  const size_t tile_bytes = static_cast<size_t>(nkc) * NS_PANEL * PLANE;
  double out[32];
  if (!tile_run<NS_PANEL>(a + rt * tile_bytes, bt + ct * tile_bytes, 0, nkc,
                          out, nullptr))
    return;
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 32; q += 2) {
    const int r = row0 + acc_row(t, q);
    const int c = col0 + acc_col(t, q);
    if (c0 + r < row_start) continue;
    const double s = sa[r];
    const double v0 = __dmul_rn(out[q], __dmul_rn(s, sb[c]));
    const double v1 = __dmul_rn(out[q + 1], __dmul_rn(s, sb[c + 1]));
    const float2 h = make_float2(__double2float_rn(v0), __double2float_rn(v1));
    const size_t idx = static_cast<size_t>(c0 + r) * m + col + c;
    *reinterpret_cast<float2*>(hi + idx) = h;
    *reinterpret_cast<float2*>(lo + idx) = make_float2(
        __double2float_rn(__dsub_rn(v0, static_cast<double>(h.x))),
        __double2float_rn(__dsub_rn(v1, static_cast<double>(h.y))));
  }
}

constexpr int TILE = 256;       // grain of the window's shape rules
constexpr int MAX_K = 1 << 14;  // exact int32 depth of the group sums

bool bad_window(int m, int col, int c0, int nc, int ns) {
  return ns != NS_PANEL || m <= 0 || m % TILE || nc <= 0 || nc % TILE ||
         nc > MAX_K || col < 0 || col % TILE || col + nc > m || c0 < 0 ||
         c0 >= m || c0 % TILE;
}

}  // namespace

// K10's product: (hi, lo)[r][col + c] = (A[r][col:col+nc] Linv^T)[c] for
// rows r >= row_start, in place, A the carry pair.  a: the window's tiled
// slices (slicemm.slice_pair_operand of rows c0.., (m - c0) / 64 row
// tiles), sa their (m - c0,) f64 scales; bt: Linv's tiled slices (nc / 64
// row tiles), sb its (nc,) f64 row scales; both nc deep.  The window must
// have been sliced before this launch on the stream.  m, col, c0, nc
// multiples of 256, c0 < m, col + nc <= m, nc at most 2^14, ns 6 (the
// count this kernel is built for).  Returns cudaGetLastError().
extern "C" int panel_into_carry(void* hi, void* lo, const void* a,
                                const void* bt, const void* sa,
                                const void* sb, int m, int col, int c0,
                                int row_start, int nc, int ns,
                                void* stream) {
  if (bad_window(m, col, c0, nc, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = hopper::smem_bytes<NS_PANEL>();
  if (cudaFuncSetAttribute(panel_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int ntr = (m - c0) / hopper::TM, ntc = nc / hopper::TM;
  panel_wgmma_kernel<<<ntr * ntc, hopper::THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
      static_cast<const double*>(sa), static_cast<const double*>(sb),
      static_cast<float*>(hi), static_cast<float*>(lo), m, col, c0,
      row_start, nc, ntr, ntc);
  return static_cast<int>(cudaGetLastError());
}
