// K10, the fused panel stage's product (ANDVARANAUT_FUSED_PANEL), which
// replaces the Pallas TPU kernel pallas_panel.panel_into_carry
// (_panel_kernel) of andvaranaut_tpu/gp/pallas_panel.py.  The stage's K11
// (pallas_panel.pair_to_slices) runs slicing.cu's pair mode, on the
// carry's finished column block, and K12 slicemm.cu's syrk_sub_pair.  So
// does K5 (pallas_panel.pair_to_slices_cols: the pair-carried L^-1 cut
// into the operand of K6), the pair mode on the transposed view.
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
