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
// K11 and K10: the fused panel stage (ANDVARANAUT_FUSED_PANEL), which
// replaces the Pallas TPU kernels pallas_panel.pair_to_slices
// (_slices_kernel) and pallas_panel.panel_into_carry (_panel_kernel) of
// andvaranaut_tpu/gp/pallas_panel.py.
//
// K11 cuts the carry's column block [col, col + nc), rows c0.. (c0 =
// row_start rounded down to 256), into 6 int8 slices below each row's
// exact pow2 scale (made by the wrapper from the hi plane, as the
// reference does), in the (6, m - c0, nc) layout that K1's kernel reads
// (slicemm.cu), so K12 launches K1's kernel on them as they are.  Rows
// above row_start are zero slices, the zero panel rows K1 expects there.
// The value is the exact f64 sum hi + lo divided by the exact scale, cut
// by the exact steps R *= 128, c = trunc(R), R -= c: 6 x 7 bits lie inside
// f64's mantissa.  The reference carried R as an f32 pair, whose rounding
// of Rh + Rl can move one slice by 1 and the next by -128 with the same
// represented value; the slices here equal the plain PyTorch version's bit
// for bit.  One thread does 4 consecutive elements: 32 bytes read, 6
// 4-byte words written.  Bound by bytes: 8 read and 6 written per
// element.
//
// K10 writes the finished panel P = A[:, col:col+nc] Linv^T into the
// carry's own column block, rows >= row_start, in place.  The hazard:
// every output tile of a row needs the whole k range of that row's
// window, which other blocks overwrite.  So the launch runs in two
// kernels on one stream: K11's kernel first cuts the whole window
// (before the update) into int8 slices in a scratch of the wrapper's, then
// the product kernel reads only the scratch and Linv's slices (made by the
// wrapper, (6, nc, nc)) and writes the f64 result, split into a proper
// f32 pair, into the carry.  The product is K2's (ozaki.cuh's tile,
// 21 pair products, the plain order), so the panel equals K2's
// slice_matmul(cols, Linv^T) on those rows bit for bit.  Bound by int8
// operations (21 x 2 x rows x nc^2); the scratch adds 12 bytes of traffic
// per window element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ozaki.cuh"

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

constexpr int NS_PANEL = 6;  // slices of K10 and K11; the count must match

// K11: out[s][r][k] = slice s of (hi + lo)[c0 + r][col + k] / sa[r] for
// rows c0 + r >= row_start, zero above; 4 consecutive k a thread.
__global__ void __launch_bounds__(256) pair_to_slices_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const double* __restrict__ sa, int8_t* __restrict__ out, int m,
    int col, int c0, int row_start, int nc) {
  const int words = nc / 4;
  const int nr = m - c0;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(nr) * words) return;
  const int r = static_cast<int>(idx / words);
  const int w = static_cast<int>(idx - static_cast<long long>(r) * words);
  uint32_t packed[NS_PANEL];
#pragma unroll
  for (int q = 0; q < NS_PANEL; ++q) packed[q] = 0u;
  if (c0 + r >= row_start) {
    const size_t g = static_cast<size_t>(c0 + r) * m + col + w * 4;
    const float4 h = *reinterpret_cast<const float4*>(hi + g);
    const float4 l = *reinterpret_cast<const float4*>(lo + g);
    const float hv[4] = {h.x, h.y, h.z, h.w};
    const float lv[4] = {l.x, l.y, l.z, l.w};
    const double s = sa[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      double v = __ddiv_rn(__dadd_rn(static_cast<double>(hv[e]),
                                     static_cast<double>(lv[e])),
                           s);
#pragma unroll
      for (int q = 0; q < NS_PANEL; ++q) {
        v = __dmul_rn(v, 128.0);
        const double c = trunc(v);
        packed[q] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         static_cast<int8_t>(static_cast<int>(c))))
                     << (8 * e);
        v = __dsub_rn(v, c);
      }
    }
  }
  const size_t plane = static_cast<size_t>(nr) * nc;
#pragma unroll
  for (int q = 0; q < NS_PANEL; ++q)
    *reinterpret_cast<uint32_t*>(out + q * plane +
                                 static_cast<size_t>(r) * nc + w * 4) =
        packed[q];
}

// K10's product: the (64 x 64) tile (row0, col0) of the panel, rows from
// c0, columns from col, from the window slices a (6, nr, nc) and Linv's
// slices lsl (6, nc, nc); rows >= row_start are written into the carry as
// a proper f32 pair, the rest are left as they are.
__global__ void __launch_bounds__(ozaki::NTHREADS) panel_product_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ lsl,
    const double* __restrict__ sa, const double* __restrict__ sb,
    float* __restrict__ hi, float* __restrict__ lo, int m, int col, int c0,
    int row_start, int nc) {
  using ozaki::BM;
  using ozaki::PER_THREAD;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BM;
  if (c0 + row0 + BM <= row_start) return;  // no row of the tile is live
  double out[PER_THREAD];
  ozaki::tile_product<NS_PANEL>(a, lsl, static_cast<size_t>(m - c0) * nc,
                                static_cast<size_t>(nc) * nc, nc, row0, col0,
                                out);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int e = threadIdx.x + q * ozaki::NTHREADS;
    const int r = row0 + e / BM;
    const int c = col0 + e % BM;
    if (c0 + r < row_start) continue;
    const double v = __dmul_rn(out[q], __dmul_rn(sa[r], sb[c]));
    const float h = __double2float_rn(v);
    const size_t idx = static_cast<size_t>(c0 + r) * m + col + c;
    hi[idx] = h;
    lo[idx] = __double2float_rn(__dsub_rn(v, static_cast<double>(h)));
  }
}

bool bad_window(int m, int col, int c0, int nc, int ns) {
  return ns != NS_PANEL || m <= 0 || m % ozaki::TILE || nc <= 0 ||
         nc % ozaki::TILE || nc > ozaki::MAX_K || col < 0 ||
         col % ozaki::TILE || col + nc > m || c0 < 0 || c0 >= m ||
         c0 % ozaki::TILE;
}

void launch_slices(const float* hi, const float* lo, const double* sa,
                   int8_t* out, int m, int col, int c0, int row_start,
                   int nc, cudaStream_t st) {
  const long long n = static_cast<long long>(m - c0) * (nc / 4);
  const int blocks = static_cast<int>((n + 255) / 256);
  pair_to_slices_kernel<<<blocks, 256, 0, st>>>(hi, lo, sa, out, m, col, c0,
                                                row_start, nc);
}

}  // namespace

// K11: the (ns, m - c0, nc) int8 slices of the (m, m) pair's column block
// [col, col + nc), rows c0.. (zero above row_start), with sa the (m - c0,)
// f64 pow2 row scales.  m, col, c0, nc multiples of 256, c0 < m, col + nc
// <= m, nc at most 2^14, ns 6 (the count this kernel is built for).
// Returns cudaGetLastError().
extern "C" int pair_to_slices(const void* hi, const void* lo, const void* sa,
                              void* out, int m, int col, int c0,
                              int row_start, int nc, int ns, void* stream) {
  if (bad_window(m, col, c0, nc, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  launch_slices(static_cast<const float*>(hi), static_cast<const float*>(lo),
                static_cast<const double*>(sa), static_cast<int8_t*>(out), m,
                col, c0, row_start, nc, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K10: (hi, lo)[r][col + c] = (A[r][col:col+nc] Linv^T)[c] for rows r >=
// row_start, in place, A the carry pair.  lsl: (ns, nc, nc) int8 slices of
// Linv / sb (rows), sb: (nc,) f64 row scales of Linv, sa: (m - c0,) f64 row
// scales of the window, scratch: (ns, m - c0, nc) int8.  The shape rules
// are K11's.  Returns cudaGetLastError().
extern "C" int panel_into_carry(void* hi, void* lo, const void* lsl,
                                const void* sa, const void* sb,
                                void* scratch, int m, int col, int c0,
                                int row_start, int nc, int ns,
                                void* stream) {
  if (bad_window(m, col, c0, nc, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* H = static_cast<float*>(hi);
  float* L = static_cast<float*>(lo);
  const double* SA = static_cast<const double*>(sa);
  int8_t* S = static_cast<int8_t*>(scratch);
  launch_slices(H, L, SA, S, m, col, c0, row_start, nc, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc / ozaki::BM, (m - c0) / ozaki::BM);
  panel_product_kernel<<<grid, ozaki::NTHREADS, 0, st>>>(
      S, static_cast<const int8_t*>(lsl), SA, static_cast<const double*>(sb),
      H, L, m, col, c0, row_start, nc);
  return static_cast<int>(cudaGetLastError());
}
