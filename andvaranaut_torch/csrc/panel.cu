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

#include <cuda_runtime.h>
#include <stdint.h>

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
