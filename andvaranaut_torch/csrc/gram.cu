// K9: one kernel component's cross-Gram over pre-scaled inputs, in f32.
//
// Replaces the Pallas TPU kernel andvaranaut_tpu/gp/pallas_ops.py:72
// (pallas_gram, tile body _gram_kernel at :51).  Per output entry:
//   r2 = sum_{k=0}^{d-1} (x_k - y_k)^2   (in order, the difference form)
// then the kernel value of _kernel_eval (pallas_ops.py:34-48):
//   RBF          exp(-r2 / 2)
//   Matern52     (1 + sqrt5 r + 5/3 r2) exp(-sqrt5 r),   r = sqrt(r2 + 1e-36)
//   Matern32     (1 + sqrt3 r) exp(-sqrt3 r)
//   Exponential  exp(-r / 2)                             (PyMC's convention)
//   RatQuad      (1 + r2 / (2 alpha))^(-alpha)
// Every f32 operation is written with an explicitly rounded intrinsic, so
// the compiler fuses no multiply-add the plain version (gp/ops.py) does
// not, and the transcendentals are the accurate expf / sqrtf / powf (no
// fast-math): kernel and plain version differ only by the libraries'
// last-ulp choices.
//
// What bounds it: bytes.  Each entry costs 4 bytes of output and a few
// dozen f32 operations, far below the card's operations-per-byte ridge,
// so the design keeps everything else out of device memory: a block
// covers 8 rows x 1024 columns; each thread keeps its 4 consecutive
// columns' inputs in registers (read once from the transposed (d, m)
// column operand) and the 8 x 4 r2 sums; the block's row inputs are
// loaded by all its threads from one address (a broadcast), so nothing
// needs staging in shared memory.  A warp's 32 threads store 32 x 16
// contiguous bytes per row (one float4 each where the row stride allows
// it), fully coalesced.  Edges are guarded, not padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int CPT = 4;          // consecutive columns per thread
constexpr int BC = NT * CPT;    // columns per block
constexpr int BR = 8;           // rows per block

enum { RBF = 0, MATERN52 = 1, MATERN32 = 2, EXPONENTIAL = 3, RATQUAD = 4 };

template <int NAME>
__device__ __forceinline__ float kernel_eval(float r2, float alpha) {
  if (NAME == RBF) return expf(__fmul_rn(-0.5f, r2));
  if (NAME == RATQUAD)
    return powf(__fadd_rn(1.0f, __fdiv_rn(r2, __fmul_rn(2.0f, alpha))),
                -alpha);
  const float r = sqrtf(__fadd_rn(r2, 1e-36f));
  if (NAME == MATERN52) {
    const float s5 = static_cast<float>(2.23606797749978969640917);
    const float c53 = static_cast<float>(5.0 / 3.0);
    const float poly =
        __fadd_rn(__fadd_rn(1.0f, __fmul_rn(s5, r)), __fmul_rn(c53, r2));
    return __fmul_rn(poly, expf(__fmul_rn(-s5, r)));
  }
  if (NAME == MATERN32) {
    const float s3 = static_cast<float>(1.73205080756887729352745);
    return __fmul_rn(__fadd_rn(1.0f, __fmul_rn(s3, r)),
                     expf(__fmul_rn(-s3, r)));
  }
  return expf(__fmul_rn(-0.5f, r));  // Exponential
}

// out (n, m) f32 row-major; xs (n, d) row-major; yt (d, m) row-major (the
// column inputs transposed); alpha: one f32 in device memory (RatQuad).
template <int NAME>
__global__ void __launch_bounds__(NT) gram_kernel(
    const float* __restrict__ xs, const float* __restrict__ yt,
    const float* __restrict__ alpha_p, float* __restrict__ out, int n, int m,
    int d, int vec4) {
  const int r0 = blockIdx.x * BR;
  const int c = blockIdx.y * BC + threadIdx.x * CPT;
  if (c >= m) return;
  float r2[BR][CPT];
#pragma unroll
  for (int i = 0; i < BR; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) r2[i][j] = 0.0f;
  for (int k = 0; k < d; ++k) {
    float yk[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      yk[j] = c + j < m ? yt[static_cast<size_t>(k) * m + c + j] : 0.0f;
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const float xk =
          r0 + i < n ? xs[static_cast<size_t>(r0 + i) * d + k] : 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float diff = __fsub_rn(xk, yk[j]);
        r2[i][j] = __fadd_rn(r2[i][j], __fmul_rn(diff, diff));
      }
    }
  }
  const float alpha = NAME == RATQUAD ? *alpha_p : 1.0f;
#pragma unroll
  for (int i = 0; i < BR; ++i) {
    const int row = r0 + i;
    if (row >= n) break;
    float v[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) v[j] = kernel_eval<NAME>(r2[i][j], alpha);
    float* o = out + static_cast<size_t>(row) * m + c;
    if (vec4 && c + CPT <= m) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (c + j < m) o[j] = v[j];
    }
  }
}

}  // namespace

// out (n, m) f32 = component `name` (0 RBF, 1 Matern52, 2 Matern32,
// 3 Exponential, 4 RatQuad) of the Gram of xs (n, d) f32 rows against
// the columns of yt (d, m) f32, alpha a device pointer to one f32 (read
// for RatQuad only).  All arrays contiguous.  Returns cudaGetLastError().
extern "C" int gram_tiles(const void* xs, const void* yt, const void* alpha,
                          void* out, int n, int m, int d, int name,
                          void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || name < 0 || name > 4 ||
      (m + BC - 1) / BC > 65535 || alpha == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BR - 1) / BR, (m + BC - 1) / BC);
  const int vec4 =
      m % CPT == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* X = static_cast<const float*>(xs);
  const float* Y = static_cast<const float*>(yt);
  const float* A = static_cast<const float*>(alpha);
  float* O = static_cast<float*>(out);
  switch (name) {
    case RBF:
      gram_kernel<RBF><<<grid, NT, 0, st>>>(X, Y, A, O, n, m, d, vec4);
      break;
    case MATERN52:
      gram_kernel<MATERN52><<<grid, NT, 0, st>>>(X, Y, A, O, n, m, d, vec4);
      break;
    case MATERN32:
      gram_kernel<MATERN32><<<grid, NT, 0, st>>>(X, Y, A, O, n, m, d, vec4);
      break;
    case EXPONENTIAL:
      gram_kernel<EXPONENTIAL><<<grid, NT, 0, st>>>(X, Y, A, O, n, m, d,
                                                    vec4);
      break;
    default:
      gram_kernel<RATQUAD><<<grid, NT, 0, st>>>(X, Y, A, O, n, m, d, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
