// Diagonal-block Cholesky and triangular inverse in one launch (K3).
//
// Replaces the Pallas TPU kernel andvaranaut_tpu/gp/pallas_cholinv.py
// (chol_inv_block_pair): for a power-of-two-equilibrated SPD block As
// (b x b, b <= 512, b a multiple of 32) it returns L = chol(As), X = L^-1
// (both lower, exact zeros above the diagonal) and ok = all entries of
// L and X finite and min diag(L) > 1e-6.
//
// Numerics: native f64 throughout.  The TPU kernel carried unevaluated
// f32 (hi, lo) pairs (~2^-48) because Pallas on the TPU has no f64; f64
// is more accurate than the pair and the `ok` contract is unchanged.
//
// Design: the block is far from filling the card (b^3/3 = 45 MFLOP at
// 512), so it is bound by latency: sequential column steps and their
// barriers.  One block of 1024 threads does the whole factorisation,
// with the matrix in device memory (2 MB at 512, resident in L2) -- a
// 512^2 block does not fit in 227 KB of shared memory as f64.
//   * Cholesky, right-looking by 32-column panels: the panel (rows p0..b)
//     is staged in shared memory; one warp factors its 32x32 diagonal
//     block warp-synchronously, every thread then solves one row of the
//     panel below against it (L21 = A21 L11^-T), the panel is written
//     back, and the trailing lower triangle receives one rank-32 update
//     from shared memory.  Four block barriers per panel.
//   * Inverse, left-looking by 32-row blocks: block-row R = E - L[r, :r0]
//     X[:r0, :], each thread owning one column and 16 rows in registers
//     with the L block-row broadcast from shared memory; then each
//     column solves the 32x32 diagonal triangle.  Three barriers per
//     block-row.
// On one SM the f64 rate (64 FMA per clock) bounds the b^3/6-FMA inverse
// at ~0.2 ms for b = 512; spreading a block over several SMs, or several
// blocks per launch, is the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NB = 32;      // panel width / block-row height
constexpr int PS = NB + 1;  // padded panel row stride (doubles)
constexpr int NT = 1024;    // threads
constexpr int MAXB = 512;

__global__ void __launch_bounds__(NT) cholinv_kernel(
    const double* __restrict__ A, double* __restrict__ L,
    double* __restrict__ X, int* __restrict__ ok, int b) {
  extern __shared__ double sm[];
  const int tid = threadIdx.x;

  for (int e = tid; e < b * b; e += NT) L[e] = A[e];
  __syncthreads();

  // ---- Cholesky: L's lower triangle is the working matrix -----------
  double* P = sm;  // [h][PS] panel
  for (int p0 = 0; p0 < b; p0 += NB) {
    const int h = b - p0;
    for (int e = tid; e < h * NB; e += NT) {
      const int r = e / NB;
      const int c = e - r * NB;
      P[r * PS + c] = L[static_cast<size_t>(p0 + r) * b + p0 + c];
    }
    __syncthreads();
    // diagonal 32x32 block: one warp, lane = row, warp-synchronous
    if (tid < NB) {
      const int lane = tid;
      for (int jj = 0; jj < NB; ++jj) {
        __syncwarp();
        const double s = sqrt(P[jj * PS + jj]);
        __syncwarp();
        if (lane > jj) P[lane * PS + jj] /= s;
        if (lane == jj) P[jj * PS + jj] = s;
        __syncwarp();
        if (lane > jj) {
          const double l = P[lane * PS + jj];
          for (int c = jj + 1; c <= lane; ++c)
            P[lane * PS + c] -= l * P[c * PS + jj];
        }
      }
    }
    __syncthreads();
    // rows below: L21 = A21 L11^-T, one row per thread, in place
    for (int r = NB + tid; r < h; r += NT) {
      double* row = P + r * PS;
      for (int c = 0; c < NB; ++c) {
        double v = row[c];
        for (int q = 0; q < c; ++q) v -= row[q] * P[c * PS + q];
        row[c] = v / P[c * PS + c];
      }
    }
    __syncthreads();
    for (int e = tid; e < h * NB; e += NT) {
      const int r = e / NB;
      const int c = e - r * NB;
      if (r >= c) L[static_cast<size_t>(p0 + r) * b + p0 + c] = P[r * PS + c];
    }
    const int h2 = h - NB;
    for (int e = tid; e < h2 * h2; e += NT) {
      const int i = e / h2;
      const int k = e - i * h2;
      if (k > i) continue;
      const double* pi = P + (NB + i) * PS;
      const double* pk = P + (NB + k) * PS;
      double acc = 0.0;
#pragma unroll
      for (int t = 0; t < NB; ++t) acc += pi[t] * pk[t];
      L[static_cast<size_t>(p0 + NB + i) * b + p0 + NB + k] -= acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < b * b; e += NT)
    if (e % b > e / b) L[e] = 0.0;
  __syncthreads();

  // ---- inverse: X = L^-1 by 32-row blocks ----------------------------
  double* Lrow = sm;           // [NB][b]: L[r0.., :r0]
  double* D = sm + NB * MAXB;  // [NB][PS]: diagonal block
  const int col = tid & (MAXB - 1);
  const int half = tid / MAXB;  // rows half*16 .. half*16 + 15
  for (int r0 = 0; r0 < b; r0 += NB) {
    const int w = r0 + NB;
    for (int e = tid; e < NB * w; e += NT) {
      const int rr = e / w;
      const int c = e - rr * w;
      const double v = L[static_cast<size_t>(r0 + rr) * b + c];
      if (c < r0)
        Lrow[rr * b + c] = v;
      else
        D[rr * PS + (c - r0)] = v;
    }
    __syncthreads();
    if (col < w) {
      double acc[16];
#pragma unroll
      for (int q = 0; q < 16; ++q)
        acc[q] = (r0 + half * 16 + q == col) ? 1.0 : 0.0;
      // X[t][col] == 0 for t < col: start at the diagonal
      for (int t = col; t < r0; ++t) {
        const double x = X[static_cast<size_t>(t) * b + col];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] -= Lrow[(half * 16 + q) * b + t] * x;
      }
#pragma unroll
      for (int q = 0; q < 16; ++q)
        X[static_cast<size_t>(r0 + half * 16 + q) * b + col] = acc[q];
    }
    __syncthreads();
    if (tid < w) {
      for (int q = 0; q < NB; ++q) {
        double v = X[static_cast<size_t>(r0 + q) * b + tid];
        for (int p = 0; p < q; ++p)
          v -= D[q * PS + p] * X[static_cast<size_t>(r0 + p) * b + tid];
        X[static_cast<size_t>(r0 + q) * b + tid] = v / D[q * PS + q];
      }
    }
    const int rest = b - w;
    for (int e = tid; e < NB * rest; e += NT) {
      const int rr = e / rest;
      X[static_cast<size_t>(r0 + rr) * b + w + (e - rr * rest)] = 0.0;
    }
    __syncthreads();
  }

  int bad = 0;
  for (int e = tid; e < b * b; e += NT)
    if (!isfinite(L[e]) || !isfinite(X[e])) bad = 1;
  for (int r = tid; r < b; r += NT)
    if (!(L[static_cast<size_t>(r) * b + r] > 1e-6)) bad = 1;
  bad = __syncthreads_or(bad);
  if (tid == 0) *ok = bad ? 0 : 1;
}

}  // namespace

// A: (b, b) f64 equilibrated SPD block (lower triangle read), L, X: (b, b)
// f64 outputs, ok: one int32.  b <= 512, b % 32 == 0.  Returns the launch's
// cudaError_t.
extern "C" int chol_inv_block(const void* A, void* L, void* X, void* ok,
                              int b, void* stream) {
  if (b <= 0 || b > MAXB || b % NB)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t chol = static_cast<size_t>(b) * PS;
  const size_t inv = static_cast<size_t>(NB) * MAXB + NB * PS;
  const size_t smem = (chol > inv ? chol : inv) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      cholinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cholinv_kernel<<<1, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<double*>(L),
      static_cast<double*>(X), static_cast<int*>(ok), b);
  return static_cast<int>(cudaGetLastError());
}
