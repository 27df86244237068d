// Operand slicing on the card, shared by K1, K2, K4, K7 and K8
// (slicemm.cu), K10 (panel.cu) and, in its pair mode, K5 (whose slices K6
// reads) and K11 (whose slices K12 reads): the exact power-of-two scales
// of the rows of an f64 matrix and its NS int8 mantissa planes, written in
// the tiled layout that hopper_tile.cuh's product streams into shared
// memory.
//
// It replaces the PyTorch passes that made the slices in the wrappers (the
// work XLA did outside the Pallas kernels in andvaranaut_tpu:
// precision._pow2_row_scales and precision._int_slices): one launch per
// operand where there were ~30 elementwise passes.
//
// The operand is X, a (rows, k) view with element strides (sr, sk), read
// in place: A[r0:] (sk = 1), B^T for the second operand of A B (sr = 1
// when B is contiguous), W^T for W^T W, L[lo:hi, :lo].T, L[hi:, lo:hi].
// Per row r of X:
//   scale[r] = 2^e, e = (exponent bits of f32(max_k |X[r, k]|), clamped
//              below at 1e-30) - 127 + 2, clamped to [-120, 120]
// (the f32 rounding first, as the plain version does: frexp of the f64
// maximum gives another exponent whenever the f32 rounding carries), then
// R = X[r, k] / scale[r] (exact: a power of two) and NS times
//   R = R * 128, c = trunc(R), plane_s = c, R = R - c
// in f64, every step exact, so the planes equal the plain version
// (slicemm.slice_operand_plain) bit for bit.  Rows past `rows` and
// columns past k are zero (the zero padding to (rows_p, kp)).
//
// Output layout (slicemm.tile_layout): out[rt][kc][s] is a 2048-byte tile
// of plane s, rows rt*64.., k columns kc*32.., in the canonical K-major
// layout of wgmma without swizzle: 8-row x 16-byte core matrices of 128
// contiguous bytes, the two k halves of an 8-row group next to each other
// (byte (r, b) at ((r/8)*2 + b/16)*128 + (r%8)*16 + b%16).  So the NS
// planes of one (row tile, k chunk) are one contiguous NS*2048-byte block,
// which the product fetches with one bulk copy.
//
// Two kernels, launched by one C call.  The first takes the row maxima of
// 64-row x 256-column blocks into a (ceil(k / 256), rows_p) scratch; the
// second, one 256-thread block for 64 rows and four 32-deep chunks, reduces
// its rows' maxima to the scales, cuts each 64 x 32 tile into the NS plane
// tiles in shared memory and writes them out as 16-byte vectors.  The
// reads follow the operand's layout: for sk == 1, four threads share a
// row and read 32 contiguous bytes; otherwise 64 threads read 64
// consecutive rows at one k (coalesced when sr == 1).  Both grids give
// every SM work at the operands' sizes (W^T at n = 1000 is 16 row tiles
// but 128 slice blocks).
//
// What bounds it: bytes, 8 read and NS written per element (at K2's first
// panel 126 MB and 94 MB, ~0.07 ms at 3.35 TB/s).  The slice pass reads X
// a second time, from L2 where it still holds the rows.
//
// A batch (slice_rows_batched, Sb: the chains' W[i]^T, K7b's operand) up to
// kp 1504 runs one kernel instead, slice_rows_once_kernel: a block holds 16
// rows of one operand over all of k in shared memory, so the operand is
// read once and there is no scratch.  At the chains' sizes (8-64 operands
// of 256^2-512^2) it runs at 40-75 % of its bytes bound; the 16-row strips
// give every SM blocks at 8 operands of 256^2 (128 blocks).
//
// The pair mode (slice_pair_rows: K10's window of the f32-pair carry, K11,
// the finished panel in the same window, and K5, the transposed view of
// the pair-carried L^-1, (Whi^T, Wlo^T), sr == 1):
// the operand is a view of an f32 pair (hi, lo) with one set of strides,
// its value the exact f64 sum hi + lo.  The row scales come from the hi
// plane alone, scale[r] from max_k |hi[r, k]|, as the reference
// (pallas_panel.panel_into_carry) and the plain version make them: the
// maximum of hi + lo could round across a power of two in f32 where the
// maximum of hi does not, and then give another scale.  The planes cut
// (hi + lo) / scale by the same exact steps.  The first zero_rows rows are
// zero planes (their scales are still written): the zero panel rows above
// row_start that K12's update expects.  This is K11
// (panel.pair_to_slices), which replaces the Pallas TPU kernel
// pallas_panel.pair_to_slices (_slices_kernel): the reference carried R as
// an f32 pair, whose rounding of hi + lo can move one slice by 1 and the
// next by -128 with the same represented value; the f64 steps here equal
// the plain version bit for bit instead.  K5 (panel.pair_to_slices_cols)
// replaces pallas_panel.pair_to_slices_cols (_slices_cols_kernel) the same
// way: its scales, the row maxima of the hi plane of W^T, are the
// reference's column scales of W, and its planes, cut from W^T, are the
// tiled operand of K6 (slicemm.cu's tn product) for both sides.  It reads
// 8 bytes and writes 8 an element (16384^2: 4.3 GB, 1.28 ms at the card's
// memory rate), and the hi plane a second time for the row maxima.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;             // rows a block owns
constexpr int TKC = 32;            // k chunk of one plane tile
constexpr int PLANE = TR * TKC;    // bytes of one plane tile
constexpr int NTH = 256;

__device__ __forceinline__ int tile_offset(int r, int b) {
  return (((r >> 3) * 2 + (b >> 4)) << 7) + ((r & 7) << 4) + (b & 15);
}

__device__ __forceinline__ double pow2_scale(double mx) {
  float m32 = fmaxf(__double2float_rn(mx), 1e-30f);
  int e = static_cast<int>((__float_as_uint(m32) >> 23) & 0xFF) - 127 + 2;
  e = min(max(e, -120), 120);
  return static_cast<double>(
      __uint_as_float(static_cast<unsigned>(e + 127) << 23));
}

constexpr int KA = 256;          // columns of one row-maximum block
constexpr int KCB = 4;           // 32-deep chunks of one slice block

// The operand's element (r, k): `mag` the magnitude its row scale is taken
// from, `value` the f64 value that is sliced.
struct F64Rows {
  const double* x;
  long long sr, sk, sb;
  // the operand of batch entry bi (sb: the batch stride in elements)
  __device__ __forceinline__ F64Rows batch(int bi) const {
    return F64Rows{x + static_cast<long long>(bi) * sb, sr, sk, sb};
  }
  __device__ __forceinline__ double mag(int r, int k) const {
    return fabs(x[static_cast<long long>(r) * sr +
                  static_cast<long long>(k) * sk]);
  }
  __device__ __forceinline__ double value(int r, int k) const {
    return x[static_cast<long long>(r) * sr + static_cast<long long>(k) * sk];
  }
};

// An f32 pair: the scale from the hi plane, the value hi + lo (exact in f64)
struct PairRows {
  const float* hi;
  const float* lo;
  long long sr, sk;
  __device__ __forceinline__ PairRows batch(int) const { return *this; }
  __device__ __forceinline__ double mag(int r, int k) const {
    return fabs(static_cast<double>(
        hi[static_cast<long long>(r) * sr + static_cast<long long>(k) * sk]));
  }
  __device__ __forceinline__ double value(int r, int k) const {
    const long long i =
        static_cast<long long>(r) * sr + static_cast<long long>(k) * sk;
    return __dadd_rn(static_cast<double>(hi[i]), static_cast<double>(lo[i]));
  }
};

// Thread t's row in a 64-row block and its first column offset: four
// threads a row along k when the operand is k-contiguous, else 64 rows
// side by side at four columns.
__device__ __forceinline__ void thread_slot(bool kmajor, int t, int* r,
                                            int* q) {
  *r = kmajor ? t >> 2 : t & (TR - 1);
  *q = kmajor ? t & 3 : t >> 6;
}

// A batch of operands runs on the grid's z: entry z reads src.batch(z) and
// owns the z-th slab of partial (gridDim.y x rows_p), of scale (rows) and
// of out ((rows_p / 64) x (kp / 32) plane-tile groups).
template <class Src>
__global__ void __launch_bounds__(NTH) row_amax_kernel(
    const Src src_all, int rows, int k, int rows_p,
    double* __restrict__ partial) {
  __shared__ double part[4][TR];
  const Src src = src_all.batch(blockIdx.z);
  partial += static_cast<size_t>(blockIdx.z) * gridDim.y * rows_p;
  int r, q;
  thread_slot(src.sk == 1, threadIdx.x, &r, &q);
  const int grow = blockIdx.x * TR + r;
  const int k0 = blockIdx.y * KA;
  const int k1 = min(k0 + KA, k);
  double mx = 0.0;
  if (grow < rows) {
#pragma unroll 8
    for (int kk = k0 + q; kk < k1; kk += 4) mx = fmax(mx, src.mag(grow, kk));
  }
  part[q][r] = mx;
  __syncthreads();
  if (threadIdx.x < TR) {
    const int t = threadIdx.x;
    partial[static_cast<size_t>(blockIdx.y) * rows_p + blockIdx.x * TR + t] =
        fmax(fmax(part[0][t], part[1][t]), fmax(part[2][t], part[3][t]));
  }
}

template <int NS, class Src>
__global__ void __launch_bounds__(NTH) slice_rows_kernel(
    const Src src_all, int rows, int zero_rows, int k, int rows_p, int kp,
    const double* __restrict__ partial, int nsplit,
    double* __restrict__ scale, int8_t* __restrict__ out) {
  __shared__ double rscale[TR];
  __shared__ __align__(16) int8_t tile[NS * PLANE];
  const Src src = src_all.batch(blockIdx.z);
  partial += static_cast<size_t>(blockIdx.z) * nsplit * rows_p;
  scale += static_cast<size_t>(blockIdx.z) * rows;
  out += static_cast<size_t>(blockIdx.z) * rows_p * kp * NS;
  const int t = threadIdx.x;
  if (t < TR) {
    const int gr = blockIdx.x * TR + t;
    double m = 0.0;
    for (int i = 0; i < nsplit; ++i)
      m = fmax(m, partial[static_cast<size_t>(i) * rows_p + gr]);
    const double s = pow2_scale(m);
    rscale[t] = gr < rows ? s : 1.0;
    if (gr < rows && blockIdx.y == 0) scale[gr] = s;
  }
  __syncthreads();
  int r, q;
  thread_slot(src.sk == 1, t, &r, &q);
  const int grow = blockIdx.x * TR + r;
  const bool live = grow < rows && grow >= zero_rows;
  const double rs = rscale[r];
  const int nkc = kp / TKC;
  int4* dst = reinterpret_cast<int4*>(
      out + static_cast<size_t>(blockIdx.x) * nkc * NS * PLANE);
  const int4* src4 = reinterpret_cast<const int4*>(tile);
  const int kc1 = min(static_cast<int>(blockIdx.y + 1) * KCB, nkc);
  for (int kc = blockIdx.y * KCB; kc < kc1; ++kc) {
    double v[TKC / 4];
#pragma unroll
    for (int j = 0; j < TKC / 4; ++j) {
      const int kk = kc * TKC + q + 4 * j;
      v[j] = live && kk < k ? src.value(grow, kk) : 0.0;
    }
#pragma unroll
    for (int j = 0; j < TKC / 4; ++j) {
      double R = __ddiv_rn(v[j], rs);
      const int off = tile_offset(r, q + 4 * j);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        R = __dmul_rn(R, 128.0);
        const double c = trunc(R);
        tile[s * PLANE + off] = static_cast<int8_t>(static_cast<int>(c));
        R = __dsub_rn(R, c);
      }
    }
    __syncthreads();
    for (int v4 = t; v4 < NS * PLANE / 16; v4 += NTH)
      dst[static_cast<size_t>(kc) * NS * PLANE / 16 + v4] = src4[v4];
    __syncthreads();
  }
}

// The one-read form of a batch (slice_rows_batched): block (x, y) owns
// rows RO x.. of operand y over all of k.  It reads them once into shared
// memory (kp x (RO + 1) f64, zeros past rows and k), takes the row maxima
// and scales from there, then cuts each 16-deep half chunk of a row into
// its NS plane bytes (the same exact steps as slice_rows_kernel; R = v *
// (1 / s) equals v / s, s a power of two) and writes them to the tiled
// layout as 16-byte vectors.  One read of the operand and one write of the
// planes, no scratch.
constexpr int RO = 16;
constexpr int RO_P = RO + 1;
constexpr int RO_MAX_KP = 1504;  // the strip within ~200 KB of shared memory

__host__ __device__ constexpr size_t once_smem(int kp) {
  return static_cast<size_t>(kp) * RO_P * sizeof(double);
}

template <int NS>
__global__ void __launch_bounds__(NTH) slice_rows_once_kernel(
    const F64Rows src_all, int rows, int k, int rows_p, int kp,
    double* __restrict__ scale, int8_t* __restrict__ out) {
  extern __shared__ double strip[];  // element (kk, r) at kk * RO_P + r
  __shared__ double red[NTH];
  __shared__ double rinv[RO];
  const F64Rows src = src_all.batch(blockIdx.y);
  scale += static_cast<size_t>(blockIdx.y) * rows;
  out += static_cast<size_t>(blockIdx.y) * rows_p * kp * NS;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * RO;
  const int n = RO * kp;
  // the strip, 8 loads in flight a thread: rows side by side at one k
  // (coalesced when sr == 1), or along k when the operand is k-contiguous
  const bool kmajor = src.sk == 1;
  for (int e0 = t; e0 < n; e0 += 8 * NTH) {
    double v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = e0 + j * NTH;
      const int r = kmajor ? e / kp : e % RO;
      const int kk = kmajor ? e - r * kp : e / RO;
      v[j] = e < n && r0 + r < rows && kk < k ? src.value(r0 + r, kk) : 0.0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = e0 + j * NTH;
      const int r = kmajor ? e / kp : e % RO;
      const int kk = kmajor ? e - r * kp : e / RO;
      if (e < n) strip[kk * RO_P + r] = v[j];
    }
  }
  __syncthreads();
  {
    const int r = t % RO;
    double mx = 0.0;
    for (int kk = t / RO; kk < k; kk += NTH / RO)
      mx = fmax(mx, fabs(strip[kk * RO_P + r]));
    red[t] = mx;
  }
  __syncthreads();
  if (t < RO) {
    double mx = 0.0;
    for (int j = 0; j < NTH / RO; ++j) mx = fmax(mx, red[j * RO + t]);
    const double s = pow2_scale(mx);
    const int gr = r0 + t;
    rinv[t] = gr < rows ? 1.0 / s : 1.0;  // exact: a power of two
    if (gr < rows) scale[gr] = s;
  }
  __syncthreads();
  const int nkc = kp / TKC;
  int8_t* base = out + static_cast<size_t>(r0 / TR) * nkc * NS * PLANE;
  for (int u = t; u < RO * (kp / 16); u += NTH) {
    const int r = u % RO, hk = u / RO;
    const double inv = rinv[r];
    uint32_t w[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) w[s][g] = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      double R = __dmul_rn(strip[(16 * hk + j) * RO_P + r], inv);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        R = __dmul_rn(R, 128.0);
        const double c = trunc(R);
        w[s][j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                            static_cast<int8_t>(static_cast<int>(c))))
                        << (8 * (j & 3));
        R = __dsub_rn(R, c);
      }
    }
    int8_t* dst = base + static_cast<size_t>(hk >> 1) * NS * PLANE +
                  tile_offset(r0 % TR + r, 16 * (hk & 1));
#pragma unroll
    for (int s = 0; s < NS; ++s)
      *reinterpret_cast<int4*>(dst + s * PLANE) =
          make_int4(static_cast<int>(w[s][0]), static_cast<int>(w[s][1]),
                    static_cast<int>(w[s][2]), static_cast<int>(w[s][3]));
  }
}

template <int NS>
int launch_once(const F64Rows& src, int rows, int k, int rows_p, int kp,
                void* scale, void* out, int nbatch, cudaStream_t st) {
  const size_t smem = once_smem(kp);
  if (cudaFuncSetAttribute(slice_rows_once_kernel<NS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(once_smem(RO_MAX_KP))) !=
      cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  slice_rows_once_kernel<NS><<<dim3(rows_p / RO, nbatch), NTH, smem, st>>>(
      src, rows, k, rows_p, kp, static_cast<double*>(scale),
      static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int rows, int k, int zero_rows, int rows_p, int kp, int ns) {
  return rows <= 0 || k <= 0 || zero_rows < 0 || rows_p % TR ||
         rows_p < rows || kp % TKC || kp < k || (ns != 6 && ns != 8);
}

template <class Src>
int launch(const Src& src, int rows, int k, int zero_rows, int rows_p,
           int kp, int ns, void* scale, void* out, void* partial,
           void* stream, int nbatch = 1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* S = static_cast<double*>(scale);
  int8_t* O = static_cast<int8_t*>(out);
  double* P = static_cast<double*>(partial);
  const int nsplit = (k + KA - 1) / KA;
  row_amax_kernel<Src><<<dim3(rows_p / TR, nsplit, nbatch), NTH, 0, st>>>(
      src, rows, k, rows_p, P);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid(rows_p / TR, (kp / TKC + KCB - 1) / KCB, nbatch);
  if (ns == 6)
    slice_rows_kernel<6, Src><<<grid, NTH, 0, st>>>(
        src, rows, zero_rows, k, rows_p, kp, P, nsplit, S, O);
  else
    slice_rows_kernel<8, Src><<<grid, NTH, 0, st>>>(
        src, rows, zero_rows, k, rows_p, kp, P, nsplit, S, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scales and tiled planes of the (rows, k) f64 view at x with element
// strides (sr, sk).  scale: (rows,) f64; out: (rows_p / 64, kp / 32, ns,
// 2048) int8; partial: (ceil(k / 256), rows_p) f64 scratch.  rows_p a
// multiple of 64 and at least rows, kp a multiple of 32 and at least k,
// ns 6 or 8.  Launches the row-maximum and the slice kernels.  Returns
// cudaGetLastError().
extern "C" int slice_rows(const void* x, long long sr, long long sk,
                          int rows, int k, int rows_p, int kp, int ns,
                          void* scale, void* out, void* partial,
                          void* stream) {
  if (bad_shape(rows, k, 0, rows_p, kp, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const F64Rows src{static_cast<const double*>(x), sr, sk, 0};
  return launch(src, rows, k, 0, rows_p, kp, ns, scale, out, partial,
                stream);
}

// A batch of nbatch operands in one call: operand i is the (rows, k) view
// at x + i * sb with element strides (sr, sk), e.g. W[i]^T of a batch of
// tn products.  scale: (nbatch, rows) f64; out: (nbatch, rows_p / 64, kp /
// 32, ns, 2048) int8; partial: (nbatch, ceil(k / 256), rows_p) f64 scratch,
// used only when kp > 1504.  Up to that depth one launch of the one-read
// kernel, else the row-maximum and slice kernels.  Entry i equals
// slice_rows on operand i alone.  1 <= nbatch <= 65535.
extern "C" int slice_rows_batched(const void* x, long long sb, long long sr,
                                  long long sk, int nbatch, int rows, int k,
                                  int rows_p, int kp, int ns, void* scale,
                                  void* out, void* partial, void* stream) {
  if (bad_shape(rows, k, 0, rows_p, kp, ns) || nbatch < 1 || nbatch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const F64Rows src{static_cast<const double*>(x), sr, sk, sb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp <= RO_MAX_KP)
    return ns == 6 ? launch_once<6>(src, rows, k, rows_p, kp, scale, out,
                                    nbatch, st)
                   : launch_once<8>(src, rows, k, rows_p, kp, scale, out,
                                    nbatch, st);
  return launch(src, rows, k, 0, rows_p, kp, ns, scale, out, partial, stream,
                nbatch);
}

// The pair mode: scales (from hi) and tiled planes (of hi + lo) of the
// (rows, k) views at hi and lo, both with element strides (sr, sk); the
// first zero_rows rows give zero planes.  Shapes and the rest as
// slice_rows.
extern "C" int slice_pair_rows(const void* hi, const void* lo, long long sr,
                               long long sk, int rows, int k, int zero_rows,
                               int rows_p, int kp, int ns, void* scale,
                               void* out, void* partial, void* stream) {
  if (bad_shape(rows, k, zero_rows, rows_p, kp, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairRows src{static_cast<const float*>(hi),
                     static_cast<const float*>(lo), sr, sk};
  return launch(src, rows, k, zero_rows, rows_p, kp, ns, scale, out, partial,
                stream);
}
