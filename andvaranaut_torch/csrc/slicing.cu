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
// maximum gives another exponent whenever the f32 rounding carries), and
// plane i (i = 1..NS) of R = X[r, k] / scale[r] is the i-th base-128 digit
// of R, truncated toward zero: sign(R) floor(|R| 128^i) mod 128 (plane 1
// not reduced).  That is what the plain version's exact f64 steps
// (slicemm.int_slices: R = R * 128, c = trunc(R), plane = c, R = R - c)
// give, so the planes equal slicemm.slice_operand_plain bit for bit.
// Rows past `rows` and columns past k are zero (the zero padding to
// (rows_p, kp)).
//
// The cut works on the f64 bit pattern, with no divide, trunc or f64 to
// int conversion: with |X| = M 2^(x - 1075) (M the 53-bit mantissa with
// its leading bit, x the biased exponent, 1 for subnormals) and scale
// 2^e, floor(|R| 2^(7 NS)) = M >> (1075 + e - x - 7 NS) (a left shift
// where that is negative), and plane i is its 7-bit field i from the top.
// |R| < 0.5 in every row whose scale is not clamped at 2^120, so the field
// fits 7 NS - 1 bits there; a clamped row (max |X| >= 2^119) takes the
// same digits from two shifts, its first plane saturated to int32 before
// the int8 wrap, as the f64 steps' conversion does.
//
// Output layout (slicemm.tile_layout): out[rt][kc][s] is a 2048-byte tile
// of plane s, rows rt*64.., k columns kc*32.., in the canonical K-major
// layout of wgmma without swizzle: 8-row x 16-byte core matrices of 128
// contiguous bytes, the two k halves of an 8-row group next to each other
// (byte (r, b) at ((r/8)*2 + b/16)*128 + (r%8)*16 + b%16).  So the NS
// planes of one (row tile, k chunk) are one contiguous NS*2048-byte block,
// which the product fetches with one bulk copy.
//
// One kernel, one launch a call, no scratch: slice_strip_kernel.  A strip
// of h rows (h = 8, 4, 2 or 1) over all of kp is held on chip while its
// row maxima are taken and its planes cut, so each element is read once
// from device memory.  The strip's depth is split over a thread-block
// cluster of cl CTAs (1..16), kpart columns each, held in shared memory
// as f64 (h x (kpart + 2), 72 KB at most where the plan can, so three
// CTAs share an SM and one strip's loads overlap another's cut).  Each
// CTA takes its part's row maxima, the CTAs exchange them over
// distributed shared memory across one cluster barrier, and each cuts
// its own part.  The host-side plan (gp/slicemm.py slice_plan) picks h,
// cl and kpart: the tallest strip whose part fits 72 KB on the fewest CTAs
// (K5's 16384-deep W^T: h 8 on 16 CTAs of 1024 columns), then doubles
// the cluster while the grid has fewer CTAs than the card's 132 SMs (a
// 1024 x 1024 operand: 128 strips on clusters of 2).
//
// Reads follow the operand's layout: for sk == 1 the 256/h threads of a
// row read along k (contiguous), otherwise the h rows side by side at
// 256/h columns (h * 8 contiguous bytes when sr == 1).  A thread cuts 16
// consecutive columns of one row (the strip read as 16-byte vectors, its
// rows padded by 2 doubles so the reads are free of bank conflicts),
// packs each plane's 16 bytes in registers and writes them as one 16-byte
// vector; the 8 rows of a strip write 128 contiguous bytes a plane.
//
// What bounds it: bytes, 8 read and NS written per element (K2's first
// panel, 15360 x 1024 and 1024 x 1024: 235 MB, 0.070 ms at 3.35 TB/s).
//
// The pair mode (slice_pair_rows: K10's window of the f32-pair carry, K11,
// the finished panel in the same window, and K5, the transposed view of
// the pair-carried L^-1, (Whi^T, Wlo^T), sr == 1): the operand is a view
// of an f32 pair (hi, lo) with one set of strides, its value the exact f64
// sum hi + lo.  The row scales come from the hi plane alone, scale[r] from
// max_k |hi[r, k]|, as the reference (pallas_panel.panel_into_carry) and
// the plain version make them: the maximum of hi + lo could round across
// a power of two in f32 where the maximum of hi does not, and then give
// another scale.  The planes cut (hi + lo) / scale by the same bits.  The
// first zero_rows rows are zero planes (their scales are still written):
// the zero panel rows above row_start that K12's update expects.  This is
// K11 (panel.pair_to_slices), which replaces the Pallas TPU kernel
// pallas_panel.pair_to_slices (_slices_kernel): the reference carried R
// as an f32 pair, whose rounding of hi + lo can move one slice by 1 and
// the next by -128 with the same represented value; the exact cut here
// equals the plain version bit for bit instead.  K5
// (panel.pair_to_slices_cols) replaces pallas_panel.pair_to_slices_cols
// (_slices_cols_kernel) the same way: its scales, the row maxima of the
// hi plane of W^T, are the reference's column scales of W, and its
// planes, cut from W^T, are the tiled operand of K6 (slicemm.cu's tn
// product) for both sides.  It reads 8 bytes and writes 8 an element
// (16384^2: 4.3 GB, 1.28 ms at the card's memory rate).
//
// A batch (slice_rows_batched, Sb: the chains' W[i]^T, K7b's operand) is
// the same kernel with the batch on the grid's y (slice_strip_kernel<NS,
// F64Batch> in a profile, <NS, F64Rows> for S, <NS, PairRows> for SP).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int TR = 64;             // rows of one plane tile
constexpr int TKC = 32;            // k chunk of one plane tile
constexpr int PLANE = TR * TKC;    // bytes of one plane tile
constexpr int NTH = 256;
constexpr int NWARP = NTH / 32;
constexpr int HMAX = 16;           // tallest strip
constexpr int CLMAX = 16;          // largest cluster (8 portable)
// dynamic shared memory a CTA may take: the card's 227 KB less the
// kernel's static arrays
constexpr int SMEM_MAX = 232448 - 2048;

// A strip part's shared memory: h rows of kpart + pad 8-byte elements
// (an f64, or an f32 pair in two planes), pad 2 for f64 and 4 for the
// pair, so the cut's 16-byte reads of 8 rows fall in distinct banks.
__host__ __device__ constexpr long long strip_smem(int h, int kpart,
                                                   int pad) {
  return static_cast<long long>(h) * (kpart + pad) * 8;
}

__device__ __forceinline__ int tile_offset(int r, int b) {
  return (((r >> 3) * 2 + (b >> 4)) << 7) + ((r & 7) << 4) + (b & 15);
}

// The row scale's exponent e (scale 2^e) from the row maximum; *clamped
// where the unclamped exponent passed 120 (then |R| may reach 0.5).
__device__ __forceinline__ int pow2_exp(double mx, bool* clamped) {
  const float m32 = fmaxf(__double2float_rn(mx), 1e-30f);
  const int e = static_cast<int>((__float_as_uint(m32) >> 23) & 0xFF) - 127 + 2;
  *clamped = e > 120;
  return min(max(e, -120), 120);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The operands.  `copy` starts the asynchronous copy of the element at
// offset off to strip element i (of h * P), `zero` clears one, `mag` is
// the magnitude of strip element i that the row scale is taken from, and
// `values` reads 4 consecutive strip elements as the f64 values cut.
struct F64Rows {
  static constexpr int PAD = 2;
  const double* x;
  long long sr, sk;
  __device__ __forceinline__ F64Rows batch(int) const { return *this; }
  __device__ __forceinline__ static void copy(const F64Rows& s, double* st,
                                              int, int i, long long off) {
    cp_async(st + i, s.x + off, 8);
  }
  __device__ __forceinline__ static void zero(double* st, int, int i) {
    st[i] = 0.0;
  }
  __device__ __forceinline__ static double mag(const double* st, int,
                                               int i) {
    return fabs(st[i]);
  }
  __device__ __forceinline__ static void values(const double* st, int,
                                                int i, double (&v)[4]) {
    const double2 a = *reinterpret_cast<const double2*>(st + i);
    const double2 b = *reinterpret_cast<const double2*>(st + i + 2);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
};

// A batch of f64 operands (its own type, so profiles tell Sb from S)
struct F64Batch {
  const double* x;
  long long sr, sk, sb;
  // the operand of batch entry bi (sb: the batch stride in elements)
  __device__ __forceinline__ F64Rows batch(int bi) const {
    return F64Rows{x + static_cast<long long>(bi) * sb, sr, sk};
  }
};

// An f32 pair: held as two f32 planes (hi at the strip's start, lo n
// elements on), the magnitude from hi, the value hi + lo (exact in f64)
struct PairRows {
  static constexpr int PAD = 4;
  const float* hi;
  const float* lo;
  long long sr, sk;
  __device__ __forceinline__ PairRows batch(int) const { return *this; }
  __device__ __forceinline__ static void copy(const PairRows& s, double* st,
                                              int n, int i, long long off) {
    float* f = reinterpret_cast<float*>(st);
    cp_async(f + i, s.hi + off, 4);
    cp_async(f + n + i, s.lo + off, 4);
  }
  __device__ __forceinline__ static void zero(double* st, int n, int i) {
    float* f = reinterpret_cast<float*>(st);
    f[i] = 0.0f;
    f[n + i] = 0.0f;
  }
  __device__ __forceinline__ static double mag(const double* st, int,
                                               int i) {
    return static_cast<double>(fabsf(reinterpret_cast<const float*>(st)[i]));
  }
  __device__ __forceinline__ static void values(const double* st, int n,
                                                int i, double (&v)[4]) {
    const float* f = reinterpret_cast<const float*>(st);
    const float4 h = *reinterpret_cast<const float4*>(f + i);
    const float4 l = *reinterpret_cast<const float4*>(f + n + i);
    v[0] = __dadd_rn(static_cast<double>(h.x), static_cast<double>(l.x));
    v[1] = __dadd_rn(static_cast<double>(h.y), static_cast<double>(l.y));
    v[2] = __dadd_rn(static_cast<double>(h.z), static_cast<double>(l.z));
    v[3] = __dadd_rn(static_cast<double>(h.w), static_cast<double>(l.w));
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// floor(|R| 2^(7 NS)) of R = v / 2^e, for |R| < 0.5 (a row whose scale is
// not clamped): the mantissa shifted into place.  neg: the sign bit.
template <int NS>
__device__ __forceinline__ uint64_t digits(double v, int e, uint32_t* neg) {
  const uint64_t b = static_cast<uint64_t>(__double_as_longlong(v));
  const int x = static_cast<int>(b >> 52) & 0x7FF;
  const uint64_t m =
      (b & 0xFFFFFFFFFFFFFull) | (static_cast<uint64_t>(x != 0) << 52);
  const int sh = 1075 + e - max(x, 1) - 7 * NS;
  *neg = static_cast<uint32_t>(b >> 63);
  // 6 planes: the field is below 2^41 < 2^52, so the shift is to the right
  if (NS * 7 <= 52) return m >> min(sh, 63);
  return sh >= 0 ? m >> min(sh, 63) : m << -sh;
}

// The NS signed plane bytes of R = v / 2^e in a clamped row, where |R| may
// be 0.5 or more: plane 1 is floor(|R| 128) with its sign, saturated to
// int32, then wrapped to int8 (the f64 steps' conversion); planes 2.. are
// the digits below it.
template <int NS>
__device__ __forceinline__ void clamped_bytes(double v, int e,
                                              uint32_t (&byte)[NS]) {
  const uint64_t b = static_cast<uint64_t>(__double_as_longlong(v));
  const int x = static_cast<int>(b >> 52) & 0x7FF;
  const uint64_t m =
      (b & 0xFFFFFFFFFFFFFull) | (static_cast<uint64_t>(x != 0) << 52);
  const bool neg = (b >> 63) != 0;
  const int sh = 1075 + e - max(x, 1) - 7 * NS;
  const int sh1 = sh + 7 * (NS - 1);
  const uint64_t p1 = sh1 >= 64 ? 0ull
                      : sh1 >= 0 ? m >> sh1
                      : sh1 >= -10 ? m << -sh1 : (1ull << 63);
  const uint64_t low = sh >= 64 ? 0ull
                       : sh >= 0 ? m >> sh
                       : sh > -64 ? m << -sh : 0ull;
  int c1;
  if (p1 >= 0x80000000ull)
    c1 = neg ? INT_MIN : INT_MAX;
  else
    c1 = neg ? -static_cast<int>(p1) : static_cast<int>(p1);
  byte[0] = static_cast<uint32_t>(c1) & 0xFFu;
#pragma unroll
  for (int s = 1; s < NS; ++s) {
    const uint32_t p =
        static_cast<uint32_t>(low >> (7 * (NS - 1 - s))) & 127u;
    byte[s] = (neg ? 0u - p : p) & 0xFFu;
  }
}

// Block (x, y): strip x / cl (rows h * (x / cl)..) of batch entry y, its
// columns [part * kpart, min((part + 1) * kpart, kp)), part = x % cl, the
// CTA's rank in its cluster of cl.  lh = log2 h.
template <int NS, class Src>
__global__ void __launch_bounds__(NTH, 3) slice_strip_kernel(
    const Src src_all, int rows, int zero_rows, int k, int rows_p, int kp,
    int lh, int cl, int kpart, double* __restrict__ scale,
    int8_t* __restrict__ out) {
  extern __shared__ __align__(16) double strip[];
  __shared__ double wmax[NWARP][HMAX];
  __shared__ double cmax[HMAX];  // this CTA's row maxima, read by the cluster
  __shared__ int rexp[HMAX];
  __shared__ int rclamp[HMAX];
  const auto src = src_all.batch(blockIdx.y);
  using Op = decltype(src.batch(0));
  scale += static_cast<size_t>(blockIdx.y) * rows;
  out += static_cast<size_t>(blockIdx.y) * rows_p * kp * NS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int h = 1 << lh, T = NTH >> lh;  // T threads a row
  const int part = blockIdx.x % cl;
  const int r0 = (blockIdx.x / cl) << lh;
  const int k0 = part * kpart;
  const int kn = min(kpart, kp - k0);
  const int P = kpart + Op::PAD;  // strip element (r, c) at r * P + c
  const int n = h * P;

  // 1. the strip's part into shared memory (asynchronous copies, all in
  //    flight at once), then each row's maximum
  const bool kmajor = src.sk == 1;
  const int r = kmajor ? t / T : t & (h - 1);
  const int q = kmajor ? t & (T - 1) : t >> lh;
  const int grow = r0 + r;
  const int kl = grow < rows ? min(kn, k - k0) : 0;  // columns with data
  {
    long long off =
        static_cast<long long>(grow) * src.sr + (k0 + q) * src.sk;
    const long long step = static_cast<long long>(T) * src.sk;
    int c = q;
    for (; c < kl; c += T, off += step) Op::copy(src, strip, n, r * P + c, off);
    for (; c < kn; c += T) Op::zero(strip, n, r * P + c);
  }
  cp_async_wait_all();
  __syncthreads();
  double mx = 0.0;
  for (int c = q; c < kl; c += T) mx = fmax(mx, Op::mag(strip, n, r * P + c));
  // lanes that share a row: along k a run of min(T, 32) lanes, else every
  // h-th lane
  const int run = min(T, 32);
  const int olo = kmajor ? 1 : h, ohi = kmajor ? run >> 1 : 16;
  for (int o = ohi; o >= olo; o >>= 1)
    mx = fmax(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  if (kmajor ? (lane & (run - 1)) == 0 : lane < h) wmax[warp][r] = mx;
  __syncthreads();
  double m = 0.0;
  if (t < h) {
    const int w0 = kmajor ? (t * T) >> 5 : 0;
    const int w1 = kmajor ? (((t + 1) * T - 1) >> 5) + 1 : NWARP;
    for (int w = w0; w < w1; ++w) m = fmax(m, wmax[w][t]);
    cmax[t] = m;
  }
  // 2. the row maxima of the whole strip: the cluster's parts
  if (cl > 1) {
    cluster_arrive();
    cluster_wait();
    if (t < h) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int c = 0; c < cl; ++c)
        m = fmax(m, *cluster.map_shared_rank(&cmax[t], c));
    }
    cluster_arrive();  // done with the others' shared memory
  }
  if (t < h) {
    bool clamped;
    const int e = pow2_exp(m, &clamped);
    rexp[t] = e;
    rclamp[t] = clamped;
    if (part == 0 && r0 + t < rows)
      scale[r0 + t] = __longlong_as_double(static_cast<long long>(e + 1023)
                                           << 52);
  }
  __syncthreads();

  // 3. the cut: thread u owns row u % h, columns 16 (u / h).. of the part
  const int nkc = kp / TKC;
  for (int u = t; u < (kn >> 4) << lh; u += NTH) {
    const int ur = u & (h - 1), hk = u >> lh;
    const int gr = r0 + ur;
    const int kk = k0 + 16 * hk;
    uint32_t w[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int g = 0; g < 4; ++g) w[s][g] = 0u;
    if (gr < rows && gr >= zero_rows) {
      const int e = rexp[ur];
      const int i0 = ur * P + 16 * hk;
      if (!rclamp[ur]) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          double v[4];
          Op::values(strip, n, i0 + 4 * g, v);
          uint32_t sg = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t neg;
            const uint64_t d = digits<NS>(v[j], e, &neg);
            sg |= (0u - neg) & (0xFFu << (8 * j));
#pragma unroll
            for (int s = 0; s < NS; ++s)
              w[s][g] |= (static_cast<uint32_t>(d >> (7 * (NS - 1 - s))) &
                          127u) << (8 * j);
          }
          // negate the bytes of the negative elements: every byte is at
          // most 127, so -p = ((p ^ 0x7F) + 1) ^ 0x80 carries nowhere
#pragma unroll
          for (int s = 0; s < NS; ++s)
            w[s][g] = ((w[s][g] ^ (sg & 0x7F7F7F7Fu)) +
                       (sg & 0x01010101u)) ^ (sg & 0x80808080u);
        }
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          double v[4];
          Op::values(strip, n, i0 + 4 * g, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t byte[NS];
            clamped_bytes<NS>(v[j], e, byte);
#pragma unroll
            for (int s = 0; s < NS; ++s) w[s][g] |= byte[s] << (8 * j);
          }
        }
      }
    }
    int8_t* dst = out +
                  (static_cast<size_t>(gr / TR) * nkc + kk / TKC) * NS * PLANE +
                  tile_offset(gr % TR, kk & 16);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      *reinterpret_cast<int4*>(dst + s * PLANE) =
          make_int4(static_cast<int>(w[s][0]), static_cast<int>(w[s][1]),
                    static_cast<int>(w[s][2]), static_cast<int>(w[s][3]));
  }
  if (cl > 1) cluster_wait();  // keep cmax until every CTA has read it
}

bool bad_shape(int rows, int k, int zero_rows, int rows_p, int kp, int ns) {
  return rows <= 0 || k <= 0 || zero_rows < 0 || rows_p % TR ||
         rows_p < rows || kp % TKC || kp < k || (ns != 6 && ns != 8);
}

// The plan: h in {1, 2, 4, 8, 16}, 1 <= cl <= 16, kpart a multiple of 32
// with every part holding columns ((cl - 1) kpart < kp <= cl kpart), the
// strip within shared memory, the grid within its limits.
bool bad_plan(int rows_p, int kp, int h, int cl, int kpart, int nbatch,
              int pad) {
  return (h != 1 && h != 2 && h != 4 && h != 8 && h != 16) || cl < 1 ||
         cl > CLMAX || kpart <= 0 || kpart % TKC ||
         static_cast<long long>(cl) * kpart < kp ||
         static_cast<long long>(cl - 1) * kpart >= kp ||
         strip_smem(h, kpart, pad) > SMEM_MAX ||
         static_cast<long long>(rows_p / h) * cl > INT_MAX || nbatch < 1 ||
         nbatch > 65535;
}

template <int NS, class Src>
int launch_ns(const Src& src, int rows, int k, int zero_rows, int rows_p,
              int kp, int h, int cl, int kpart, int nbatch, int pad,
              double* scale, int8_t* out, cudaStream_t st) {
  auto kernel = slice_strip_kernel<NS, Src>;
  const int smem = static_cast<int>(strip_smem(h, kpart, pad));
  // The dynamic shared memory attribute is set to each launch's own: with
  // a larger one the CUDA runtime refuses a cluster launch
  // (cudaErrorInvalidClusterSize, once the attribute allows more than the
  // cluster's SMs can hold), and a smaller one, left by an earlier call,
  // refuses a launch that needs more.  Set and launch under one lock, so
  // threads launching on one device do not interleave.
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows_p / h) * cl, nbatch);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  int lh = 0;
  while ((1 << lh) < h) ++lh;
  err = cudaLaunchKernelEx(&cfg, kernel, src, rows, zero_rows, k, rows_p, kp,
                           lh, cl, kpart, scale, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <class Src>
int launch(const Src& src, int rows, int k, int zero_rows, int rows_p,
           int kp, int ns, int h, int cl, int kpart, int nbatch, int pad,
           void* scale, void* out, void* stream) {
  if (bad_shape(rows, k, zero_rows, rows_p, kp, ns) ||
      bad_plan(rows_p, kp, h, cl, kpart, nbatch, pad))
    return static_cast<int>(cudaErrorInvalidValue);
  double* S = static_cast<double*>(scale);
  int8_t* O = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ns == 6 ? launch_ns<6>(src, rows, k, zero_rows, rows_p, kp, h, cl,
                                kpart, nbatch, pad, S, O, st)
                 : launch_ns<8>(src, rows, k, zero_rows, rows_p, kp, h, cl,
                                kpart, nbatch, pad, S, O, st);
}

}  // namespace

// Scales and tiled planes of the (rows, k) f64 view at x with element
// strides (sr, sk).  scale: (rows,) f64; out: (rows_p / 64, kp / 32, ns,
// 2048) int8.  rows_p a multiple of 64 and at least rows, kp a multiple
// of 32 and at least k, ns 6 or 8; (h, cl, kpart) the strip plan of
// gp/slicemm.py slice_plan.  One launch.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape or plan it does not
// take, before reading a pointer).
extern "C" int slice_rows(const void* x, long long sr, long long sk,
                          int rows, int k, int rows_p, int kp, int ns, int h,
                          int cl, int kpart, void* scale, void* out,
                          void* stream) {
  const F64Rows src{static_cast<const double*>(x), sr, sk};
  return launch(src, rows, k, 0, rows_p, kp, ns, h, cl, kpart, 1,
                F64Rows::PAD, scale, out, stream);
}

// A batch of nbatch operands in one launch: operand i is the (rows, k)
// view at x + i * sb with element strides (sr, sk), e.g. W[i]^T of a batch
// of tn products.  scale: (nbatch, rows) f64; out: (nbatch, rows_p / 64,
// kp / 32, ns, 2048) int8.  Entry i equals slice_rows on operand i alone.
// 1 <= nbatch <= 65535.
extern "C" int slice_rows_batched(const void* x, long long sb, long long sr,
                                  long long sk, int nbatch, int rows, int k,
                                  int rows_p, int kp, int ns, int h, int cl,
                                  int kpart, void* scale, void* out,
                                  void* stream) {
  const F64Batch src{static_cast<const double*>(x), sr, sk, sb};
  return launch(src, rows, k, 0, rows_p, kp, ns, h, cl, kpart, nbatch,
                F64Rows::PAD, scale, out, stream);
}

// The pair mode: scales (from hi) and tiled planes (of hi + lo) of the
// (rows, k) views at hi and lo, both with element strides (sr, sk); the
// first zero_rows rows give zero planes.  Shapes, plan and the rest as
// slice_rows.
extern "C" int slice_pair_rows(const void* hi, const void* lo, long long sr,
                               long long sk, int rows, int k, int zero_rows,
                               int rows_p, int kp, int ns, int h, int cl,
                               int kpart, void* scale, void* out,
                               void* stream) {
  const PairRows src{static_cast<const float*>(hi),
                     static_cast<const float*>(lo), sr, sk};
  return launch(src, rows, k, zero_rows, rows_p, kp, ns, h, cl, kpart, 1,
                PairRows::PAD, scale, out, stream);
}
