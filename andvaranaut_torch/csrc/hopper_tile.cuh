// The wgmma slice-product tile for Hopper (sm_90a), used by every slice
// product of the port: K2 (slice_matmul), K4 (mm_sub_pair), K6 and K7
// (syrk_tn_tiled), K8 (syrk_lower, syrk_sub_lower) and K1 and K12
// (syrk_sub_pair) in slicemm.cu and K10 (panel_into_carry) in panel.cu.
//
// One block computes the 64 x 64 int32 group sums G_s = sum_{i+j=s}
// A_i B_j^T of two int8 slice operands over a range of 32-deep k chunks,
// and either combines them in f64 (sum_s G_s 2^-7(s+2), ascending s, the
// plain versions' order) or stores them as int32 for a later combine.
//
// Operands come from slicing.cu in its tiled layout: for a row tile and a
// k chunk, the NS plane tiles (64 rows x 32 bytes each, wgmma's canonical
// K-major layout without swizzle: 8-row x 16-byte core matrices) are one
// contiguous block, so one cp.async.bulk per operand fills a stage.
//
// Block: 160 threads.  Warps 0-3 are the consumer warpgroup, which issues
// wgmma.mma_async m64n64k32 s8 x s8 -> s32 from shared memory for every
// slice pair (i, j) of the pass's order groups.  Warp 4 is the producer:
// one thread keeps a ring of STAGES stages filled with bulk copies, each
// completing on its stage's `full` mbarrier; the consumers release a stage
// on its `empty` mbarrier once the wgmmas reading it have retired
// (wgmma.wait_group 1 keeps one chunk's products in flight).
//
// Registers: a warpgroup's m64n64 s32 accumulator is 32 registers a
// thread.  At NS = 6 all six order groups stay in registers (192) in one
// pass over k; at NS = 8 the groups run in two passes of four (128, plus
// the f64 partial combine, 64), the second pass reading all eight planes.
// Each group sum is exact in int32 (at most 8 x 2^14 x 127^2 < 2^31 for a
// chunk range of at most 2^14), so the order of the products within a
// group does not matter; the f64 combine runs in ascending s.
//
// Shared memory: STAGES x 2 x NS x 2 KB (96 KB at NS = 6, 128 KB at 8), so
// one block per SM.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int TM = 64;                 // output tile rows and columns
constexpr int TKC = 32;                // k chunk: one wgmma's depth in int8
constexpr int PLANE = TM * TKC;        // bytes of one plane tile
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128;         // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
// canonical K-major, no swizzle: the two 16-byte k halves of an 8-row
// group are 128 bytes apart (leading byte offset), 8-row groups 256
// (stride byte offset)
constexpr uint32_t LBO = 128;
constexpr uint32_t SBO = 256;
// tile rows of a group of blocks that walk the tile columns together
// (`rect_tile`, and slicemm.cu's `lower_tile`)
constexpr int GROUP = 16;

__device__ __forceinline__ double group_weight(int s) {
  return __longlong_as_double(static_cast<long long>(1023 - 7 * (s + 2))
                              << 52);
}

template <int NS>
__host__ __device__ constexpr int groups_per_pass() {
  return NS == 8 ? 4 : NS;
}

template <int NS>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(STAGES) * 2 * NS * PLANE + 2 * STAGES * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int q = 0; q < 32; ++q) asm volatile("" : "+r"(d[q])::"memory");
}

// d += A (64 x 32, K-major) * B (64 x 32, K-major)^T, s8 x s8 -> s32
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Row and column, within the 64 x 64 tile, of accumulator register q of
// consumer thread t (the wgmma m64nN D fragment).
__device__ __forceinline__ int acc_row(int t, int q) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + ((q >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int t, int q) {
  return (q >> 2) * 8 + (t & 3) * 2 + (q & 1);
}

// The 64-tile (rt, ct) of block b in an ntr x ntc tile rectangle walked in
// groups of GROUP tile rows that go down the tile columns together, so
// that a wave of blocks shares a few row tiles of the first operand and
// column tiles of the second in L2 instead of streaming all of the second
// per tile row.
__device__ __forceinline__ void rect_tile(int b, int ntr, int ntc, int* rt,
                                          int* ct) {
  const int per_group = GROUP * ntc;
  const int first = (b / per_group) * GROUP;
  const int rows = min(GROUP, ntr - first);
  const int in = b % per_group;
  *rt = first + in % rows;
  *ct = in / rows;
}

// Shared-memory ring and the producer's bulk copies, then the consumers'
// passes over k chunks [kc0, kc1).  a, b: the operands' tiled slices at
// k chunk 0 of their row tiles (chunk kc at + kc * NS * PLANE).  Each
// consumer thread receives, per output element q of its fragment, either
// the f64 combination out[q] (slot == nullptr) or, with slot given, the
// int32 group sums written to slot[s * 4096 + row * 64 + col].  Returns
// false on the producer warp, which the caller lets exit.
template <int NS>
__device__ __forceinline__ bool tile_run(const int8_t* __restrict__ a,
                                         const int8_t* __restrict__ b,
                                         int kc0, int kc1,
                                         double (&out)[32],
                                         int* __restrict__ slot) {
  constexpr int GP = groups_per_pass<NS>();
  constexpr int NPASS = NS / GP;
  constexpr size_t CHUNK = static_cast<size_t>(NS) * PLANE;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(STAGES) * 2 *
                                             CHUNK);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + STAGES * 8;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + st * 8, 1);
      mbar_init(empty0 + st * 8, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= CONSUMERS) {
    if (t == CONSUMERS) {
      int it = 0;
      for (int p = 0; p < NPASS; ++p) {
        const uint32_t bytes = static_cast<uint32_t>((p + 1) * GP * PLANE);
        for (int kc = kc0; kc < kc1; ++kc, ++it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          mbar_wait(empty0 + st * 8, ph ^ 1);
          mbar_expect_tx(full0 + st * 8, 2 * bytes);
          const uint32_t sa = base + static_cast<uint32_t>(st * 2 * CHUNK);
          bulk_load(sa, a + kc * CHUNK, bytes, full0 + st * 8);
          bulk_load(sa + static_cast<uint32_t>(CHUNK), b + kc * CHUNK,
                    bytes, full0 + st * 8);
        }
      }
    }
    return false;
  }

#pragma unroll
  for (int q = 0; q < 32; ++q) out[q] = 0.0;
  int it = 0;
#pragma unroll
  for (int p = 0; p < NPASS; ++p) {
    int acc[GP][32];
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[g][q] = 0;
    int prev = -1;
    for (int kc = kc0; kc < kc1; ++kc, ++it) {
      const int st = it % STAGES;
      mbar_wait(full0 + st * 8, (it / STAGES) & 1);
      const uint32_t sa = base + static_cast<uint32_t>(st * 2 * CHUNK);
      const uint32_t sb = sa + static_cast<uint32_t>(CHUNK);
#pragma unroll
      for (int g = 0; g < GP; ++g) fence_acc(acc[g]);
      wg_fence();
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const uint64_t da = desc(sa + i * PLANE);
#pragma unroll
        for (int j = 0; j < NS - i; ++j) {
          const int g = i + j - p * GP;
          if (g >= 0 && g < GP) wgmma_s8(acc[g], da, desc(sb + j * PLANE));
        }
      }
      wg_commit();
      wg_wait<1>();
#pragma unroll
      for (int g = 0; g < GP; ++g) fence_acc(acc[g]);
      if (prev >= 0) mbar_arrive(empty0 + prev * 8);
      prev = st;
    }
    wg_wait<0>();
#pragma unroll
    for (int g = 0; g < GP; ++g) fence_acc(acc[g]);
    if (prev >= 0) mbar_arrive(empty0 + prev * 8);
    if (slot != nullptr) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        int* sg = slot + static_cast<size_t>(p * GP + g) * TM * TM;
#pragma unroll
        for (int q = 0; q < 32; q += 2)
          *reinterpret_cast<int2*>(sg + acc_row(t, q) * TM + acc_col(t, q)) =
              make_int2(acc[g][q], acc[g][q + 1]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 32; ++q)
#pragma unroll
        for (int g = 0; g < GP; ++g)
          out[q] = __dadd_rn(out[q],
                             __dmul_rn(static_cast<double>(acc[g][q]),
                                       group_weight(p * GP + g)));
    }
  }
  return true;
}

}  // namespace hopper
