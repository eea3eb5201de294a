// Causal GQA prefill attention over fresh keys and values, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package attends in plain jnp
// (models/layers.py _attn_core), as the port's plain path does, which
// casts q, k and v to float32, builds the whole (S, S) logits of every
// head, masks half of them away and takes two float32 GEMMs over the full
// square.  A prefill from scratch (positions 0..S-1) attends query row s
// of head h to keys t <= s of KV head h / G (G = H / K query heads a KV
// head); left padding is attended like any other position, as on the
// plain path.
//
// Bound by operations: 4 hd FLOPs for each of the S (S + 1) / 2 causal
// (query, key) pairs of a head, 2 B H hd S (S + 1) a call, against bytes of
// O(B S H hd).  Design (FlashAttention on Hopper's asynchronous units): a
// block of two warpgroups for each (tile of 128 query rows, query head,
// row), launched longest tiles first, two blocks an SM.  One thread loads
// the block's Q tile and streams its K and V tiles of 64 keys through a
// two-stage ring in shared memory with the tensor memory accelerator (TMA,
// 128-byte swizzled boxes of 64 columns, rows past S zero-filled), each
// stage completing on an mbarrier; the tile is refilled once every
// warpgroup is done with it.  Each warpgroup takes its 64 rows:
// S = Q K^T with wgmma (m64n64k16, both operands in shared memory, float32
// accumulators), the online softmax in registers, then O += P V with wgmma
// (m64n{hd}k16, P from registers as bf16, V in shared memory read
// transposed).  Key tiles wholly above the diagonal carry zero weight on
// the plain path (its mask value -1e30 underflows exp to 0): the block
// stops at the tile holding its last row, and a warpgroup skips the tiles
// wholly above its own rows.  Only tiles that cross a warp's diagonal are
// masked element by element.
//
// Precision, as the plain path (float32 attention over bf16 inputs): the
// tensor cores multiply the bf16 values exactly and add in float32; the
// logits, the running max, the exponent sums and the P V accumulation are
// float32; the logits are scaled by log2(e) / sqrt(hd) (one fused
// multiply-add with the max) and exponentiated with ex2.approx.  The plain
// path rounds the normalised probabilities to bf16 before P V; the online
// softmax cannot know the final max, so here exp(s - m_tile) is rounded to
// bf16 before P V (as the decode kernel, decode_attention.cu, does), and
// the sums take the unrounded values.

#include <cuda.h>

#include "common.cuh"

namespace {

using repro::pack2;
using repro::smem_u32;
using T = __nv_bfloat16;

constexpr int kGroups = 2;                 // warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kStages = 2;                 // K and V tiles in shared memory
constexpr int kMaxGroup = 16;   // query heads a KV head, as the decode kernel
constexpr float kLog2e = 1.4426950408889634f;

// 2^x, float32 (ex2.approx: 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- mbarriers and the tensor memory accelerator ------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// the barrier's phase completes once `bytes` have landed
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the box of `map` at coordinates (c0, c1, c2, c3) into shared memory at
// dst, counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// -- warpgroup matrix products ------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving register reads or writes across an
// asynchronous product's issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// descriptor of an operand in shared memory in 128-byte-swizzled atoms of
// 8 rows x 128 bytes (1024-byte aligned); lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (+)= A B: m64n64k16, A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B: m64n64k16, A from registers, B from shared memory
// (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: m64n128k16, A from registers, B from shared memory
// (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_n64(o, a, db);
  else
    wgmma_rs_n128(o, a, db);
}

// Shared memory: Q as HALVES boxes of (BM rows x 64 columns), each K and V
// stage as HALVES boxes of (BN rows x 64 columns), 128 bytes a row; then
// the mbarriers (one a stage, one for Q)
template <int HD>
struct Tile {
  static constexpr int BM = 64 * kGroups;    // query rows a block
  static constexpr int BN = 64;              // keys a stage
  static constexpr int HALVES = HD / 64;     // 64-column boxes a row
  static constexpr int TQ = HALVES * BM * 128;
  static constexpr int TKV = HALVES * BN * 128;
  static constexpr int SMEM = 1024 + TQ + 2 * kStages * TKV + 8 * (kStages + 1);
};

// q (B, S, H, hd), k and v (B, S, K, hd), boxes of 64 columns
struct Maps {
  CUtensorMap q, k, v;
};

struct Args {
  T* out;
  int S, H, G, n_tiles, heads;   // heads = B * H
  float scale_log2;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
prefill_attn_wgmma(const __grid_constant__ Maps maps, const Args a) {
  using Tl = Tile<HD>;
  constexpr int BM = Tl::BM, BN = Tl::BN, HALVES = Tl::HALVES;
  constexpr int NT = BN / 8;     // n-tiles of S, 8 keys each
  constexpr int ONT = HD / 8;    // n-tiles of O
  // K-major Q and K: k-steps of 32 bytes inside an atom, atoms of 8 rows
  // 1024 bytes apart (the leading offset is unused); V read MN-major: its
  // 64-column boxes BN * 128 bytes apart, groups of 8 keys 1024 apart
  constexpr uint32_t V_LBO = BN * 128, V_SBO = 1024;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Tl::TQ;                  // [kStages][TKV]
  const uint32_t sv = sk + kStages * Tl::TKV;       // [kStages][TKV]
  const uint32_t bars = sv + kStages * Tl::TKV;     // one a stage
  const uint32_t qbar = bars + 8 * kStages;

  // longest tiles first: block i takes query tile n_tiles - 1 - i / heads
  const int tile = a.n_tiles - 1 - (int)(blockIdx.x / a.heads);
  const int bh = (int)(blockIdx.x % a.heads);
  const int b = bh / a.H, h = bh % a.H, kh = h / a.G;
  const int q0 = tile * BM;
  const int last = min(q0 + BM, a.S) - 1;   // the tile's last valid row
  const int n_kt = last / BN + 1;           // key tiles holding a key <= last
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = q0 + (warp >> 2) * 64;     // the warpgroup's first row
  const int w0 = g0 + (warp & 3) * 16;      // the warp's first row

  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    const uint32_t bar = bars + 8 * st;
    mbar_expect(bar, 2 * Tl::TKV);
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      tma_load(sk + st * Tl::TKV + hf * BN * 128, &maps.k, hf * 64, kt * BN,
               kh, b, bar);
      tma_load(sv + st * Tl::TKV + hf * BN * 128, &maps.v, hf * 64, kt * BN,
               kh, b, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(qbar, Tl::TQ);
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
      tma_load(sq + hf * BM * 128, &maps.q, hf * 64, q0, h, b, qbar);
    for (int kt = 0; kt < min(kStages - 1, n_kt); ++kt) load_kv(kt);
  }
  __syncthreads();

  // C rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3) of the warp's 16, columns
  // 8 j + cq + e % 2, at sc[4 j + e] and o[4 j + e]
  const int r0 = lane >> 2, cq = 2 * (lane & 3);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const uint32_t qg = sq + (warp >> 2) * 64 * 128;   // the warpgroup's rows
  mbar_wait(qbar, 0);

  for (int it = 0; it < n_kt; ++it) {
    // every warpgroup is done with tile it - 1: its stage takes tile
    // it + kStages - 1
    __syncthreads();
    if (threadIdx.x == 0 && it + kStages - 1 < n_kt)
      load_kv(it + kStages - 1);
    const int k0 = it * BN;
    if (k0 > g0 + 63) continue;   // wholly above the warpgroup's rows
    const int st = it % kStages;
    mbar_wait(bars + 8 * st, (it / kStages) & 1);
    const uint32_t tk = sk + st * Tl::TKV, tv = sv + st * Tl::TKV;

    // S = Q K^T
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(qg + (kk / 4) * BM * 128 + off, 16, 1024),
                   sw128_desc(tk + (kk / 4) * BN * 128 + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // keys past a row masked, only where the tile crosses the warp's
    // diagonal
    if (k0 + BN - 1 > w0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + cq + (e & 1) > w0 + r0 + 8 * (e >> 1))
            sc[j * 4 + e] = -INFINITY;
    }
    // the online softmax, the max in log2 units (scale_log2 > 0, so the
    // max of the scaled products is the scaled max)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j * 4 + e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // finite from the first tile on: key 0 is valid for every row
      const float mnew = fmaxf(m[i], mx[i] * a.scale_log2);
      const float alpha = ex2(m[i] - mnew);   // 0 on the first tile
      m[i] = mnew;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < ONT; ++n) {
        o[n * 4 + 2 * i] *= alpha;
        o[n * 4 + 2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j * 4 + e] = ex2(fmaf(sc[j * 4 + e], a.scale_log2, -m[e >> 1]));
        l[e >> 1] += sc[j * 4 + e];
      }

    // O += P V, P rounded to bf16 in the A layout of m64nNk16 (16 keys a
    // k-step)
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      pa[ks][0] = pack2(sc[8 * ks + 0], sc[8 * ks + 1]);
      pa[ks][1] = pack2(sc[8 * ks + 2], sc[8 * ks + 3]);
      pa[ks][2] = pack2(sc[8 * ks + 4], sc[8 * ks + 5]);
      pa[ks][3] = pack2(sc[8 * ks + 6], sc[8 * ks + 7]);
    }
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks)
      wgmma_pv<HD>(o, pa[ks], sw128_desc(tv + ks * 2048, V_LBO, V_SBO));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
  }

  // out (B, S, H, hd), contiguous
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = w0 + r0 + 8 * i;
    if (row >= a.S) continue;
    T* dst = a.out + (((size_t)b * a.S + row) * a.H + h) * HD + cq;
#pragma unroll
    for (int n = 0; n < ONT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n * 4 + 2 * i] / sum,
                                o[n * 4 + 2 * i + 1] / sum);
  }
}

// -- host ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the library
// links no libcuda); null where libcuda lacks it
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &res) == cudaSuccess &&
                   res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, S, N, hd) bf16 tensor with element strides sb, ss, sn, in boxes of
// (rows x 64 columns), 128-byte swizzled; rows past S read as zeros
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int N, int hd,
            long long sb, long long ss, long long sn, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sn * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t run(const Maps& maps, const Args& a, cudaStream_t st) {
  auto kern = prefill_attn_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<HD>::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((long long)a.n_tiles * a.heads), kThreads,
         Tile<HD>::SMEM, st>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H = K * G, hd), k and v (B, S, K, hd), bf16, each with the
// strides given (in elements; the last dimension contiguous, every other
// stride and each base 16-byte aligned); out (B, S, H, hd) contiguous.
// Causal attention of every query row over the keys at or before it.
extern "C" int repro_prefill_attention(
    const void* q, const void* k, const void* v, int B, int S, int H, int K,
    int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, void* out, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < K || H % K != 0 || H / K > kMaxGroup ||
      (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  constexpr int bm = Tile<128>::BM, bn = Tile<128>::BN;
  const long long n_tiles = (S + bm - 1) / bm;
  if (n_tiles * B * H >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!encode(&maps.q, q, B, S, H, hd, q_sb, q_ss, q_sh, bm) ||
      !encode(&maps.k, k, B, S, K, hd, k_sb, k_ss, k_sh, bn) ||
      !encode(&maps.v, v, B, S, K, hd, v_sb, v_ss, v_sh, bn))
    return (int)cudaErrorInvalidValue;
  const Args a{(T*)out, S, H, H / K, (int)n_tiles, B * H, scale * kLog2e};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(hd == 64 ? run<64>(maps, a, st) : run<128>(maps, a, st));
}
