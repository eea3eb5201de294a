// GQA decode attention over the written prefix of a KV cache, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package attends in plain jnp
// (models/layers.py _attn_core), and so did the port's decode step, which
// on the card cast the whole cache to float32 in every layer of every step
// and took a masked softmax over every slot, written or not.  One query row
// a sequence (the decode step) attends over slots [0, n_valid) of its
// cache; query head h reads KV head h / G (G = H / K query heads a KV
// head).  For a linear cache those are the slots 0..pos; for a ring cache
// of S <= window slots they are exactly the slots whose positions the
// masked path leaves valid, and the order of the slots does not matter.
//
// Bound by bytes: every K and V byte of the prefix is read once, 2 * B *
// n_valid * K * hd * sizeof(T) a call, and serves all G query heads of its
// KV head.  Design (flash-decoding): a grid of (split, KV head, row)
// blocks of four warps; a block streams its split's K and V through shared
// memory in tiles of TK slots, three stages deep with cp.async (slots past
// the split's end are zero-filled and masked), and keeps an online softmax
// of its own.  Every warp takes S = Q K^T of the tile for all G <= 16
// query heads on the tensor cores (mma.m16n8k16, bf16 operands, float32
// accumulators; rows G..15 of Q are zero), then P V over a quarter of hd,
// with P taken from S's accumulators in registers.  bf16 caches only: the
// model dtype of every configuration served; other caches keep the plain
// path.  The split length is chosen by the
// wrapper from B * K and n_valid so the grid holds ~16 blocks an SM; with
// more than one split a second launch combines the splits' (m, l, o) in
// float32.
//
// Precision, as the plain path (float32 attention over bf16 storage):
// K, V and q are loaded in their stored type and widened to float32 for
// the products (the tensor cores multiply 16-bit values exactly and add in
// float32); the logits, scale, soft cap, running max, exponent sums, the
// P V accumulation and the combine are float32.  The plain path rounds the
// normalised probabilities to the value type before P V; a split cannot
// know the final max, so here exp(s - m_tile) is rounded to bf16 before
// P V, and the sums take the unrounded values.  expf and tanhf are the accurate library functions.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kMaxGroup = 16;   // query heads a KV head: one m16 tile

template <int HD>
struct Tile {
  static constexpr int TK = HD == 256 ? 32 : 64;   // slots a stage
  static constexpr int ROW = HD + 8;                // padded row, elements
  static constexpr int SMEM = kStages * 2 * TK * ROW * 2;   // bytes, 16-bit
};

using repro::pack2;
using repro::smem_u32;

// 16 bytes from global to shared memory; zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b: m16n8k16, bf16 A row-major, B column-major, float32
// accumulators
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float softcapped(float acc, float scale,
                                            float softcap) {
  float x = acc * scale;
  return softcap > 0.f ? softcap * tanhf(x / softcap) : x;
}

// A block's result for query head g of (row, KV head) bk: the output
// itself when the grid has one split, else the split's unnormalised o
// (float32) and its (m, l).
struct Sink {
  int HD, G, n_splits;
  float* part_o;
  float* part_ml;
  __device__ __forceinline__ size_t head(size_t bk, int split, int g) const {
    return (bk * n_splits + split) * G + g;
  }
};

using T = __nv_bfloat16;

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_mma(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, int S, int K, int G, int n_valid,
                int split_len, float scale, float softcap,
                T* __restrict__ out, Sink sink) {
  constexpr int TK = Tile<HD>::TK, ROW = Tile<HD>::ROW;
  constexpr int KSTEPS = HD / 16;   // k-steps of S = Q K^T
  constexpr int NT = TK / 8;        // n-tiles of S, 8 slots each
  constexpr int DW = HD / kWarps;   // columns of P V a warp
  constexpr int ONT = DW / 8;       // n-tiles of a warp's O
  constexpr int CHUNKS = HD / 8;    // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);   // [kStages][TK][ROW]
  T* sv = sk + kStages * TK * ROW;

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = split * split_len;
  const int t1 = min(t0 + split_len, n_valid);
  const int n_tiles = (t1 - t0 + TK - 1) / TK;
  const size_t slot_stride = (size_t)K * HD;
  const size_t kv0 = ((size_t)b * S * K + kh) * HD;
  const T* kb = k + kv0;
  const T* vb = v + kv0;

  auto load_tile = [&](int tile, int stage) {
    const int base = t0 + tile * TK;
    T* dk = sk + stage * TK * ROW;
    T* dv = sv + stage * TK * ROW;
    for (int c = threadIdx.x; c < TK * CHUNKS; c += kThreads) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const bool ok = base + r < t1;
      const size_t off = (size_t)(ok ? base + r : t0) * slot_stride + col;
      cp_async16(dk + r * ROW + col, kb + off, ok);
      cp_async16(dv + r * ROW + col, vb + off, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // Q as the A operand, rows r0 = lane / 4 and r1 = r0 + 8 (zero past G)
  const int r0 = lane >> 2, cq = 2 * (lane & 3);
  const size_t bk = (size_t)b * K + kh;
  const T* qb = q + bk * G * HD;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1), col = kk * 16 + cq + 8 * (e >> 1);
      qa[kk][e] = row < G ? __ldg(reinterpret_cast<const unsigned*>(
                                qb + row * HD + col))
                          : 0u;
    }
  }

  float m[2] = {-INFINITY, -INFINITY};   // running max of rows r0, r1
  float l[2] = {0.f, 0.f};               // this thread's part of the sums
  float o[ONT][4];
#pragma unroll
  for (int n = 0; n < ONT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile it has landed; stage (it - 1) is free
    {
      const int nx = it + kStages - 1;
      if (nx < n_tiles) load_tile(nx, nx % kStages);
      cp_async_commit();
    }
    const T* tk = sk + (it % kStages) * TK * ROW;
    const T* tv = sv + (it % kStages) * TK * ROW;

    // S = Q K^T: C rows r0 (e = 0, 1) and r1 (e = 2, 3), slot j*8 + cq + e%2
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, tk + (j * 8 + (lane & 7)) * ROW + kk * 16 + (lane >> 3) * 8);
        mma16816(sc[j], qa[kk], kf[0], kf[1]);
        mma16816(sc[j], qa[kk + 1], kf[2], kf[3]);
      }
    }

    const int base = t0 + it * TK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = base + j * 8 + cq + (e & 1) < t1;
        sc[j][e] = ok ? softcapped(sc[j][e], scale, softcap) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = expf(m[i] - mx[i]);   // 0 on the first tile
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < ONT; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // P, rounded to T, as the A operand of P V (16 slots a k-step)
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = expf(sc[j][0] - m[0]), p1 = expf(sc[j][1] - m[0]);
      const float p2 = expf(sc[j][2] - m[1]), p3 = expf(sc[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack2(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack2(p2, p3);
    }

    // O += P V over this warp's columns
    const int mi = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks)
#pragma unroll
      for (int n = 0; n < ONT; n += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, tv + (ks * 16 + (lane & 7) + (mi & 1) * 8) * ROW +
                          warp * DW + n * 8 + (mi >> 1) * 8);
        mma16816(o[n], pa[ks], vf[0], vf[1]);
        mma16816(o[n + 1], pa[ks], vf[2], vf[3]);
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int g = r0 + 8 * i;
    if (g >= G) continue;
    const int col = warp * DW + cq;
    if (sink.n_splits == 1) {
      T* dst = out + (bk * G + g) * HD + col;
#pragma unroll
      for (int n = 0; n < ONT; ++n) {
        dst[n * 8] = __float2bfloat16_rn(o[n][2 * i] / l[i]);
        dst[n * 8 + 1] = __float2bfloat16_rn(o[n][2 * i + 1] / l[i]);
      }
    } else {
      const size_t h = sink.head(bk, split, g);
      float* dst = sink.part_o + h * HD + col;
#pragma unroll
      for (int n = 0; n < ONT; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (warp == 0 && (lane & 3) == 0)
        *reinterpret_cast<float2*>(sink.part_ml + 2 * h) =
            make_float2(m[i], l[i]);
    }
  }
}

// -- the splits' combine ----------------------------------------------------

// a block a (row, KV head, query head), a thread a column
__global__ void __launch_bounds__(256)
combine_splits(Sink sink, T* __restrict__ out) {
  const size_t bk = blockIdx.x;
  const int g = blockIdx.y, d = threadIdx.x;
  const int G = sink.G, HD = sink.HD, n = sink.n_splits;
  const size_t h0 = sink.head(bk, 0, g);   // split s: h0 + s * G
  const float* ml = sink.part_ml + 2 * h0;
  const float* po = sink.part_o + h0 * HD + d;
  float mmax = -INFINITY;
  for (int s = 0; s < n; ++s) mmax = fmaxf(mmax, ml[2 * s * G]);
  float den = 0.f, num = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float w = expf(ml[2 * s * G] - mmax);
    den += w * ml[2 * s * G + 1];
    num += w * po[(size_t)s * G * HD];
  }
  out[(bk * G + g) * HD + d] = __float2bfloat16_rn(num / den);
}

template <int HD>
cudaError_t run_mma(const void* q, const void* k, const void* v, int B,
                    int S, int K, int G, int n_valid, int split_len,
                    float scale, float softcap, void* out, Sink sink,
                    cudaStream_t st) {
  auto kern = decode_attn_mma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<HD>::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(sink.n_splits, K, B), kThreads, Tile<HD>::SMEM, st>>>(
      (const T*)q, (const T*)k, (const T*)v, S, K, G, n_valid, split_len,
      scale, softcap, (T*)out, sink);
  return cudaGetLastError();
}

}  // namespace

// q (B, H = K * G, hd), k and v (B, S, K, hd) contiguous, all bf16; out
// (B, H, hd).  Slots [0, n_valid) are attended, in n_splits splits of
// split_len slots (a multiple of the tile: 32 at hd 256, else 64).  With
// more than one split, part_o holds B * K * n_splits * G * hd float32 and
// part_ml twice B * K * n_splits * G; with one they may be null.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, int B, int S, int K,
                                      int G, int hd, int n_valid,
                                      int split_len, int n_splits,
                                      float scale, float softcap, void* out,
                                      void* part_o, void* part_ml,
                                      void* stream) {
  const int tk = hd == 256 ? 32 : 64;
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || G < 1 || G > kMaxGroup ||
      (hd != 64 && hd != 128 && hd != 256) || n_valid < 1 || n_valid > S ||
      split_len < tk || split_len % tk != 0 ||
      n_splits != (n_valid + split_len - 1) / split_len ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Sink sink{hd, G, n_splits, (float*)part_o, (float*)part_ml};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (hd) {
    case 64: err = run_mma<64>(q, k, v, B, S, K, G, n_valid, split_len, scale, softcap, out, sink, st); break;
    case 128: err = run_mma<128>(q, k, v, B, S, K, G, n_valid, split_len, scale, softcap, out, sink, st); break;
    default: err = run_mma<256>(q, k, v, B, S, K, G, n_valid, split_len, scale, softcap, out, sink, st); break;
  }
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  combine_splits<<<dim3((unsigned)(B * K), G), hd, 0, st>>>(sink, (T*)out);
  return (int)cudaGetLastError();
}
