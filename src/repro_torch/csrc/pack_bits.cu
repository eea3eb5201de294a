// Bit-pack of quantizer indices to the wire width for Hopper (sm_90a).
//
// Replaces the Pallas kernel pack_bits._kernel (pack_rows_2d), the packed
// split-runtime transport's pack where the quantizer does not pack itself
// (per-channel codecs; the per-tensor quantizer #1 packs inside its own
// launch, repro_clip_quant_pack).  The TPU kernel took an (8, n_bytes)
// "lane view" -- row j holding the j-th index of every output byte, rows
// per..8 zero, columns padded to a 1024 multiple -- because a sublane tile
// is 8 rows of int32, and combined the rows with shift+adds.  Here the
// kernel packs the flat tensor in its own layout: no padded copy, no
// transpose.  Byte k holds index k * per + j at bit offset j * bits
// (little-end-first lanes); the last byte is zero-padded.
//
// The lanes are summed, not OR-ed, and the low byte kept, as the
// reference's int32 shift+add followed by astype(uint8) does, so an index
// outside [0, 2^bits) gives the reference's byte too.  The sum runs in
// unsigned arithmetic: its low byte is that of the int32 sum, and a
// negative index shifts without undefined behaviour.
//
// Bound by bytes: 4 B read per index, 1 / per B written.  A thread makes
// four consecutive bytes and stores them as one 32-bit word, from its
// 4 * per indices read as 16-byte vectors (two at 4 bits, four at 2, eight
// at 1), so each thread keeps 32-128 B of loads in flight; a scalar path
// -- one byte a thread, the same bytes -- takes buffers that are not
// aligned and the tail past the last whole word.  At the split runtime's
// decode boundary (16,384 indices) the call is bound by its launch, not
// by its ~70 KB.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
pack_bits_kernel(const int* __restrict__ idx, long long n, long long n_words,
                 long long n_out, unsigned char* __restrict__ out) {
  constexpr int PER = 8 / BITS;
  constexpr int V = 4 * PER;                  // indices of one word
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_words) {
    const int4* src = reinterpret_cast<const int4*>(idx) + k * (V / 4);
    int q[V];
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      int4 a = __ldg(src + h);
      q[4 * h] = a.x;
      q[4 * h + 1] = a.y;
      q[4 * h + 2] = a.z;
      q[4 * h + 3] = a.w;
    }
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      unsigned acc = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) acc += (unsigned)q[b * PER + j] << (j * BITS);
      word |= (acc & 0xFFu) << (8 * b);
    }
    reinterpret_cast<unsigned*>(out)[k] = word;
    return;
  }
  const long long byte = n_words * 4 + (k - n_words);
  if (byte >= n_out) return;
  unsigned acc = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const long long i = byte * PER + j;
    if (i < n) acc += (unsigned)__ldg(&idx[i]) << (j * BITS);
  }
  out[byte] = (unsigned char)(acc & 0xFFu);
}

}  // namespace

extern "C" int repro_pack_bits(const void* idx, long long n, int bits,
                               void* out, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || (bits != 1 && bits != 2 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const int per = 8 / bits;
  const long long n_out = (n + per - 1) / per;
  const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const long long n_words = vec ? n / (4 * per) : 0;
  const long long threads = n_words + (n_out - n_words * 4);
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const int* in = (const int*)idx;
  unsigned char* o = (unsigned char*)out;
  switch (bits) {
    case 1: pack_bits_kernel<1><<<blocks, kThreads, 0, s>>>(in, n, n_words, n_out, o); break;
    case 2: pack_bits_kernel<2><<<blocks, kThreads, 0, s>>>(in, n, n_words, n_out, o); break;
    default: pack_bits_kernel<4><<<blocks, kThreads, 0, s>>>(in, n, n_words, n_out, o); break;
  }
  return (int)cudaGetLastError();
}
