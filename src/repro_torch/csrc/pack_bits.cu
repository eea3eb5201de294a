// Bit-pack of quantizer indices to the wire width for Hopper (sm_90a).
//
// Replaces the Pallas kernel pack_bits._kernel (pack_rows_2d), the packed
// split-runtime transport's pack.  The TPU kernel took an (8, n_bytes)
// "lane view" -- row j holding the j-th index of every output byte, rows
// per..8 zero, columns padded to a 1024 multiple -- because a sublane tile
// is 8 rows of int32, and combined the rows with shift+adds.  Here one
// thread makes one output byte from the per = 8 / bits consecutive indices
// of the flat tensor that it packs, in the tensor's own layout: no padded
// copy, no transpose.  Byte k holds index k * per + j at bit offset
// j * bits (little-end-first lanes); the last byte is zero-padded.
//
// The lanes are summed, not OR-ed, and the low byte kept, as the
// reference's int32 shift+add followed by astype(uint8) does, so an index
// outside [0, 2^bits) gives the reference's byte too.  The sum runs in
// unsigned arithmetic: its low byte is that of the int32 sum, and a
// negative index shifts without undefined behaviour.
//
// Bound by bytes: 4 B read per index, 1 / per B written.  Neighbouring
// threads read neighbouring runs of per indices, so a warp's loads cover
// 32 * per consecutive int32 in per coalesced passes.  At the split
// runtime's decode boundary (16,384 indices) the call is bound by its
// launch, not by its ~70 KB.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void pack_bits_kernel(const int* __restrict__ idx, long long n,
                                 int bits, int per, long long n_out,
                                 unsigned char* __restrict__ out) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_out) return;
  long long base = k * per;
  unsigned acc = 0;
  for (int j = 0; j < per; ++j) {
    long long i = base + j;
    if (i < n) acc += (unsigned)__ldg(&idx[i]) << (j * bits);
  }
  out[k] = (unsigned char)(acc & 0xFFu);
}

}  // namespace

extern "C" int repro_pack_bits(const void* idx, long long n, int bits,
                               void* out, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || (bits != 1 && bits != 2 && bits != 4))
    return (int)cudaErrorInvalidValue;
  int per = 8 / bits;
  long long n_out = (n + per - 1) / per;
  unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  pack_bits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, n, bits, per, n_out, (unsigned char*)out);
  return (int)cudaGetLastError();
}
