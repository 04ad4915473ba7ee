// K2: byte stream -> K=7 mother code (G1=171o, G2=133o) -> Table-3 puncturing.
//
// Replaces dvbt_tpu/kernels/coder_pallas.py::_coder_kernel, and keeps its
// formulation: the mother code runs on packed bytes and the bits are
// expanded only at the end.  One thread per unit of PERIOD input bytes
// (8 * PERIOD info bits = 8 puncture periods -> 8 * KEEP coded bytes):
//   - it reads the unit's bytes once, with the byte before them (at a
//     row's start, the carried 6-bit state), into one register word in
//     which stream bit q of the unit sits at bit 8 * PERIOD - 1 - q, so
//     tap d (bit q - d) is the word shifted right by d;
//   - x = w ^ w>>1 ^ w>>2 ^ w>>3 ^ w>>6 (G1 taps {0,1,2,3,6}) and
//     y = w ^ w>>2 ^ w>>3 ^ w>>5 ^ w>>6 (G2 taps {0,2,3,5,6}) give all
//     its coded bits at once;
//   - the Table-3 serial order is a template parameter (one instantiation
//     a rate, DVBT_RATES below), so each output byte is one bit picked
//     from x or y at a shift known at compile time;
//   - the bytes go to shared memory as 8-byte words, and the block writes
//     its contiguous run of the row with 16-byte stores (byte stores only
//     where a row's output does not start 16-byte aligned).  A run per
//     warp, each warp waiting only for itself, measured 7% slower.
// Index arithmetic is 32-bit within a row (the wrapper checks that a
// row's output is below 2^31 bytes); the mux is the grid's y.  On the
// H100 the pass is bound by its output bytes: one byte per coded bit,
// 12x the input at rate 2/3.
#include <cstdint>
#include <cuda_runtime.h>

// (period, keep, serial order packed 4 bits a position) of each code rate:
// serial position r reads mother position (order >> 4r) & 15 of the
// period's (x0, y0, x1, y1, ...).  tests/test_torch_build.py holds this
// table against utils/puncture.pattern.
#define DVBT_RATES(X) \
  X(1, 2, 0x10u)      \
  X(2, 3, 0x310u)     \
  X(3, 4, 0x4310u)    \
  X(5, 6, 0x874310u)  \
  X(7, 8, 0xcb875310u)

namespace {

constexpr int kThreads = 256;

// The 8 * KEEP coded bytes of one unit, as KEEP 8-byte words (byte b of
// word v is coded byte 8v + b).  prev: the byte before the unit; in: its
// PERIOD bytes.
template <int PERIOD, int KEEP, uint32_t ORDER>
__device__ __forceinline__ void encode_unit(unsigned prev, const unsigned* in,
                                            uint64_t* words) {
  uint64_t w = prev;
#pragma unroll
  for (int j = 0; j < PERIOD; ++j) w = (w << 8) | in[j];
  const uint64_t x = w ^ (w >> 1) ^ (w >> 2) ^ (w >> 3) ^ (w >> 6);
  const uint64_t y = w ^ (w >> 2) ^ (w >> 3) ^ (w >> 5) ^ (w >> 6);
#pragma unroll
  for (int v = 0; v < KEEP; ++v) {
    uint64_t word = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int k = 8 * v + b;              // coded byte of the unit
      const int g = k / KEEP;               // puncture period of the unit
      const int o = (ORDER >> (4 * (k % KEEP))) & 15;  // mother position
      const int q = g * PERIOD + (o >> 1);  // info bit of the unit
      const uint64_t src = (o & 1) ? y : x;
      word |= ((src >> (8 * PERIOD - 1 - q)) & 1u) << (8 * b);
    }
    words[v] = word;
  }
}

template <int PERIOD, int KEEP, uint32_t ORDER>
__global__ void __launch_bounds__(kThreads)
byte_coder_kernel(const uint8_t* __restrict__ stream,
                  const uint8_t* __restrict__ state6,
                  uint8_t* __restrict__ out, int n_mux, int n_bytes,
                  int n_coded) {
  constexpr int kOut = 8 * KEEP;            // coded bytes a unit
  __shared__ __align__(16) uint64_t stage[kThreads * KEEP];
  const int unit = blockIdx.x * kThreads + threadIdx.x;
  const int b0 = unit * PERIOD;
  const int64_t c0 = (int64_t)blockIdx.x * kThreads * kOut;
  const int64_t rest = n_coded - c0;        // the block's run of a row
  const int len = (int)(rest < kThreads * kOut ? rest : kThreads * kOut);
  for (int m = blockIdx.y; m < n_mux; m += gridDim.y) {
    const uint8_t* s = stream + (int64_t)m * n_bytes;
    if (b0 < n_bytes) {
      unsigned prev;
      if (b0 > 0) {
        prev = s[b0 - 1];
      } else {
        const uint8_t* st = state6 + (int64_t)m * 6;
        prev = 0;
#pragma unroll
        for (int k = 0; k < 6; ++k) prev = (prev << 1) | st[k];
      }
      unsigned in[PERIOD];
#pragma unroll
      for (int j = 0; j < PERIOD; ++j)  // a ragged row ends mid-unit
        in[j] = b0 + j < n_bytes ? s[b0 + j] : 0u;
      uint64_t words[KEEP];
      encode_unit<PERIOD, KEEP, ORDER>(prev, in, words);
#pragma unroll
      for (int v = 0; v < KEEP; ++v) stage[threadIdx.x * KEEP + v] = words[v];
    }
    __syncthreads();
    uint8_t* dst = out + (int64_t)m * n_coded + c0;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(stage);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      const uint4* s16 = reinterpret_cast<const uint4*>(stage);
      uint4* d16 = reinterpret_cast<uint4*>(dst);
      done = len & ~15;
      for (int i = threadIdx.x; i < (len >> 4); i += kThreads) d16[i] = s16[i];
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) dst[i] = src[i];
    __syncthreads();
  }
}

template <int PERIOD, int KEEP, uint32_t ORDER>
cudaError_t launch(const uint8_t* stream, const uint8_t* state6, uint8_t* out,
                   int64_t n_mux, int64_t n_bytes, int64_t n_coded,
                   cudaStream_t cuda_stream) {
  const int64_t n_units = (n_bytes + PERIOD - 1) / PERIOD;
  const dim3 grid((unsigned)((n_units + kThreads - 1) / kThreads),
                  (unsigned)(n_mux < 65535 ? n_mux : 65535));
  byte_coder_kernel<PERIOD, KEEP, ORDER><<<grid, kThreads, 0, cuda_stream>>>(
      stream, state6, out, (int)n_mux, (int)n_bytes, (int)n_coded);
  return cudaGetLastError();
}

}  // namespace

// One launch over n_mux rows; (period, keep, order) must be a row of
// DVBT_RATES (else cudaErrorInvalidValue), n_coded = n_bytes * 8 / period
// * keep < 2^31 (checked by the wrapper).
extern "C" int dvbt_byte_coder(const void* stream, const void* state6,
                               void* out, int64_t n_mux, int64_t n_bytes,
                               int64_t n_coded, int64_t period, int64_t keep,
                               int64_t order, void* cuda_stream) {
#define DVBT_LAUNCH(P, K, O)                                               \
  if (period == P && keep == K && order == (int64_t)O)                     \
    return (int)launch<P, K, O>((const uint8_t*)stream,                    \
                                (const uint8_t*)state6, (uint8_t*)out,     \
                                n_mux, n_bytes, n_coded,                   \
                                (cudaStream_t)cuda_stream);
  DVBT_RATES(DVBT_LAUNCH)
#undef DVBT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
