// K2: byte stream -> K=7 mother code (G1=171o, G2=133o) -> Table-3 puncturing.
//
// Replaces dvbt_tpu/kernels/coder_pallas.py::_coder_kernel.  One thread per
// OUTPUT coded bit: it finds the info step and tap set (x or y) its serial
// position belongs to, reads the 7 stream bits b[q-6..q] (bits before the
// block come from the carried 6-bit state) and writes the parity of the
// tapped bits.  The pass is bound by the 1-byte-per-coded-bit store: every
// input byte is re-read by ~12 neighbouring threads, which the L1 serves.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// bit k of the window = b[q - k]; x taps delays {0,1,2,3,6}, y {0,2,3,5,6}
constexpr unsigned kTapsX = 0x4Fu;
constexpr unsigned kTapsY = 0x6Du;

__global__ void byte_coder_kernel(const uint8_t* __restrict__ stream,
                                  const uint8_t* __restrict__ state6,
                                  uint8_t* __restrict__ out, int64_t n_mux,
                                  int64_t n_bytes, int64_t n_coded, int period,
                                  int keep, uint64_t order) {
  const int64_t total = n_mux * n_coded;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t m = idx / n_coded;
    const int64_t o = idx - m * n_coded;
    const int64_t grp = o / keep;
    const int r = (int)(o - grp * keep);
    // serial position r of a period reads mother position pos of the
    // interleaved (x0, y0, x1, y1, ...) period: x_i = 2i, y_i = 2i + 1
    const int pos = (int)((order >> (4 * r)) & 15u);
    const int64_t q = grp * period + (pos >> 1);
    const uint8_t* s = stream + m * n_bytes;
    const uint8_t* st = state6 + m * 6;
    unsigned win = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int64_t i = q - k;
      const unsigned b =
          i >= 0 ? (s[i >> 3] >> (7 - (i & 7))) & 1u : (unsigned)st[6 + i];
      win |= b << k;
    }
    out[idx] = (uint8_t)(__popc(win & ((pos & 1) ? kTapsY : kTapsX)) & 1);
  }
}

}  // namespace

extern "C" int dvbt_byte_coder(const void* stream, const void* state6,
                               void* out, int64_t n_mux, int64_t n_bytes,
                               int64_t n_coded, int64_t period, int64_t keep,
                               int64_t order, void* cuda_stream) {
  const int threads = 256;
  int64_t blocks = (n_mux * n_coded + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past this
  if (blocks < 1) blocks = 1;
  byte_coder_kernel<<<(unsigned)blocks, threads, 0,
                      (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)stream, (const uint8_t*)state6, (uint8_t*)out, n_mux,
      n_bytes, n_coded, (int)period, (int)keep, (uint64_t)order);
  return (int)cudaGetLastError();
}

extern "C" const char* dvbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
