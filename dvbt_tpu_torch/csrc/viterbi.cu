// Overlapped-window Viterbi decoders for the K=7 DVB-T mother code.
//
// K1 replaces dvbt_tpu/kernels/viterbi_pallas.py::_vit_punct_kernel (the
// punctured soft stream in, info bytes out); K3 replaces
// dvbt_tpu/kernels/viterbi_pallas.py::_viterbi_kernel (the depunctured
// streams x, y and their per-step masks xm, ym in, one byte per info bit
// out).  Both share one design.  One thread block of 64 threads decodes
// one window (all muxes' windows form one flat grid); thread s owns trellis
// state s:
//   * the window's steps are staged in shared memory as (x, y, x_known,
//     y_known): carried tail for extended positions < overlap, the block's
//     steps afterwards (K1 resolves them through the static Table-3 rank,
//     K3 reads the four streams), and erasures (zero branch metric) past
//     the end of the block;
//   * add-compare-select (acs_forward) keeps the path metric in a register
//     and exchanges it through a double buffer in shared memory, one
//     __syncthreads per step.  The decision is c1 < c0 (ties go to the even
//     predecessor);
//   * __ballot_sync packs each warp's 32 decisions into one word, so step t
//     stores words (states 0..31, states 32..63) — 8 bytes a step;
//   * thread 0 traces back (traceback) from the lowest-index state of
//     minimum metric (best_state) and emits the body's bits: K1 as
//     MSB-first bytes, K3 as one byte per bit.
// Both passes are sequential in the window length, so the kernels are bound
// by latency, not by memory: a shared-memory round trip and a barrier per
// ACS step, then a dependent shared-memory read per traceback step in one
// thread.  Throughput comes from many resident windows per SM: 12 bytes of
// shared memory a step, ~15 KB a window for K1 at body 1024 and ~51 KB for
// K3 at its default body 4096 (4 windows per SM).  Path metrics grow by at
// most 30 a step and fit int32 without renormalisation.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
// branch outputs of the edge into state s from its d=0 predecessor are the
// parities of ((s << 1) & G) (the d=1 edge flips both: G1, G2 tap bit 0)
constexpr unsigned kG1 = 0x79u;  // 171 octal
constexpr unsigned kG2 = 0x5Bu;  // 133 octal

// Forward pass over the L staged steps; dec receives 2 words a step.  The
// caller has zeroed pmbuf[0] and synchronised.  Returns this thread's final
// path metric.
__device__ __forceinline__ int acs_forward(const uchar4* in, uint32_t* dec,
                                           int (*pmbuf)[kStates], int L) {
  const int s = threadIdx.x;
  const int pred = (s & 31) << 1;
  const bool px = __popc(((unsigned)s << 1) & kG1) & 1;
  const bool py = __popc(((unsigned)s << 1) & kG2) & 1;
  const int lane = s & 31;
  const int warp = s >> 5;
  int pm = 0;
  for (int t = 0; t < L; ++t) {
    const uchar4 v = in[t];
    const int sx = v.x, sy = v.y;
    const int bm0 = v.z * (px ? 15 - sx : sx) + v.w * (py ? 15 - sy : sy);
    const int bm1 = 15 * (v.z + v.w) - bm0;
    const int* cur = pmbuf[t & 1];
    const int c0 = cur[pred] + bm0;
    const int c1 = cur[pred + 1] + bm1;
    const bool d = c1 < c0;
    pm = d ? c1 : c0;
    pmbuf[(t + 1) & 1][s] = pm;
    const unsigned word = __ballot_sync(0xffffffffu, d);
    if (lane == 0) dec[2 * t + warp] = word;
    __syncthreads();
  }
  return pm;
}

// Lowest-index state among the minimum metrics: min of (pm << 6 | s) over
// the block.  Every thread calls it and gets the answer.
__device__ __forceinline__ int best_state(int pm, unsigned* best) {
  const int s = threadIdx.x;
  const unsigned key =
      __reduce_min_sync(0xffffffffu, ((unsigned)pm << 6) | (unsigned)s);
  if ((s & 31) == 0) best[s >> 5] = key;
  __syncthreads();
  return (int)(min(best[0], best[1]) & 63u);
}

// Single-thread traceback from state st at step L-1 down to step ov; calls
// emit(u, bit) for each body step u = t - ov < body, in descending u.
template <class Emit>
__device__ __forceinline__ void traceback(const uint32_t* dec, int st, int L,
                                          int ov, int body, Emit emit) {
  for (int t = L - 1; t >= ov; --t) {
    const int u = t - ov;  // body step of this window
    if (u < body) emit(u, st >> 5);
    const unsigned dbit = (dec[2 * t + (st >> 5)] >> (st & 31)) & 1u;
    st = ((st & 31) << 1) | (int)dbit;
  }
}

__global__ void __launch_bounds__(kStates)
    viterbi_punct_kernel(const uint8_t* __restrict__ coded,
                         const uint8_t* __restrict__ tail,
                         uint8_t* __restrict__ out, int64_t n_c,
                         int64_t n_bits, int64_t n_win, int body, int ov,
                         int period, int keep, uint64_t rank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = body + 2 * ov;
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem);           // (L, 2)
  uchar4* in = reinterpret_cast<uchar4*>(smem + 8 * (size_t)L);  // (L,)
  __shared__ int pmbuf[2][kStates];
  __shared__ unsigned best[2];

  const int64_t m = blockIdx.x / n_win;
  const int64_t w = blockIdx.x - m * n_win;
  const uint8_t* cm = coded + m * n_c;
  const uint8_t* tm = tail + m * 4 * (int64_t)ov;  // rows x, y, xm, ym
  const int s = threadIdx.x;

  for (int t = s; t < L; t += kStates) {
    const int64_t p = w * body + t;  // extended-stream position
    uchar4 v = make_uchar4(0, 0, 0, 0);
    if (p < ov) {
      v = make_uchar4(tm[p], tm[ov + p], tm[2 * ov + p], tm[3 * ov + p]);
    } else if (p - ov < n_bits) {
      const int64_t q = p - ov;
      const int64_t grp = q / period;
      const int ph = (int)(q - grp * period);
      const int rx = (int)((rank >> (8 * ph)) & 15u) - 1;
      const int ry = (int)((rank >> (8 * ph + 4)) & 15u) - 1;
      const int64_t base = grp * keep;
      if (rx >= 0) {
        v.x = cm[base + rx];
        v.z = 1;
      }
      if (ry >= 0) {
        v.y = cm[base + ry];
        v.w = 1;
      }
    }
    in[t] = v;
  }
  pmbuf[0][s] = 0;
  __syncthreads();

  const int st = best_state(acs_forward(in, dec, pmbuf, L), best);
  if (s != 0) return;

  const int64_t n_bytes = n_bits >> 3;
  uint8_t* om = out + m * n_bytes;
  const int64_t obase = w * (body >> 3);
  unsigned acc = 0;
  traceback(dec, st, L, ov, body, [&](int u, int bit) {
    acc |= (unsigned)bit << (7 - (u & 7));
    if ((u & 7) == 0) {
      const int64_t b = obase + (u >> 3);
      if (b < n_bytes) om[b] = (uint8_t)acc;
      acc = 0;
    }
  });
}

__global__ void __launch_bounds__(kStates)
    viterbi_depunct_kernel(const uint8_t* __restrict__ x,
                           const uint8_t* __restrict__ y,
                           const uint8_t* __restrict__ xm,
                           const uint8_t* __restrict__ ym,
                           const uint8_t* __restrict__ tail,
                           uint8_t* __restrict__ out, int64_t n_bits,
                           int64_t n_win, int body, int ov) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = body + 2 * ov;
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem);           // (L, 2)
  uchar4* in = reinterpret_cast<uchar4*>(smem + 8 * (size_t)L);  // (L,)
  __shared__ int pmbuf[2][kStates];
  __shared__ unsigned best[2];

  const int64_t m = blockIdx.x / n_win;
  const int64_t w = blockIdx.x - m * n_win;
  const int64_t row = m * n_bits;
  const uint8_t* tm = tail + m * 4 * (int64_t)ov;  // rows x, y, xm, ym
  const int s = threadIdx.x;

  for (int t = s; t < L; t += kStates) {
    const int64_t p = w * body + t;  // extended-stream position
    uchar4 v = make_uchar4(0, 0, 0, 0);
    if (p < ov) {
      v = make_uchar4(tm[p], tm[ov + p], tm[2 * ov + p], tm[3 * ov + p]);
    } else if (p - ov < n_bits) {
      const int64_t q = row + p - ov;
      v = make_uchar4(x[q], y[q], xm[q], ym[q]);
    }
    in[t] = v;
  }
  pmbuf[0][s] = 0;
  __syncthreads();

  const int st = best_state(acs_forward(in, dec, pmbuf, L), best);
  if (s != 0) return;

  uint8_t* om = out + row;
  const int64_t base = w * body;
  traceback(dec, st, L, ov, body, [&](int u, int bit) {
    if (base + u < n_bits) om[base + u] = (uint8_t)bit;
  });
}

}  // namespace

extern "C" int dvbt_viterbi_punct(const void* coded, const void* tail,
                                  void* out, int64_t n_mux, int64_t n_c,
                                  int64_t n_bits, int64_t body, int64_t ov,
                                  int64_t period, int64_t keep, int64_t rank,
                                  void* cuda_stream) {
  const int64_t n_win = (n_bits + body - 1) / body;
  const size_t smem = 12 * (size_t)(body + 2 * ov);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_punct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  viterbi_punct_kernel<<<(unsigned)(n_mux * n_win), kStates, smem,
                         (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)coded, (const uint8_t*)tail, (uint8_t*)out, n_c, n_bits,
      n_win, (int)body, (int)ov, (int)period, (int)keep, (uint64_t)rank);
  return (int)cudaGetLastError();
}

extern "C" int dvbt_viterbi_depunct(const void* x, const void* y,
                                    const void* xm, const void* ym,
                                    const void* tail, void* out,
                                    int64_t n_mux, int64_t n_bits,
                                    int64_t body, int64_t ov,
                                    void* cuda_stream) {
  const int64_t n_win = (n_bits + body - 1) / body;
  const size_t smem = 12 * (size_t)(body + 2 * ov);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_depunct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  viterbi_depunct_kernel<<<(unsigned)(n_mux * n_win), kStates, smem,
                           (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)x, (const uint8_t*)y, (const uint8_t*)xm,
      (const uint8_t*)ym, (const uint8_t*)tail, (uint8_t*)out, n_bits, n_win,
      (int)body, (int)ov);
  return (int)cudaGetLastError();
}
