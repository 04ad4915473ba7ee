// Demap and deinterleave of the receiver's payload cells (R3 + R4 + R5 +
// R6, EN 300 744 §4.3.4-4.3.5): the demap_deinterleave stage, one launch.
//
// Replaces no TPU kernel: the JAX package leaves the stage to XLA, which
// fuses it.  The port's plain version (kernels/demap.py) is ~30 PyTorch
// operations (a complex64 row gather, the per-axis demap, a 32-bit bit
// expansion and a 64-bit index gather), each writing a full-size
// intermediate to HBM: 2.3 ms (hard, 8K 64-QAM) and 4.7 ms (soft with CSI,
// 16-QAM) of an 8-mux x 4-frame step on the H100.  The stage's bound is
// its bytes: the equalized carriers read once (and the channel estimate,
// soft with CSI), the metrics written once: 198 MB (0.059 ms) hard at 8K
// 64-QAM, 290 MB (0.087 ms) soft at 8K 16-QAM, over 3.35 TB/s.  The work on
// chip is a few table reads and at most ~100 flops a cell, far below the
// ridge, so the design keeps every intermediate on chip:
//   - one block a (mux, symbol) row: the row's K carriers (54.5 KB at 8K)
//     go to shared memory with asynchronous 8-byte copies (cp.async;
//     warps read consecutive addresses), so the cell deinterleave's random
//     gather reads shared memory, never HBM;
//   - soft with CSI: the block reads the row's channel estimate once,
//     keeps |H|^2 a carrier in shared memory and reduces its row sum in the
//     block (the mean that normalises the CSI);
//   - each thread demaps payload cells through the 4-phase deinterleaver
//     table (row phase = symbol mod 4) into a shared tile: one byte a cell
//     (hard: the cell's v bits), or v metric bytes a cell (soft);
//   - the block writes the row's metrics in coded order, 4 bytes a thread
//     and store (a warp writes 128 contiguous bytes), reading the tile
//     through the bit deinterleaver's in-block table.  A 126-cell
//     bit-interleaver block never crosses a symbol (1,512 and 6,048 cells
//     are 12 and 48 blocks), so a row is whole.  Hierarchical modes have
//     one table a stream and write the HP bits (the first 2 of each cell's
//     v) and the LP bits straight into their own outputs;
//   - hard: 62 KB of shared memory a block at 8K (3 blocks an SM), soft
//     with CSI 107 KB at 16-QAM (2 an SM).
// Arithmetic follows the plain version step by step on the card: each
// product and difference is rounded on its own (__fmul_rn, __fsub_rn, no
// FMA contraction), rounding is half to even (rintf), and the soft scale
// 1 / dmin2 is the float32 reciprocal PyTorch's CUDA division by a
// Python number multiplies by.  Hard metrics are bit-exact; the soft CSI
// mean sums the row in another order than torch.mean, so a soft metric on
// a rounding boundary may differ by one level.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockCells = 126;      // cells of a bit-interleaver block

// the wrapper's constants (kernels/demap.py::CONSTS_WORDS, 52 words)
struct DemapConsts {
  float scale, alpha, inv_dmin2;      // hard: per-axis scale and alpha
  int32_t pad;
  int32_t contrib_i[8], contrib_q[8];  // hard: (sign, level) -> cell bits
  float lev_i[8], hsq_i[8];           // soft: I levels, levels^2 / 2
  float lev_q[8], hsq_q[8];           // soft: Q levels, levels^2 / 2
};
static_assert(sizeof(DemapConsts) == 52 * 4, "DemapConsts is 52 words");

__device__ __forceinline__ void copy8_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

// one axis' bits of a hard cell: the nearest level index
// clip(round((|z| * scale - alpha) / 2), 0, M - 1) and the sign pick them
// from contrib (M levels a half-axis)
template <int M>
__device__ __forceinline__ int hard_axis(float z, const int32_t* contrib,
                                         float scale, float alpha) {
  const int neg = z < 0.0f;
  if (M == 1) return contrib[neg];
  float t = __fmul_rn(__fsub_rn(__fmul_rn(fabsf(z), scale), alpha), 0.5f);
  t = fminf(fmaxf(rintf(t), 0.0f), float(M - 1));
  return contrib[int(t) + M * neg];
}

// the quantized max-log metrics of one axis' H bits (MSB first): score
// s_k = z * level_k - level_k^2 / 2, llr = max over the levels whose bit
// is 1 minus max over those whose bit is 0, times the CSI weight w, then
// round(7.5 + 7.5 * llr / dmin2) clipped to 0..15
template <int H>
__device__ __forceinline__ void soft_axis(float z, const float* lev,
                                          const float* hsq, float w,
                                          float inv_dmin2, uint32_t* out) {
  float s[1 << H];
#pragma unroll
  for (int k = 0; k < (1 << H); ++k)
    s[k] = __fsub_rn(__fmul_rn(z, lev[k]), hsq[k]);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float m0 = __uint_as_float(0xff800000u), m1 = m0;   // -inf
#pragma unroll
    for (int k = 0; k < (1 << H); ++k) {
      if ((k >> (H - 1 - j)) & 1)
        m1 = fmaxf(m1, s[k]);
      else
        m0 = fmaxf(m0, s[k]);
    }
    const float llr = __fmul_rn(__fsub_rn(m1, m0), w);
    float t = __fadd_rn(__fmul_rn(__fmul_rn(7.5f, llr), inv_dmin2), 7.5f);
    t = fminf(fmaxf(rintf(t), 0.0f), 15.0f);
    out[j] = uint32_t(t);
  }
}

// the row's metrics of one stream in coded order: W bytes a cell slot (v
// for the only stream, 2 for HP, v - 2 for LP), 4 a thread and store.  tp
// is the stream's in-block table: entry r of a 126-cell block reads cell
// (tp[r] >> 3) of the block, bit tp[r] & 7
template <int V, bool SOFT, int W>
__device__ __forceinline__ void write_stream(const uint8_t* tile,
                                             const uint16_t* tp,
                                             uint8_t* out, int n_payload,
                                             int tid) {
  constexpr int kRun = kBlockCells * W;   // a block's bytes, 4 | kRun
  const int n4 = n_payload * W / 4;
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  for (int g = tid; g < n4; g += kThreads) {
    const int q = 4 * g;
    const int blk = q / kRun;
    const int r = q - blk * kRun;
    const uint2 ent = *reinterpret_cast<const uint2*>(tp + r);
    const int base = blk * kBlockCells;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t e = ((b < 2 ? ent.x : ent.y) >> (16 * (b & 1))) & 0xffffu;
      const int c = base + int(e >> 3);
      const int bit = int(e & 7u);
      uint32_t val;
      if (SOFT)
        val = tile[c * V + bit];
      else
        val = ((uint32_t(tile[c]) >> (V - 1 - bit)) & 1u) * 15u;
      word |= val << (8 * b);
    }
    o[g] = word;
  }
}

// hard: 3 blocks an SM by shared memory at 8K, so at most 40 registers;
// soft: 2
template <int V, bool SOFT, bool HIER>
__global__ void __launch_bounds__(kThreads, SOFT ? 2 : 3)
demap_kernel(const float2* __restrict__ x, const float2* __restrict__ h,
             const int16_t* __restrict__ cell_idx,
             const uint16_t* __restrict__ perm,
             const DemapConsts* __restrict__ consts,
             uint8_t* __restrict__ out_hp, uint8_t* __restrict__ out_lp,
             int n_sym, int n_carriers, int n_payload) {
  constexpr int kH = V / 2;              // bits an axis
  constexpr int kM = 1 << (kH - 1);      // levels a half-axis
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ DemapConsts cs;
  __shared__ float red[kWarps];
  const int K = n_carriers, P = n_payload;
  const bool csi = SOFT && h != nullptr;
  // layout: carriers (8 B each), the in-block tables (8-byte aligned: 252 V
  // bytes), |H|^2 (soft with CSI), the demapped tile
  float2* xs = reinterpret_cast<float2*>(smem);
  uint16_t* tp = reinterpret_cast<uint16_t*>(xs + K);
  float* hs = reinterpret_cast<float*>(tp + kBlockCells * V);
  uint8_t* tile = reinterpret_cast<uint8_t*>(hs + (csi ? K : 0));
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;          // mux * n_sym + symbol

  const float2* xr = x + row * K;
  for (int k = tid; k < K; k += kThreads) copy8_async(xs + k, xr + k);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < kBlockCells * V; i += kThreads) tp[i] = perm[i];
  if (tid < int(sizeof(DemapConsts) / 4))
    reinterpret_cast<int32_t*>(&cs)[tid] =
        reinterpret_cast<const int32_t*>(consts)[tid];
  if (csi) {
    const float2* hr = h + row * K;
    float sum = 0.0f;
#pragma unroll 4
    for (int k = tid; k < K; k += kThreads) {
      const float2 hv = hr[k];
      const float a = hypotf(hv.x, hv.y);
      const float p2 = __fmul_rn(a, a);
      hs[k] = p2;
      sum = __fadd_rn(sum, p2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    if ((tid & 31) == 0) red[tid >> 5] = sum;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float mean = 1.0f;
  if (csi) {
    float total = 0.0f;                   // every thread, the same order
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, red[w]);
    mean = __fmul_rn(total, 1.0f / float(K));
  }
  const int16_t* ci = cell_idx + (int(row % size_t(n_sym)) & 3) * P;
  for (int i = tid; i < P; i += kThreads) {
    const int k = ci[i];
    const float2 y = xs[k];
    if (SOFT) {
      const float w = csi ? __fdiv_rn(hs[k], mean) : 1.0f;
      uint32_t mi[kH], mq[kH];
      soft_axis<kH>(y.x, cs.lev_i, cs.hsq_i, w, cs.inv_dmin2, mi);
      soft_axis<kH>(y.y, cs.lev_q, cs.hsq_q, w, cs.inv_dmin2, mq);
      // metric e of the cell: I bit e / 2 for even e, Q bit e / 2 for odd
      uint16_t* dst = reinterpret_cast<uint16_t*>(tile + i * V);
#pragma unroll
      for (int j = 0; j < kH; ++j) dst[j] = uint16_t(mi[j] | (mq[j] << 8));
    } else {
      tile[i] = uint8_t(hard_axis<kM>(y.x, cs.contrib_i, cs.scale, cs.alpha) |
                        hard_axis<kM>(y.y, cs.contrib_q, cs.scale, cs.alpha));
    }
  }
  __syncthreads();

  const size_t cells = row * size_t(P);
  if constexpr (HIER) {
    write_stream<V, SOFT, 2>(tile, tp, out_hp + cells * 2, P, tid);
    write_stream<V, SOFT, V - 2>(tile, tp + kBlockCells * 2,
                                 out_lp + cells * (V - 2), P, tid);
  } else {
    write_stream<V, SOFT, V>(tile, tp, out_hp + cells * V, P, tid);
  }
}

template <int V, bool SOFT, bool HIER>
cudaError_t launch(const void* x, const void* h, const void* cell_idx,
                   const void* perm, const void* consts, void* out_hp,
                   void* out_lp, int64_t n_rows, int64_t n_sym, int64_t K,
                   int64_t P, cudaStream_t stream) {
  auto kernel = demap_kernel<V, SOFT, HIER>;
  const bool csi = SOFT && h != nullptr;
  const size_t smem = size_t(K) * 8 + size_t(kBlockCells) * V * 2 +
                      (csi ? size_t(K) * 4 : 0) + size_t(P) * (SOFT ? V : 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(n_rows), kThreads, smem, stream>>>(
      (const float2*)x, csi ? (const float2*)h : nullptr,
      (const int16_t*)cell_idx, (const uint16_t*)perm,
      (const DemapConsts*)consts, (uint8_t*)out_hp, (uint8_t*)out_lp,
      int(n_sym), int(K), int(P));
  return cudaGetLastError();
}

}  // namespace

// One launch over n_rows = n_mux * n_sym symbol rows of K equalized carriers
// x (complex64, contiguous; row 0 of each mux a frame's symbol 0, n_sym a
// multiple of 4) -> the K1 metrics of each stream, uint8 (n_rows, P * W):
// hard {0, 15} or soft 0..15, in coded order.  h: the channel estimate
// (like x) for the soft CSI weight, or null.  cell_idx: int16 (4, P)
// carrier of each deinterleaved cell by symbol mod 4; perm: uint16 (126 v)
// in-block tables (HP's 252 entries, then LP's, in hierarchical modes);
// consts: the 52-word DemapConsts; out_lp null unless hierarchical (v 4 or
// 6).  perm and the outputs must be 8- and 4-byte aligned (the wrapper's
// own tensors).
extern "C" int dvbt_demap(const void* x, const void* h, const void* cell_idx,
                          const void* perm, const void* consts, void* out_hp,
                          void* out_lp, int64_t n_rows, int64_t n_sym,
                          int64_t n_carriers, int64_t n_payload, int64_t v,
                          int64_t soft, void* cuda_stream) {
  if (n_rows <= 0 || n_sym <= 0 || n_sym % 4 || n_rows % n_sym ||
      n_payload <= 0 || n_payload % kBlockCells || n_carriers < n_payload ||
      n_carriers > 0x7fff)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const bool hier = out_lp != nullptr;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define DVBT_DEMAP(V_, SOFT_, HIER_)                                        \
  return (int)launch<V_, SOFT_, HIER_>(x, h, cell_idx, perm, consts, out_hp, \
                                        out_lp, n_rows, n_sym, n_carriers,   \
                                        n_payload, st)
  if (soft) {
    if (v == 2 && !hier) DVBT_DEMAP(2, true, false);
    if (v == 4) {
      if (hier) DVBT_DEMAP(4, true, true);
      DVBT_DEMAP(4, true, false);
    }
    if (v == 6) {
      if (hier) DVBT_DEMAP(6, true, true);
      DVBT_DEMAP(6, true, false);
    }
  } else {
    if (v == 2 && !hier) DVBT_DEMAP(2, false, false);
    if (v == 4) {
      if (hier) DVBT_DEMAP(4, false, true);
      DVBT_DEMAP(4, false, false);
    }
    if (v == 6) {
      if (hier) DVBT_DEMAP(6, false, true);
      DVBT_DEMAP(6, false, false);
    }
  }
#undef DVBT_DEMAP
  return (int)cudaErrorInvalidValue;
}
