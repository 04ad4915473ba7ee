// RS(204,188,T=8) decode (R9) and systematic encode (T2), EN 300 744
// §4.3.2: one kernel each, one launch a call.
//
// Decode replaces no TPU kernel: the JAX package decodes with bit-sliced
// GF(2) matmuls and log/exp gathers that XLA fuses.  The port's plain version
// (kernels/rs.py) issued ~1,200 small launches a call (16 unrolled
// Berlekamp-Massey iterations, the Chien and Forney loops), and its int64
// table gathers took half the head-end step on the H100.  The bound is the
// codewords read and the messages written once over HBM (392 bytes a
// packet); the work on chip is ~3,300 table lookups a noiseless packet.
//
// One thread a packet, kThreads packets a block:
//   - the block stages its run of packets (kThreads * 204 contiguous
//     bytes) in shared memory with 16-byte loads, with the tables (the
//     wrapper's 5,632 bytes: f * g(x) for every byte f, exp and log);
//   - each thread divides its codeword by the generator g(x) (the
//     encoder's LFSR: 204 steps of one 16-byte table row, four funnel
//     shifts and four XORs).  The remainder r(x) is zero exactly when
//     every syndrome S_j = c(alpha^j) = r(alpha^j) is: the plain version's
//     no_err rule, and the whole of a noiseless packet's work;
//   - any other packet runs the full decode in its thread: the syndromes
//     from r(x), Berlekamp-Massey's fixed 16 iterations with the plain
//     version's update and growth rule (so Lambda and L are identical),
//     Omega = S * Lambda mod x^8, Chien over all 204 positions (log-domain
//     terms stepped by alpha^k a position), and Forney at every root where
//     Lambda' != 0; corrections go into the staged bytes, uncorrectable
//     packets included, n_corrected counts the roots and uncorrectable is
//     (roots != L) | (L > 8);
//   - the block writes its 188-byte messages back from shared memory with
//     16-byte stores.
// GF(2^8) products are exp[log a + log b] with log 0 = 510 and exp zero
// from 510 on, so a zero factor needs no branch.
//
// Encode replaces no TPU kernel either: the JAX package encodes with
// bit-sliced GF(2) matmuls in plain JAX.  The port's plain version gathers
// a 16-byte row a message byte from a (position, byte) table through an
// int64 index, pads, folds with XOR and concatenates: ~16 launches and
// ~280 MB of HBM traffic a call at 32,256 packets, the largest stage of
// the head-end step.  The bound is the messages read and the codewords
// written once (392 bytes a packet).  One thread a packet, kThreads
// packets a block, the decoder's layout turned around:
//   - the block stages its run of messages (kThreads * 188 contiguous
//     bytes, 16-byte loads) at a codeword's stride in shared memory, with
//     the decoder's f * g(x) rows (its tables' first 4,096 bytes);
//   - each thread computes m(x) * x^16 mod g(x) with the decoder's LFSR
//     fed the message and the top coefficient: 188 steps of one table row,
//     four funnel shifts and four XORs, and writes the 16 parity bytes
//     after its message in the stage;
//   - the block stores the staged codewords with 16-byte stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 204, kK = 188, kT = 8, k2T = 16;
constexpr int kThreads = 64;                // packets a block
constexpr int kMinBlocks = 8;               // a block's registers: <= 128
constexpr int kFbBytes = 256 * 16;          // row f: f * g_15 .. f * g_0
constexpr int kExpBytes = 1024;             // alpha^i for i < 510, then 0
constexpr int kLogBytes = 256 * 2;          // uint16, log 0 = 510
constexpr int kTableBytes = kFbBytes + kExpBytes + kLogBytes;
static_assert(kTableBytes % 16 == 0 && kN % 4 == 0 && kK % 4 == 0, "");
static_assert((kThreads * kN) % 16 == 0 && (kThreads * kK) % 16 == 0,
              "a block's runs of codewords and messages stay 16-byte aligned");

struct Gf {
  const uint8_t* exp;
  const uint16_t* log;
  __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) const {
    return exp[log[a] + log[b]];
  }
  // a * alpha^e for 0 <= e < 255 (0 for a = 0)
  __device__ __forceinline__ unsigned mul_pow(unsigned a, unsigned e) const {
    return a ? exp[(log[a] + e) % 255] : 0u;
  }
};

// The full decode of one packet whose remainder rw is not zero (byte m of
// rw[0..3] is the coefficient of x^(15 - m)); corrects the staged message
// bytes c in place.  Returns (Chien roots, L).
__device__ __forceinline__ int2 decode_packet(const Gf gf, const uint32_t* rw,
                                              uint8_t* c) {
  // syndromes S_j = r(alpha^j): exp index at most 254 + 15 * 15 for a
  // nonzero r_k, and at least 510 for r_k = 0
  unsigned lr[k2T], S[k2T];
#pragma unroll
  for (int k = 0; k < k2T; ++k)
    lr[k] = gf.log[(rw[(15 - k) >> 2] >> (8 * ((15 - k) & 3))) & 0xff];
#pragma unroll
  for (int j = 0; j < k2T; ++j) {
    unsigned s = 0;
#pragma unroll
    for (int k = 0; k < k2T; ++k) s ^= gf.exp[lr[k] + j * k];
    S[j] = s;
  }
  // Berlekamp-Massey: C (Lambda) and Bm (x * B) of degree 8, truncated
  // there as the plain version's are
  unsigned C[kT + 1], Bm[kT + 1];
#pragma unroll
  for (int m = 0; m <= kT; ++m) C[m] = Bm[m] = 0;
  C[0] = 1;
  Bm[1] = 1;
  unsigned binv = 1;
  int L = 0;
#pragma unroll
  for (int n = 0; n < k2T; ++n) {
    unsigned d = 0;
#pragma unroll
    for (int m = 0; m <= kT; ++m)
      if (n - m >= 0) d ^= gf.mul(C[m], S[n - m]);
    const unsigned coef = gf.mul(d, binv);   // 0 when d is: C unchanged
    const bool grow = d != 0 && 2 * L <= n;
#pragma unroll
    for (int m = kT; m >= 1; --m) {
      const unsigned cm = C[m];
      C[m] = cm ^ gf.mul(coef, Bm[m]);
      Bm[m] = grow ? C[m - 1] : Bm[m - 1];   // C[m - 1] not yet updated
    }
    Bm[0] = 0;                               // C[0] stays 1
    if (grow) {
      binv = gf.exp[255 - gf.log[d]];
      L = n + 1 - L;
    }
  }
  // Omega = S * Lambda mod x^8
  unsigned om[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    unsigned o = 0;
#pragma unroll
    for (int i = 0; i <= k; ++i) o ^= gf.mul(C[i], S[k - i]);
    om[k] = o;
  }
  // Chien: position p has X = alpha^deg, deg = 203 - p; term k of
  // Lambda(X^-1) is alpha^(log C_k - deg * k), stepped by alpha^k a
  // position (C_0 = 1 is the constant term)
  unsigned e[kT + 1], live[kT + 1];
#pragma unroll
  for (int k = 1; k <= kT; ++k) {
    live[k] = C[k] ? 0xffu : 0u;
    e[k] = C[k] ? (gf.log[C[k]] + (255 - (kN - 1) % 255) * k) % 255 : 0u;
  }
  int roots = 0;
  for (int p = 0; p < kN; ++p) {
    unsigned acc = 1;
#pragma unroll
    for (int k = 1; k <= kT; ++k) {
      acc ^= gf.exp[e[k]] & live[k];
      e[k] += k;
      e[k] = e[k] >= 255 ? e[k] - 255 : e[k];
    }
    if (acc == 0) {
      ++roots;
      // Forney: X * Omega(X^-1) / Lambda'(X^-1); X^-1 = alpha^nd
      const unsigned deg = kN - 1 - p;
      const unsigned nd = deg ? 255 - deg : 0;
      unsigned xom = 0, dl = 0;
#pragma unroll
      for (int k = 0; k < kT; ++k)
        xom ^= gf.mul_pow(om[k], (nd * k + deg) % 255);
#pragma unroll
      for (int k = 0; k < kT / 2; ++k)
        dl ^= gf.mul_pow(C[2 * k + 1], (2 * nd * k) % 255);
      if (dl != 0 && p < kK)
        c[p] ^= gf.exp[gf.log[xom] + 255 - gf.log[dl]];
    }
  }
  return make_int2(roots, L);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rs_decode_kernel(const uint8_t* __restrict__ cw,
                 const uint8_t* __restrict__ tables,
                 uint8_t* __restrict__ msg, int32_t* __restrict__ n_corr,
                 uint8_t* __restrict__ bad, int64_t n_packets) {
  __shared__ __align__(16) uint8_t tab[kTableBytes];
  __shared__ __align__(16) uint8_t stage[kThreads * kN];
  const int64_t p0 = (int64_t)blockIdx.x * kThreads;
  const int n = (int)(n_packets - p0 < kThreads ? n_packets - p0 : kThreads);
  const int t = threadIdx.x;

  const uint4* tab_src = reinterpret_cast<const uint4*>(tables);
  for (int i = t; i < kTableBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(tab)[i] = tab_src[i];
  const uint8_t* src = cw + p0 * kN;
  const int len = n * kN;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = len & ~15;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    for (int i = t; i < (len >> 4); i += kThreads)
      reinterpret_cast<uint4*>(stage)[i] = s16[i];
  }
  for (int i = done + t; i < len; i += kThreads) stage[i] = src[i];
  __syncthreads();

  const uint4* fb = reinterpret_cast<const uint4*>(tab);
  const Gf gf{tab + kFbBytes,
              reinterpret_cast<const uint16_t*>(tab + kFbBytes + kExpBytes)};
  if (t < n) {
    uint8_t* c = stage + t * kN;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(c);
    // r(x) = c(x) mod g(x); byte m of (r0, r1, r2, r3) is the coefficient
    // of x^(15 - m).  Each step: r = (r * x + c_i) mod g, the top
    // coefficient fed back through row f of the table
    uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll 3
    for (int i = 0; i < kN / 4; ++i) {  // a packet's words: banks differ
      const uint32_t word = w[i];       // (51 words apart, 51 odd)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint4 f = fb[r0 & 0xff];
        r0 = __funnelshift_r(r0, r1, 8) ^ f.x;
        r1 = __funnelshift_r(r1, r2, 8) ^ f.y;
        r2 = __funnelshift_r(r2, r3, 8) ^ f.z;
        r3 = __funnelshift_r(r3, word >> (8 * b), 8) ^ f.w;
      }
    }
    int2 found = make_int2(0, 0);       // (roots, L)
    if (r0 | r1 | r2 | r3) {
      const uint32_t rw[4] = {r0, r1, r2, r3};
      found = decode_packet(gf, rw, c);
    }
    n_corr[p0 + t] = found.x;
    bad[p0 + t] = (found.x != found.y) | (found.y > kT);
  }
  __syncthreads();

  // messages: word v of the block's output is word v % 47 of packet v / 47
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(stage);
  uint8_t* dst = msg + p0 * kK;
  const int n_words = n * (kK / 4);
  const int n_quads = n_words >> 2;
  for (int q = t; q < n_quads; q += kThreads) {
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int wd = 4 * q + j;
      v[j] = sw[(wd / (kK / 4)) * (kN / 4) + wd % (kK / 4)];
    }
    reinterpret_cast<uint4*>(dst)[q] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int wd = 4 * n_quads + t; wd < n_words; wd += kThreads)
    reinterpret_cast<uint32_t*>(dst)[wd] =
        sw[(wd / (kK / 4)) * (kN / 4) + wd % (kK / 4)];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rs_encode_kernel(const uint8_t* __restrict__ msg,
                 const uint8_t* __restrict__ tables,
                 uint8_t* __restrict__ cw, int64_t n_packets) {
  __shared__ __align__(16) uint8_t fbs[kFbBytes];
  __shared__ __align__(16) uint8_t stage[kThreads * kN];
  const int64_t p0 = (int64_t)blockIdx.x * kThreads;
  const int n = (int)(n_packets - p0 < kThreads ? n_packets - p0 : kThreads);
  const int t = threadIdx.x;

  const uint4* tab_src = reinterpret_cast<const uint4*>(tables);
  for (int i = t; i < kFbBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(fbs)[i] = tab_src[i];
  // message word wd of the block goes to word wd % 47 of codeword wd / 47
  uint32_t* sw = reinterpret_cast<uint32_t*>(stage);
  const uint8_t* src = msg + p0 * kK;
  const int len = n * kK;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = len & ~15;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    for (int q = t; q < (len >> 4); q += kThreads) {
      const uint4 v = s16[q];
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int wd = 4 * q + j;
        sw[(wd / (kK / 4)) * (kN / 4) + wd % (kK / 4)] = vw[j];
      }
    }
  }
  for (int i = done + t; i < len; i += kThreads)
    stage[(i / kK) * kN + i % kK] = src[i];
  __syncthreads();

  if (t < n) {
    uint32_t* c = sw + t * (kN / 4);     // 51 words apart, 51 odd: no
    const uint4* fb = reinterpret_cast<const uint4*>(fbs);   // conflicts
    // r(x) = m(x) * x^16 mod g(x), bytes as the decoder's remainder: byte
    // m of (r0, r1, r2, r3) is the coefficient of x^(15 - m), and so
    // codeword byte 188 + m.  Each step: f = m_i + r_15, r = r * x + f *
    // (g(x) - x^16)
    uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll 3
    for (int i = 0; i < kK / 4; ++i) {
      const uint32_t word = c[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint4 f = fb[(r0 ^ (word >> (8 * b))) & 0xff];
        r0 = __funnelshift_r(r0, r1, 8) ^ f.x;
        r1 = __funnelshift_r(r1, r2, 8) ^ f.y;
        r2 = __funnelshift_r(r2, r3, 8) ^ f.z;
        r3 = (r3 >> 8) ^ f.w;
      }
    }
    c[kK / 4] = r0;
    c[kK / 4 + 1] = r1;
    c[kK / 4 + 2] = r2;
    c[kK / 4 + 3] = r3;
  }
  __syncthreads();

  // the block's n codewords are contiguous: n * 204 bytes, a multiple of 4
  uint8_t* dst = cw + p0 * kN;
  const int n_words = n * (kN / 4);
  const int n_quads = n_words >> 2;
  for (int q = t; q < n_quads; q += kThreads)
    reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(sw)[q];
  for (int wd = 4 * n_quads + t; wd < n_words; wd += kThreads)
    reinterpret_cast<uint32_t*>(dst)[wd] = sw[wd];
}

}  // namespace

// One launch over n_packets > 0 codewords (..., 204) -> messages (..., 188),
// n_corrected int32 and uncorrectable bool (one byte) a packet.  tables and
// msg must be 16-byte aligned (the wrapper's own tensors); cw need not be.
extern "C" int dvbt_rs_decode(const void* cw, const void* tables, void* msg,
                              void* n_corr, void* bad, int64_t n_packets,
                              void* cuda_stream) {
  if (n_packets <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_packets + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  rs_decode_kernel<<<(unsigned)blocks, kThreads, 0,
                     (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)cw, (const uint8_t*)tables, (uint8_t*)msg,
      (int32_t*)n_corr, (uint8_t*)bad, n_packets);
  return (int)cudaGetLastError();
}

// One launch over n_packets > 0 messages (..., 188) -> systematic codewords
// (..., 204).  tables (decode's, of which the first 4,096 bytes are read) and
// cw must be 16-byte aligned (the wrapper's own tensors); msg need not be.
extern "C" int dvbt_rs_encode(const void* msg, const void* tables, void* cw,
                              int64_t n_packets, void* cuda_stream) {
  if (n_packets <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_packets + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  rs_encode_kernel<<<(unsigned)blocks, kThreads, 0,
                     (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)msg, (const uint8_t*)tables, (uint8_t*)cw, n_packets);
  return (int)cudaGetLastError();
}
