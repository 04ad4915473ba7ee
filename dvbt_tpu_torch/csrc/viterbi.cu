// Overlapped-window Viterbi decoders for the K=7 DVB-T mother code.
//
// K1 replaces dvbt_tpu/kernels/viterbi_pallas.py::_vit_punct_kernel (the
// punctured soft stream in, info bytes out); K3 replaces
// dvbt_tpu/kernels/viterbi_pallas.py::_viterbi_kernel (the depunctured
// streams x, y and their per-step masks xm, ym in, one byte per info bit
// out).  Both share one design: ONE WARP DECODES ONE WINDOW, with no block
// barrier (a block holds a few windows only for scheduling; no warp waits on
// another).
//   * Lane l owns states l and l + 32, both fed by the butterfly of
//     predecessors 2l and 2l + 1.  Bit 6 is set in G1 and G2, so the branch
//     outputs of state s + 32 are those of s flipped: bm0(s + 32) = bm1(s),
//     and the lane needs only its butterfly's two branch metrics.
//   * Path metrics are packed two to a 32-bit word (state l low, l + 32 high,
//     16 bits each).  A step is two shuffles that fetch the predecessors'
//     words, two byte permutes that pick their halves, two adds and one
//     Hopper DPX __vibmin_s16x2, which gives both minima and both decisions
//     (c0 <= c1 keeps the even predecessor, so a decision is exactly
//     c1 < c0).  Every 256 steps the warp subtracts its minimum metric from
//     all 64: decisions and the argmin do not change, and the metrics stay
//     below 180 + 30 * 287 < 2^15.
//   * Inputs are not staged: each lane reads one step of the next 32 with
//     coalesced loads (K1 through the static Table-3 rank, K3 from x, y, xm,
//     ym; the carried tail for extended positions < overlap, erasures past
//     the block), packs the step's four possible branch metrics into one
//     word, and each step takes its word from its lane by one shuffle.
//   * The step's two __ballot_sync words (states 0..31, 32..63: the layout
//     of _pack_states) are the only thing kept in shared memory, 8 bytes a
//     step, for the steps from the last multiple of 32 not above the
//     overlap on (the traceback stops at the overlap).
//   * The traceback starts at the lowest-index minimum state and keeps the
//     path in a shift register S whose low 6 bits are the state: a step back
//     shifts in the decision bit, so S also holds the decoded bits, 6 steps
//     late, and every 32 steps it is a finished word of the body's output.
//     Each step loads its whole decision pair at an address that depends
//     only on the step, so the loads run ahead, and which word to read is
//     known one step early: the dependent chain is one funnel shift and one
//     logic operation a step.  The warp then writes the words out
//     coalesced: K1 as MSB-first bytes, K3 as one byte per bit.
// What bounds it: the sequential ACS, 13 warp instructions a step for 64
// states (3 shuffles, 4 byte permutes, 2 adds, the VIMNMX.S16x2, 2 votes, a
// store), and ~5 a traceback step.  Nine of the 13 go to the integer ALU
// pipe, which takes a warp instruction every 2 clocks in each of the SM's 4
// partitions: ~4.5 SM clocks a window-step, where the bound (3 operations
// a state-step, two adds and one min that also gives the decision, at the
// packed 16-bit rate) allows 1.5.  A step's shuffle-permute-add-min chain
// is serial within the warp (~40 clocks), so an SM needs ~9 windows or
// more to hide it.  K1 (~9 KB of shared memory a window at body 1024, 24
// windows resident per SM) is bound by issue.  K3's decisions at body 4096
// (~34 KB a window) would leave 6 windows per SM, so they spill: each warp
// flushes a 32-step ring to device memory, coalesced, and the traceback
// stages them back; K3 then runs 40 windows per SM (its registers capped
// for 5 blocks of 8).  Spilling everywhere would be simpler, but keeping
// the decisions resident where 24 windows fit is measurably faster (K1 at
// the flagship shape, and the time-sharded halo's 24 windows, whose
// traceback cannot hide device-memory latency; measured on the H100, see
// PERF.md).  The launch geometry (windows per block, shared bytes a window,
// decisions resident or spilled, the blocks per SM it counts on, grid)
// comes from kernels/viterbi.py::window_geometry; the launcher checks that
// the kernel as built reaches that residency.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// branch outputs of the edge into state s from its d=0 predecessor are the
// parities of ((s << 1) & G) (the d=1 edge flips both: G1, G2 tap bit 0)
constexpr unsigned kG1 = 0x79u;  // 171 octal
constexpr unsigned kG2 = 0x5Bu;  // 133 octal
constexpr int kRenormChunks = 8;  // renormalise every 8 chunks of 32 steps
constexpr int kMaxWarps = 8;      // windows (warps) per block at most
// Blocks of 8 warps per SM that the registers must allow (window_geometry
// counts on them, as REG_WARPS_PER_SM): 3 when the decisions stay in shared
// memory (K1's ~9 KB windows fill 3 such blocks an SM), 5 when they spill
// (shared memory would take 8; uncapped, the traceback's staging takes ~80
// registers a thread and leaves 3).
constexpr int kResidentMinBlocks = 3;
constexpr int kSpillMinBlocks = 5;

// One step's inputs: soft values and their "was sent" masks.
struct Step {
  unsigned sx, sy, mx, my;
};

// The step's four branch metrics, one per byte: byte 2*px + py is the cost
// of an edge whose outputs are (px, py), mx*(px ? 15-sx : sx) + my*(py ?
// 15-sy : sy) (soft values 0..15 and masks 0/1, so each fits a byte).
__device__ __forceinline__ unsigned bm_word(Step v) {
  const unsigned a0 = v.mx * v.sx, a1 = v.mx * (15u - v.sx);
  const unsigned b0 = v.my * v.sy, b1 = v.my * (15u - v.sy);
  return (a0 + b0) | (a0 + b1) << 8 | (a1 + b0) << 16 | (a1 + b1) << 24;
}

// Where a window's decision pairs live.  Resident (kSpill false): in shared
// memory, sh[t - skip] for steps t >= skip.  Spilled: sh is a 32-step ring
// that the warp flushes each chunk, coalesced, to dev[t - skip] in device
// memory; the traceback reads them back 32 steps at a time.
template <bool kSpill>
struct Decisions {
  uint2* sh;
  uint2* dev;
  int skip;
};

// Forward pass over the window's L steps.  feed.next() gives this lane's
// packed branch metrics (bm_word) for its step of the next chunk of 32:
// chunk 0 first, then 1, ... (also past L).  Keeps the decision pair of
// each step t >= skip (lane 0 writes it).  Returns the lowest-index state of
// minimum final metric, the same in every lane.
template <bool kSpill, class Feed>
__device__ __forceinline__ int acs_forward(Feed& feed,
                                           const Decisions<kSpill>& dec,
                                           int L) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned i = (__popc((lane << 1) & kG1) & 1u) << 1 |
                     (__popc((lane << 1) & kG2) & 1u);
  // c0 adds bm0 (byte i) to state lane, bm1 (byte 3-i) to state lane + 32;
  // c1 the other way round
  const unsigned sel_c0 = 0x4040u | i | (3u - i) << 8;
  const unsigned sel_c1 = 0x4040u | (3u - i) | i << 8;
  // predecessors 2*lane, 2*lane + 1: low halves of lanes 2l, 2l+1 for
  // lane < 16, high halves of lanes 2l-32, 2l-31 after; copied to both halves
  const unsigned sel_pm = lane < 16 ? 0x1010u : 0x3232u;
  const int src0 = (int)(2 * lane) & 31, src1 = src0 + 1;
  const bool writer = lane == 0;
  const int skip = dec.skip;

  unsigned pm = 0;
  auto step = [&](unsigned w, bool store, int t) {
    const unsigned a = __byte_perm(__shfl_sync(kFull, pm, src0), 0, sel_pm);
    const unsigned b = __byte_perm(__shfl_sync(kFull, pm, src1), 0, sel_pm);
    const unsigned c0 = a + __byte_perm(w, 0, sel_c0);
    const unsigned c1 = b + __byte_perm(w, 0, sel_c1);
    bool even_hi, even_lo;  // c0 <= c1 per half: the even predecessor
    pm = __vibmin_s16x2(c0, c1, &even_hi, &even_lo);
    const unsigned d_lo = __ballot_sync(kFull, !even_lo);
    const unsigned d_hi = __ballot_sync(kFull, !even_hi);
    if (store) dec.sh[kSpill ? t & 31 : t - skip] = make_uint2(d_lo, d_hi);
  };
  // spilled: the chunk from step t0 goes to device memory, n steps of it
  auto flush = [&](int t0, int n) {
    __syncwarp();
    if ((int)lane < n) dec.dev[t0 + (int)lane - skip] = dec.sh[lane];
    __syncwarp();
  };

  const int n_full = L >> 5;
  unsigned w_next = feed.next();
  for (int c = 0; c < n_full; ++c) {
    const unsigned w_cur = w_next;
    w_next = feed.next();  // runs ahead of the chunk's steps
    const bool keep = c * 32 >= skip;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      step(__shfl_sync(kFull, w_cur, k), writer && keep, c * 32 + k);
    if (kSpill && keep) flush(c * 32, 32);
    if (c % kRenormChunks == kRenormChunks - 1) {
      const unsigned mn =
          __reduce_min_sync(kFull, min(pm & 0xffffu, pm >> 16));
      pm -= mn * 0x10001u;
    }
  }
  for (int t = n_full * 32; t < L; ++t)  // ragged last chunk
    step(__shfl_sync(kFull, w_next, t & 31), writer && t >= skip, t);
  if (kSpill && n_full * 32 >= skip) flush(n_full * 32, L - n_full * 32);

  const unsigned key = min((pm & 0xffffu) << 6 | lane,
                           (pm >> 16) << 6 | (lane + 32));
  return (int)(__reduce_min_sync(kFull, key) & 63u);
}

// Traceback of the block's windows after every warp's forward pass, in
// warp 0: lane i traces the block's window i (the warps' chains are
// serial, so one lane each costs no more time and 1/32 of the issue).  S is
// a shift register of the path: its low 6 bits are the state at step t,
// and each step back shifts in the decision bit, so bit k of S at step t is
// the decoded bit of step t - 5 + k.  At t = ov + 5 + 32j, S is the body's
// word j: bit (u & 31) of bits[u >> 5] is body step u (step ov + u).  Steps
// ov + 6 .. L-1 are read, in blocks: block 0 from L-1 down to the first
// word boundary, block b >= 1 the 32 steps below boundary J + 1 - b.
// Spilled decisions are staged block by block into each window's ring,
// coalesced, one block ahead.  Window strides are 8 mod 128 bytes, so the
// lanes' loads of one step fall in different banks.  Needs ov >= 5.
template <bool kSpill>
__device__ __forceinline__ void traceback_block(
    unsigned char* smem, const uint2* scratch, const int* best, int n_here,
    int64_t g0, int window_bytes, int L, int ov, int body, int skip) {
  const int lane = (int)(threadIdx.x & 31u);
  const bool writer = lane < n_here;
  auto region = [&](int m) {
    return reinterpret_cast<uint2*>(smem + (size_t)m * window_bytes);
  };
  const int mine = min(lane, n_here - 1);  // lanes past the windows shadow
  uint2* sh = region(mine);                // decisions, or the ring
  unsigned* bits = reinterpret_cast<unsigned*>(sh + (kSpill ? 32 : L - skip));
  const int base = ov + 5;
  const int n_words = (body + 31) >> 5;
  const int J = (L - 1 - base) >> 5;   // full blocks
  const int n0 = (L - 1 - base) & 31;  // steps of block 0
  unsigned S = (unsigned)best[mine];
  bool hi = S & 32u;  // which decision word the state's bit is in
  auto back = [&](uint2 d) {  // d: the step's pair, loaded independently
    const unsigned w = hi ? d.y : d.x;
    hi = S & 16u;  // bit 5 of the next state
    S = S << 1 | (__funnelshift_r(w, w, S) & 1u);  // bit S & 31 of w
  };
  auto word = [&](int j) {
    if (writer && j < n_words) bits[j] = S;
  };
  if (!kSpill) {
    const uint2* d = sh - skip;
    for (int k = 0; k < n0; ++k) back(d[L - 1 - k]);
    for (int b = 1; b <= J; ++b) {
      const int top = base + 32 * (J + 1 - b);
      word(J + 1 - b);
#pragma unroll
      for (int k = 0; k < 32; ++k) back(d[top - k]);
    }
  } else {
    // window m's step top(b) - lane, for its ring slot lane
    auto fetch = [&](int b, int m) {
      const int top = b == 0 ? L - 1 : base + 32 * (J + 1 - b);
      const bool in = m < n_here && b <= J && lane < (b == 0 ? n0 : 32);
      return in ? scratch[(g0 + m) * (L - skip) + top - lane - skip]
                : make_uint2(0, 0);
    };
    uint2 pf[kMaxWarps];
#pragma unroll
    for (int m = 0; m < kMaxWarps; ++m) pf[m] = fetch(0, m);
    for (int b = 0; b <= J; ++b) {
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kMaxWarps; ++m)
        if (m < n_here) region(m)[lane] = pf[m];
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kMaxWarps; ++m) pf[m] = fetch(b + 1, m);
      if (b == 0) {
        for (int k = 0; k < n0; ++k) back(sh[k]);
      } else {
        word(J + 1 - b);
#pragma unroll
        for (int k = 0; k < 32; ++k) back(sh[k]);
      }
    }
  }
  word(0);
}

// K1's input: lane's step at extended position p (the carried tail below
// ov, the punctured block through the static Table-3 rank, erasures past
// it).  q = p - ov = grp * period + ph is kept by increments, no division
// per chunk.
struct PunctFeed {
  const uint8_t* cm;
  const uint8_t* tm;
  int ov, n_bits, period, keep;
  uint64_t rank;  // byte ph: x's rank + 1 (low 4 bits), y's (high 4 bits)
  int p, ph, base, dph, dbase;
  __device__ PunctFeed(const uint8_t* cm_, const uint8_t* tm_, int ov_,
                       int n_bits_, int period_, int keep_, uint64_t rank_,
                       int p_)
      : cm(cm_), tm(tm_), ov(ov_), n_bits(n_bits_), period(period_),
        keep(keep_), rank(rank_), p(p_) {
    const int q = p - ov;
    const int grp = (q >= 0 ? q : q - period + 1) / period;  // floor
    ph = q - grp * period;
    base = grp * keep;
    dph = 32 % period;
    dbase = 32 / period * keep;
  }
  __device__ __forceinline__ unsigned next() {
    Step v{0, 0, 0, 0};
    if (p < ov) {
      v = Step{tm[p], tm[ov + p], tm[2 * ov + p], tm[3 * ov + p]};
    } else if (p - ov < n_bits) {
      const int rx = (int)((rank >> (8 * ph)) & 15u) - 1;
      const int ry = (int)((rank >> (8 * ph + 4)) & 15u) - 1;
      if (rx >= 0) v.sx = cm[base + rx], v.mx = 1;
      if (ry >= 0) v.sy = cm[base + ry], v.my = 1;
    }
    p += 32;
    ph += dph;
    base += dbase;
    if (ph >= period) ph -= period, base += keep;
    return bm_word(v);
  }
};

// K3's input: x, y, xm, ym of the mux's row at q = p - ov.
struct DepunctFeed {
  const uint8_t *x, *y, *xm, *ym, *tm;
  int ov, n_bits, p;
  __device__ __forceinline__ unsigned next() {
    Step v{0, 0, 0, 0};
    if (p < ov) {
      v = Step{tm[p], tm[ov + p], tm[2 * ov + p], tm[3 * ov + p]};
    } else if (p - ov < n_bits) {
      const int q = p - ov;
      v = Step{x[q], y[q], xm[q], ym[q]};
    }
    p += 32;
    return bm_word(v);
  }
};

// The warp's window: its mux and index, its decisions, its body's bits
// (shared memory after the decisions or the ring), and the block's share
// of the windows.
template <bool kSpill>
struct WarpWindow {
  int64_t m, w, g0;
  Decisions<kSpill> dec;
  unsigned* bits;
  bool valid;
  int n_here;  // windows of this block
  __device__ WarpWindow(unsigned char* smem, uint2* scratch, int64_t n_mux,
                        int64_t n_win, int window_bytes, int L, int skip) {
    const int warp = threadIdx.x >> 5;
    g0 = (int64_t)blockIdx.x * (blockDim.x >> 5);
    n_here = (int)min((int64_t)(blockDim.x >> 5), n_mux * n_win - g0);
    const int64_t g = g0 + warp;
    m = g / n_win;
    w = g - m * n_win;
    dec.sh = reinterpret_cast<uint2*>(smem + (size_t)warp * window_bytes);
    dec.dev = kSpill ? scratch + g * (L - skip) : nullptr;
    dec.skip = skip;
    bits = reinterpret_cast<unsigned*>(dec.sh + (kSpill ? 32 : L - skip));
    valid = g < n_mux * n_win;
  }
};

template <bool kSpill>
__global__ void
__launch_bounds__(256, kSpill ? kSpillMinBlocks : kResidentMinBlocks)
    viterbi_punct_kernel(const uint8_t* __restrict__ coded,
                         const uint8_t* __restrict__ tail,
                         uint8_t* __restrict__ out, uint2* scratch,
                         int64_t n_mux, int64_t n_c,
                         int n_bits, int64_t n_win, int body, int ov,
                         int period, int keep, uint64_t rank, int window_bytes,
                         int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = body + 2 * ov;
  __shared__ int best[kMaxWarps];
  const WarpWindow<kSpill> ww(smem, scratch, n_mux, n_win, window_bytes, L,
                              skip);
  const int start = (int)ww.w * body;  // extended position
  if (ww.valid) {
    const uint8_t* cm = coded + ww.m * n_c;
    const uint8_t* tm = tail + ww.m * 4 * (int64_t)ov;  // rows x, y, xm, ym
    PunctFeed feed(cm, tm, ov, n_bits, period, keep, rank,
                   start + (int)(threadIdx.x & 31));
    const int st = acs_forward(feed, ww.dec, L);
    if ((threadIdx.x & 31) == 0) best[threadIdx.x >> 5] = st;
  }
  __syncthreads();
  if (threadIdx.x < 32)
    traceback_block<kSpill>(smem, scratch, best, ww.n_here, ww.g0,
                            window_bytes, L, ov, body, skip);
  __syncthreads();
  if (!ww.valid) return;  // the whole warp

  const int n_bytes = n_bits >> 3;
  const int obase = (int)ww.w * (body >> 3);
  const int n_out = min(body >> 3, n_bytes - obase);
  uint8_t* om = out + ww.m * n_bytes + obase;
  for (int b = threadIdx.x & 31; b < n_out; b += 32)  // MSB-first bytes
    om[b] = (uint8_t)(__brev(ww.bits[b >> 2] >> (8 * (b & 3))) >> 24);
}

template <bool kSpill>
__global__ void
__launch_bounds__(256, kSpill ? kSpillMinBlocks : kResidentMinBlocks)
    viterbi_depunct_kernel(const uint8_t* __restrict__ x,
                           const uint8_t* __restrict__ y,
                           const uint8_t* __restrict__ xm,
                           const uint8_t* __restrict__ ym,
                           const uint8_t* __restrict__ tail,
                           uint8_t* __restrict__ out, uint2* scratch,
                           int64_t n_mux, int n_bits, int64_t n_win, int body, int ov,
                           int window_bytes, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = body + 2 * ov;
  __shared__ int best[kMaxWarps];
  const WarpWindow<kSpill> ww(smem, scratch, n_mux, n_win, window_bytes, L,
                              skip);
  const int64_t row = ww.m * n_bits;
  const int start = (int)ww.w * body;  // extended position
  if (ww.valid) {
    const uint8_t* tm = tail + ww.m * 4 * (int64_t)ov;  // rows x, y, xm, ym
    DepunctFeed feed{x + row, y + row, xm + row, ym + row, tm, ov, n_bits,
                     start + (int)(threadIdx.x & 31)};
    const int st = acs_forward(feed, ww.dec, L);
    if ((threadIdx.x & 31) == 0) best[threadIdx.x >> 5] = st;
  }
  __syncthreads();
  if (threadIdx.x < 32)
    traceback_block<kSpill>(smem, scratch, best, ww.n_here, ww.g0,
                            window_bytes, L, ov, body, skip);
  __syncthreads();
  if (!ww.valid) return;  // the whole warp

  const int n_out = min(body, n_bits - start);
  uint8_t* om = out + row + start;
  for (int u = threadIdx.x & 31; u < n_out; u += 32)
    om[u] = (uint8_t)((ww.bits[u >> 5] >> (u & 31)) & 1u);
}

// Shared bytes one window needs: its decisions (steps [skip, L)) or, when
// they spill to device memory, a 32-step ring; then its body's bits.
int64_t window_need(int64_t body, int64_t ov, int64_t skip, bool spill) {
  return 8 * (spill ? 32 : body + 2 * ov - skip) + 4 * ((body + 31) / 32);
}

// Checks the geometry from window_geometry and sets the kernel's shared
// memory.  blocks_per_sm is the residency the geometry counted on: a kernel
// whose registers or shared memory allow fewer blocks per SM is refused.
template <class Kernel>
int configure(Kernel kernel, int64_t warps, int64_t window_bytes,
              int64_t body, int64_t ov, int64_t skip, bool spill,
              int64_t blocks_per_sm) {
  if (warps < 1 || warps > kMaxWarps || ov < 5 || skip < 0 ||
      skip > ov + 6 || skip % 32 || window_bytes % 128 != 8 ||
      window_bytes < window_need(body, ov, skip, spill) || blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(warps * window_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int fit = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kernel, (int)(32 * warps), (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  return fit >= blocks_per_sm ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace

// scratch: device memory for the decisions of every window (n_mux * n_win
// windows of L - skip pairs), or null to keep them in shared memory.
extern "C" int dvbt_viterbi_punct(const void* coded, const void* tail,
                                  void* out, int64_t n_mux, int64_t n_c,
                                  int64_t n_bits, int64_t body, int64_t ov,
                                  int64_t period, int64_t keep, int64_t rank,
                                  int64_t grid, int64_t warps,
                                  int64_t window_bytes, int64_t skip,
                                  int64_t blocks_per_sm, void* scratch,
                                  void* cuda_stream) {
  const int64_t n_win = (n_bits + body - 1) / body;
  if (grid * warps < n_mux * n_win) return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel) {
    const int code = configure(kernel, warps, window_bytes, body, ov, skip,
                               scratch != nullptr, blocks_per_sm);
    if (code != 0) return code;
    kernel<<<(unsigned)grid, (unsigned)(32 * warps),
             (size_t)(warps * window_bytes), (cudaStream_t)cuda_stream>>>(
        (const uint8_t*)coded, (const uint8_t*)tail, (uint8_t*)out,
        (uint2*)scratch, n_mux, n_c, (int)n_bits, n_win, (int)body, (int)ov,
        (int)period, (int)keep, (uint64_t)rank, (int)window_bytes,
        (int)skip);
    return (int)cudaGetLastError();
  };
  return scratch ? run(viterbi_punct_kernel<true>)
                 : run(viterbi_punct_kernel<false>);
}

extern "C" int dvbt_viterbi_depunct(const void* x, const void* y,
                                    const void* xm, const void* ym,
                                    const void* tail, void* out,
                                    int64_t n_mux, int64_t n_bits,
                                    int64_t body, int64_t ov, int64_t grid,
                                    int64_t warps, int64_t window_bytes,
                                    int64_t skip, int64_t blocks_per_sm,
                                    void* scratch, void* cuda_stream) {
  const int64_t n_win = (n_bits + body - 1) / body;
  if (grid * warps < n_mux * n_win) return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel) {
    const int code = configure(kernel, warps, window_bytes, body, ov, skip,
                               scratch != nullptr, blocks_per_sm);
    if (code != 0) return code;
    kernel<<<(unsigned)grid, (unsigned)(32 * warps),
             (size_t)(warps * window_bytes), (cudaStream_t)cuda_stream>>>(
        (const uint8_t*)x, (const uint8_t*)y, (const uint8_t*)xm,
        (const uint8_t*)ym, (const uint8_t*)tail, (uint8_t*)out,
        (uint2*)scratch, n_mux, (int)n_bits, n_win, (int)body, (int)ov,
        (int)window_bytes, (int)skip);
    return (int)cudaGetLastError();
  };
  return scratch ? run(viterbi_depunct_kernel<true>)
                 : run(viterbi_depunct_kernel<false>);
}
