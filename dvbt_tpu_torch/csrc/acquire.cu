// CP-correlation symbol acquisition (R1, EN 300 744 §4.4): the
// ofdm_sym_acquisition block, timing and fractional carrier offset of raw
// captures, in two launches (the fold, then a one-block-a-capture pick).
//
// Replaces no TPU kernel: the JAX package leaves the acquisition to XLA.
// The port's plain version (kernels/acquire.py) casts the capture to
// complex128, takes float64 and complex128 running sums over each whole
// capture (a float32 running sum over millions of samples loses the
// G-sample window sums to round-off), forms the window sums as their
// differences and folds the metric over the symbol periods: ~20 PyTorch
// operations, two of them scans over eight 3.4 M-sample rows that keep a
// few SMs busy, 17-19 ms of a 29 ms capture pass on the H100 (8 captures
// of 409 8K symbols).  The block's bound is its bytes: the capture read
// once, 8 x 3,455,232 complex64 samples = 221 MB, 0.066 ms at 3.35 TB/s;
// the float64 arithmetic (~40 operations a sample) is of the same order.
// The design reads the capture from HBM about once and keeps every
// intermediate on chip:
//   - a block owns T consecutive timing candidates theta of one capture
//     (a theta tile, T >= G, T + G - 1 <= 4 x threads) and a contiguous
//     group of its symbol periods (folds); for each fold f it stages
//     x[fL + theta0 ..] and x[fL + theta0 + N ..] (T + G - 1 samples each)
//     in shared memory with asynchronous 8-byte copies, a warp reading 256
//     contiguous bytes, the next fold's copies in flight while the block
//     works on this one; the halo (G of every T + G - 1) and the second
//     range come mostly from L2, since the neighbouring tiles and the next
//     fold read them too;
//   - the block forms a conj(b) and (|a|^2 + |b|^2) / 2 in float64, takes
//     one block-wide exclusive scan of each over the tile (4 consecutive
//     samples a thread, then warp shuffles, then the warps' totals), and
//     reads gamma(theta) and phi(theta) as differences of that scan G
//     apart: a scan over ~1,000 samples in float64, more accurate than the
//     plain version's scan over the whole capture;
//   - it adds |gamma| - rho phi and gamma over its folds in float64
//     registers, a few theta a thread, and writes the group's partial sums
//     (score, gamma) to a float64 scratch (rows, groups, 3, L);
//   - the pick (one block a capture) sums the groups in a fixed order,
//     takes the first argmax over L (NaN counting as largest, as
//     torch.argmax does), and computes cfo = -angle(sum gamma) / 2 pi in
//     double.  No atomics: the same input gives the same bits every run.
// Shared memory is padded (one spare slot after every 4 entries), so a
// thread's 4 consecutive samples and scan entries fall in distinct banks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kElems = 4;             // consecutive samples a thread scans
constexpr int kPickThreads = 1024;
constexpr double kRho = 0.1;          // the plain version's energy weight
constexpr double kTwoPi = 6.283185307179586476925286766559;

// padded shared-memory index: a spare slot after every kElems entries
__device__ __forceinline__ int pad(int i) { return i + i / kElems; }

__device__ __forceinline__ void copy8_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

// stage x[base + j] and x[base + n_fft + j], j < n_ld, in shared memory
template <int kThreads>
__device__ __forceinline__ void stage(const float2* x, int64_t base,
                                      int n_fft, int n_ld, float2* ra,
                                      float2* rb) {
  for (int j = threadIdx.x; j < n_ld; j += kThreads) {
    copy8_async(ra + pad(j), x + base + j);
    copy8_async(rb + pad(j), x + base + n_fft + j);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// grid (theta tile, fold group, capture row).  partial: float64 (rows,
// groups, 3, L): each theta's score, Re gamma, Im gamma summed over the
// group's folds.
// at most 64 registers: 4 blocks of 256 threads an SM (2 of 512, 1 of 1024)
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
acquire_fold_kernel(const float2* __restrict__ x, double* __restrict__ partial,
                    int64_t row_stride, int n_fft, int n_guard, int n_folds,
                    int tile) {
  constexpr int kCap = kElems * kThreads;       // samples a tile stages
  constexpr int kPad = kCap + kCap / kElems;    // padded length
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  // the scans' prefix sums (S[0] = 0, S[j + 1] = sum of the first j + 1
  // terms), then the staged samples
  double* s_re = reinterpret_cast<double*>(smem);
  double* s_im = s_re + kPad + 1;
  double* s_en = s_im + kPad + 1;
  float2* ra = reinterpret_cast<float2*>(s_en + kPad + 1);
  float2* rb = ra + kPad;
  __shared__ double wsum[kWarps][3];

  const int G = n_guard, L = n_fft + n_guard;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int theta0 = blockIdx.x * tile;
  const int n_theta = min(tile, L - theta0);
  const int n_ld = n_theta + G - 1;
  const int n_groups = gridDim.y, g = blockIdx.y;
  const int f0 = int(int64_t(g) * n_folds / n_groups);
  const int f1 = int(int64_t(g + 1) * n_folds / n_groups);
  const float2* xr = x + int64_t(blockIdx.z) * row_stride + theta0;

  double acc[kElems], gam_re[kElems], gam_im[kElems];
#pragma unroll
  for (int k = 0; k < kElems; ++k) acc[k] = gam_re[k] = gam_im[k] = 0.0;
  if (tid == 0) s_re[0] = s_im[0] = s_en[0] = 0.0;

  stage<kThreads>(xr, int64_t(f0) * L, n_fft, n_ld, ra, rb);
  for (int f = f0; f < f1; ++f) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    // this thread's 4 consecutive terms: their running sums go to the
    // thread's own scan slots, the warps' offsets are added below
    double t_re = 0.0, t_im = 0.0, t_en = 0.0;
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      const int j = tid * kElems + i;
      if (j < n_ld) {
        const float2 a = ra[pad(j)], b = rb[pad(j)];
        const double ar = a.x, ai = a.y, br = b.x, bi = b.y;
        t_re += ar * br + ai * bi;                       // a conj(b)
        t_im += ai * br - ar * bi;
        t_en += (ar * ar + ai * ai + br * br + bi * bi) * 0.5;
      }
      const int s = pad(j + 1);
      s_re[s] = t_re;
      s_im[s] = t_im;
      s_en[s] = t_en;
    }
    // inclusive scan of the threads' totals within the warp
    double w_re = t_re, w_im = t_im, w_en = t_en;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double u_re = __shfl_up_sync(0xffffffffu, w_re, d);
      const double u_im = __shfl_up_sync(0xffffffffu, w_im, d);
      const double u_en = __shfl_up_sync(0xffffffffu, w_en, d);
      if (lane >= d) {
        w_re += u_re;
        w_im += u_im;
        w_en += u_en;
      }
    }
    if (lane == 31) {
      wsum[warp][0] = w_re;
      wsum[warp][1] = w_im;
      wsum[warp][2] = w_en;
    }
    // the exclusive prefix of this thread within its warp
    double o_re = __shfl_up_sync(0xffffffffu, w_re, 1);
    double o_im = __shfl_up_sync(0xffffffffu, w_im, 1);
    double o_en = __shfl_up_sync(0xffffffffu, w_en, 1);
    if (lane == 0) o_re = o_im = o_en = 0.0;
    __syncthreads();                  // every staged sample read; wsum set
    if (f + 1 < f1) stage<kThreads>(xr, int64_t(f + 1) * L, n_fft, n_ld, ra,
                                    rb);
    double p_re = 0.0, p_im = 0.0, p_en = 0.0;   // the warps before, in order
    for (int w = 0; w < warp; ++w) {
      p_re += wsum[w][0];
      p_im += wsum[w][1];
      p_en += wsum[w][2];
    }
    o_re += p_re;
    o_im += p_im;
    o_en += p_en;
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      const int s = pad(tid * kElems + i + 1);
      s_re[s] += o_re;
      s_im[s] += o_im;
      s_en[s] += o_en;
    }
    __syncthreads();
    // gamma(theta0 + t) and phi(theta0 + t): window sums G apart
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      const int t = tid + k * kThreads;
      if (t < n_theta) {
        const int lo = pad(t), hi = pad(t + G);
        const double gr = s_re[hi] - s_re[lo];
        const double gi = s_im[hi] - s_im[lo];
        const double ph = s_en[hi] - s_en[lo];
        acc[k] += sqrt(gr * gr + gi * gi) - kRho * ph;
        gam_re[k] += gr;
        gam_im[k] += gi;
      }
    }
  }
  double* out = partial + (int64_t(blockIdx.z) * n_groups + g) * 3 * L +
                theta0;
#pragma unroll
  for (int k = 0; k < kElems; ++k) {
    const int t = tid + k * kThreads;
    if (t < n_theta) {
      out[t] = acc[k];
      out[L + t] = gam_re[k];
      out[2 * L + t] = gam_im[k];
    }
  }
}

// (score, theta) a beats b: the larger score, NaN the largest, the smaller
// theta on a tie
__device__ __forceinline__ bool beats(double sa, int ta, double sb, int tb) {
  const bool na = sa != sa, nb = sb != sb;
  if (na || nb) return na && (!nb || ta < tb);
  return sa > sb || (sa == sb && ta < tb);
}

// one block a capture row: theta = the first argmax over L of the groups'
// summed scores, cfo = -angle(summed gamma at theta) / 2 pi
__global__ void __launch_bounds__(kPickThreads)
acquire_pick_kernel(const double* __restrict__ partial, int32_t* theta_out,
                    float* cfo_out, int L, int n_groups) {
  __shared__ double best_s[kPickThreads / 32];
  __shared__ int best_t[kPickThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double* p = partial + int64_t(blockIdx.x) * n_groups * 3 * L;
  double bs = 0.0;
  int bt = -1;
  for (int t = tid; t < L; t += kPickThreads) {
    double s = 0.0;
    for (int g = 0; g < n_groups; ++g) s += p[int64_t(g) * 3 * L + t];
    if (bt < 0 || beats(s, t, bs, bt)) {
      bs = s;
      bt = t;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double os = __shfl_xor_sync(0xffffffffu, bs, o);
    const int ot = __shfl_xor_sync(0xffffffffu, bt, o);
    if (ot >= 0 && (bt < 0 || beats(os, ot, bs, bt))) {
      bs = os;
      bt = ot;
    }
  }
  if (lane == 0) {
    best_s[warp] = bs;
    best_t[warp] = bt;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kPickThreads / 32; ++w)
      if (best_t[w] >= 0 && (bt < 0 || beats(best_s[w], best_t[w], bs, bt))) {
        bs = best_s[w];
        bt = best_t[w];
      }
    double gr = 0.0, gi = 0.0;
    for (int g = 0; g < n_groups; ++g) {
      gr += p[(int64_t(g) * 3 + 1) * L + bt];
      gi += p[(int64_t(g) * 3 + 2) * L + bt];
    }
    theta_out[blockIdx.x] = bt;
    cfo_out[blockIdx.x] = float(-atan2(gi, gr) / kTwoPi);
  }
}

template <int kThreads>
cudaError_t launch_fold(const void* x, void* partial, int64_t n_rows,
                        int64_t row_stride, int64_t n_fft, int64_t n_guard,
                        int64_t n_folds, int64_t tile, int64_t n_tiles,
                        int64_t n_groups, cudaStream_t stream) {
  constexpr int kCap = kElems * kThreads;
  constexpr int kPad = kCap + kCap / kElems;
  if (tile + n_guard - 1 > kCap) return cudaErrorInvalidValue;
  auto kernel = acquire_fold_kernel<kThreads>;
  const size_t smem = size_t(3) * (kPad + 1) * 8 + size_t(2) * kPad * 8;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned(n_tiles), unsigned(n_groups), unsigned(n_rows)};
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float2*)x, (double*)partial, row_stride, int(n_fft),
      int(n_guard), int(n_folds), int(tile));
  return cudaGetLastError();
}

}  // namespace

// Acquisition of n_rows captures x (complex64, row r at x + r * row_stride
// samples, each holding at least n_folds * L + n_fft + n_guard - 1
// samples, L = n_fft + n_guard) -> theta int32 (n_rows,), the offset in
// [0, L) of the first whole symbol start, and cfo float32 (n_rows,), the
// fractional carrier offset in subcarriers.  The geometry is the wrapper's
// (kernels/acquire.py::geometry): theta tiles of `tile` candidates
// (n_tiles of them cover L, the last may be short; tile + n_guard - 1 <= 4
// x threads), n_groups contiguous groups of the n_folds symbol periods,
// threads 256, 512 or 1024 a fold block.  partial: float64 scratch (n_rows,
// n_groups, 3, L).
extern "C" int dvbt_acquire(const void* x, void* partial, void* theta,
                            void* cfo, int64_t n_rows, int64_t row_stride,
                            int64_t n_fft, int64_t n_guard, int64_t n_folds,
                            int64_t tile, int64_t n_tiles, int64_t n_groups,
                            int64_t threads, void* cuda_stream) {
  const int64_t L = n_fft + n_guard;
  if (n_rows <= 0 || n_rows > 65535 || n_fft <= 0 || n_guard <= 0 ||
      n_folds <= 0 || L > 0x7fffffff || n_folds * L > 0x7fffffff ||
      tile <= 0 || n_tiles <= 0 || n_tiles * tile < L ||
      (n_tiles - 1) * tile >= L || n_groups <= 0 || n_groups > n_folds ||
      n_groups > 65535 || row_stride < n_folds * L + n_fft + n_guard - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  cudaError_t err;
  if (threads == 256)
    err = launch_fold<256>(x, partial, n_rows, row_stride, n_fft, n_guard,
                           n_folds, tile, n_tiles, n_groups, st);
  else if (threads == 512)
    err = launch_fold<512>(x, partial, n_rows, row_stride, n_fft, n_guard,
                           n_folds, tile, n_tiles, n_groups, st);
  else if (threads == 1024)
    err = launch_fold<1024>(x, partial, n_rows, row_stride, n_fft, n_guard,
                            n_folds, tile, n_tiles, n_groups, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  acquire_pick_kernel<<<unsigned(n_rows), kPickThreads, 0, st>>>(
      (const double*)partial, (int32_t*)theta, (float*)cfo, int(L),
      int(n_groups));
  return (int)cudaGetLastError();
}
