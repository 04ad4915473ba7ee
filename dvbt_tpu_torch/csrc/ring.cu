// K4: the halo ring, shift(x) -> x of the LEFT neighbour, i.e.
// ppermute(x, [(i, i+1 mod D)]) between processes through CUDA IPC.
//
// Replaces dvbt_tpu/parallel/ring.py::_shift_kernel, which signals a barrier
// semaphore on both neighbours, waits for both, then DMAs its buffer into
// the right neighbour's output over the TPU interconnect.  Here every rank
// is a process with its own CUDA context.  Each rank owns one cudaMalloc'd
// region: kHeader bytes of flag words, then its receive buffer.  The ranks
// exchange IPC handles of their regions once; afterwards a rank writes into
// its right neighbour's region and signals both neighbours' flags directly.
// On one card the regions are all in the card's memory and the contexts run
// time-sliced; with a card per rank the stores cross the link.
//
// One launch per shift, sequence number seq (1, 2, ... per ring object):
//   1. neighbour barrier: thread 0 of every block stores seq, with release
//      semantics at system scope, into the left neighbour's kFromRight word
//      and the right neighbour's kFromLeft word, then waits (acquire loads)
//      until both of its own words are >= seq.  A neighbour that entered
//      call seq has finished call seq-1, so its receive buffer is free;
//   2. the payload goes into the right neighbour's receive buffer, 16-byte
//      vectors when both pointers are 16-byte aligned, then bytes;
//   3. each block fences at system scope and adds 1 to the right
//      neighbour's kData word; the left neighbour's payload of call seq is
//      complete in this rank's buffer once kData >= seq * kBlocks;
//   4. the receive buffer is copied out into the caller's output tensor
//      (loads bypass L1: another context wrote it).
// Every wait is bounded by %globaltimer: past the deadline the kernel
// writes an error code and the sequence number into a word of mapped host
// memory and returns; the wrapper raises on it.  The bytes moved are 2x
// the payload (store to the neighbour, copy-out), a few microseconds of
// HBM time at the flagship halo; the barrier across contexts costs more.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 16;
constexpr int kThreads = 256;
constexpr int64_t kHeader = 256;  // flag words, then the receive buffer
constexpr int kFromLeft = 0;      // seq of the left neighbour's last entry
constexpr int kFromRight = 1;     // seq of the right neighbour's last entry
constexpr int kData = 2;          // blocks of payload landed, cumulative
constexpr int kBarrierTimeout = 1;
constexpr int kDataTimeout = 2;

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle is 64 bytes");

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ bool wait_at_least(const uint64_t* p, uint64_t target,
                              uint64_t deadline) {
  while (load_acquire(p) < target) {
    if (now_ns() > deadline) return false;
    __nanosleep(200);
  }
  return true;
}

__device__ void report(volatile int* err, int code, uint64_t seq) {
  err[1] = (int)seq;
  err[0] = code;
  __threadfence_system();
}

// Grid-stride copy of n bytes; loads bypass L1.
__device__ void copy_payload(uint8_t* dst, const uint8_t* src, int64_t n) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t n16 = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    n16 = n >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int64_t i = tid; i < n16; i += stride) d[i] = __ldcg(s + i);
  }
  for (int64_t i = (n16 << 4) + tid; i < n; i += stride)
    dst[i] = __ldcg(src + i);
}

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                  int64_t n, uint8_t* mine, uint8_t* left, uint8_t* right,
                  uint64_t seq, uint64_t timeout_ns, int* err) {
  __shared__ bool ok;
  uint64_t* my_flags = reinterpret_cast<uint64_t*>(mine);
  if (threadIdx.x == 0) {
    store_release(reinterpret_cast<uint64_t*>(left) + kFromRight, seq);
    store_release(reinterpret_cast<uint64_t*>(right) + kFromLeft, seq);
    const uint64_t deadline = now_ns() + timeout_ns;
    ok = wait_at_least(my_flags + kFromLeft, seq, deadline) &&
         wait_at_least(my_flags + kFromRight, seq, deadline);
    if (!ok) report(err, kBarrierTimeout, seq);
  }
  __syncthreads();
  if (!ok) return;

  copy_payload(right + kHeader, src, n);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd_system(reinterpret_cast<unsigned long long*>(right) + kData,
                     1ull);
    const uint64_t deadline = now_ns() + timeout_ns;
    ok = wait_at_least(my_flags + kData, seq * (uint64_t)gridDim.x, deadline);
    if (!ok) report(err, kDataTimeout, seq);
    __threadfence();
  }
  __syncthreads();
  if (!ok) return;

  copy_payload(out, mine + kHeader, n);
}

}  // namespace

// A region of kHeader flag bytes (zeroed) plus nbytes of receive buffer.
extern "C" int dvbt_ring_alloc(int64_t device, int64_t nbytes, void** base) {
  cudaError_t e = cudaSetDevice((int)device);
  if (e == cudaSuccess) e = cudaMalloc(base, (size_t)(kHeader + nbytes));
  if (e == cudaSuccess) e = cudaMemset(*base, 0, (size_t)kHeader);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

extern "C" int dvbt_ring_free(void* base) { return (int)cudaFree(base); }

// The 64-byte IPC handle of a region from dvbt_ring_alloc.
extern "C" int dvbt_ring_get_handle(void* base, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, base);
  if (e == cudaSuccess) std::memcpy(handle, &h, sizeof h);
  return (int)e;
}

// Map another process's region into this one (never one's own: CUDA
// refuses a handle in the process that made it).
extern "C" int dvbt_ring_open_handle(int64_t device, const void* handle,
                                     void** base) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  cudaError_t e = cudaSetDevice((int)device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
  return (int)e;
}

extern "C" int dvbt_ring_close_handle(void* base) {
  return (int)cudaIpcCloseMemHandle(base);
}

// Two ints of mapped, zeroed host memory (error code, sequence number)
// that the kernel writes on a timeout: *host for the wrapper, *dev for it.
extern "C" int dvbt_ring_error_word(void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, 2 * sizeof(int),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  std::memset(*host, 0, 2 * sizeof(int));
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

extern "C" int dvbt_ring_free_host(void* host) {
  return (int)cudaFreeHost(host);
}

// One shift: src (n bytes, this rank's payload) -> out (n bytes, the left
// neighbour's payload).  mine/left/right are the regions of this rank and
// its neighbours (mapped through IPC; this rank's own for D = 1).
extern "C" int dvbt_ring_shift(const void* src, void* out, int64_t n,
                               void* mine, void* left, void* right,
                               int64_t seq, int64_t timeout_ns, void* err,
                               void* cuda_stream) {
  ring_shift_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)src, (uint8_t*)out, n, (uint8_t*)mine, (uint8_t*)left,
      (uint8_t*)right, (uint64_t)seq, (uint64_t)timeout_ns, (int*)err);
  return (int)cudaGetLastError();
}
