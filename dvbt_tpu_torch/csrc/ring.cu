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
//
// Two ways to wait, chosen by the wrapper at ring set-up from the cards the
// ranks are on (each measured the faster where it is used):
//
// A. Some ring neighbours share a card: the waits run in stream order, not
// on the SMs.  The flags are written and awaited with the driver's stream
// memory operations (cuStreamWriteValue64, cuStreamWaitValue64 >=), so a
// rank whose neighbours have not arrived has no kernel resident.  On one
// card the ranks' contexts are time-sliced, and a kernel that spun on a
// flag held its context's slice until the slice ended (~9 ms a call with 4
// ranks); a stream wait lets the card serve the other contexts at once.
// One shift, sequence number seq (1, 2, ... per ring object), all on the
// caller's stream:
//   dvbt_ring_send
//     1. write seq into the left neighbour's kFromRight word and the right
//        neighbour's kFromLeft word;
//     2. wait until this rank's kFromLeft >= seq and kFromRight >= seq.  A
//        neighbour that signalled seq has finished its copy-out of seq-1
//        (its signal follows that copy-out in its stream), so its receive
//        buffer is free;
//     3. store kernel: the payload goes into the right neighbour's receive
//        buffer (16-byte vectors when both pointers are 16-byte aligned,
//        then bytes), then a system-scope fence;
//     4. write seq into the right neighbour's kData word (a stream write
//        with the default flags is preceded by a memory barrier, so it
//        cannot pass step 3's stores);
//   dvbt_ring_receive
//     5. wait until this rank's kData >= seq;
//     6. copy-out kernel: the receive buffer goes into the caller's output
//        (loads bypass L1: another context wrote it).
// A stream wait has no deadline of its own: the wrapper's watchdog bounds
// each call, and on expiry writes an error code into a word of mapped host
// memory, which makes both kernels return at once, and releases the waits
// by writing past them into this rank's flags (dvbt_ring_release) from
// another stream.
//
// B. Every rank on a card of its own: dvbt_ring_shift, one kernel that
// does the same steps on the SMs.  Thread 0 of every block signals with
// st.release.sys and waits with ld.acquire.sys (bounded by %globaltimer:
// past the deadline it writes the error word and the kernel returns); each
// block stores its share, fences and adds 1 to the right neighbour's kData
// (payload complete at seq * kBlocks).  Across cards a spinning kernel
// takes nothing from anyone, and it is ~7x faster than the stream
// operations there (measured, PERF.md).
//
// The bytes moved are 2x the payload (store to the neighbour, copy-out), a
// few microseconds at the flagship halo; the waits cost more.
#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 16;
constexpr int kThreads = 256;
constexpr int64_t kHeader = 256;  // flag words, then the receive buffer
constexpr int kFromLeft = 0;      // seq of the left neighbour's last entry
constexpr int kFromRight = 1;     // seq of the right neighbour's last entry
constexpr int kData = 2;          // the left neighbour's payloads landed:
                                  // seq (route A), blocks (route B)
constexpr int kBarrierTimeout = 1;
constexpr int kDataTimeout = 2;
constexpr int kDriverError = 10000;  // + CUresult: a driver API failure

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle is 64 bytes");

using StreamValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t,
                                   unsigned int);
using DeviceGet = CUresult (*)(CUdevice*, int);
using DeviceGetAttribute = CUresult (*)(int*, CUdevice_attribute, CUdevice);
using GetErrorString = CUresult (*)(CUresult, const char**);
StreamValue64 write_value64 = nullptr;
StreamValue64 wait_value64 = nullptr;
GetErrorString get_error_string = nullptr;

// A driver entry point by name, at the CUDA 12.0 ABI.
template <typename Fn>
cudaError_t entry_point(const char* name, Fn* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                   cudaEnableDefault, &found);
  if (e == cudaSuccess && found != cudaDriverEntryPointSuccess)
    e = cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<Fn>(p);
  return e;
}

int driver(CUresult r) { return r == CUDA_SUCCESS ? 0 : kDriverError + r; }

CUdeviceptr flag(void* region, int word) {
  return reinterpret_cast<CUdeviceptr>(region) + word * sizeof(uint64_t);
}

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

// Route A's store and copy-out: copy_payload, after returning at once if
// the wrapper's watchdog has reported a timeout.
__global__ void __launch_bounds__(kThreads)
ring_copy_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                 int64_t n, const volatile int* err, bool fence) {
  __shared__ bool failed;
  if (threadIdx.x == 0) failed = err[0] != 0;
  __syncthreads();
  if (failed) return;
  copy_payload(dst, src, n);
  if (fence) __threadfence_system();
}

// Route B: the whole shift in one kernel, its waits bounded by the timer.
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

// Binds the driver's stream memory operations and checks that `device`
// supports them (64-bit).  attrs[0..1] get CU_DEVICE_ATTRIBUTE_
// CAN_USE_STREAM_MEM_OPS_V1 (deprecated with the v1 API) and
// CAN_USE_64_BIT_STREAM_MEM_OPS.  Returns cudaErrorNotSupported if the
// 64-bit operations are missing: there is no other barrier to fall back to.
extern "C" int dvbt_ring_stream_ops(int64_t device, void* attrs) {
  DeviceGet device_get;
  DeviceGetAttribute get_attribute;
  cudaError_t e = cudaSetDevice((int)device);
  if (e == cudaSuccess) e = cudaFree(nullptr);  // the primary context
  if (e == cudaSuccess) e = entry_point("cuStreamWriteValue64", &write_value64);
  if (e == cudaSuccess) e = entry_point("cuStreamWaitValue64", &wait_value64);
  if (e == cudaSuccess) e = entry_point("cuGetErrorString", &get_error_string);
  if (e == cudaSuccess) e = entry_point("cuDeviceGet", &device_get);
  if (e == cudaSuccess)
    e = entry_point("cuDeviceGetAttribute", &get_attribute);
  if (e != cudaSuccess) return (int)e;
  CUdevice dev;
  int v1 = 0, ops64 = 0;
  CUresult r = device_get(&dev, (int)device);
  if (r == CUDA_SUCCESS)
    r = get_attribute(&v1, CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1, dev);
  if (r == CUDA_SUCCESS)
    r = get_attribute(&ops64, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
                      dev);
  if (r != CUDA_SUCCESS) return driver(r);
  static_cast<int64_t*>(attrs)[0] = v1;
  static_cast<int64_t*>(attrs)[1] = ops64;
  return ops64 ? 0 : (int)cudaErrorNotSupported;
}

// The 16-byte UUID of a device: ranks compare theirs to tell whether ring
// neighbours share a card.
extern "C" int dvbt_ring_device_uuid(int64_t device, void* uuid) {
  cudaDeviceProp prop;
  const cudaError_t e = cudaGetDeviceProperties(&prop, (int)device);
  if (e == cudaSuccess) std::memcpy(uuid, &prop.uuid, sizeof prop.uuid);
  return (int)e;
}

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
// that the watchdog writes on a timeout: *host for it, *dev for the
// kernels.
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

// Route B, one shift: src (n bytes, this rank's payload) -> out (n bytes,
// the left neighbour's payload), every wait bounded by timeout_ns.
extern "C" int dvbt_ring_shift(const void* src, void* out, int64_t n,
                               void* mine, void* left, void* right,
                               int64_t seq, int64_t timeout_ns, void* err,
                               void* cuda_stream) {
  ring_shift_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      (const uint8_t*)src, (uint8_t*)out, n, (uint8_t*)mine, (uint8_t*)left,
      (uint8_t*)right, (uint64_t)seq, (uint64_t)timeout_ns, (int*)err);
  return (int)cudaGetLastError();
}

// Route A, steps 1-4 of a shift: src (n bytes, this rank's payload) into
// the right neighbour's receive buffer.  mine/left/right (both routes) are
// the regions of this rank and its neighbours (mapped through IPC; this
// rank's own for D = 1).
extern "C" int dvbt_ring_send(const void* src, int64_t n, void* mine,
                              void* left, void* right, int64_t seq, void* err,
                              void* cuda_stream) {
  const CUstream s = (CUstream)cuda_stream;
  const cuuint64_t v = (cuuint64_t)seq;
  CUresult r = write_value64(s, flag(left, kFromRight), v,
                             CU_STREAM_WRITE_VALUE_DEFAULT);
  if (r == CUDA_SUCCESS)
    r = write_value64(s, flag(right, kFromLeft), v,
                      CU_STREAM_WRITE_VALUE_DEFAULT);
  if (r == CUDA_SUCCESS)
    r = wait_value64(s, flag(mine, kFromLeft), v, CU_STREAM_WAIT_VALUE_GEQ);
  if (r == CUDA_SUCCESS)
    r = wait_value64(s, flag(mine, kFromRight), v, CU_STREAM_WAIT_VALUE_GEQ);
  if (r != CUDA_SUCCESS) return driver(r);
  ring_copy_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      (uint8_t*)right + kHeader, (const uint8_t*)src, n, (const int*)err,
      true);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return driver(write_value64(s, flag(right, kData), v,
                              CU_STREAM_WRITE_VALUE_DEFAULT));
}

// Route A, steps 5-6: once the left neighbour's payload of call seq has
// landed in this rank's buffer, copy it into out (n bytes).
extern "C" int dvbt_ring_receive(void* out, int64_t n, void* mine, int64_t seq,
                                 void* err, void* cuda_stream) {
  const CUresult r = wait_value64((CUstream)cuda_stream, flag(mine, kData),
                                  (cuuint64_t)seq, CU_STREAM_WAIT_VALUE_GEQ);
  if (r != CUDA_SUCCESS) return driver(r);
  ring_copy_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      (uint8_t*)out, (const uint8_t*)mine + kHeader, n, (const int*)err,
      false);
  return (int)cudaGetLastError();
}

// The watchdog's release: write value into this rank's three flag words
// on cuda_stream (another stream than the blocked one), so every wait of
// a call up to value passes.
extern "C" int dvbt_ring_release(void* mine, int64_t value,
                                 void* cuda_stream) {
  for (int word : {kFromLeft, kFromRight, kData}) {
    const CUresult r = write_value64((CUstream)cuda_stream, flag(mine, word),
                                     (cuuint64_t)value,
                                     CU_STREAM_WRITE_VALUE_DEFAULT);
    if (r != CUDA_SUCCESS) return driver(r);
  }
  return 0;
}

// The message of a code returned by any entry point of the library.
extern "C" const char* dvbt_error_string(int code) {
  if (code >= kDriverError) {
    const char* msg = nullptr;
    if (get_error_string == nullptr ||
        get_error_string((CUresult)(code - kDriverError), &msg) !=
            CUDA_SUCCESS || msg == nullptr)
      return "CUDA driver error";
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
