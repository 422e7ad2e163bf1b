// K1: exact bincount for Hopper (sm_90a), one launch per call.
//
// Replaces torchmetrics_tpu/ops/pallas_hist.py::_bincount_kernel (entry bincount_pallas). That
// kernel sweeps every 1024-bin output block against every 4096-sample tile with a broadcast
// compare, which on this card would be O(N * length / 128) wasted work. Here each sample is
// read once and added to its bin with an integer atomic, and the launch writes the whole output
// in the caller's dtype (int32 or int64), zeros included: no fill before it, no cast after it.
//
//   - Shared branch (length + 1 words fit in a block's opt-in shared memory, 58,111 bins on an
//     H100). Each block counts into shared memory: one sub-histogram per warp while 16 copies
//     fit in 48 KB (length <= 768; at C = 5 the 25 bins would otherwise take every warp's adds
//     on the same words), else one per block. Then it adds its non-zero bins into an int32 sum
//     in global scratch, and after a __threadfence() takes a ticket (an atomicAdd on a counter
//     beside the sums). The block that draws the last ticket writes every bin of the output from
//     the sums, then sets the sums and the ticket back to 0, so the next call on the stream, and
//     a CUDA-graph replay, find them clean. The wrapper keeps that scratch per device and stream
//     (ops/bincount.py::zeroed_scratch). A grid of one block writes the output directly.
//     Why a ticket and not a thread-block cluster: the partial sums are at most 58K words, and a
//     cluster of at most 16 blocks would still need a second merge across clusters.
//   - Global branch (longer histograms; C = 1000 classes give C*C = 1M bins). The C entry zeroes
//     the output with cudaMemsetAsync on the caller's stream, then each sample is an atomicAdd
//     straight into the output in its own width (unsigned long long for int64). A cooperative
//     launch that zeroes, syncs the grid and counts would save the memset, but caps the grid at
//     the resident blocks and needs the cooperative launch API; the memset is one device op.
//
// Each thread keeps 4 loads in flight before it adds, so that enough bytes are on their way to
// cover HBM's latency (one load per thread left the 2^26-sample stream at 61% of the bound).
//
// Two loaders share the kernel body: a plain index stream (int32 or int64), the counterpart of
// bincount_pallas, and a confusion loader that reads preds and target (int32 or int64) and forms
// target*C + pred in registers, so the fused index never touches device memory. Range checks
// run in 64 bits before any narrowing, as pallas_hist.py:70-76 does: an int64 value >= 2^31
// never wraps into a valid bin.
//
// Counts are exact integers; integer adds commute, so the result does not depend on the order
// of the atomics. Device attributes and occupancy are queried once per device and kernel
// (device_cache.cuh), not on every call.
//
// Bound on the card: HBM bytes, 4 or 8 B per index, or 8 to 16 B per confusion sample, against
// the peak bandwidth.
//
// Plain C interface, loaded with ctypes: each entry returns a cudaError_t as an int.

#include <cuda_runtime.h>

#include "device_cache.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// per-warp sub-histograms while kWarps copies fit in the default 48 KB of shared memory
constexpr int kSubHistBytes = 48 * 1024;
// words of scratch before the cross-block sums; word 0 is the ticket
constexpr int kScratchHead = 32;

template <typename T>
struct IndexLoader {
  const T* __restrict__ x;
  long long length;

  __device__ __forceinline__ int operator()(long long i) const {
    const long long v = static_cast<long long>(x[i]);
    return (v >= 0 && v < length) ? static_cast<int>(v) : -1;
  }
};

template <typename TP, typename TT>
struct ConfusionLoader {
  const TP* __restrict__ preds;
  const TT* __restrict__ target;
  const unsigned char* __restrict__ mask;  // may be null; a 0 drops the sample
  long long num_classes;
  long long ignore_index;
  int has_ignore;

  __device__ __forceinline__ int operator()(long long i) const {
    const long long t = static_cast<long long>(target[i]);
    const long long p = static_cast<long long>(preds[i]);
    bool keep = t >= 0 && t < num_classes && p >= 0 && p < num_classes;
    if (has_ignore) keep = keep && t != ignore_index;
    if (mask != nullptr) keep = keep && mask[i] != 0;
    // num_classes <= 46340 is checked by the caller, so t*C + p fits an int
    return keep ? static_cast<int>(t * num_classes + p) : -1;
  }
};

__device__ __forceinline__ void bump(unsigned* p) { atomicAdd(p, 1u); }
__device__ __forceinline__ void bump(int* p) { atomicAdd(p, 1); }
__device__ __forceinline__ void bump(long long* p) { atomicAdd(reinterpret_cast<unsigned long long*>(p), 1ULL); }

// Adds one to hist[bin] for every kept sample of [0, n), over a grid-stride loop with kUnroll
// loads in flight per thread.
template <class Loader, typename H>
__device__ __forceinline__ void count(const Loader& load, long long n, H* hist) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) b[k] = load(i + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (b[k] >= 0) bump(hist + b[k]);
    }
  }
  for (; i < n; i += stride) {
    const int b = load(i);
    if (b >= 0) bump(hist + b);
  }
}

template <class Loader, typename OutT>
__global__ void __launch_bounds__(kThreads) hist_shared(Loader load, long long n, int length, int copies,
                                                        unsigned* __restrict__ scratch, OutT* __restrict__ out) {
  extern __shared__ unsigned hist[];  // copies * length counts, then one word: "this block is last"
  const int words = copies * length;
  for (int w = threadIdx.x; w < words; w += blockDim.x) hist[w] = 0;
  __syncthreads();
  count(load, n, hist + (threadIdx.x / 32 % copies) * length);
  __syncthreads();
  if (gridDim.x == 1) {
    for (int b = threadIdx.x; b < length; b += blockDim.x) {
      unsigned c = 0;
      for (int k = 0; k < copies; ++k) c += hist[k * length + b];
      out[b] = static_cast<OutT>(c);
    }
    return;
  }
  unsigned* ticket = scratch;
  unsigned* sums = scratch + kScratchHead;
  for (int b = threadIdx.x; b < length; b += blockDim.x) {
    unsigned c = 0;
    for (int k = 0; k < copies; ++k) c += hist[k * length + b];
    if (c != 0) atomicAdd(&sums[b], c);
  }
  __threadfence();  // this block's sums are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) hist[words] = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (hist[words] == 0) return;
  __threadfence();
  for (int b = threadIdx.x; b < length; b += blockDim.x) {
    out[b] = static_cast<OutT>(__ldcg(&sums[b]));
    sums[b] = 0;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <class Loader, typename OutT>
__global__ void __launch_bounds__(kThreads) hist_global(Loader load, long long n, OutT* __restrict__ out) {
  count(load, n, out);
}

int shared_bins_max(const tm_cache::Device& dev) { return dev.smem_optin / static_cast<int>(sizeof(unsigned)) - 1; }

template <class Loader, typename OutT>
int launch(const Loader& load, long long n, int length, OutT* out, unsigned* scratch, int device, cudaStream_t stream) {
  if (n <= 0 || length <= 0) return static_cast<int>(cudaSuccess);
  tm_cache::Device dev;
  cudaError_t err = tm_cache::device(device, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wanted = (n + kThreads - 1) / kThreads;
  if (length <= shared_bins_max(dev)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int copies = static_cast<long long>(kWarps) * length * sizeof(unsigned) <= kSubHistBytes ? kWarps : 1;
    const size_t smem = (static_cast<size_t>(copies) * length + 1) * sizeof(unsigned);
    int per_sm = 0;
    err = tm_cache::blocks_per_sm(hist_shared<Loader, OutT>, device, dev, kThreads, smem, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(dev.sms) * per_sm;
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    hist_shared<Loader, OutT><<<grid, kThreads, smem, stream>>>(load, n, length, copies, scratch, out);
  } else {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(length) * sizeof(OutT), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(dev.sms) * (2048 / kThreads);
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    hist_global<Loader, OutT><<<grid, kThreads, 0, stream>>>(load, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Loader>
int launch_as(const Loader& load, long long n, int length, void* out, int out_is_int64, void* scratch, int device,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* sc = static_cast<unsigned*>(scratch);
  if (out_is_int64) return launch(load, n, length, static_cast<long long*>(out), sc, device, s);
  return launch(load, n, length, static_cast<int*>(out), sc, device, s);
}

template <typename TP, typename TT>
int launch_confusion(const void* preds, const void* target, const void* mask, long long ignore_index,
                     int has_ignore, long long n, int num_classes, void* out, int out_is_int64, void* scratch,
                     int device, void* stream) {
  const ConfusionLoader<TP, TT> load{static_cast<const TP*>(preds), static_cast<const TT*>(target),
                                     static_cast<const unsigned char*>(mask), num_classes, ignore_index,
                                     has_ignore};
  return launch_as(load, n, num_classes * num_classes, out, out_is_int64, scratch, device, stream);
}

}  // namespace

extern "C" {

// Bins the shared branch holds on `device`; longer histograms take the global branch.
int tm_shared_bins_max(int device, int* bins) {
  tm_cache::Device dev;
  const cudaError_t err = tm_cache::device(device, &dev);
  *bins = err == cudaSuccess ? shared_bins_max(dev) : 0;
  return static_cast<int>(err);
}

// out[b] = #{i : x[i] == b} for b in [0, length), int32 or int64 (out_is_int64); other values
// are dropped. The shared branch needs `scratch`: kScratchHead + length int32 zeros, left zeroed.
int tm_bincount(const void* x, int x_is_int64, long long n, int length, void* out, int out_is_int64, void* scratch,
                int device, void* stream) {
  if (x_is_int64) {
    const IndexLoader<long long> load{static_cast<const long long*>(x), length};
    return launch_as(load, n, length, out, out_is_int64, scratch, device, stream);
  }
  const IndexLoader<int> load{static_cast<const int*>(x), length};
  return launch_as(load, n, length, out, out_is_int64, scratch, device, stream);
}

// out[t*C + p] = #{i : target[i] == t, preds[i] == p} over the samples with t, p in [0, C),
// t != ignore_index (when has_ignore) and mask[i] != 0 (when mask is not null). out is C*C
// int32 or int64; `scratch` as for tm_bincount.
int tm_confusion(const void* preds, int preds_is_int64, const void* target, int target_is_int64,
                 const void* mask, long long ignore_index, int has_ignore, long long n, int num_classes,
                 void* out, int out_is_int64, void* scratch, int device, void* stream) {
  if (preds_is_int64 && target_is_int64)
    return launch_confusion<long long, long long>(preds, target, mask, ignore_index, has_ignore, n, num_classes, out,
                                                  out_is_int64, scratch, device, stream);
  if (preds_is_int64)
    return launch_confusion<long long, int>(preds, target, mask, ignore_index, has_ignore, n, num_classes, out,
                                            out_is_int64, scratch, device, stream);
  if (target_is_int64)
    return launch_confusion<int, long long>(preds, target, mask, ignore_index, has_ignore, n, num_classes, out,
                                            out_is_int64, scratch, device, stream);
  return launch_confusion<int, int>(preds, target, mask, ignore_index, has_ignore, n, num_classes, out, out_is_int64,
                                    scratch, device, stream);
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
