// K1: int32 bincount for Hopper (sm_90a).
//
// Replaces torchmetrics_tpu/ops/pallas_hist.py::_bincount_kernel (entry bincount_pallas). That
// kernel sweeps every 1024-bin output block against every 4096-sample tile with a broadcast
// compare, which on this card would be O(N * length / 128) wasted work. Here each sample is
// read once and added to its bin with an integer atomic:
//
//   - a grid-stride loop over samples;
//   - while length * 4 bytes fit in a block's opt-in shared memory (227 KB, about 58K bins),
//     each block counts into a private int32 histogram in dynamic shared memory and then adds
//     each non-zero bin once into the global output;
//   - above that, each sample is an int32 atomicAdd straight into global memory (C = 1000
//     classes give C*C = 1M bins and take this branch).
//
// Two loaders share the kernel body: a plain index stream (int32 or int64), the counterpart of
// bincount_pallas, and a confusion loader that reads preds and target (int32 or int64) and forms
// target*C + pred in registers, so the fused index never touches device memory. Range checks
// run in 64 bits before any narrowing, as pallas_hist.py:70-76 does: an int64 value >= 2^31
// never wraps into a valid bin.
//
// Counts are int32 and exact past 2^24. Integer adds commute, so the result does not depend on
// the order of the atomics.
//
// Bound on the card: HBM bytes, 4 or 8 B per index, or 8 to 16 B per confusion sample, against
// the peak bandwidth. At C = 5 (25 bins) every warp contends on the same shared-memory words,
// which is what is likely to hold it below that bound; per-warp sub-histograms are the fix.
//
// Plain C interface, loaded with ctypes: each entry returns a cudaError_t as an int.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

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

template <class Loader>
__global__ void __launch_bounds__(kThreads) hist_shared(Loader load, long long n, int length, int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < length; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int b = load(i);
    if (b >= 0) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < length; b += blockDim.x) {
    const int c = hist[b];
    if (c != 0) atomicAdd(&out[b], c);
  }
}

template <class Loader>
__global__ void __launch_bounds__(kThreads) hist_global(Loader load, long long n, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int b = load(i);
    if (b >= 0) atomicAdd(&out[b], 1);
  }
}

int shared_bins_max(int device, int* bins) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bins = optin / static_cast<int>(sizeof(int));
  return static_cast<int>(err);
}

template <class Loader>
int launch(const Loader& load, long long n, int length, int* out, int device, cudaStream_t stream) {
  if (n <= 0 || length <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int bins_max = 0;
  const int rc = shared_bins_max(device, &bins_max);
  if (rc != 0) return rc;
  const long long wanted = (n + kThreads - 1) / kThreads;
  if (length <= bins_max) {
    const size_t smem = static_cast<size_t>(length) * sizeof(int);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(hist_shared<Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_shared<Loader>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    hist_shared<Loader><<<grid, kThreads, smem, stream>>>(load, n, length, out);
  } else {
    const long long resident = static_cast<long long>(sms) * (2048 / kThreads);
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    hist_global<Loader><<<grid, kThreads, 0, stream>>>(load, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, typename TT>
int launch_confusion(const void* preds, const void* target, const void* mask, long long ignore_index,
                     int has_ignore, long long n, int num_classes, int* out, int device, cudaStream_t stream) {
  const ConfusionLoader<TP, TT> load{static_cast<const TP*>(preds), static_cast<const TT*>(target),
                                     static_cast<const unsigned char*>(mask), num_classes, ignore_index,
                                     has_ignore};
  return launch(load, n, num_classes * num_classes, out, device, stream);
}

}  // namespace

extern "C" {

// Bins the shared-memory branch holds on `device`; longer histograms take the global branch.
int tm_shared_bins_max(int device, int* bins) { return shared_bins_max(device, bins); }

// out[b] += #{i : x[i] == b} for b in [0, length); other values are dropped. out is int32.
int tm_bincount(const void* x, int x_is_int64, long long n, int length, void* out, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (x_is_int64) {
    const IndexLoader<long long> load{static_cast<const long long*>(x), length};
    return launch(load, n, length, o, device, s);
  }
  const IndexLoader<int> load{static_cast<const int*>(x), length};
  return launch(load, n, length, o, device, s);
}

// out[t*C + p] += 1 for each sample with t, p in [0, C), t != ignore_index (when has_ignore)
// and mask[i] != 0 (when mask is not null). out is int32 of C*C.
int tm_confusion(const void* preds, int preds_is_int64, const void* target, int target_is_int64,
                 const void* mask, long long ignore_index, int has_ignore, long long n, int num_classes,
                 void* out, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (preds_is_int64 && target_is_int64)
    return launch_confusion<long long, long long>(preds, target, mask, ignore_index, has_ignore, n, num_classes, o, device, s);
  if (preds_is_int64)
    return launch_confusion<long long, int>(preds, target, mask, ignore_index, has_ignore, n, num_classes, o, device, s);
  if (target_is_int64)
    return launch_confusion<int, long long>(preds, target, mask, ignore_index, has_ignore, n, num_classes, o, device, s);
  return launch_confusion<int, int>(preds, target, mask, ignore_index, has_ignore, n, num_classes, o, device, s);
}

const char* tm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
