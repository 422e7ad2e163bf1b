// K2: float32 weighted histogram pair for Hopper (sm_90a).
//
// Replaces torchmetrics_tpu/ops/pallas_hist.py::_hist_pair_kernel (entry hist_pair_pallas): for
// an index stream idx (int32 or int64) and two weight streams pos and neg (float32),
//
//   out[0, b] = sum_i pos[i] * [idx[i] == b],   out[1, b] = sum_i neg[i] * [idx[i] == b]
//
// for b in [0, length); other indices are dropped. The TPU kernel compares every 1024-bin block
// with every 4096-sample tile; here each sample is read once and its two weights are added to
// its bin, on the skeleton of K1 (csrc/bincount.cu):
//
//   - a grid-stride loop over samples;
//   - while both histograms fit a block's opt-in shared memory (2 * length * 4 bytes, up to
//     29,056 bins), each block adds into a private pair in dynamic shared memory and then adds
//     each non-zero bin once into the global output;
//   - above that, each weight is a float atomicAdd straight into global memory.
//
// Indices are range-checked in 64 bits before any narrowing, so an int64 value >= 2^31 never
// wraps into a valid bin. A zero weight adds nothing and is skipped; `neg` may be null, which
// counts as a zero stream.
//
// Contract on order: float atomics add in an order that changes from run to run. With 0/1
// weights (every caller of the curve sketch) each bin's sums are integers below 2^24, exact in
// any order, so the result is exact and repeatable. General weights give sums that may differ
// in the last bits between runs.
//
// Bound on the card: HBM bytes, 12 or 16 B per sample (index and two weights) against the peak
// bandwidth. What is likely to hold it below: contention on the few hot bins of a skewed score
// distribution in shared memory, and float atomics on the global branch.
//
// Plain C interface, loaded with ctypes: each entry returns a cudaError_t as an int.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

template <typename T>
__device__ __forceinline__ int bin_of(const T* __restrict__ idx, long long i, long long length) {
  const long long v = static_cast<long long>(idx[i]);
  return (v >= 0 && v < length) ? static_cast<int>(v) : -1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pair_shared(const T* __restrict__ idx, const float* __restrict__ pos,
                                                        const float* __restrict__ neg, long long n, int length,
                                                        float* __restrict__ out) {
  extern __shared__ float hist[];  // [0, length): pos, [length, 2 * length): neg, as out
  for (int b = threadIdx.x; b < 2 * length; b += blockDim.x) hist[b] = 0.f;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int b = bin_of(idx, i, length);
    if (b < 0) continue;
    const float p = pos[i];
    if (p != 0.f) atomicAdd(&hist[b], p);
    if (neg != nullptr) {
      const float q = neg[i];
      if (q != 0.f) atomicAdd(&hist[length + b], q);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 2 * length; b += blockDim.x) {
    const float h = hist[b];
    if (h != 0.f) atomicAdd(&out[b], h);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pair_global(const T* __restrict__ idx, const float* __restrict__ pos,
                                                        const float* __restrict__ neg, long long n, int length,
                                                        float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int b = bin_of(idx, i, length);
    if (b < 0) continue;
    const float p = pos[i];
    if (p != 0.f) atomicAdd(&out[b], p);
    if (neg != nullptr) {
      const float q = neg[i];
      if (q != 0.f) atomicAdd(&out[length + b], q);
    }
  }
}

int shared_bins_max(int device, int* bins) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bins = optin / static_cast<int>(2 * sizeof(float));
  return static_cast<int>(err);
}

template <typename T>
int launch(const T* idx, const float* pos, const float* neg, long long n, int length, float* out, int device,
           cudaStream_t stream) {
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
    const size_t smem = static_cast<size_t>(2) * length * sizeof(float);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(pair_shared<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_shared<T>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    pair_shared<T><<<grid, kThreads, smem, stream>>>(idx, pos, neg, n, length, out);
  } else {
    const long long resident = static_cast<long long>(sms) * (2048 / kThreads);
    const int grid = static_cast<int>(wanted < resident ? wanted : resident);
    pair_global<T><<<grid, kThreads, 0, stream>>>(idx, pos, neg, n, length, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bins the shared-memory branch holds on `device`; longer histograms take the global branch.
int tm_hist_pair_shared_bins_max(int device, int* bins) { return shared_bins_max(device, bins); }

// out (2, length) float32 += the weighted histograms of idx under pos and neg (neg may be null).
int tm_hist_pair(const void* idx, int idx_is_int64, const void* pos, const void* neg, long long n, int length,
                 void* out, int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* q = static_cast<const float*>(neg);
  float* o = static_cast<float*>(out);
  if (idx_is_int64) return launch(static_cast<const long long*>(idx), p, q, n, length, o, device, s);
  return launch(static_cast<const int*>(idx), p, q, n, length, o, device, s);
}

const char* tm_hist_pair_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
