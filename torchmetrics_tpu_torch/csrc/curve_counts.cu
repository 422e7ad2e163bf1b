// K3: per-threshold weighted counts of the binned curve family, for Hopper (sm_90a).
//
// Replaces torchmetrics_tpu/ops/pallas_curve.py::_curve_counts_kernel (entry curve_counts_pallas)
// and the class-batched dot of precision_recall_curve.py::_indicator_counts. For each class row c
// of scores, pos and neg (C, N) and each threshold t:
//
//   tp[c, t] = sum_i pos[c, i] * [scores[c, i] >= thr[t]]
//   fp[c, t] = sum_i neg[c, i] * [scores[c, i] >= thr[t]]
//
// The compare is direct, so the thresholds need not be sorted, and a NaN score meets no
// threshold and counts nowhere, as in the JAX package. Nothing (N, T)-shaped is ever stored.
//
// Design. The TPU kernel keeps a (2, T) accumulator resident across a sequential grid over
// sample tiles. Here blocks run in parallel and in no order, so:
//
//   - a block owns one class row, up to 2048 thresholds (threshold chunk) and one contiguous
//     chunk of samples. Each thread holds PER_THREAD thresholds and their two sums in registers;
//   - the block stages 512 samples at a time in shared memory as (score, pos, neg) float4s, and
//     every thread walks the tile in the same order: each read is a broadcast, free of bank
//     conflicts, and feeds PER_THREAD compares and 2 * PER_THREAD adds;
//   - each block writes its sums to a (blocks, 2, C, T) scratch, and a second kernel adds the
//     scratch over blocks in a fixed order (a fixed split over 32 lanes, then a fixed tree).
//     There are no float atomics, so the result is bitwise repeatable for any weights. With one
//     sample block the first kernel writes the output itself.
//
// Bound on the card: operations. The work is 3 * C * N * T compares and adds against
// 12 * C * N bytes read; at C = 1, N = 1M, T = 200 that is 6e8 operations, 9 us at the float32
// rate outside the tensor cores, and 3.6 us of HBM reads. What holds the kernel below that bound:
// one shared-memory read per sample for every PER_THREAD thresholds (PER_THREAD is 2 at T = 200),
// and the idle lanes of the last warp when T is not a multiple of 32.
//
// Counts are float32: exact for 0/1 weights while a sum stays below 2^24, as in the JAX package.
//
// Plain C interface, loaded with ctypes: each entry returns a cudaError_t as an int.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kTile = 512;
constexpr int kReduceLanes = 32;

template <int PER_THREAD>
__global__ void __launch_bounds__(256) counts_partial(
    const float* __restrict__ scores, const float* __restrict__ pos, const float* __restrict__ neg,
    const float* __restrict__ thr, long long n, int num_classes, int num_thr, int chunks_t,
    long long chunk, float* __restrict__ partial) {
  __shared__ float4 tile[kTile];
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  const int span = blockDim.x * PER_THREAD;
  const long long plane = static_cast<long long>(num_classes) * num_thr;  // one (C, T) block of the scratch
  for (int row = blockIdx.y; row < num_classes * chunks_t; row += gridDim.y) {
    const int c = row / chunks_t;
    const int t0 = (row % chunks_t) * span;
    float my_thr[PER_THREAD];
    float tp[PER_THREAD];
    float fp[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int t = t0 + threadIdx.x + k * blockDim.x;
      my_thr[k] = t < num_thr ? thr[t] : INFINITY;
      tp[k] = 0.f;
      fp[k] = 0.f;
    }
    const float* s_row = scores + static_cast<long long>(c) * n;
    const float* p_row = pos + static_cast<long long>(c) * n;
    const float* n_row = neg + static_cast<long long>(c) * n;
    for (long long base = begin; base < end; base += kTile) {
      const int m = static_cast<int>(end - base < kTile ? end - base : kTile);
      __syncthreads();  // every thread is done with the previous tile
      for (int j = threadIdx.x; j < m; j += blockDim.x) {
        tile[j] = make_float4(s_row[base + j], p_row[base + j], n_row[base + j], 0.f);
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float4 v = tile[j];
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
          const bool hit = v.x >= my_thr[k];
          tp[k] += hit ? v.y : 0.f;
          fp[k] += hit ? v.z : 0.f;
        }
      }
    }
    float* out = partial + static_cast<long long>(blockIdx.x) * 2 * plane + static_cast<long long>(c) * num_thr;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int t = t0 + threadIdx.x + k * blockDim.x;
      if (t < num_thr) {
        out[t] = tp[k];
        out[plane + t] = fp[k];
      }
    }
  }
}

// out[r] = sum over b of partial[b * rows + r], for r in [0, rows). A block of 32 x 32 threads
// covers 32 outputs: lane y sums b = y, y + 32, ... in order, then the 32 lane sums are added
// by a fixed tree. The order of the adds depends only on `blocks`, never on the schedule.
__global__ void __launch_bounds__(kReduceLanes * kReduceLanes) counts_reduce(
    const float* __restrict__ partial, int blocks, long long rows, float* __restrict__ out) {
  __shared__ float sums[kReduceLanes][kReduceLanes + 1];
  const long long r = static_cast<long long>(blockIdx.x) * kReduceLanes + threadIdx.x;
  float acc = 0.f;
  if (r < rows) {
    for (int b = threadIdx.y; b < blocks; b += kReduceLanes) acc += partial[static_cast<long long>(b) * rows + r];
  }
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduceLanes / 2; half > 0; half /= 2) {
    if (threadIdx.y < half) sums[threadIdx.y][threadIdx.x] += sums[threadIdx.y + half][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && r < rows) out[r] = sums[0][threadIdx.x];
}

template <int PER_THREAD>
void launch_partial(dim3 grid, int threads, cudaStream_t stream, const float* scores, const float* pos,
                    const float* neg, const float* thr, long long n, int num_classes, int num_thr,
                    int chunks_t, long long chunk, float* partial) {
  counts_partial<PER_THREAD><<<grid, threads, 0, stream>>>(scores, pos, neg, thr, n, num_classes, num_thr,
                                                           chunks_t, chunk, partial);
}

}  // namespace

extern "C" {

// out (2, C, T) float32: out[0] = tp, out[1] = fp. The launch shape comes from the caller
// (ops/curve_counts.py::launch_plan): `blocks` sample chunks of `chunk` samples, `threads`
// threads of `per_thread` thresholds each (1, 2, 4 or 8), `chunks_t` threshold chunks per class.
// With blocks > 1, `scratch` holds blocks * 2 * C * T floats; with blocks == 1 it is unused.
int tm_curve_counts(const void* scores, const void* pos, const void* neg, const void* thr, long long n,
                    int num_classes, int num_thr, int blocks, int threads, int per_thread, int chunks_t,
                    long long chunk, void* scratch, void* out, int device, void* stream) {
  if (n <= 0 || num_classes <= 0 || num_thr <= 0) return static_cast<int>(cudaSuccess);
  if (threads <= 0 || threads > 256 || threads % 32 != 0 || blocks <= 0 || chunks_t <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_y = num_classes * chunks_t;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows_y < 65535 ? rows_y : 65535));
  float* partial = static_cast<float*>(blocks > 1 ? scratch : out);
  const float* sc = static_cast<const float*>(scores);
  const float* po = static_cast<const float*>(pos);
  const float* ne = static_cast<const float*>(neg);
  const float* th = static_cast<const float*>(thr);
  switch (per_thread) {
    case 1: launch_partial<1>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    case 2: launch_partial<2>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    case 4: launch_partial<4>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    case 8: launch_partial<8>(grid, threads, s, sc, po, ne, th, n, num_classes, num_thr, chunks_t, chunk, partial); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  const long long rows = 2LL * num_classes * num_thr;
  const long long reduce_blocks = (rows + kReduceLanes - 1) / kReduceLanes;
  counts_reduce<<<static_cast<unsigned>(reduce_blocks), dim3(kReduceLanes, kReduceLanes), 0, s>>>(
      static_cast<const float*>(scratch), blocks, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tm_curve_counts_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
